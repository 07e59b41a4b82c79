#!/usr/bin/env python3
"""Instruction mix of kernels in the port's built library, from ``cuobjdump -sass``.

    python3 scripts/sass_mix.py gram_free_ring_kernel similarity_kernelIfLb1EE

Builds the library if needed (``repro_torch.kernels._build``, so it needs
``nvcc``), disassembles it and prints, for each kernel whose mangled name
holds one of the given substrings, how many SASS instructions of each kind
it holds: the fp32 FMAs, the shared-memory loads by width, the asynchronous
copies, the barriers and all the rest.  The counts are static (each
instruction once, as compiled), so for a kernel whose k-slab loop is one
unrolled block they say what one pass of that loop issues.
"""
from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    lib, _ = _build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    functions = re.split(r"\n\s*Function : ", sass)[1:]
    for want in sys.argv[1:]:
        found = [f for f in functions if want in f.split("\n", 1)[0]]
        if not found:
            print(f"{want}: no such kernel in {lib.name}")
            return 1
        for f in found:
            name, body = f.split("\n", 1)
            ops = collections.Counter(
                m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                                               body))
            total = sum(ops.values())
            ffma = sum(n for op, n in ops.items() if op.startswith("FFMA"))
            lds = {op: n for op, n in ops.items() if op.startswith("LDS")}
            copies = sum(n for op, n in ops.items() if op.startswith("LDGSTS"))
            bars = sum(n for op, n in ops.items() if op.startswith("BAR"))
            print(f"{name.strip()}: {total} instructions; FFMA {ffma} ({ffma / total:.1%}), "
                  f"shared loads {lds}, cp.async {copies}, barriers {bars}; "
                  f"most common: {dict(ops.most_common(12))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
