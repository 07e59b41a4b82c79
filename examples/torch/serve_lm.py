"""Serving example on the PyTorch port: batched decode with the slot-pool
engine.

Loads (initializes) an assigned-arch smoke model, submits a burst of
requests larger than the slot pool, and streams completions — the serving
counterpart of the LM training example.

Run:  PYTHONPATH=src python examples/torch/serve_lm.py [--arch yi-6b] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.serve.lm_engine import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = registry.smoke(args.arch)
    params = lm.init_lm(cfg, seed=0, device=args.device)
    eng = ServeEngine(params, cfg, max_batch=3, max_len=64)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 12))).astype(np.int32)
        eng.submit(Request(rid, prompt, max_new_tokens=args.max_new))

    done = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.generated}")
    print(f"{len(done)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s on {eng.device.type} smoke config)")
    assert len(done) == args.requests
    return {"requests": len(done), "tokens": total_tokens}


if __name__ == "__main__":
    main()
