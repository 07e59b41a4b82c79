"""Rules the PyTorch port keeps: it never loads JAX or the JAX package, and
it never falls back to the CPU on its own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.milo import MiloPreprocessor
from repro_torch.models.classifier import init_mlp
from repro_torch.selection import MiloSession, MiloSessionConfig, build_selector

# the suite runs in parallel workers beside wall-clock-sensitive tests:
# keep this file's PyTorch CPU work (and its subprocesses') on one thread
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples" / "torch").glob("*.py")))

SLICE_ON_CPU = """
import sys
import numpy as np
from repro_torch.data.datasets import GaussianMixtureDataset
from repro_torch.selection import MiloSession

ds = GaussianMixtureDataset(n=300, n_classes=3, dim=16, seed=0)
s = MiloSession(use_pallas=True, total_epochs=6, device="cpu")
s.preprocess(ds.x, ds.y)
r = s.train(ds.x, ds.y, test_x=ds.x, test_y=ds.y)
import dataclasses
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.serve.lm_engine import Request, ServeEngine

cfg = dataclasses.replace(registry.smoke("jamba-1.5-large-398b"), attention_impl="pallas",
                          ssm_impl="pallas")
eng = ServeEngine(lm.init_lm(cfg, seed=0, device="cpu"), cfg, max_batch=2, max_len=16)
for i in range(3):
    eng.submit(Request(i, np.arange(3 + i, dtype=np.int32), max_new_tokens=4))
assert sorted(len(r.generated) for r in eng.run()) == [4, 4, 4]
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print("LOADED", loaded, r.final_acc)
"""


def _env():
    env = dict(os.environ)  # inherit: a stripped env can hang interpreter startup
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_port_never_loads_jax_or_the_reference():
    out = subprocess.run([sys.executable, "-c", SLICE_ON_CPU], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LOADED")][-1]
    assert line.startswith("LOADED []"), line


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        MiloSession()
    with pytest.raises(RuntimeError, match="cuda"):
        MiloPreprocessor()
    with pytest.raises(RuntimeError, match="cuda"):
        init_mlp(torch.Generator().manual_seed(0), 4, 2, 8)
    assert init_mlp(torch.Generator().manual_seed(0), 4, 2, 8, device="cpu")["w1"].device.type == "cpu"


def test_server_defaults_to_the_card():
    """``MiloServer`` runs its sessions and places its buffers on the card
    unless the caller asks for the CPU; without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.serve import BufferRegistry, MiloServer

    with pytest.raises(RuntimeError, match="cuda"):
        MiloServer(MiloSessionConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        MiloServer(MiloSessionConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        BufferRegistry()
    assert MiloServer(MiloSessionConfig(), device="cpu").device.type == "cpu"


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import registry
    from repro_torch.models import lm

    cfg = registry.smoke("yi-6b")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_caches(cfg, 1, 8)


def test_multihost_start_up_defaults_to_the_card(monkeypatch):
    """``multihost.initialize`` resolves its device before it creates the
    store: without a card the default (the card) raises, no store is made,
    and a session resolves its own device before it starts the group."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.distributed import multihost
    from repro_torch.testing.faults import free_port

    def no_store(*args, **kwargs):
        raise AssertionError("a store was created before the device was resolved")

    monkeypatch.setattr(torch.distributed, "TCPStore", no_store)
    address = f"localhost:{free_port()}"
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.initialize(address, 2, 0)
    assert not multihost.is_initialized()
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.local_device()
    monkeypatch.setenv("MILO_COORDINATOR", address)
    monkeypatch.setenv("MILO_NUM_PROCESSES", "2")
    monkeypatch.setenv("MILO_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="cuda"):
        MiloSession(multihost_init=True)
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize(address, 2, 0, device="cpu", backend="nccl")
    assert not multihost.is_initialized()


def test_configs_build_from_each_other():
    """Field names and defaults are the reference's: either package's config
    builds the other's, and ``device`` is no field."""
    from repro.core.milo import MiloPreprocessor as JPre
    from repro.selection import MiloSessionConfig as JCfg
    import dataclasses

    assert dataclasses.asdict(MiloSessionConfig()) == dataclasses.asdict(JCfg())
    assert dataclasses.asdict(MiloPreprocessor(device="cpu")) == dataclasses.asdict(JPre())
    JPre(**dataclasses.asdict(MiloPreprocessor(device="cpu", use_pallas=True)))
    MiloPreprocessor(**dataclasses.asdict(JPre(use_pallas=True)), device="cpu")
    assert "device" not in dataclasses.asdict(MiloPreprocessor(device="cpu"))


def test_unported_selectors_raise_keyerror():
    """Every name of the reference's registry is ported: the five baselines
    the port refused until they landed build and plan through
    ``build_selector``; only a name no package registers raises."""
    with pytest.raises(KeyError, match="unknown selector"):
        build_selector("not_a_selector")
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(50, 6)).astype(np.float32)
    grads = rng.normal(size=(50, 6))
    built = {
        "el2n": build_selector("el2n", scores=rng.random(50), k=5),
        "selfsup_prune": build_selector("selfsup_prune", features=feats, k=5, n_prototypes=3,
                                        device="cpu"),
        "craig_pb": build_selector("craig_pb", grad_fn=lambda: grads, k=5, R=2, device="cpu"),
        "gradmatch_pb": build_selector("gradmatch_pb", grad_fn=lambda: grads, k=5, R=2,
                                       device="cpu"),
        "glister": build_selector("glister", grad_fn=lambda: grads,
                                  val_grad_fn=lambda: grads[0], k=5, R=2, device="cpu"),
        "random": build_selector("random", n=50, k=5, seed=0),
    }
    for name, sel in built.items():
        plan = sel.plan(0).validate(50)
        assert plan.k == 5 and plan.provenance["selector"] == name, name


def test_chip_smoke_refuses_without_a_card_and_rehearses_on_cpu():
    smoke = ROOT / "chip_smoke.py"
    env = _env()
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(smoke)], capture_output=True, text=True,
                             env=env, cwd=ROOT, timeout=120)
        assert out.returncode != 0 and '"ok"' not in out.stdout
    out = subprocess.run([sys.executable, str(smoke), "--cpu-rehearsal"], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == '{"ok": true, "rehearsal": "cpu"}'
