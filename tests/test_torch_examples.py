"""The port's examples (``examples/torch/*.py``) run on the CPU through their
``main(argv)`` at small sizes, with their own asserts: the artifact reused,
targeted coverage above untargeted, the loss decreasing, the resume exact,
every request answered.  Running one loads neither JAX nor the JAX package."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# the suite runs in parallel workers: keep this file's CPU work on one thread
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
NAMES = ("quickstart", "tune_hparams", "targeted_selection", "serve_selection", "serve_lm",
         "train_lm_milo")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_has_a_port_counterpart():
    ref = {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert ref == set(NAMES) == {p.stem for p in EXAMPLES.glob("*.py")}


def test_quickstart(tmp_path):
    out = _example("quickstart").main(["--device", "cpu", "--artifact", str(tmp_path / "a.npz"),
                                       "--n", "1200", "--epochs", "4"])
    assert (tmp_path / "a.npz").exists()
    assert out["k"] == 84 and 0.0 <= out["milo_acc"] <= 1.0


def test_tune_hparams():
    out = _example("tune_hparams").main(["--device", "cpu", "--n", "600", "--max-budget", "3"])
    assert out["full"]["trials"] == out["milo"]["trials"] > 0


def test_targeted_selection():
    out = _example("targeted_selection").main(["--device", "cpu", "--n", "1200"])
    assert out["coverage"] > out["untargeted_coverage"] and out["hit"] > out["untargeted_hit"]


def test_serve_selection(tmp_path):
    out = _example("serve_selection").main(["--device", "cpu", "--n", "600", "--max-budget", "3",
                                            "--store-root", str(tmp_path)])
    assert out["artifact_sources"] == ["memory"] * 3
    assert out["stats"]["store"]["builds"] == 1 and out["stats"]["store"]["hits"] == 3


def test_serve_lm():
    out = _example("serve_lm").main(["--device", "cpu", "--requests", "4", "--max-new", "4"])
    assert out == {"requests": 4, "tokens": 16}


def test_train_lm_milo(tmp_path):
    out = _example("train_lm_milo").main(["--device", "cpu", "--steps", "24",
                                          "--ckpt", str(tmp_path / "ckpt")])
    assert out["steps"] == 24 and out["loss_last"] < out["loss_first"]


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_the_card(name, tmp_path):
    """Without ``--device`` an example asks for the card and raises without
    one, before any work: no example falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = {"quickstart": ["--artifact", str(tmp_path / "a.npz")],
            "serve_selection": ["--store-root", str(tmp_path)],
            "train_lm_milo": ["--ckpt", str(tmp_path / "ckpt")]}.get(name, [])
    with pytest.raises(RuntimeError, match="cuda"):
        _example(name).main(argv)


def test_an_example_loads_no_jax_or_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    script = (
        "import runpy, sys\n"
        "sys.argv = ['serve_lm.py', '--device', 'cpu', '--requests', '2', '--max-new', '2']\n"
        "runpy.run_path('examples/torch/serve_lm.py', run_name='__main__')\n"
        "print('LOADED', sorted(m for m in sys.modules\n"
        "                       if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LOADED")][-1]
    assert line == "LOADED []", line
