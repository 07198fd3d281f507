"""The port's examples stay runnable: each runs in a subprocess on the
CPU at a small size, with ``jax`` and ``repro`` blocked from import, and
prints the healthy lines ``tests/test_examples.py`` looks for in the
JAX package's examples.  Each subprocess runs torch on two host threads:
beside the other test workers, more would oversubscribe the cores, and
the examples' small tensors gain nothing from them."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

# run an example as __main__ where importing jax or repro fails, then
# check that neither was imported
RUNNER = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['repro'] = None\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
    "for m, v in sys.modules.items() if v is not None)\n")


def run_example(name: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", RUNNER, f"examples/{name}", "--device",
         "cpu", *args], capture_output=True, text=True, timeout=TIMEOUT_S,
        cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_torch_quickstart():
    out = run_example("torch_quickstart.py", "--steps", "2")
    assert "oracle lower bound" in out
    assert "work exchange" in out
    assert "through the 'cuda' backend (1 device(s)) on cpu" in out
    assert "cache HIT" in out
    assert "step 1: loss=" in out


@pytest.mark.parametrize("live", [False, True])
def test_torch_serve_batch(live):
    out = run_example("torch_serve_batch.py", "--slots", "300",
                      *(["--live"] if live else []))
    assert "greedy, KV-cached" in out
    assert "streaming prefill batches" in out
    for policy in ("work_exchange", "work_exchange_unknown", "fixed",
                   "uniform"):
        assert f"  {policy} " in out
    assert "SLO-miss" in out
    assert ("executing one 40-request batch live" in out) == live
    if live:
        assert out.count("MC-predicted") == 4


def test_torch_train_het_sim(tmp_path):
    out = run_example("torch_train_het_sim.py", "--steps", "2", "--seq",
                      "16", "--ckpt", str(tmp_path))
    assert "[work_exchange] step 0: loss=" in out
    assert "final-loss  virtual-time" in out
    assert "(oracle bound)" in out
    for policy in ("equal_static", "het_static", "work_exchange",
                   "work_exchange_online", "gradient_coded"):
        assert f"\n{policy} " in out
