"""The port stands alone: no JAX, nothing of ``repro``, and no quiet CPU
fallback when the default CUDA device is missing."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import HetSpec, get_scheme
from repro_torch.launch import serve
from repro_torch.models import build_model

PKG = Path(repro_torch.__file__).resolve().parent


def test_imports_and_runs_with_jax_and_repro_blocked():
    """In a fresh interpreter where importing ``jax`` or ``repro`` fails,
    the port imports and runs a small Monte Carlo on the CPU, serves the
    recurrentgemma and granite-moe smoke configs, and runs a tiny sweep
    of the torch serving engine."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch.core import HetSpec, get_scheme\n"
        "rng = np.random.default_rng(0)\n"
        "het = HetSpec.uniform_random(8, 20.0, 20.0**2 / 6, rng)\n"
        "r = get_scheme('work_exchange_unknown').mc(het, 5000, 16, rng, "
        "device='cpu')\n"
        "assert np.isfinite(r.t_comp) and r.extra['backend'] == 'cuda'\n"
        "import dataclasses, torch\n"
        "from repro_torch.configs import get_config, smoke_config\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.train.serve import greedy_generate\n"
        "for arch in ('recurrentgemma-2b', 'granite-moe-3b-a800m'):\n"
        "    cfg = dataclasses.replace(smoke_config(get_config(arch)), "
        "dtype='float32')\n"
        "    m = build_model(cfg)\n"
        "    toks, _ = greedy_generate(m, m.init(0, 'cpu'), {'tokens': "
        "torch.zeros((2, 20), dtype=torch.long)}, m.init_cache(2, 24, "
        "'cpu'), 4)\n"
        "    assert toks.shape == (2, 4)\n"
        "from repro_torch.serving import ServingConfig, run_serving_grid\n"
        "sv = run_serving_grid('work_exchange', {}, [het], ServingConfig("
        "loads=(0.6,), slots=60), 10, 2, 0, backend='torch', "
        "device='cpu')[0]\n"
        "assert sv.extra['serving_backend'] == 'torch'\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', r.t_comp)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_imports_no_jax_and_no_repro():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 40
    for sub in ("core", "distributed", "hettrain", "scenarios",
                "experiments", "serving", "control"):
        assert any(p.parent == PKG / sub for p in files), sub
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)
    root = PKG.parents[1]
    examples = sorted((root / "examples").glob("torch_*.py"))
    assert len(examples) == 3
    for script in [root / "chip_smoke.py", *examples]:
        for mod in _imported_modules(script):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                (script, mod)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    het = HetSpec.uniform_random(8, 20.0, 0.0, np.random.default_rng(0))
    for name in ("oracle", "fixed", "mds", "work_exchange"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_scheme(name).mc(het, 1000, 4, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    model = build_model(smoke_config(get_config("recurrentgemma-2b")))
    for call in (model.init, lambda: model.init_cache(2, 8),
                 lambda: serve.main(["--arch", "recurrentgemma-2b"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_training_runs_with_jax_and_repro_blocked():
    """The training slice (the differentiable ops, the loss, AdamW, the
    synthetic data, ``fit`` and the unit-group gradient engine) imports,
    takes two steps of the recurrentgemma smoke config and sums a unit
    group's gradients of the granite-moe one on the CPU where importing
    ``jax`` or ``repro`` fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import dataclasses, math\n"
        "from repro_torch.configs import get_config, smoke_config\n"
        "from repro_torch.data import UnitStore\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.optim import AdamW, warmup_cosine\n"
        "from repro_torch.train.loop import fit\n"
        "cfg = dataclasses.replace(smoke_config(get_config("
        "'recurrentgemma-2b')), dtype='float32')\n"
        "m = build_model(cfg)\n"
        "store = UnitStore(2, 24, cfg.vocab_size, structured=True)\n"
        "_, state, hist = fit(m, m.init(0, 'cpu'), AdamW(lr=warmup_cosine("
        "1e-3, 1, 4)), [store.fetch(u) for u in range(2)], log_every=1)\n"
        "assert state.step == 2 and all(math.isfinite(h['loss']) for h in "
        "hist)\n"
        "from repro_torch.hettrain import ScanGradEngine\n"
        "moe = build_model(dataclasses.replace(smoke_config(get_config("
        "'granite-moe-3b-a800m')), dtype='float32'))\n"
        "eng = ScanGradEngine(moe, UnitStore(1, 12, 256))\n"
        "_, losses = eng.grad_sum(moe.init(0, 'cpu'), [1, 0])\n"
        "assert losses.shape == (2,) and eng.stats()['units'] == 2\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', hist[-1]['loss'])\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_het_training_runs_with_jax_and_repro_blocked():
    """The heterogeneous-training subsystem (the master protocol, the
    policies, ``HetTrainer`` with a compressor, the runner) imports and
    runs on the CPU at the ``tiny`` preset where importing ``jax`` or
    ``repro`` fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import math\n"
        "import numpy as np\n"
        "from repro_torch.core import HetSpec\n"
        "from repro_torch.distributed import HetTrainer, Int8Compressor\n"
        "from repro_torch.hettrain import TrainConfig, run_training_grid\n"
        "train = TrainConfig(model='tiny', steps=2)\n"
        "model, params = train.build_model('cpu')\n"
        "rates = np.array([1.0, 4.0, 2.0, 8.0])\n"
        "for comp in (None, Int8Compressor()):\n"
        "    t = HetTrainer(model, train.build_optimizer(), rates, "
        "train.build_store(), policy='work_exchange_online', "
        "units_per_step=8, compressor=comp)\n"
        "    _, _, hist = t.train(params, 1)\n"
        "    assert math.isfinite(hist[0].loss) and hist[0].grad_bytes > 0\n"
        "[rep] = run_training_grid('gradient_coded', {}, [HetSpec(rates)], "
        "train, 4, 2, 0, device='cpu')\n"
        "assert len(rep.extra['training']['loss_curve']) == 2\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', rep.t_comp)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_experiment_layer_runs_with_jax_and_repro_blocked(tmp_path):
    """The scenario families and the experiment layer (spec, plan,
    engine, store, CLI) import and run on the CPU where importing ``jax``
    or ``repro`` fails: the quick demo through the CLI with its cache
    check, the trace demo (a ``trace_corpus`` grid and ``trace_replay``
    on the committed corpus) on the ``cuda`` backend's plain version,
    a committed store entry read back and hashed, and one short live
    episode over ``inproc`` (the live control plane, its payload on the
    CPU)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch.core import HetSpec\n"
        "from repro_torch.experiments import ResultsStore, run_experiment\n"
        "from repro_torch.experiments.__main__ import demo_spec, main\n"
        "from repro_torch.scenarios import list_families, load_corpus\n"
        f"assert main(['--demo', 'quick', '--backend', 'numpy', "
        f"'--device', 'cpu', '--store', {str(tmp_path)!r}, "
        f"'--check-cache']) == 0\n"
        "r = run_experiment(demo_spec('trace').replace(trials=2), "
        "device='cpu')\n"
        "assert r.spec.backend == 'cuda' and len(r.report("
        "'trace_replay@w0')) == 2\n"
        "assert len(list_families()) == 5 and load_corpus().workers == 64\n"
        f"store = ResultsStore({str(PKG.parents[1] / 'results' / 'store')!r})\n"
        "h = '07eaead10b06f4862dc583bb9fb4342f8eaee8c7e4d074b5d61eb94bc527fbb7'\n"
        "assert store.get(h).spec.spec_hash() == h\n"
        "from repro_torch.control import LiveConfig, run_live\n"
        "lv = run_live('work_exchange', {}, HetSpec.uniform_random(3, 4.0, "
        "1.0, np.random.default_rng(0)), 300, LiveConfig(target_wall_s="
        "0.1), 1, device='cpu')\n"
        "assert lv.extra['control_plane']['ledger']['units_completed'] == "
        "300\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', r.report('work_exchange')[0].t_comp)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "check-cache: OK" in res.stdout
    assert res.stdout.splitlines()[-1].startswith("ok")


def test_torch_backend_and_row_split_run_with_jax_and_repro_blocked(
        tmp_path):
    """The ``torch`` sampler backend (grid, panel, MDS sweep), the row
    split of ``grid_sharding`` on both fluid backends and the serving
    engine, and a ``--devices`` run of the experiment CLI import and run
    on the CPU where importing ``jax`` or ``repro`` fails (the examples'
    run is ``test_torch_examples.py``'s)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch.core import HetSpec, get_scheme, mc_grid_panel\n"
        "from repro_torch.core.samplers import grid_sharding\n"
        "from repro_torch.serving import ServingConfig, run_serving_grid\n"
        "rng = np.random.default_rng(0)\n"
        "het = HetSpec.uniform_random(8, 20.0, 20.0**2 / 6, rng)\n"
        "for name in ('work_exchange_unknown', 'mds'):\n"
        "    r = get_scheme(name).mc(het, 5000, 16, rng, backend='torch', "
        "device='cpu')\n"
        "    assert np.isfinite(r.t_comp) and r.extra['backend'] == 'torch'\n"
        "p = mc_grid_panel({n: get_scheme(n) for n in ('work_exchange', "
        "'work_exchange_unknown')}, [het], 5000, 16, rng, backend='torch', "
        "device='cpu')\n"
        "assert p['work_exchange'][0].extra['fused_panel'] == 1\n"
        "with grid_sharding(2, device='cpu'):\n"
        "    for b in ('torch', 'cuda'):\n"
        "        r = get_scheme('work_exchange').mc(het, 5000, 16, rng, "
        "backend=b, device='cpu')\n"
        "        assert np.isfinite(r.t_comp)\n"
        "    sv = run_serving_grid('work_exchange', {}, [het], ServingConfig("
        "loads=(0.6,), slots=60), 10, 2, 0, backend='torch', "
        "device='cpu')[0]\n"
        "    assert sv.extra['serving_backend'] == 'torch'\n"
        "from repro_torch.experiments.__main__ import main\n"
        f"assert main(['--demo', 'quick', '--backend', 'torch', '--devices', "
        f"'2', '--trials', '4', '--device', 'cpu', '--store', "
        f"{str(tmp_path)!r}, "
        f"'--force']) == 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', r.t_comp)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "devices=1" in res.stdout
    assert res.stdout.splitlines()[-1].startswith("ok")


def test_sharded_prefill_runs_with_jax_and_repro_blocked(tmp_path):
    """A 2-rank gloo mesh (data 1, model 2) runs the sharded prefill of
    the qwen3-moe smoke config (the all-to-all path, the vocab-parallel
    embedding, tensor-parallel attention) where importing ``jax`` or
    ``repro`` fails in the launching process; each rank checks that
    neither was imported on its way."""
    out = str(tmp_path)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import os\n"
        "from repro_torch.launch.mesh import spawn\n"
        "import torch_mesh_ranks as R\n"
        f"spawn(R.isolated_prefill_rank, 2, ({out!r},), timeout_s=120, "
        f"store_dir={out!r})\n"
        f"assert all(os.path.exists(os.path.join({out!r}, f'isolated-r{{r}}"
        f".pt')) for r in range(2))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=f"{PKG.parent}{os.pathsep}{tests}")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=150)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.splitlines()[-1] == "ok"


def test_sharded_train_step_runs_with_jax_and_repro_blocked(tmp_path):
    """A 2-rank gloo mesh (data 1, model 2) inits the qwen3-moe smoke
    config in the training layout and takes two sharded train steps (the
    all-to-all path's backward, the autograd collectives, the global clip
    norm) where importing ``jax`` or ``repro`` fails in the launching
    process; each rank checks that neither was imported on its way."""
    out = str(tmp_path)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import os\n"
        "from repro_torch.launch.mesh import spawn\n"
        "import torch_train_ranks as R\n"
        f"spawn(R.isolated_train_rank, 2, ({out!r},), timeout_s=120, "
        f"store_dir={out!r})\n"
        f"assert all(os.path.exists(os.path.join({out!r}, f'isolated-train-"
        f"r{{r}}.pt')) for r in range(2))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=f"{PKG.parent}{os.pathsep}{tests}")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=150)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.splitlines()[-1] == "ok"
