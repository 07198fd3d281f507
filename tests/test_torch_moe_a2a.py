"""The port's expert-parallel ``moe_apply_a2a`` against the JAX package's,
on the CPU.

Four gloo ranks form a (data 2, model 2) mesh (one spawn for every case,
a 120 s limit); each takes its (batch over 'data', sequence over 'model')
block of x (4, 16, 32) and the serving layout of the expert weights
(``param_specs(fsdp=False)``: by expert where 2 divides E, else by F).
The inputs are drawn with numpy from a seed.
The reference runs ``moe_apply_a2a`` jitted under ``jax.set_mesh`` on a
(2, 2) mesh of forced host devices, in one subprocess, as
``tests/test_distributed.py`` runs it.  Cases:

* qwen3-like, E 8, top-2, capacity factor 1.0: pairs drop, and other
  pairs than the global scatter drops (per-rank capacity ``c_send``);
* granite-like, E 5: padded to 6 with dummy experts behind -1e30 logits,
  the weights gathered over F and sliced by rank;
* drop-free, E 8 at capacity factor 8 (the reference test's setting),
  also against the port's own scatter path.

With ``MOE_IMPL = "scatter"`` the same ``moe_apply`` call takes the
scatter path on the mesh (no all-to-all) and gives the global scatter's
block in every case.

Outputs within 1e-5 in float32, the aux term within 1e-6, the dropped
pairs counted equal (the reference's counted from its own
``_local_rank_in_expert`` on each block).
"""
import sys
import subprocess
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

import torch_mesh_ranks as ranks

pytestmark = pytest.mark.skipif(
    not hasattr(jax.sharding, "AxisType"),
    reason="requires jax >= 0.6 sharding API (AxisType / set_mesh)")

REPO = Path(__file__).resolve().parents[1]
CASES = tuple(ranks.MOE_CASES)
LIMIT_S = 120
OUT_TOL, AUX_TOL = 1e-5, 1e-6

JAX_RUN = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe as moe_mod
from repro.configs import get_config, smoke_config
import dataclasses

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
inputs = dict(np.load({out!r} + "/inputs.npz"))
out = {{}}
for case, (arch, E, cf) in {cases!r}.items():
    cfg = dataclasses.replace(
        smoke_config(get_config(arch)), dtype="float32", d_model={d!r},
        n_experts=E, experts_per_token=2, d_ff=16, capacity_factor=cf)
    p = {{k: jnp.asarray(inputs[f"{{case}}/p/{{k}}"])
         for k in ("router", "wi_gate", "wi_up", "wo")}}
    x = jnp.asarray(inputs[f"{{case}}/x"])
    with jax.set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe_mod.moe_apply_a2a(
            p, cfg, x, jax.sharding.get_abstract_mesh()))(p, x)
    # the pairs each (data, model) block drops under its local capacity
    E, K, tp = cfg.n_experts, cfg.experts_per_token, 2
    E_pad = -(-E // tp) * tp
    dropped = 0
    for blk in (x[:2, :8], x[:2, 8:], x[2:, :8], x[2:, 8:]):
        xf = blk.reshape(-1, blk.shape[-1])
        logits = jnp.pad(xf @ p["router"], ((0, 0), (0, E_pad - E)),
                         constant_values=-1e30)
        _, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
        ranks = moe_mod._local_rank_in_expert(top_e.reshape(-1), E_pad)
        t = xf.shape[0]
        c_send = max(4, -(-int(t * K * cfg.capacity_factor / E_pad) // 4) * 4)
        dropped += int(jnp.sum(ranks >= c_send))
    out.update({{f"{{case}}/out": np.asarray(y),
                f"{{case}}/aux": np.asarray(aux),
                f"{{case}}/dropped": np.asarray(dropped)}})
np.savez({out!r} + "/jax-moe.npz", **out)
print("ok")
"""


def draw_inputs(case: str, seed: int) -> dict:
    """x (4, 16, 32) and the router and expert weights of ``case`` from
    ``default_rng(seed)``, at the JAX ``moe_init``'s scales."""
    cfg = ranks.moe_config(case)
    D, Ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    return {"x": normal(ranks.MOE_X, 1.0),
            "p/router": normal((D, E), D ** -.5),
            "p/wi_gate": normal((E, D, Ff), D ** -.5),
            "p/wi_up": normal((E, D, Ff), D ** -.5),
            "p/wo": normal((E, Ff, D), Ff ** -.5)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs drawn here; then the JAX subprocess and the 4-rank
    spawn at once."""
    out = tmp_path_factory.mktemp("moe_a2a")
    np.savez(out / "inputs.npz", **{
        f"{case}/{k}": v for i, case in enumerate(CASES)
        for k, v in draw_inputs(case, 10 + i).items()})
    script = textwrap.dedent(JAX_RUN).format(
        src=str(REPO / "src"), out=str(out), d=ranks.MOE_X[2],
        cases=ranks.MOE_CASES)
    ref = subprocess.Popen([sys.executable, "-c", script],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        spawn(ranks.moe_rank, 4, (str(out),), timeout_s=LIMIT_S,
              store_dir=str(out))
        _, stderr = ref.communicate(timeout=LIMIT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, stderr[-4000:]
    got = [torch.load(out / f"moe-r{r}.pt", weights_only=False)
           for r in range(4)]
    return got, dict(np.load(out / "jax-moe.npz"))


def _block(arr, d: int, m: int):
    return arr[2 * d:2 * d + 2, 8 * m:8 * m + 8]


@pytest.mark.parametrize("case", CASES)
def test_output_matches_the_reference(runs, case):
    got, ref = runs
    for rec in got:
        d, m = rec["coord"]
        want = _block(ref[f"{case}/out"], d, m)
        gap = float(np.max(np.abs(rec["cases"][case]["out"].numpy() - want)))
        assert gap <= OUT_TOL, (rec["coord"], gap)


@pytest.mark.parametrize("case", CASES)
def test_aux_matches_the_reference(runs, case):
    got, ref = runs
    for rec in got:
        aux = float(rec["cases"][case]["aux"])
        assert abs(aux - float(ref[f"{case}/aux"])) <= AUX_TOL


@pytest.mark.parametrize("case", CASES)
def test_dropped_pairs_equal_the_reference(runs, case):
    got, ref = runs
    want = int(ref[f"{case}/dropped"])
    assert {rec["cases"][case]["dropped"] for rec in got} == {want}
    if case.endswith("cf1"):
        assert want > 0                   # the case really drops pairs
    else:
        assert want == 0


@pytest.mark.parametrize("case", CASES)
def test_moe_apply_takes_the_a2a_path_with_two_exchanges(runs, case):
    got, _ = runs
    for rec in got:
        c = rec["cases"][case]
        assert c["apply_equal"]
        assert c["counts"]["all_to_all/2"]["calls"] == 2
        # E 5 does not split over 2: its weights are gathered over F
        gathers = c["counts"].get("all_gather/2", {}).get("calls", 0)
        assert gathers == (3 if "e5" in case else 0)


def test_drop_free_a2a_matches_the_scatter_path(runs):
    got, _ = runs
    for rec in got:
        d, m = rec["coord"]
        c = rec["cases"]["qwen3-e8-cf8"]
        gap = float((c["out"] - _block(c["scatter"], d, m)).abs().max())
        assert gap <= OUT_TOL, gap


@pytest.mark.parametrize("case", CASES)
def test_moe_impl_scatter_pins_the_scatter_path_on_the_mesh(runs, case):
    got, _ = runs
    for rec in got:
        d, m = rec["coord"]
        c = rec["cases"][case]
        assert not any(k.startswith("all_to_all") for k in c["pinned_counts"])
        gap = float((c["pinned"] - _block(c["scatter"], d, m)).abs().max())
        assert gap <= OUT_TOL, (rec["coord"], gap)
