"""The port's dry run (``repro_torch.launch.dryrun``) and its step
accounting (``launch.op_analysis``, ``kernels.tally``), on the CPU.

* the collective ring factors are the JAX package's
  (``repro.launch.hlo_analysis._wire_bytes``) for all four kinds;
* each model kernel op's ``meta`` branch makes its kernel's output (the
  plain version's shape and dtype, contiguous), and its tally is the
  hand count of the kernel's work;
* a smoke-config step counts the same dot FLOPs, op-boundary bytes and
  collectives on CPU tensors as on ``meta`` (a granite-moe training
  step, a phi4-mini prefill and decode step), at world size 1 and on a
  fake world of 8 at (data 2, model 4);
* the peak tracker is exact on hand-built allocate/free sequences;
* the dot FLOPs match the JAX package's ``lower_cell`` on the same
  smoke cells (one subprocess, its module globals patched to a (2, 4)
  mesh of 8 host devices) once each known difference is taken out;
* cells the port cannot run yet are ``not_ported`` with their item, and
  a one-cell CLI run writes its JSON.
"""
import contextlib
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (ShapeConfig, get_config, resolve_for_tp,
                                 smoke_config)
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import tally
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.moe_gmm.ops import expert_matmul
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.op_analysis import BLOCK, StepCounter
from repro_torch.models import build_model
from repro_torch.models import registry
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models.attention import _flash
from repro_torch.optim import AdamW

REPO = Path(__file__).resolve().parents[1]
META = torch.device("meta")
SMOKE_S, SMOKE_B, SMOKE_TP, SMOKE_WORLD = 64, 8, 4, 8
# the port's dot FLOPs against the JAX package's, once the known terms
# are taken out: every one of the six cells measured equal, so the limit
# is float rounding's
REF_FLOPS_RTOL = 1e-9


def _rounded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, device=META)


# ---------------------------------------------------------------------------
# (1) ring factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("op,kind,out_elems", [
    ("all_gather", "all-gather", lambda m, n: m * n),
    ("all_reduce", "all-reduce", lambda m, n: m),
    ("reduce_scatter", "reduce-scatter", lambda m, n: m // n),
    ("all_to_all", "all-to-all", lambda m, n: m)])
def test_ring_factors_are_the_reference(op, kind, out_elems, n):
    from repro.launch.hlo_analysis import _wire_bytes as ref_wire
    m = 4096                                   # bf16 input elements
    out = out_elems(m, n)
    port = coll._wire_bytes(op, 2 * m, 2 * out, n)
    ref = ref_wire(kind, "", f"bf16[{out}]", [2 * m], n)
    assert port == ref


# ---------------------------------------------------------------------------
# (2) the kernel ops' meta branches and tallies
# ---------------------------------------------------------------------------

def _tallied(fn, *args):
    tally.reset_tally()
    out = fn(*args)
    return out, dict(tally.OP_TALLY)


# (Sq, Sk, causal, window, unmasked pairs by hand)
FLASH_CASES = {
    "causal": (8, 8, True, 0, 36),
    "window": (8, 8, True, 3, 1 + 2 + 3 * 6),
    "non_causal": (8, 8, False, 0, 64),
    "cross_causal": (4, 8, True, 0, 5 + 6 + 7 + 8),
    "cross_non_causal": (4, 8, False, 0, 32),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_meta_branch_and_tally(case):
    Sq, Sk, causal, window, pairs = FLASH_CASES[case]
    B, Hq, Hkv, d = 2, 4, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d)))
    plain, t_cpu = _tallied(flash_attention, q, k, v, causal, window)
    out, t_meta = _tallied(flash_attention, _meta(q), _meta(k), _meta(v),
                           causal, window)
    assert out.is_meta and out.shape == plain.shape
    assert out.dtype == plain.dtype and out.is_contiguous()
    want = {"calls": 1, "flops": 4.0 * B * Hq * d * pairs,
            "bytes": 4 * (q.numel() + k.numel() + v.numel() + plain.numel())}
    assert t_cpu == t_meta == {"flash_attention": want}


def test_flash_tally_counts_mla_padded_heads():
    """MLA's q.k dim 24 and v dim 16 go to the kernel padded to its
    least head dim that holds them: the tally counts the padded heads the
    kernel computes."""
    B, S, H, dq, dv = 1, 8, 2, 24, 16
    q = torch.randn(B, S, H, dq)
    k = torch.randn(B, S, H, dq)
    v = torch.randn(B, S, H, dv)
    plain, t_cpu = _tallied(_flash, q, k, v, True, 0, dq ** -0.5)
    out, t_meta = _tallied(_flash, _meta(q), _meta(k), _meta(v), True, 0,
                           dq ** -0.5)
    assert out.shape == plain.shape == (B, S, H, dv)
    assert t_cpu == t_meta
    d = min(h for h in HEAD_DIMS if h >= dq)
    assert t_meta["flash_attention"]["flops"] == 4.0 * B * H * d * 36


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_matmul_meta_branch_and_tally(dtype):
    E, C, Dm, F = 3, 8, 16, 24
    buf = torch.randn(E, C, Dm).to(dtype)
    w = torch.randn(E, Dm, F).to(dtype)
    plain, t_cpu = _tallied(expert_matmul, buf, w)
    out, t_meta = _tallied(expert_matmul, _meta(buf), _meta(w))
    assert out.is_meta and out.shape == plain.shape == (E, C, F)
    assert out.dtype == plain.dtype == dtype and out.is_contiguous()
    size = buf.element_size()
    assert t_cpu == t_meta == {"expert_matmul": {
        "calls": 1, "flops": 2.0 * E * C * Dm * F,
        "bytes": size * (E * C * Dm + E * Dm * F + E * C * F)}}


def test_linear_scan_meta_branch_and_tally():
    a = torch.rand(2, 16, 8)
    b = torch.randn(2, 16, 8)
    plain, t_cpu = _tallied(linear_scan, a, b)
    out, t_meta = _tallied(linear_scan, _meta(a), _meta(b))
    assert out.is_meta and out.shape == plain.shape
    assert out.dtype == plain.dtype and out.is_contiguous()
    assert t_cpu == t_meta == {"linear_scan": {
        "calls": 1, "flops": 0.0, "bytes": 3 * 4 * a.numel()}}


# ---------------------------------------------------------------------------
# (3) CPU and meta count alike
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _world(n: int, tp: int):
    """The active mesh of a fake world of ``n`` ranks at (data n // tp,
    model tp), or none at n == 1."""
    if n == 1:
        yield
        return
    with D.fake_world(n), shd.use_mesh(make_host_mesh(model=tp)):
        yield


def _count(arch: str, kind: str, device, tp: int) -> dict:
    """One smoke step of ``kind`` on ``device`` (the CPU's weights and
    tokens drawn from seed 0) on the active mesh, counted."""
    model = build_model(resolve_for_tp(smoke_config(get_config(arch)), tp))
    cfg = model.cfg
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SMOKE_B, SMOKE_S if kind != "decode" else 1)))
    train = kind == "train"
    if device == META:
        params = D.meta_params(model, fsdp=train)
        tokens = _meta(tokens)
    else:
        params = model.init(seed=0, device="cpu", fsdp=train)
    if train:
        opt = AdamW(lr=3e-4)
        return D.count_train(model, opt, params, opt.init(params),
                             {"tokens": tokens, "labels": tokens})
    if device == META:
        cache = D.meta_cache(model, SMOKE_B, SMOKE_S)
    else:
        cache = model.init_cache(SMOKE_B, SMOKE_S, device="cpu")
    if kind == "prefill":
        return D.count_prefill(model, params,
                               D.local_batch({"tokens": tokens}), cache)[0]
    cache["pos"] = SMOKE_S - 1
    return D.count_decode(model, params, cache,
                          D.local_batch({"tokens": tokens})["tokens"])[0]


STEPS = [("granite-moe-3b-a800m", "train"), ("phi4-mini-3.8b", "prefill"),
         ("phi4-mini-3.8b", "decode")]


@pytest.mark.parametrize("world", [1, SMOKE_WORLD])
@pytest.mark.parametrize("arch,kind", STEPS)
def test_cpu_and_meta_count_alike(arch, kind, world):
    tp = SMOKE_TP if world > 1 else 1
    with _world(world, tp):
        cpu = _count(arch, kind, torch.device("cpu"), tp)
    with _world(world, tp):
        meta = _count(arch, kind, META, tp)
    assert cpu["dot_flops"] == meta["dot_flops"] > 0
    assert cpu["mem_bytes"] == meta["mem_bytes"] > 0
    assert cpu["kernel_ops"] == meta["kernel_ops"]
    assert cpu["collectives"] == meta["collectives"]
    if world > 1:
        assert meta["total_collective_bytes"] > 0


# ---------------------------------------------------------------------------
# (4) the peak tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_peak_tracker_is_exact(device):
    x = torch.empty(1000, device=device)                      # an input
    with StepCounter([x]) as counter:
        a = torch.empty(300, 300, device=device)              # 360000 B
        b = a @ a
        del a
        c = b * 2
        del b, c
        e = torch.empty(100_000, device=device)               # 400000 B
        f = e[:10]                                            # a view
        del e, f
    res = counter.result()
    assert res["input_bytes"] == _rounded(4000)
    assert res["peak_bytes"] == _rounded(4000) + 2 * _rounded(360_000)


def test_peak_tracker_adds_cuda_workspace_and_skips_kernel_internals():
    """logsumexp's CUDA working memory (the row maxima and the shifted
    input) is live while it runs; inside a kernel op only its output is
    tracked, not the plain version's temporaries."""
    x = torch.empty(64, 1000, device="meta")
    with StepCounter([x]) as counter:
        y = torch.logsumexp(x, dim=-1)
        del y
    row, out = _rounded(64 * 4), _rounded(64_000 * 4)
    assert counter.result()["peak_bytes"] == out + row + (out + row)
    buf, w = torch.randn(4, 8, 16), torch.randn(4, 16, 32)
    with StepCounter([buf, w]) as counter:
        expert_matmul(buf, w)
    res = counter.result()
    assert res["peak_bytes"] == res["input_bytes"] + _rounded(4 * 8 * 32 * 4)
    assert res["aten_flops"] == 0
    assert res["dot_flops"] == 2.0 * 4 * 8 * 16 * 32


def test_counted_step_leaves_the_counters_as_they_were():
    coll.COUNTS.clear()
    tally.reset_tally()
    with _world(SMOKE_WORLD, SMOKE_TP):
        res = _count("granite-moe-3b-a800m", "prefill", META, SMOKE_TP)
    assert res["collectives"] and res["kernel_ops"]
    assert {f"{op}/{n}": row for (op, n), row in coll.COUNTS.items()} == \
        res["collectives"]
    assert tally.OP_TALLY == res["kernel_ops"]


# ---------------------------------------------------------------------------
# (5) against the JAX package's lower_cell
# ---------------------------------------------------------------------------

REF_RUN = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
import json, sys
sys.path.insert(0, {src!r})
import jax
jax.devices()
import repro.launch.dryrun as D
from repro.configs import ShapeConfig, get_config, smoke_config
from repro.launch.mesh import make_host_mesh
D.TP = {tp}
D.make_production_mesh = lambda multi_pod=False: make_host_mesh(model={tp})
D.get_config = lambda a: smoke_config(get_config(a))
D.SHAPES = {{k: ShapeConfig(k, {s}, {b}, k)
            for k in ("train", "prefill", "decode")}}
out = {{}}
for arch in {archs!r}:
    for kind in ("train", "prefill", "decode"):
        r = D.lower_cell(arch, kind, False)
        out[arch + "/" + kind] = {{
            "dot_flops": r["hlo"]["dot_flops"],
            "peak": r["memory"]["peak_bytes_est"],
            "coll": r["hlo"]["total_collective_bytes"]}}
print("RESULT " + json.dumps(out))
"""
REF_ARCHS = ("granite-moe-3b-a800m", "phi4-mini-3.8b")


def _explained(arch: str, kind: str, res: dict) -> float:
    """The port's dot FLOPs less the known differences from the JAX
    package's compiled step:

    * attention: the flash op counts the unmasked (query, key) pairs,
      where the JAX package's XLA path computes each S x S chunk whole
      (at S = 64 one chunk, so no causal chunk is skipped), in the
      forward and in remat's recompute of it; and the port's backward
      recomputes the forward through the plain version (the JAX
      package's XLA backward differentiates the saved chunk);
    * the decode's MoE (the scatter path): the port gathers every token
      over the batch axes and each data rank runs the experts on all of
      them, where the JAX package shards the expert buffer's capacity
      over the batch axes; its router's product too runs on every
      token."""
    flops = res["dot_flops"]
    cfg = resolve_for_tp(smoke_config(get_config(arch)), SMOKE_TP)
    attn = res["kernel_ops"].get("flash_attention")
    if attn:
        pairs = tally.attention_pairs(SMOKE_S, SMOKE_S, True, cfg.window
                                      if getattr(cfg, "window", 0) else 0)
        square = attn["flops"] / attn["calls"] * SMOKE_S ** 2 / pairs
        flops += attn["calls"] * square - attn["flops"]
        if kind == "train":          # forward + remat: two calls a layer
            flops -= attn["calls"] // 2 * square
    gmm = res["kernel_ops"].get("expert_matmul")
    if gmm and kind == "decode":
        local = SMOKE_TP / SMOKE_WORLD       # this rank's share of the batch
        flops -= gmm["flops"] * (1 - local)
        flops -= (SMOKE_B * (1 - local) * 2 * cfg.d_model * cfg.n_experts
                  * cfg.n_layers)
    return flops


def test_dot_flops_against_the_reference_lower_cell():
    """Peak and collective bytes are printed beside the JAX package's and
    not held: XLA's buffer assignment (donation, fusion, its own remat)
    is not the caching allocator's live set, and GSPMD chooses its own
    collectives, which the CPU compile ships in float32."""
    script = REF_RUN.format(world=SMOKE_WORLD, src=str(REPO / "src"),
                            tp=SMOKE_TP, s=SMOKE_S, b=SMOKE_B,
                            archs=REF_ARCHS)
    ref = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert ref.returncode == 0, ref.stderr[-3000:]
    line = [x for x in ref.stdout.splitlines() if x.startswith("RESULT ")]
    refs = json.loads(line[-1][len("RESULT "):])
    for arch in REF_ARCHS:
        model = build_model(resolve_for_tp(smoke_config(get_config(arch)),
                                           SMOKE_TP))
        for kind in ("train", "prefill", "decode"):
            with _world(SMOKE_WORLD, SMOKE_TP):
                res = D.trace_cell(model, ShapeConfig(kind, SMOKE_S,
                                                      SMOKE_B, kind))
            want = refs[f"{arch}/{kind}"]
            got = _explained(arch, kind, res)
            print(f"{arch} {kind}: dot FLOPs port {res['dot_flops']:.6e} "
                  f"({got:.6e} less the known terms), JAX "
                  f"{want['dot_flops']:.6e}; peak port {res['peak_bytes']}, "
                  f"JAX {want['peak']}; collective bytes port "
                  f"{res['total_collective_bytes']:.6e}, JAX "
                  f"{want['coll']:.6e}")
            assert got == pytest.approx(want["dot_flops"],
                                        rel=REF_FLOPS_RTOL), (arch, kind)


# ---------------------------------------------------------------------------
# (6) cells not ported yet, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,item", [
    ("minicpm3-4b", "prefill_32k", "12c"),
    ("minicpm3-4b", "train_4k", "12c"),
    ("h2o-danube-3-4b", "long_500k", "12d")])
def test_cells_not_ported_name_their_item(arch, shape, item):
    res = D.lower_cell(arch, shape, multi_pod=False)
    assert D.status(res) == "not_ported"
    assert res["item"] == item and res["reason"]


def test_cli_writes_one_cell(tmp_path, capsys):
    D.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
            "--mesh", "single", "--out", str(tmp_path)])
    res = json.loads((tmp_path / "single__phi4-mini-3.8b__decode_32k.json"
                      ).read_text())
    assert D.status(res) == "ok" and res["n_devices"] == 256
    assert res["batch_shardable"] and res["trace_s"] >= 0
    assert res["memory"]["peak_bytes_est"] >= res["memory"]["argument_bytes"]
    assert res["cost_analysis"]["flops"] == res["hlo"]["dot_flops"] > 0
    assert set(res["hlo"]["collective_counts"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert res["fsdp"] is False             # decode: the serving layout
    assert "all requested cells OK" in capsys.readouterr().out


def test_fake_world_refuses_a_group_already_initialised():
    with D.fake_world(8, 3):
        with pytest.raises(RuntimeError, match="initialised already"):
            with D.fake_world(4, 1):
                pass
        with pytest.raises(RuntimeError, match="initialised already"):
            D.lower_cell("phi4-mini-3.8b", "decode_32k", multi_pod=False)
        assert dist.get_world_size() == 8 and dist.get_rank() == 3
    assert not dist.is_initialized()


def test_train_specs_are_built_outside_the_count():
    """The step's parameter specs, built on ``meta`` on first use, are
    not the step's work: a count with them built anew equals one with
    them kept."""
    registry._train_specs.cache_clear()
    with _world(SMOKE_WORLD, SMOKE_TP):
        cold = _count("granite-moe-3b-a800m", "train", META, SMOKE_TP)
        warm = _count("granite-moe-3b-a800m", "train", META, SMOKE_TP)
    for key in ("dot_flops", "mem_bytes", "peak_bytes", "by_op"):
        assert cold[key] == warm[key], key
