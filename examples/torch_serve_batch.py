"""Serving on the PyTorch port: batched greedy decoding, then streaming
prefill batches dispatched across heterogeneous replicas.

A real (small) model serves a batch of requests on the device; then
prefill batches *arrive continuously* and are queued and dispatched
across K heterogeneous serving replicas by the torch slot-step engine
(``repro_torch.serving``, on the same device) -- the paper's schemes
recast as dispatch policies, compared on tail latency and SLO misses at
a fixed offered load.

With ``--live`` the same batch also *executes* over the asyncio control
plane (``repro_torch.control``): real transport round-trips and matmul
shards on the device per replica, measured T_comp printed next to the
Monte-Carlo prediction per policy.

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--live]
      [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import HetSpec, get_scheme
from repro_torch.models import build_model
from repro_torch.serving import ServingConfig, run_serving_grid
from repro_torch.train.serve import greedy_generate

POLICIES = ("work_exchange", "work_exchange_unknown", "fixed", "uniform")


def run_live_batch(het, N, policies, device):
    """One arriving batch executed for real per policy: live episodes
    through the coordinator against the MC prediction at the same
    point."""
    from repro_torch.control import LiveConfig, run_live

    cfg = LiveConfig(target_wall_s=0.3)
    print(f"\nexecuting one {N}-request batch live "
          f"(inproc transport, matmul shards on {device}) per policy:")
    for policy in policies:
        rep = run_live(policy, {}, het, N, cfg, trials=2, seed=5,
                       device=device)
        mc = get_scheme(policy).mc(het, N, 400, np.random.default_rng(0),
                                   device=device)
        cp = rep.extra["control_plane"]
        print(f"  {policy:<21} measured {rep.t_comp:6.2f}s  "
              f"MC-predicted {mc.t_comp:6.2f}s  "
              f"coordination {cp['coordination_frac']:.1%} of wall")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--live", action="store_true",
                    help="also execute the batch over the async control "
                         "plane (repro_torch.control) and print measured "
                         "vs MC-predicted T_comp")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--slots", type=int, default=1500,
                    help="serving horizon in slots")
    args = ap.parse_args(argv)
    dev = args.device
    cfg = dataclasses.replace(smoke_config(get_config("phi4-mini-3.8b")),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(0, dev)

    # --- batched generation (real decode path with KV cache) --------------
    B, S_prompt, steps = 4, 16, 12
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S_prompt))).to(dev)
    cache = model.init_cache(B, S_prompt + steps, dev)
    with torch.inference_mode():
        toks, _ = greedy_generate(model, params, {"tokens": prompts}, cache,
                                  steps)
    print(f"generated {toks.shape[1]} tokens for {B} requests "
          f"(greedy, KV-cached) on {dev}:")
    print(toks.cpu().numpy()[:, :10])

    # --- streaming prefill batches through the serving engine -------------
    rates = np.array([2.0, 7.0, 3.0, 11.0])   # prefill throughput/replica
    het = HetSpec(rates)
    N = 40                       # prefill requests per arriving batch job
    load = 0.8                   # offered fraction of aggregate capacity
    scfg = ServingConfig(loads=(load,), slots=args.slots, deadline_slo=4.0,
                         backend="torch")
    print(f"\nstreaming prefill batches ({N} requests each) over "
          f"{len(rates)} heterogeneous replicas at {load:.0%} load:")
    for policy in POLICIES:
        [rep] = run_serving_grid(policy, {}, [het], scfg, N, 8, 3,
                                 device=dev)
        e = rep.extra
        print(f"  {policy:<21} sojourn {rep.t_comp:6.2f}s  "
              f"p99 {e['p99']:6.2f}s  "
              f"throughput {e['throughput_jobs']:.2f} jobs/s  "
              f"SLO-miss {e['slo_miss_rate']:.0%}")
    print("  (work_exchange_unknown learns replica rates online; uniform "
          "ignores heterogeneity)")

    if args.live:
        run_live_batch(het, N, POLICIES, dev)


if __name__ == "__main__":
    main()
