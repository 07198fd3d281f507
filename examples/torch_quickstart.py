"""Quickstart on the PyTorch port: the paper in a minute, on the card.

1. Builds a heterogeneous 50-worker cluster (rates ~ Uniform).
2. Compares scheduling schemes through the registry -- three lines per
   scheme:

       het = HetSpec.uniform_random(K, mu, sigma2, rng)
       report = get_scheme("work_exchange").mc(het, N, trials, rng)
       print(report.t_comp, report.iterations, report.n_comm)

3. Declares a (mu, sigma^2) scenario study as an ``ExperimentSpec``
   (``repro_torch.experiments``) and runs it through the single engine
   entry point: the sampler backend (``$REPRO_SAMPLER_BACKEND``, else
   ``cuda``: the ``we_rounds`` kernel; ``torch``: the fluid engine as
   torch ops; ``numpy``: the exact host engine) and the device count
   (``devices="auto"``: the rows split over every card) ride on the spec,
   results land in a content-addressed store, and re-running the
   unchanged spec is a cache hit.

4. Trains a small transformer for a few steps under the work-exchange
   scheduler (virtual clocks, real gradients).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import HetSpec, get_scheme, list_schemes, \
    resolve_backend
from repro_torch.data import UnitStore
from repro_torch.distributed import HetTrainer
from repro_torch.experiments import (ExperimentSpec, ResultsStore,
                                     ScenarioGrid, run_experiment,
                                     scheme_spec)
from repro_torch.models import build_model
from repro_torch.optim import AdamW


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--steps", type=int, default=8,
                    help="training steps in part 4")
    args = ap.parse_args(argv)
    dev = args.device

    # --- 1. the paper's setting, one registry call per scheme --------------
    N, K = 100_000, 50
    rng = np.random.default_rng(0)
    het = HetSpec.uniform_random(K, mu=50.0, sigma2=50.0 ** 2 / 6, rng=rng)
    oracle = N / het.lambda_sum
    print(f"cluster: K={K}, lambda_sum={het.lambda_sum:.1f}")
    print(f"registered schemes: {', '.join(list_schemes())}")
    print(f"oracle lower bound (Thm 1):       {oracle:.3f} s")

    panel = ("mds", "fixed", "work_exchange", "work_exchange_unknown",
             "het_mds", "hedged")
    for name in panel:
        rep = get_scheme(name).mc(het, N, trials=30, rng=rng, device=dev)
        extra = "".join(f" {k}={v:g}" for k, v in rep.extra.items()
                        if isinstance(v, (int, float)))
        print(f"{name:22s} {rep.t_comp:9.3f} s "
              f"(+{100 * (rep.t_comp / oracle - 1):5.1f}%)  "
              f"I={rep.iterations:5.1f}  N_comm/N={rep.n_comm / N:.4f}"
              f"{extra}")

    # --- 2. a declarative experiment through the store ----------------------
    backend = resolve_backend()      # REPRO_SAMPLER_BACKEND or "cuda"
    mus = (10.0, 50.0, 100.0)
    spec = ExperimentSpec(
        name="quickstart",
        grid=ScenarioGrid(K=K, points=[(mu, mu * mu / 6, int(mu))
                                       for mu in mus]),
        schemes=(scheme_spec("work_exchange"),),
        N=N, trials=30, seed=7, backend=backend,
        devices="auto")              # splits the rows over every card
    store = ResultsStore(tempfile.mkdtemp(prefix="repro-store-"))
    result = run_experiment(spec, store=store, device=dev)
    print(f"\nExperimentSpec {spec.name!r} through the '{backend}' backend "
          f"({result.spec.devices} device(s)) on {dev}; stored at "
          f"store/{result.spec_hash[:16]}....json:")
    for (mu, _, _), het_g, rep in zip(spec.grid.points, spec.grid.specs(),
                                      result.report("work_exchange")):
        print(f"  mu={mu:5.1f}  T_comp={rep.t_comp:8.3f} s "
              f"(oracle {N / het_g.lambda_sum:8.3f} s)  "
              f"I={rep.iterations:5.1f}")
    again = run_experiment(spec, store=store, device=dev)
    print(f"  re-run with the unchanged spec: "
          f"{'cache HIT, served from the store' if again.cache_hit else 'recomputed'}")

    # --- 3. real training under the work exchange scheduler ----------------
    print("\nwork exchange training (real gradients, virtual clocks):")
    cfg = dataclasses.replace(smoke_config(get_config("phi3-mini-3.8b")),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(0, dev)
    units = UnitStore(unit_batch=2, seq_len=32, vocab=cfg.vocab_size,
                      structured=True)
    trainer = HetTrainer(model, AdamW(lr=5e-3, weight_decay=0.0),
                         rates=[1.0, 4.0, 2.0, 8.0], store=units,
                         policy="work_exchange_online", units_per_step=8)
    _, _, hist = trainer.train(params, steps=args.steps)
    for h in hist:
        print(f"  step {h.step}: loss={h.loss:.3f} "
              f"T_virtual={h.t_virtual:.3f}s I={h.iterations} "
              f"moved_units={h.n_comm_units}")


if __name__ == "__main__":
    main()
