"""End-to-end training on the PyTorch port: a real model trained under
every scheduling policy, with per-policy virtual completion times.

Default is a small model; ``--scale 100m`` selects the ~100M-parameter
configuration (same code path).  Checkpoints and restart
are supported (kill and re-run with the same ``--ckpt``).

Run:  PYTHONPATH=src python examples/torch_train_het_sim.py --steps 60
      [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.checkpoint import (latest_checkpoint, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import UnitStore
from repro_torch.distributed.hetsched import POLICIES, HetTrainer
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves, tree_map

SCALES = {
    # the small default
    "15m": dict(n_layers=4, d_model=256, n_heads=8, head_dim=32,
                n_kv_heads=4, d_ff=1024, vocab_size=8192),
    # ~100M params
    "100m": dict(n_layers=12, d_model=768, n_heads=12, head_dim=64,
                 n_kv_heads=4, d_ff=3072, vocab_size=32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--scale", choices=SCALES, default="15m")
    ap.add_argument("--policy", choices=POLICIES, default=None,
                    help="default: compare all policies")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--units", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fail-worker", type=int, default=None,
                    help="kill this worker at step 5 (fault-tolerance demo)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    base = smoke_config(get_config("phi3-mini-3.8b"))
    cfg = dataclasses.replace(base, dtype="float32", **SCALES[args.scale])
    model = build_model(cfg)
    params0 = model.init(0, args.device)
    n_params = sum(x.numel() for x in tree_leaves(params0))
    print(f"model: {n_params / 1e6:.1f}M params | seq {args.seq} "
          f"| {args.units} units/step | {args.device}")

    rates = np.array([1.0, 3.0, 5.0, 9.0, 2.0, 6.0, 4.0, 8.0])
    store = UnitStore(unit_batch=2, seq_len=args.seq, vocab=cfg.vocab_size,
                      structured=True)
    policies = [args.policy] if args.policy else \
        ["equal_static", "het_static", "work_exchange",
         "work_exchange_online", "gradient_coded"]

    failures = {5: [args.fail_worker]} if args.fail_worker is not None else {}
    summary = []
    for policy in policies:
        trainer = HetTrainer(model, AdamW(lr=3e-3, weight_decay=0.0),
                             rates, store, policy=policy,
                             units_per_step=args.units, seed=11)
        # every policy starts from the same weights; the optimizer updates
        # them in place, so each trains its own copy
        params = tree_map(lambda x: x.clone(), params0)
        opt_state = trainer.opt.init(params)
        start = 0
        if args.ckpt:
            ck = latest_checkpoint(f"{args.ckpt}/{policy}")
            if ck:
                (params, opt_state), extra = restore_checkpoint(
                    ck, (params, opt_state))
                start = extra["step"] + 1
                for _ in range(start):
                    trainer.skip()
                print(f"[{policy}] resumed from step {start}")
        t0 = time.time()
        hist = []
        for s in range(start, args.steps):
            params, opt_state, rep = trainer.step(
                params, opt_state, s, failures.get(s, ()))
            hist.append(rep)
            if args.ckpt and s % 20 == 19:
                save_checkpoint(f"{args.ckpt}/{policy}", s,
                                (params, opt_state), extra={"step": s})
            if s % 10 == 0:
                print(f"[{policy}] step {s}: loss={rep.loss:.3f} "
                      f"T={rep.t_virtual:.3f}s I={rep.iterations}")
        t_virtual = sum(h.t_virtual for h in hist)
        summary.append((policy, hist[-1].loss if hist else float("nan"),
                        t_virtual, time.time() - t0))

    print("\npolicy                 final-loss  virtual-time   wall")
    for policy, loss, tv, wall in summary:
        print(f"{policy:22s} {loss:10.3f} {tv:12.2f}s {wall:7.1f}s")
    oracle = args.steps * args.units / rates.sum()
    print(f"{'(oracle bound)':22s} {'':10s} {oracle:12.2f}s")


if __name__ == "__main__":
    main()
