"""Training launcher: the port of ``repro.launch.train``.  Wires config
-> model -> a policy of the paper's heterogeneity-aware schedule
(``HetTrainer``) -> checkpointing.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --steps 20 --policy work_exchange_online --ckpt /tmp/run1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu

Without ``--full-config`` the architecture's reduced smoke config runs in
float32.  ``--device`` defaults to ``cuda`` and raises without a card.

With ``--ckpt`` a run resumes from the directory's latest checkpoint and
saves every ``--save-every`` steps and at its last.  Resuming restores
the params and the AdamW state and then replays the schedule of the
steps before the checkpoint (``HetTrainer.skip``: no gradients), so the
virtual clocks, the data units and the loader's ownership continue where
the uninterrupted run has them: a run stopped and resumed ends on the
uninterrupted run's parameters, bit for bit, and prints its ``[train]``
lines.  (The JAX package's launcher starts the schedule afresh on a
resume.)
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from ..checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from ..configs import get_config, list_configs, smoke_config
from ..data import UnitStore
from ..device import DEFAULT_DEVICE, resolve_device
from ..distributed.hetsched import POLICIES, HetTrainer
from ..models import build_model
from ..optim import AdamW, warmup_cosine
from ..optim.adamw import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(),
                    default="phi4-mini-3.8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--policy", choices=POLICIES, default="work_exchange")
    ap.add_argument("--units", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--unit-batch", type=int, default=2)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--het-sigma", type=float, default=0.5,
                    help="relative rate spread of the simulated fleet")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published architecture size; default "
                         "uses the reduced smoke config in float32")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = dataclasses.replace(smoke_config(cfg), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] arch={args.arch} params={n_params/1e6:.1f}M "
          f"policy={args.policy}")

    rng = np.random.default_rng(0)
    mu = 5.0
    spread = args.het_sigma * mu
    rates = np.clip(rng.normal(mu, spread, args.workers), 0.5, None)
    store = UnitStore(unit_batch=args.unit_batch, seq_len=args.seq,
                      vocab=cfg.vocab_size, structured=True)
    opt = AdamW(lr=warmup_cosine(args.lr, 10, args.steps))
    trainer = HetTrainer(model, opt, rates, store, policy=args.policy,
                         units_per_step=args.units)

    opt_state = opt.init(params)
    start = 0
    if args.ckpt:
        ck = latest_checkpoint(args.ckpt)
        if ck:
            (params, opt_state), extra = restore_checkpoint(
                ck, (params, opt_state))
            start = extra["step"] + 1
            for _ in range(start):
                trainer.skip()
            print(f"[train] resumed from {ck}")
    t0 = time.time()
    for s in range(start, args.steps):
        params, opt_state, rep = trainer.step(params, opt_state, s)
        print(f"[train] step {s}: loss={rep.loss:.4f} "
              f"T_virtual={rep.t_virtual:.3f}s I={rep.iterations} "
              f"moved={rep.n_comm_units}")
        if args.ckpt and (s % args.save_every == args.save_every - 1
                          or s == args.steps - 1):
            save_checkpoint(args.ckpt, s, (params, opt_state),
                            extra={"step": s})
    print(f"[train] done in {time.time()-t0:.1f}s wall")


if __name__ == "__main__":
    main()
