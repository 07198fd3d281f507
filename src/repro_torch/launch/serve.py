"""Serving launcher: batched greedy generation with a cache, the port of
``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --full-config --batch 4 --prompt-len 3000 \\
      --steps 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --device cpu       # smoke config, float32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-medium --device cpu     # frames + 4 tokens

Without ``--full-config`` the architecture's reduced smoke config runs in
float32.  ``--device`` defaults to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config, list_configs, smoke_config
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import build_model
from ..train.serve import greedy_generate


def prompt_batch(cfg, batch: int, prompt_len: int, device) -> dict:
    """The JAX launcher's requests, drawn from ``default_rng(0)`` in its
    order: an enc-dec config's ``frame_embeds`` (B, prompt_len, d) and 4
    decoder tokens; else ``prompt_len`` tokens, and a vision config's
    ``image_embeds`` (B, n_frontend_tokens, d) after them.  Embeddings in
    the config's dtype, tokens int64, on ``device``."""
    rng = np.random.default_rng(0)
    dt = getattr(torch, cfg.dtype)

    def embeds(n):
        return torch.from_numpy(rng.normal(size=(batch, n, cfg.d_model))
                                ).to(device=device, dtype=dt)

    def tokens(n):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (batch, n))).to(device)

    if cfg.family == "encdec":
        return {"frame_embeds": embeds(prompt_len), "tokens": tokens(4)}
    out = {"tokens": tokens(prompt_len)}
    if cfg.frontend == "vision":
        out["image_embeds"] = embeds(cfg.n_frontend_tokens)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(),
                    default="phi4-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = dataclasses.replace(smoke_config(cfg), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, dev)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, dev)
    B = args.batch
    cache = model.init_cache(B, args.prompt_len + args.steps
                             + cfg.n_frontend_tokens, dev)
    t0 = time.perf_counter()
    toks, _ = greedy_generate(model, params, batch, cache, args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.arch}: {B} x {args.steps} tokens "
          f"in {dt:.2f}s ({B * args.steps / dt:.1f} tok/s)")
    print(toks.cpu().numpy())


if __name__ == "__main__":
    main()
