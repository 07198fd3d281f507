"""Greedy generation: prefill the prompt, then decode one token a step
with the cache.  The port of ``repro.train.serve``; PyTorch runs eagerly,
so there is no jit and no step factory."""
from __future__ import annotations

import torch


def greedy_generate(model, params, prompt_batch, cache, steps: int,
                    mode: str = "unroll"):
    """Returns ``(tokens (B, steps), cache)``."""
    logits, cache = model.prefill(params, prompt_batch, cache, mode=mode)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = model.decode_step(params, cache, tok, mode=mode)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, dim=1), cache
