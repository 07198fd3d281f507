"""Carry the JAX package's weights onto the port's model.

``params_from_jax`` takes the JAX parameter pytree with its leaves as
numpy arrays (or anything ``np.asarray`` reads) and returns the port's
parameter dict on ``device``: the same leaves (for a decoder stack
``embed``, ``final_norm``, ``lm_head``, a vision config's ``vis_proj``,
``body.b<i>`` stacked over periods and ``tail.t<i>``; for the
encoder-decoder ``embed``, ``enc`` and ``dec`` stacked over layers,
``enc_norm``, ``final_norm`` and ``lm_head``), each copied and cast to
the port's dtype for it.  It raises on a missing or
extra leaf and on a shape mismatch.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .encdec import init_encdec_params
from .transformer import init_lm_params


def params_from_jax(tree: Any, cfg, device=DEFAULT_DEVICE) -> Any:
    dev = resolve_device(device)
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params
    want = init(cfg, None, torch.device("meta"))
    return _convert(tree, want, dev, "params")


def _convert(tree: Any, want: Any, dev: torch.device, path: str) -> Any:
    if isinstance(want, dict):
        if not isinstance(tree, Mapping):
            raise ValueError(f"{path}: expected a mapping of "
                             f"{sorted(want)}; got {type(tree).__name__}")
        missing = sorted(set(want) - set(tree))
        extra = sorted(set(tree) - set(want))
        if missing or extra:
            raise ValueError(f"{path}: missing leaves {missing}, extra "
                             f"leaves {extra}")
        return {k: _convert(tree[k], want[k], dev, f"{path}.{k}")
                for k in want}
    arr = np.array(tree, dtype=np.float32)      # a writable copy
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)} does not match "
                         f"the port's {tuple(want.shape)}")
    return torch.from_numpy(arr).to(device=dev, dtype=want.dtype)
