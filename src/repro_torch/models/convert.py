"""Carry the JAX package's weights onto the port's model.

``params_from_jax`` takes the JAX parameter pytree with its leaves as
numpy arrays (or anything ``np.asarray`` reads) and returns the port's
parameter dict on ``device``: the same leaves (``embed``, ``final_norm``,
``lm_head``, ``body.b<i>`` stacked over periods, ``tail.t<i>``), each
copied and cast to the port's dtype for it.  It raises on a missing or
extra leaf and on a shape mismatch.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .transformer import init_lm_params


def params_from_jax(tree: Any, cfg, device=DEFAULT_DEVICE) -> Any:
    dev = resolve_device(device)
    want = init_lm_params(cfg, None, torch.device("meta"))
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
