"""Model facade: uniform init / loss / prefill / decode across families,
the port of ``repro.models.registry``.

Every entry point takes ``device=`` and defaults to ``"cuda"``, which
raises without a card.  The encoder-decoder family comes with a later
slice of the port; ``loss`` trains every decoder stack the port serves,
the MoE family included (its loss adds the router's aux term).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..device import DEFAULT_DEVICE, resolve_device
from . import transformer as tf_mod


def _lm_only(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family comes with a later "
            "slice of the port (seamless-m4t serving)")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device=DEFAULT_DEVICE) -> Any:
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device``."""
        _lm_only(self.cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return tf_mod.init_lm_params(self.cfg, gen, dev)

    def loss(self, params, batch, mode: str = "scan", remat: bool = False):
        """(mean next-token cross entropy, plus the router aux term for
        an MoE config; metrics) of ``batch`` (tokens and labels (B, S) on
        the params' device)."""
        _lm_only(self.cfg)
        return tf_mod.lm_loss(params, self.cfg, batch, mode, remat)

    def init_cache(self, batch: int, s_max: int, device=DEFAULT_DEVICE):
        _lm_only(self.cfg)
        return tf_mod.init_cache(self.cfg, batch, s_max,
                                 resolve_device(device))

    def prefill(self, params, batch, cache, mode: str = "unroll"):
        _lm_only(self.cfg)
        return tf_mod.lm_prefill(params, self.cfg, batch, cache, mode)

    def decode_step(self, params, cache, tokens, mode: str = "unroll"):
        _lm_only(self.cfg)
        return tf_mod.lm_decode_step(params, self.cfg, cache, tokens, mode)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
