"""Model facade: uniform init / loss / prefill / decode across families,
the port of ``repro.models.registry``.

Every entry point takes ``device=`` and defaults to ``"cuda"``, which
raises without a card.  The encoder-decoder family dispatches to
``encdec``; every other family is a decoder stack (``transformer``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..device import DEFAULT_DEVICE, resolve_device
from . import encdec as encdec_mod
from . import transformer as tf_mod


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def is_encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def init(self, seed: int = 0, device=DEFAULT_DEVICE) -> Any:
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        if self.is_encdec:
            return encdec_mod.init_encdec_params(self.cfg, gen, dev)
        return tf_mod.init_lm_params(self.cfg, gen, dev)

    def loss(self, params, batch, mode: str = "scan", remat: bool = False):
        """(mean next-token cross entropy, plus the router aux term for
        an MoE config; metrics) of ``batch`` on the params' device: tokens
        and labels (B, S), and an enc-dec config's ``frame_embeds`` or a
        vision config's ``image_embeds``."""
        if self.is_encdec:
            return encdec_mod.encdec_loss(params, self.cfg, batch, mode,
                                          remat)
        return tf_mod.lm_loss(params, self.cfg, batch, mode, remat)

    def init_cache(self, batch: int, s_max: int, device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        if self.is_encdec:
            return encdec_mod.encdec_cache_init(self.cfg, batch, s_max, dev)
        return tf_mod.init_cache(self.cfg, batch, s_max, dev)

    def prefill(self, params, batch, cache, mode: str = "unroll"):
        if self.is_encdec:
            return encdec_mod.encdec_prefill(params, self.cfg, batch, cache,
                                             mode)
        return tf_mod.lm_prefill(params, self.cfg, batch, cache, mode)

    def decode_step(self, params, cache, tokens, mode: str = "unroll"):
        if self.is_encdec:
            return encdec_mod.encdec_decode_step(params, self.cfg, cache,
                                                 tokens, mode)
        return tf_mod.lm_decode_step(params, self.cfg, cache, tokens, mode)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
