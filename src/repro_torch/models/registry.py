"""Model facade: uniform init / loss / prefill / decode across families,
the port of ``repro.models.registry``.

Every entry point takes ``device=`` and defaults to ``"cuda"``, which
raises without a card.  The encoder-decoder family dispatches to
``encdec``; every other family is a decoder stack (``transformer``).

``param_specs``, ``cache_specs`` and ``input_specs`` give the shapes and
dtypes of every parameter, cache and model input on the ``meta`` device
(the JAX package's ``eval_shape`` / ``ShapeDtypeStruct`` stand-ins).
Inside ``distributed.sharding.use_mesh`` ``init`` and ``init_cache``
return this rank's local tensors: ``init`` in the serving layout
(``param_specs(fsdp=False)``; the whole tree where ``model`` is 1) or,
with ``fsdp=True``, in the training layout (``param_specs(fsdp=True)``,
at any ``model``).  The sharded init draws every leaf in ``init``'s order
from the same seeded generator and keeps this rank's block of it, so the
weights are those the unsharded ``init(seed)`` draws and a rank's peak is
one whole layer.  ``loss`` takes and returns local tensors in the
training layout (``models.transformer.lm_loss``); serving takes the
serving layout.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..distributed import sharding as shd
from . import encdec as encdec_mod
from . import transformer as tf_mod

# decoder prefix length used when prefilling an encoder-decoder model
ENCDEC_PREFILL_TGT = 1024


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def is_encdec(self) -> bool:
        return self.cfg.family == "encdec"

    # -- parameters ---------------------------------------------------------

    def _init(self, gen, dev, keep=None) -> Any:
        if self.is_encdec:
            return encdec_mod.init_encdec_params(self.cfg, gen, dev)
        return tf_mod.init_lm_params(self.cfg, gen, dev, keep)

    def init(self, seed: int = 0, device=DEFAULT_DEVICE,
             fsdp: bool = False) -> Any:
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device``; on a mesh, this rank's blocks of them in the
        serving layout, or with ``fsdp`` in the training layout."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        mesh = shd.active_mesh()
        tp = shd.axis_size("model")
        if mesh is None or (tp == 1 and not fsdp):
            return self._init(gen, dev)
        tf_mod.check_mesh(self.cfg, train=fsdp)
        specs = shd.param_specs(self.cfg, self.param_specs(), tp, fsdp=fsdp)

        def keep(path, leaf):
            spec = shd.leaf_at(specs, path)
            if path[0] == "body":                 # a layer of the stack
                spec = spec[1:]
            return shd.local_block(leaf, spec, mesh).clone(
                memory_format=torch.contiguous_format)

        return self._init(gen, dev, keep)

    def param_specs(self) -> Any:
        """The parameter tree's shapes and dtypes on the ``meta`` device."""
        return self._init(None, torch.device("meta"))

    def train_specs(self, tp: int) -> Any:
        """The training layout (``param_specs(fsdp=True)``) at ``tp``,
        built once a (config, tp): what ``loss`` places its params by on a
        mesh."""
        return _train_specs(self, tp)

    # -- train --------------------------------------------------------------

    def loss(self, params, batch, mode: str = "scan", remat: bool = False):
        """(mean next-token cross entropy, plus the router aux term for
        an MoE config; metrics) of ``batch`` on the params' device: tokens
        and labels (B, S), and an enc-dec config's ``frame_embeds`` or a
        vision config's ``image_embeds``.  On a mesh: this rank's batch
        block and its training-layout params; the loss is the block's,
        the metrics the global batch's."""
        if self.is_encdec:
            if shd.active_mesh() is not None:
                raise NotImplementedError(
                    f"{self.cfg.name}: the encoder-decoder family does not "
                    f"train on a mesh")
            return encdec_mod.encdec_loss(params, self.cfg, batch, mode,
                                          remat)
        specs = None if shd.active_mesh() is None else \
            self.train_specs(shd.axis_size("model"))
        return tf_mod.lm_loss(params, self.cfg, batch, mode, remat,
                              specs=specs)

    # -- serve ---------------------------------------------------------------

    def _cache(self, batch: int, s_max: int, dev):
        if self.is_encdec:
            return encdec_mod.encdec_cache_init(self.cfg, batch, s_max, dev)
        return tf_mod.init_cache(self.cfg, batch, s_max, dev)

    def init_cache(self, batch: int, s_max: int, device=DEFAULT_DEVICE):
        """Zero caches for ``batch`` requests of up to ``s_max`` tokens;
        on a mesh, this rank's blocks of them (``local_cache_specs``)."""
        dev = resolve_device(device)
        if shd.active_mesh() is None:
            return self._cache(batch, s_max, dev)

        def zeros(path, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            return torch.zeros(leaf.shape, dtype=leaf.dtype, device=dev)

        return shd.tree_map_with_path(zeros,
                                      self.local_cache_specs(batch, s_max))

    def local_cache_specs(self, batch: int, s_max: int) -> Any:
        """This rank's blocks of the serving cache on the ``meta`` device
        (``cache_specs`` with the batch over the data axes; the whole
        cache outside a mesh)."""
        whole = self.cache_specs(batch, s_max)
        mesh = shd.active_mesh()
        if mesh is None:
            return whole
        tf_mod.check_mesh(self.cfg)
        specs = shd.cache_specs(self.cfg, whole, shd.BATCH_AXES,
                                shd.axis_size("model"))

        def local(path, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            shape = shd.local_shape(leaf.shape, shd.leaf_at(specs, path), mesh)
            return torch.empty(shape, dtype=leaf.dtype, device="meta")

        return shd.tree_map_with_path(local, whole)

    def cache_specs(self, batch: int, s_max: int) -> Any:
        """The serving cache's shapes and dtypes on the ``meta`` device."""
        return self._cache(batch, s_max, torch.device("meta"))

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

    # -- dry-run input specs --------------------------------------------------

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Every model input of an (arch x shape) cell as a ``meta``
        tensor of its shape and dtype (tokens int32, embeddings in the
        config's dtype), as the JAX package's ``input_specs`` gives them."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def i32(s):
            return torch.empty(s, dtype=torch.int32, device="meta")

        def emb(s):
            return torch.empty(s, dtype=getattr(torch, cfg.dtype),
                               device="meta")

        if cfg.family == "encdec":
            if shape.kind == "train":
                s = S // 2
                return {"frame_embeds": emb((B, s, cfg.d_model)),
                        "tokens": i32((B, s)), "labels": i32((B, s))}
            if shape.kind == "prefill":
                return {"frame_embeds": emb((B, S, cfg.d_model)),
                        "tokens": i32((B, ENCDEC_PREFILL_TGT))}
            return {"tokens": i32((B, 1))}
        if cfg.frontend == "vision":
            F = cfg.n_frontend_tokens
            if shape.kind == "train":
                return {"tokens": i32((B, S - F)), "labels": i32((B, S - F)),
                        "image_embeds": emb((B, F, cfg.d_model))}
            if shape.kind == "prefill":
                return {"tokens": i32((B, S - F)),
                        "image_embeds": emb((B, F, cfg.d_model))}
            return {"tokens": i32((B, 1))}
        if shape.kind == "train":
            return {"tokens": i32((B, S)), "labels": i32((B, S))}
        if shape.kind == "prefill":
            return {"tokens": i32((B, S))}
        return {"tokens": i32((B, 1))}


@functools.cache
def _train_specs(model: Model, tp: int) -> Any:
    return shd.param_specs(model.cfg, model.param_specs(), tp, fsdp=True)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
