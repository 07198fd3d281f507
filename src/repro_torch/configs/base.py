"""Config system: architecture + input-shape descriptions.

The port's own copy of ``repro.configs.base`` (pure data, same fields and
values).  Every architecture gets one ``ModelConfig`` (exact public
numbers) in its own ``configs/<id>.py``; the four input shapes live here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention flavour
    attn_kind: str = "full"      # full | swa | mla
    window: int = 0              # swa / local-attention window
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_router_dtype: str = "float32"
    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # hybrid (recurrentgemma): repeating block pattern, e.g. ("rec","rec","attn")
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    conv_width: int = 4
    # xlstm: layer i is sLSTM iff (i % slstm_every == slstm_every - 1)
    slstm_every: int = 0
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    # enc-dec (seamless)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # modality frontend stub
    frontend: str = "none"       # none | audio | vision
    n_frontend_tokens: int = 256  # patch/frame embeddings prepended (vlm/audio)
    # misc
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # --- derived / TP-resolution fields (filled by resolve_for_tp) ---
    n_heads_padded: int = 0
    n_kv_heads_eff: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding/logits tables padded for TP divisibility (Megatron
        convention); padded logit slots are masked to -inf in the loss."""
        return -(-self.vocab_size // 128) * 128

    @property
    def heads(self) -> int:
        return self.n_heads_padded or self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads_eff or self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack."""
        if self.block_pattern:
            reps = math.ceil(self.n_layers / len(self.block_pattern))
            return (self.block_pattern * reps)[: self.n_layers]
        if self.slstm_every:
            return tuple("slstm" if (i % self.slstm_every == self.slstm_every - 1)
                         else "mlstm" for i in range(self.n_layers))
        return ("attn",) * self.n_layers


def resolve_for_tp(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Pad Q heads to a multiple of tp; expand KV heads so the cache shards.

    The JAX package's rule (``repro.configs.base.resolve_for_tp``) field
    for field.  Its docstring says the numerics are unchanged, but its
    ``gqa_init`` draws random weights for every padded or expanded head,
    and so does the port's: a resolved config is a model of its own, and
    the two sides of a comparison take the same resolved config.
    """
    if tp <= 1:
        return dataclasses.replace(cfg, n_heads_padded=cfg.n_heads,
                                   n_kv_heads_eff=cfg.n_kv_heads)
    pad = math.ceil(cfg.n_heads / tp) * tp
    kv = cfg.n_kv_heads
    if kv % tp == 0:
        kv_eff = kv
    elif tp % kv == 0:
        kv_eff = tp
    else:                        # fall back to replication (no expansion)
        kv_eff = kv
    # GQA grouping must stay aligned: q-per-kv must divide evenly
    if kv_eff and pad % kv_eff:
        kv_eff = kv
    return dataclasses.replace(cfg, n_heads_padded=pad, n_kv_heads_eff=kv_eff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs able to run long_500k (sub-quadratic context handling); see DESIGN §7
SUBQUADRATIC = {"h2o-danube-3-4b", "recurrentgemma-2b", "xlstm-350m"}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.name in SUBQUADRATIC
    return True


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2 * max(1, len(cfg.block_pattern) or
                                           (cfg.slstm_every or 1))),
        d_model=64, n_heads=4, head_dim=16,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_frontend_tokens=8,
        n_heads_padded=0, n_kv_heads_eff=0,
    )
    if cfg.is_moe:
        # capacity_factor = n_experts makes the reduced config drop-free so
        # forward/prefill/decode agree exactly (full configs keep 1.25)
        kw.update(n_experts=4, experts_per_token=2, d_ff=64,
                  capacity_factor=4.0)
    if cfg.attn_kind == "mla":
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                  qk_rope_dim=8, v_head_dim=16)
    if cfg.lru_width:
        kw.update(lru_width=64)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, n_dec_layers=2, n_layers=2)
    if cfg.slstm_every:
        kw.update(n_layers=4, slstm_every=2)
    return dataclasses.replace(cfg, **kw)
