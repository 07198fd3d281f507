"""minicpm3-4b [hf:openbmb/MiniCPM3-4B].

62L, d_model 2560, 40 heads, Multi-head Latent Attention (MLA):
q_lora 768, kv_lora 256, qk_nope 64 + qk_rope 32, v_head 64.
d_ff 6400, vocab 73448.  Decode caches the shared latent (288/token).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,               # MLA: per-head K/V derived from shared latent
    head_dim=64,
    d_ff=6_400,
    vocab_size=73_448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    rope_theta=10_000.0,
)
