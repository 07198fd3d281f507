"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 family].

32L, d_model 1536, 24 Q heads, GQA kv=8, MoE 40 experts top-8 with
per-expert d_ff 512, vocab 49155.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                    # per-expert intermediate size
    vocab_size=49_155,
    n_experts=40,
    experts_per_token=8,
    rope_theta=10_000.0,
)
