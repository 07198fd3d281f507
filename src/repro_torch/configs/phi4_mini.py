"""phi4-mini-3.8b [arXiv:2412.08905].

32L, d_model 3072, 24 Q heads (head_dim 128), GQA kv=8, d_ff 8192,
vocab 200064, RoPE + SwiGLU.  Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8_192,
    vocab_size=200_064,
    rope_theta=10_000.0,
)
