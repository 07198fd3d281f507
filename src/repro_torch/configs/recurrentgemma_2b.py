"""recurrentgemma-2b [arXiv:2402.19427, Griffin].

26L, d_model 2560, 10 Q heads (head_dim 256), MQA kv=1, d_ff 7680
(GeGLU), vocab 256000.  Block pattern (rec, rec, attn): RG-LRU temporal
mixing 2-of-3 layers, local (windowed, 2048) attention 1-of-3.
Sub-quadratic -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7_680,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "attn"),
    window=2_048,
    lru_width=2_560,
    conv_width=4,
    rope_theta=10_000.0,
)
