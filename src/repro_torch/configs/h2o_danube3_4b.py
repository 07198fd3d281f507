"""h2o-danube-3-4b [arXiv:2401.16818].

24L, d_model 3840, 32 Q heads (head_dim 120), GQA kv=8, d_ff 10240,
vocab 32000.  Llama+Mistral mix with sliding-window attention (window 4096)
-> sub-quadratic context handling; runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10_240,
    vocab_size=32_000,
    attn_kind="swa",
    window=4_096,
    rope_theta=10_000.0,
)
