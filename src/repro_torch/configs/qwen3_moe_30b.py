"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B].

48L, d_model 2048, 32 Q heads (head_dim 128), GQA kv=4, MoE 128 experts
top-8 with per-expert d_ff 768, vocab 151936.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                    # per-expert intermediate size
    vocab_size=151_936,
    n_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
)
