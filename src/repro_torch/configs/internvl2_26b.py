"""internvl2-26b [arXiv:2404.16821].

InternViT-6B vision frontend (STUB: ``input_specs()`` provides precomputed
patch embeddings) + InternLM2-20B language backbone: 48L, d_model 6144,
48 Q heads (head_dim 128), GQA kv=8, d_ff 16384, vocab 92553.
Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6_144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=92_553,
    frontend="vision",
    n_frontend_tokens=256,
    rope_theta=1_000_000.0,
)
