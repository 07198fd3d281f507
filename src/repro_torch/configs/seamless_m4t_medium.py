"""seamless-m4t-medium [arXiv:2308.11596].

Encoder-decoder, 12L each side, d_model 1024, 16 heads (MHA), d_ff 4096,
vocab 256206.  The speech frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, frames, d).
Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4_096,
    vocab_size=256_206,
    frontend="audio",
    rope_theta=10_000.0,
)
