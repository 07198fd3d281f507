"""xlstm-350m [arXiv:2405.04517].

24L, d_model 1024, 4 heads, vocab 50304, d_ff 0 (the xLSTM blocks carry
their own up/down projections: mLSTM proj factor 2, sLSTM 4/3).
Every 8th layer is sLSTM (xLSTM[7:1] ratio); the rest are mLSTM.
Constant-size recurrent state -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=8,
    proj_factor_mlstm=2.0,
    proj_factor_slstm=4.0 / 3.0,
    conv_width=4,
)
