"""xlstm-1.3b [ssm] — arXiv:2405.04517.

48 blocks, d_model 2048, 4 heads, mLSTM:sLSTM 7:1 pattern, no separate FFN in
mLSTM blocks (proj_factor 2 up-projection built in; sLSTM blocks carry a 4/3
gated FFN), vocab 50304.
"""

from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attention="none",
    block_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm=XLSTMConfig(proj_factor_m=2.0, proj_factor_s=4 / 3, chunk=64),
)

SMOKE = CONFIG.with_overrides(
    num_layers=4,
    d_model=64, num_heads=4, num_kv_heads=4, vocab_size=256,
    block_pattern=("mlstm", "slstm"),
    xlstm=XLSTMConfig(chunk=8),
)
