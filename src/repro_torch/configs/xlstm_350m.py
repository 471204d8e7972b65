"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]).  24L
d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].

d_ff=0: xLSTM blocks carry their own up/down projections (proj_factor=2);
there is no separate FFN sublayer.  7 mLSTM : 1 sLSTM per 8-layer group.

Port of ``repro/configs/xlstm_350m.py`` (same values)."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMConfig(slstm_period=8, proj_factor=2.0, conv_kernel=4),
    rope_theta=0.0,          # recurrence provides position
    tie_embeddings=True,
    group_size=8,
    source="arXiv:2405.04517; unverified",
)
