"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (1:1 alternation).  [arXiv:2405.04517; unverified]

d_ff = 0: xLSTM blocks carry their own up/down projections (proj_factor 2);
there is no separate FFN.  Runs long_500k (recurrent state, O(1)/token).

A copy of `repro.configs.xlstm_125m`.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    norm="layernorm", act="gelu", mlp_gated=False,
    pos="none",
    xlstm=XLSTMConfig(proj_factor=2.0, conv_width=4, chunk=64, slstm_every=2),
    source="arXiv:2405.04517; unverified",
)

REDUCED = dataclasses.replace(
    CONFIG, name="xlstm-reduced",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, vocab=512,
    xlstm=XLSTMConfig(proj_factor=2.0, conv_width=4, chunk=16, slstm_every=2),
)
