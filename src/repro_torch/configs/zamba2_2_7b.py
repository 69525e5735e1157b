"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
ssm_state=64 — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

54 Mamba2 layers in 9 groups of 6; one *weight-shared* (attention + FFN)
block runs at the start of every group (gradient accumulates across its 9
invocations).  Mamba2: expand 2 (d_inner 5120), head_dim 64 (80 heads),
state 64, conv 4, chunked SSD.  Runs long_500k (O(1)/token state).

A copy of `repro.configs.zamba2_2_7b` (the port imports nothing of the
JAX package).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    norm="rmsnorm", act="silu", mlp_gated=True,
    ssm=SSMConfig(state=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    hybrid=HybridConfig(shared_attn_every=6, attn_heads=32, attn_kv_heads=32,
                        shared_ff=10240),
    source="arXiv:2411.15242; hf",
)

REDUCED = dataclasses.replace(
    CONFIG, name="zamba2-reduced",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    ssm=SSMConfig(state=8, head_dim=16, expand=2, conv_width=4, chunk=16),
    hybrid=HybridConfig(shared_attn_every=2, attn_heads=4, attn_kv_heads=4,
                        shared_ff=128),
)
