"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual.  [hf:Snowflake/snowflake-arctic-base; hf]

Arctic's dense-MoE hybrid: every layer has a small dense FFN residual branch
in parallel with the 128-expert top-2 MoE (both width 4864).

A copy of `repro.configs.arctic_480b`.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    norm="rmsnorm", act="silu", mlp_gated=True,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864, n_shared=0,
                  capacity_factor=1.25, group_size=512, dense_ff=4864),
    source="hf:Snowflake/snowflake-arctic-base; hf",
)

REDUCED = dataclasses.replace(
    CONFIG, name="arctic-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
    head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=0,
                  capacity_factor=1.25, group_size=64, dense_ff=96),
)
