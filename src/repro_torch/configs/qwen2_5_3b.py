"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]

A copy of `repro.configs.qwen2_5_3b`.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, head_dim=128,
    norm="rmsnorm", act="silu", mlp_gated=True, attn_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2.5-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16,
)
