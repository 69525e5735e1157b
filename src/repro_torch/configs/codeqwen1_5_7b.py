"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32, MHA) d_ff=13440
vocab=92416 — qwen1.5 arch (QKV bias).  [hf:Qwen/CodeQwen1.5-7B; hf]

A copy of `repro.configs.codeqwen1_5_7b`.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, head_dim=128,
    norm="rmsnorm", act="silu", mlp_gated=True, attn_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
)

REDUCED = dataclasses.replace(
    CONFIG, name="codeqwen-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    head_dim=16,
)
