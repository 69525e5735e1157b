"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — MLA kv_lora=512, 2 shared + routed top-6.
[arXiv:2405.04434; hf]

Assignment note: the brief's annotation says "160 routed" but the config
column says "MoE 64e"; we follow the config column (64 routed experts,
matching the HF release) — recorded in DESIGN.md.  All layers are MoE with
2 shared experts (width 1408 each); MLA uses decoupled RoPE (rope_dim=64,
nope 128, v 128) with no q-compression (the Lite variant).

A copy of `repro.configs.deepseek_v2_lite_16b`.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=128,
    norm="rmsnorm", act="silu", mlp_gated=True,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  capacity_factor=1.3, group_size=256),
    mla=MLAConfig(kv_lora=512, rope_dim=64, nope_dim=128, v_dim=128),
    source="arXiv:2405.04434; hf",
)

REDUCED = dataclasses.replace(
    CONFIG, name="deepseek-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48, vocab=512,
    head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48, n_shared=1,
                  capacity_factor=1.3, group_size=64),
    mla=MLAConfig(kv_lora=32, rope_dim=8, nope_dim=16, v_dim=16),
)
