"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — GPT-BigCode-style code model.  [arXiv:2405.04324; hf]

GPT-BigCode lineage: LayerNorm, learned absolute positions, *non-gated*
GELU MLP, MQA, biases on attention and MLP.

A copy of `repro.configs.granite_34b`.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    norm="layernorm", act="gelu_tanh", mlp_gated=False,
    attn_bias=True, mlp_bias=True, pos="learned",
    source="arXiv:2405.04324; hf",
)

REDUCED = dataclasses.replace(
    CONFIG, name="granite-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=512,
    head_dim=16,
)
