"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP (STUB) + gemma decoder.  [arXiv:2407.07726; hf]

Gemma-style decoder: head_dim 256, GeGLU (gated gelu), RMSNorm, RoPE, tied
embeddings.  Vision tower stubbed as in the reference: the batch carries
precomputed patch embeddings (B, 256, 2048); attention uses a prefix-LM
mask (bidirectional over patches, causal over text).

A copy of `repro.configs.paligemma_3b` (the port imports nothing of the
JAX package).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, head_dim=256,
    norm="rmsnorm", act="gelu_tanh", mlp_gated=True, tie_embeddings=True,
    vlm=VLMConfig(n_patches=256),
    source="arXiv:2407.07726; hf",
)

REDUCED = dataclasses.replace(
    CONFIG, name="paligemma-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=512,
    head_dim=16,
    vlm=VLMConfig(n_patches=16),
)
