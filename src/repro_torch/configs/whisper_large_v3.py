"""whisper-large-v3 [audio]: 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866 — enc-dec, conv frontend (STUB).  [arXiv:2212.04356; unverified]

32 encoder + 32 decoder layers; the conv frontend is stubbed as in the
reference: the batch carries precomputed frame embeddings (B, 1500,
1280).  LayerNorm, plain GELU, MHA, sinusoidal (enc) / learned (dec)
positions, output head tied to the token embedding.

A copy of `repro.configs.whisper_large_v3`.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    norm="layernorm", act="gelu", mlp_gated=False, attn_bias=True,
    pos="learned", tie_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=32, enc_frames=1500),
    source="arXiv:2212.04356; unverified",
)

REDUCED = dataclasses.replace(
    CONFIG, name="whisper-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    head_dim=16,
    encdec=EncDecConfig(n_enc_layers=2, enc_frames=32),
)
