"""Architecture configuration schema.

One `ArchConfig` instance fully determines a model.  The reference
drives every family from it (dense, MoE, MLA, Mamba2, xLSTM,
encoder-decoder, VLM prefix); the port builds the dense decoder and the
MoE family with or without MLA (`repro_torch.models.lm`) and reads the
other families' fields only in the codesign arithmetic
(`repro_torch.core.codesign.extract_gemms`).

A copy of `repro.configs.base` (the port imports nothing of the JAX
package).  `n_params` / `n_active_params` count from the shapes of the
port's modules (`repro_torch.models.registry.count_params`), so they
raise for the families the port does not build.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    group_size: int = 512        # tokens per dispatch group (GSPMD-friendly)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    dense_ff: int = 0            # parallel dense FFN width (Arctic residual)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512           # compressed KV latent dim
    rope_dim: int = 64           # decoupled rope head dim
    nope_dim: int = 128          # per-head non-rope q/k dim
    v_dim: int = 128             # per-head value dim


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 64              # Mamba2 SSM state per head
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256             # SSD chunk length
    n_groups: int = 1            # B/C groups


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0     # mLSTM up-projection factor
    conv_width: int = 4
    chunk: int = 64              # mLSTM chunkwise-parallel length
    slstm_every: int = 2         # every k-th block is sLSTM (1:1 -> 2)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    shared_attn_every: int = 6   # Zamba2: shared attn block period
    attn_heads: int = 32
    attn_kv_heads: int = 32
    shared_ff: int = 10240


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 32
    enc_frames: int = 1500       # whisper fixed encoder length (stub frontend)


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256         # SigLIP stub: precomputed patch embeddings


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"
    mlp_gated: bool = True
    attn_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    pos: str = "rope"            # rope | learned | sinusoidal (enc)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # source annotation from the assignment table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k decode is admissible (SSM/hybrid/linear-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only archs in this assignment

    def n_params(self) -> int:
        """Total parameter count (exact, from the modules' shapes)."""
        from repro_torch.models import registry  # local import to avoid cycle

        return registry.count_params(self)

    def n_active_params(self) -> int:
        from repro_torch.models import registry

        return registry.count_params(self, active_only=True)
