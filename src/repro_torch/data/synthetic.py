"""Deterministic, stateless synthetic token batches.

Counterpart of `repro.data.synthetic` for every family (the VLM's
batches add stub patch embeddings, the audio family's stub frame
embeddings).  Batch t is
a pure function of (seed, step): each batch draws from its own CPU `torch.Generator`, seeded from (seed,
step), so there is no iterator state and every device gets the same
tokens.  Tokens follow a Zipfian marginal
with periodic copy structure, so the LM loss actually decreases.  The
distribution is the reference's; the bits are not (torch cannot reproduce
`jax.random`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    markov_period: int = 64     # learnable short-range structure


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_a)
    return (p / p.sum()).astype(np.float32)


def global_batch(cfg: DataConfig, step: int) -> dict:
    """Full logical batch for `step` (deterministic), int64 tokens on
    the CPU: {"inputs": (B, S), "targets": (B, S)}."""
    seed = int(np.random.SeedSequence([cfg.seed, step]).generate_state(1)[0])
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.global_batch, cfg.seq + 1)
    base = torch.multinomial(torch.from_numpy(_zipf_probs(cfg)),
                             shape[0] * shape[1], replacement=True,
                             generator=g).reshape(shape)
    # periodic copy structure: token[t] = token[t - period] with prob 1/2
    # -> the model can learn to halve its loss vs unigram
    copy = torch.rand(shape, generator=g) < 0.5
    shifted = torch.roll(base, cfg.markov_period, dims=1)
    toks = torch.where(copy, shifted, base)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class SyntheticStream:
    """The reference's stream object over `global_batch`: batch t of
    every process is a pure function of (seed, t)."""
    cfg: DataConfig

    def global_batch(self, step: int) -> dict:
        """Full logical batch for `step` (deterministic)."""
        return global_batch(self.cfg, step)

    def host_batch(self, step: int, *, process_index: int | None = None,
                   process_count: int | None = None) -> dict:
        """This process's rows of `global_batch(step)`: the
        `process_index`-th of `process_count` equal slices (default 0 of
        1, one process; the port runs on one device)."""
        pi = 0 if process_index is None else process_index
        pc = 1 if process_count is None else process_count
        per = self.cfg.global_batch // pc
        return {k: v[pi * per:(pi + 1) * per]
                for k, v in self.global_batch(step).items()}


def batch_for(cfg: ArchConfig, seq: int, global_batch_size: int, step: int,
              seed: int = 1234, device=None) -> dict:
    """The batch of `step` for a model of `cfg`'s family, on `device`.
    Tokens are `global_batch`'s (the dense, MoE, hybrid and SSM families'
    batches are tokens only, as the reference's).  The VLM's batch adds
    `patches` (B, n_patches, D) (the SigLIP stub), the audio family's
    `frames` (B, enc_frames, D) (the conv frontend's stub): float32 = 0.1
    x standard normal, drawn from a CPU `torch.Generator` seeded from
    (seed + 7, step), as the reference keys its draw from
    `fold_in(key(seed + 7), step)`; the values are not the reference's
    (torch cannot reproduce `jax.random`).  An unknown family raises
    `ValueError`."""
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "ssm", "audio"):
        raise ValueError(f"{cfg.name!r}: unknown family {cfg.family!r}")
    batch = global_batch(DataConfig(cfg.vocab, seq, global_batch_size, seed),
                         step)
    if cfg.family in ("vlm", "audio"):
        name, rows = (("patches", cfg.vlm.n_patches) if cfg.family == "vlm"
                      else ("frames", cfg.encdec.enc_frames))
        key = np.random.SeedSequence([seed + 7, step]).generate_state(1)[0]
        g = torch.Generator().manual_seed(int(key))
        batch[name] = 0.1 * torch.randn(
            (global_batch_size, rows, cfg.d_model), generator=g,
            dtype=torch.float32)
    return {k: v.to(device) for k, v in batch.items()}
