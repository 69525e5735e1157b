"""Deterministic, stateless synthetic token batches.

Counterpart of `repro.data.synthetic` for the dense and MoE families
(token batches only).  Batch t is a pure function of (seed, step): each
batch draws from its own CPU `torch.Generator`, seeded from (seed,
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
    """The batch of `step` for a dense- or MoE-family model, on `device`
    (the families whose batches are tokens alone)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"synthetic batches of the {cfg.family!r} family are not ported")
    batch = global_batch(DataConfig(cfg.vocab, seq, global_batch_size, seed),
                         step)
    return {k: v.to(device) for k, v in batch.items()}
