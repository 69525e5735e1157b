"""Batched serving engine: slot-based continuous batching over the
single-token `decode_step`.

Counterpart of `repro.serve.engine`.  A fixed pool of B slots holds
independent sequences; finished slots are refilled from the request
queue without stopping the decode loop (lightweight continuous
batching).  Per-slot position/active bookkeeping lives on the host; the
cache is the decode state's stacked tensors (the hybrid family's also
its Mamba2 states and its shared block's caches, the SSM family's its
mLSTM and sLSTM states, the audio family's its self-attention caches
beside cross K / V that stay zero, as in the reference's engine),
written in place each step.
Sampling: greedy, or at temperature T > 0 `argmax(logits / T + g)` with
g standard Gumbel noise (the Gumbel-max form of `jax.random.categorical`,
which the reference calls).  The noise is an explicit tensor from
`noise(n)`: by default the engine's CPU `torch.Generator` seeded with
`seed`; tests pass the reference's `jax.random.gumbel` draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new: int = 16
    temperature: float = 0.0


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: list[int]


def sample(logits: torch.Tensor, temperature: float,
           gumbel: torch.Tensor | None = None) -> int:
    """The next token of one slot from its float32 (V,) logits: argmax at
    temperature <= 0, else `argmax(logits / temperature + gumbel)`."""
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    return int(torch.argmax(logits / temperature + gumbel))


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: Any, *, slots: int = 4,
                 max_seq: int = 256, seed: int = 0, device=None,
                 noise: Callable[[int], torch.Tensor] | None = None):
        """`params` is the model (`build_model(cfg).init`) on `device`
        (CUDA when None, raising without it).  `noise(n)` returns n float32 standard Gumbel draws
        on the CPU, one call per sampled token."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = build_model(cfg)
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.state = self.api.init_decode_state(slots, max_seq,
                                                device=self.device)
        self.generator = torch.Generator().manual_seed(seed)
        self.noise = noise or self._gumbel
        # host-side slot bookkeeping
        self.slot_req: list[Request | None] = [None] * slots
        self.slot_out: list[list[int]] = [[] for _ in range(slots)]
        self.slot_remaining_prompt: list[list[int]] = [[] for _ in range(slots)]
        self.queue: list[Request] = []
        self.done: list[Completion] = []

    # NOTE: positions are global (shared `pos` counter), so slots admitted
    # later simply start deeper in the cache — correct for causal decode
    # since their earlier cache rows are zero-masked by position validity.
    # For strict per-slot positions a per-slot pos vector would be threaded
    # through decode_step; kept scalar as the reference keeps it.

    def _gumbel(self, n: int) -> torch.Tensor:
        """n standard Gumbel draws, -log(E) with E ~ Exponential(1)."""
        e = torch.empty(n, dtype=torch.float32).exponential_(
            generator=self.generator)
        return -torch.log(e)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[s] = req
                self.slot_out[s] = []
                self.slot_remaining_prompt[s] = list(req.prompt)

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        gumbel = None if req.temperature <= 0.0 else self.noise(
            logits.shape[-1])
        return sample(logits, req.temperature, gumbel)

    def run(self, max_steps: int = 512) -> list[Completion]:
        """Drive the loop until queue + slots drain (or step budget)."""
        self._admit()
        feed = [0] * self.slots
        for s in range(self.slots):
            if self.slot_req[s] and self.slot_remaining_prompt[s]:
                feed[s] = self.slot_remaining_prompt[s].pop(0)
        for _ in range(max_steps):
            if all(r is None for r in self.slot_req) and not self.queue:
                break
            logits, self.state = self.api.decode_step(
                self.params, self.state,
                torch.tensor(feed, dtype=torch.int64, device=self.device))
            logits = logits.cpu()
            nxt = [0] * self.slots
            for s in range(self.slots):
                req = self.slot_req[s]
                if req is None:
                    continue
                if self.slot_remaining_prompt[s]:
                    nxt[s] = self.slot_remaining_prompt[s].pop(0)
                else:
                    tok = self._sample(logits[s], req)
                    self.slot_out[s].append(tok)
                    nxt[s] = tok
                    if len(self.slot_out[s]) >= req.max_new:
                        self.done.append(Completion(req.uid, self.slot_out[s]))
                        self.slot_req[s] = None
            self._admit()
            for s in range(self.slots):
                if self.slot_req[s] and self.slot_out[s] == [] \
                        and self.slot_remaining_prompt[s] and nxt[s] == 0:
                    nxt[s] = self.slot_remaining_prompt[s].pop(0)
            feed = nxt
        return self.done
