"""Fault-tolerant training loop of the LM substrate (every family).

Counterpart of `repro.train.trainer`: the train step
(`launch.steps.make_train_step`), the stateless data pipeline
(`data.synthetic.batch_for`), atomic checkpoints in the reference's
format (`checkpoint.ckpt`, through `convert.train_state_tree`) and the
preemption / failure / straggler runtime (`runtime.fault_tolerance`).

Restart-exactness: state lives entirely in (checkpoint, step index); the
data pipeline is a pure function of step, and a checkpoint holds the
float32 masters, moments and counts bit for bit, so an interrupted and
resumed run gives the losses of an uninterrupted one bit for bit.

With a mesh (`launch.mesh.Mesh`) the state is split over its positions
(`launch.steps.MeshState`) under `TrainerConfig.model_strategy` ("tp":
tensor parallelism over the "model" axis, the MoE family's experts
split over it; "fsdp": ZeRO-3);
checkpoints are written gathered, in the reference's layout, so
a checkpoint written on one mesh loads onto another (or onto one
device).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import batch_for
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import make_policy
from repro_torch.runtime.fault_tolerance import (RESTART_EXIT_CODE,
                                                 FailureInjector,
                                                 PreemptionGuard,
                                                 StragglerMonitor)


@dataclasses.dataclass
class TrainerConfig:
    seq: int = 256
    global_batch: int = 8
    total_steps: int = 50
    ckpt_every: int = 10
    ckpt_dir: str = "runs/ckpt"
    microbatches: int = 1
    remat: bool = False
    seed: int = 0
    log_every: int = 10
    opt: adamw.AdamWConfig | None = None
    # a mesh's sharding strategy (`parallel.sharding.make_policy`)
    model_strategy: str = "tp"
    # the loss on a bf16 cast of the masters (`make_train_step`'s)
    cast_bf16: bool = False


@dataclasses.dataclass
class TrainResult:
    exit_code: int
    losses: list
    steps_run: int
    straggler_events: list


def init_state(cfg: ArchConfig, tcfg: TrainerConfig, device=None,
               mesh=None):
    """A fresh train state on `device` (CUDA when None, raising without
    it): float32 parameters from the model's `init(seed=tcfg.seed)`
    (`registry.build_model`: the LM, or whisper's encoder-decoder), zero
    AdamW moments, step 0.  With `mesh`, the same parameters split over
    its positions, a `MeshState` (`steps.init_mesh_state`: each leaf is
    split as it is drawn on the CPU, so no device holds the whole
    model)."""
    opt_cfg = tcfg.opt or steps_mod.default_opt_cfg(cfg)
    if mesh is not None:
        policy = make_policy(mesh, cfg, model_strategy=tcfg.model_strategy)
        return steps_mod.init_mesh_state(cfg, policy, opt_cfg,
                                         seed=tcfg.seed)
    dev = resolve_device(device)
    params = registry.build_model(cfg).init(seed=tcfg.seed, device=dev)
    opt = adamw.init(dict(params.named_parameters()), opt_cfg)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _empty_state(cfg: ArchConfig, tcfg: TrainerConfig,
                 dev: torch.device) -> dict:
    """A train state of the right shapes and dtypes on `dev` with nothing
    drawn (a checkpoint is about to be loaded into it)."""
    params = registry.meta_model(cfg).to_empty(device=dev)
    opt_cfg = tcfg.opt or steps_mod.default_opt_cfg(cfg)
    opt = adamw.init(dict(params.named_parameters()), opt_cfg)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _tree(state) -> dict:
    """A checkpoint's tree (lazy leaves) of a one-device or mesh state."""
    if isinstance(state, steps_mod.MeshState):
        state = state.full()
    return convert.train_state_tree(state, lazy=True)


def train(cfg: ArchConfig, tcfg: TrainerConfig, *,
          guard: PreemptionGuard | None = None,
          injector: FailureInjector | None = None,
          on_step: Callable[[int, dict], None] | None = None,
          device=None, mesh=None) -> TrainResult:
    """Run (or resume) training on `device` (CUDA when None, raising
    without it), or over `mesh` (its positions' devices; `device` is
    then unused); returns exit code 0 (done) or RESTART_EXIT_CODE
    (preempted after checkpointing).  A mesh resumes from a checkpoint
    of any mesh: the tree is loaded whole on the CPU, then split."""
    dev = resolve_device(device) if mesh is None else mesh.device(0)
    opt_cfg = tcfg.opt or steps_mod.default_opt_cfg(cfg)
    ts = steps_mod.make_train_step(
        cfg, mesh, opt_cfg=opt_cfg, microbatches=tcfg.microbatches,
        remat=tcfg.remat, device=dev, model_strategy=tcfg.model_strategy,
        cast_bf16=tcfg.cast_bf16)
    monitor = StragglerMonitor()
    losses: list[float] = []

    start = ckpt.latest_step(tcfg.ckpt_dir)
    if start is not None:
        state = _empty_state(cfg, tcfg, dev if mesh is None
                             else torch.device("cpu"))
        if mesh is not None:
            state["params"] = steps_mod._master_named(
                cfg, dict(state["params"].named_parameters()))
            state["opt"] = adamw.init(state["params"], opt_cfg)
        target = convert.train_state_tree(state, spec=True)
        tree = ckpt.restore(tcfg.ckpt_dir, start, target)
        if mesh is None:
            convert.load_train_state(tree, state)
        else:
            state = steps_mod.shard_state(
                convert.load_train_state(tree, state), ts.policy)
    else:
        start = 0
        state = init_state(cfg, tcfg, dev, mesh=mesh)

    step = start
    while step < tcfg.total_steps:
        if injector is not None:
            injector.maybe_fail(step)
        batch = batch_for(cfg, tcfg.seq, tcfg.global_batch, step, tcfg.seed,
                          device=dev)
        t0 = time.time()
        state, metrics = ts.fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        monitor.observe(step, dt)
        losses.append(loss)
        if on_step is not None:
            on_step(step, metrics)
        if tcfg.log_every and step % tcfg.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
                  flush=True)
        step += 1
        stop_now = guard is not None and guard.preempted
        if step % tcfg.ckpt_every == 0 or step == tcfg.total_steps or stop_now:
            ckpt.save(tcfg.ckpt_dir, step, _tree(state),
                      extra={"arch": cfg.name, "loss": loss})
        if stop_now:
            return TrainResult(RESTART_EXIT_CODE, losses, step - start,
                               monitor.events)
    return TrainResult(0, losses, step - start, monitor.events)
