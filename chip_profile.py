#!/usr/bin/env python3
"""Where the time of the port's paths goes, on one GPU.

    python3 chip_profile.py

Run from the root of a checkout on a machine with a CUDA device (it
builds the kernels on first use, like `chip_smoke.py`).  After one
warm-up request it runs `DesignSession().run(DesignRequest(16384))` at
the default budget once under `torch.profiler` (CPU + CUDA activity)
and prints:

1. the request's explore and layout seconds, as its provenance reports
   them, and the device time of the `nsga2_evolve` kernel (one launch
   per explore dispatch runs every generation) that explore runs;
2. the layout flow's stages (`layout.place`, `layout.drc`,
   `layout.nets`, `layout.route`: the profiler ranges of
   `repro_torch.eda.batched_flow.generate_layouts`), each with its host
   time and the device time of its annotation where the profiler
   records one; `layout.route` also with the device time of the
   `route_slots` kernel (one launch per layout bucket) that it runs;
3. the device kernels and copies with the most time, their counts, and
   their summed time against the wall time (the device's busy share;
   the rest is host time the device idles through);
4. for the CIM-in-the-loop trainer at full width (d 768, 12 layers,
   seq 128, batch 8, the codesign pick's macro), after 2 warm-up steps:
   the mean step time of 5 steps, then 3 steps under the profiler with
   the device kernels with the most time, the `acim_matmul` kernels'
   device time per step by route (wgmma, cuda_core; split-K's zeroing
   memsets beside), and the busy share;
5. for the long-context prefill of qwen2.5-3b at full width (36 layers,
   bf16 serving weights drawn from seed 0, batch 1 x 32768,
   `make_prefill_step`), after one warm-up prefill: one prefill under the
   profiler, its device time split into the flash attention kernel, the
   GEMMs (cuBLAS / CUTLASS kernels) and the rest, with the kernels with
   the most time and the busy share;
6. for the single-token decode of the same model and weights
   (`decode_step` at batch 4, the serving engine's slots, cache of 256
   positions), after 4 warm-up steps: the mean step time of 8 steps,
   then 8 steps under the profiler with the device time per step (GEMMs
   and the rest), the device events and the host's aten operators per
   step, and the busy share;
7. the full-width qwen2.5-3b train step (float32 masters from seed 0,
   `make_train_step(remat=True)`, default AdamW, 8 x 256 tokens), after
   2 warm-up steps: the mean step time of 3 steps, then 3 steps under the
   profiler with the device time per step (GEMMs and the rest), the
   device kernels with the most time, the device events and the host's
   aten operators per step (the most called beside), and the busy share;
8. the full-width deepseek-v2-lite-16b prefill (27 layers, bf16 weights
   drawn on the card from seed 0, 1 x 32768), after one warm-up: one
   prefill under the profiler, its device time split into the (192, 128)
   flash attention instantiation, the GEMMs and the rest; then by stage
   (MLA with its attention kernel, the MoE's route, dispatch, experts,
   combine and always-on FFNs: CUDA events around those model
   functions);
9. the island explore of `DesignRequest(16384, islands=4)` (4 islands,
   pop 256, 80 generations, 20-generation rounds, on every local card)
   beside the single-island explore of the same cell, each once under
   the profiler after a warm-up: wall, device time of `nsga2_evolve` and
   `nds_rank`, device events and the busy share.

It checks nothing: `chip_smoke.py` holds the results against the
golden rows and the trainer's losses.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARRAY_SIZE = 16384
STAGE_PREFIX = "layout."


def _device_kernels(prof) -> list[tuple[str, int, float]]:
    """(name, calls, device us) of the device events, most time first.
    Only device events are summed (a CPU operator's row repeats the
    time of the kernels it launched), and the layout stage ranges are
    left out (they span kernels listed on their own)."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith(STAGE_PREFIX)]
    return sorted(rows, key=lambda r: -r[2])


def profile_request(request) -> dict:
    """One request under the profiler: provenance times, the layout
    stages' ranges, the top device entries and the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import DesignSession

    session = DesignSession()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        art = session.run(request)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages: dict[str, dict] = {}
    for e in prof.key_averages():
        if e.key.startswith(STAGE_PREFIX):
            # A range appears once on the host and, where the profiler
            # annotates the device too, once more as a device row.
            st = stages.setdefault(e.key[len(STAGE_PREFIX):],
                                   {"host_ms": 0.0, "device_ms": None})
            if e.device_type == DeviceType.CUDA:
                st["device_ms"] = e.device_time_total / 1e3
            else:
                st["host_ms"] = e.cpu_time_total / 1e3
    kernels = _device_kernels(prof)
    device_s = sum(r[2] for r in kernels) / 1e6
    route = [r for r in kernels if "route_slots" in r[0]]
    evolve = [r for r in kernels if "nsga2_evolve" in r[0]]
    prov = art.provenance
    return {"wall_s": wall, "explore_s": prov.explore_s,
            "layout_s": prov.layout_s, "net_slots": prov.route_rounds,
            "stages": stages, "route_slots_calls": sum(r[1] for r in route),
            "route_slots_ms": sum(r[2] for r in route) / 1e3,
            "nsga2_evolve_calls": sum(r[1] for r in evolve),
            "nsga2_evolve_ms": sum(r[2] for r in evolve) / 1e3,
            "device_s": device_s,
            "busy_share": device_s / wall,
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:15]]}


def profile_train(steps: int = 3) -> dict:
    """Full-width trainer steps under the profiler (after warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import batch_for
    from repro_torch.models.lm import init_lm
    from repro_torch.quant.cim_linear import CIMConfig
    from repro_torch.train import acim_lm

    cfg = acim_lm.build_cfg(768, 12)
    cim = CIMConfig(acim_lm.pick_macro(cfg).spec)
    model = init_lm(cfg, seed=0)
    batches = [batch_for(cfg, 128, 8, i, device="cuda") for i in range(10)]
    for i in range(2):
        acim_lm.sgd_step(model, batches[i], cfg, cim, 3e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, 7):
        acim_lm.sgd_step(model, batches[i], cfg, cim, 3e-3)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(7, 7 + steps):
            acim_lm.sgd_step(model, batches[i], cfg, cim, 3e-3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    device_s = sum(r[2] for r in kernels) / 1e6
    acim_s = sum(r[2] for r in kernels if "acim_matmul" in r[0]) / 1e6
    # per route: the tensor-core kernel and the CUDA-core one
    wgmma_s = sum(r[2] for r in kernels
                  if "acim_matmul_wgmma_kernel" in r[0]) / 1e6
    memset_s = sum(r[2] for r in kernels if "Memset" in r[0]) / 1e6
    return {"spec": str(cim.spec), "step_ms": step_ms,
            "profiled_step_ms": 1e3 * wall / steps,
            "device_ms_per_step": 1e3 * device_s / steps,
            "acim_matmul_ms_per_step": 1e3 * acim_s / steps,
            "acim_matmul_ms_per_step_by_route": {
                "wgmma": 1e3 * wgmma_s / steps,
                "cuda_core": 1e3 * (acim_s - wgmma_s) / steps},
            "memset_ms_per_step": 1e3 * memset_s / steps,
            "busy_share": device_s / wall,
            "launches_per_step": sum(r[1] for r in kernels) / steps,
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:12]]}


GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def profile_prefill(params, seq: int = 32768, batch: int = 1) -> dict:
    """One full-width qwen2.5-3b prefill under the profiler (after a
    warm-up), its device time by kernel class."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step

    cfg = registry.get("qwen2.5-3b")
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=batch, seq=seq)
    step = make_prefill_step(cfg, shape)
    tokens = batch_for(cfg, *step.batch_shapes["inputs"][::-1], 0)
    step.fn(params, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.fn(params, tokens)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.fn(params, tokens)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    flash = sum(r[2] for r in kernels if "flash_attention" in r[0]) / 1e6
    gemm = sum(r[2] for r in kernels if any(
        m in r[0].lower() for m in GEMM_MARKS)) / 1e6
    device_s = sum(r[2] for r in kernels) / 1e6
    return {"tokens": batch * seq, "wall_s": wall_s,
            "profiled_s": prof_s, "device_s": device_s,
            "flash_attention_s": flash, "gemm_s": gemm,
            "rest_s": device_s - flash - gemm,
            "busy_share": device_s / prof_s,
            "device_events": sum(r[1] for r in kernels),
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:12]]}


MOE_RANGES = {"mla": ("attention", "mla_fwd_blockwise"),
              "moe.route": ("mlp", "moe_route"),
              "moe.dispatch": ("mlp", "moe_dispatch"),
              "moe.experts": ("mlp", "moe_experts"),
              "moe.combine": ("mlp", "moe_combine"),
              "moe.always_on": ("mlp", "add_always_on")}


def profile_moe_prefill(seq: int = 32768, batch: int = 1) -> dict:
    """One full-width deepseek-v2-lite-16b prefill (27 layers, bf16
    weights drawn on the card from seed 0) under the profiler, after a
    warm-up: its device time by kernel class (the (192, 128) flash
    attention instantiation, the GEMMs, the rest); then one more prefill
    with each model function of `MOE_RANGES` bracketed by CUDA events on
    the stream (the device time from its first kernel's start to its
    last's end, summed over the layers; `mla` includes the flash
    kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, mlp
    from repro_torch.models.lm import init_lm

    cfg = registry.get("deepseek-v2-lite-16b")
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=batch, seq=seq)
    step = make_prefill_step(cfg, shape)
    tokens = batch_for(cfg, seq, batch, 0)
    step.fn(params, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.fn(params, tokens)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.fn(params, tokens)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    modules = {"attention": attention, "mlp": mlp}
    saved, marks = {}, {name: [] for name in MOE_RANGES}

    def bracketed(name, fn):
        def wrapped(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            marks[name].append((start, end))
            return out
        return wrapped

    for name, (m, fn) in MOE_RANGES.items():
        saved[name] = getattr(modules[m], fn)
        setattr(modules[m], fn, bracketed(name, saved[name]))
    try:
        step.fn(params, tokens)
        torch.cuda.synchronize()
    finally:
        for name, (m, fn) in MOE_RANGES.items():
            setattr(modules[m], fn, saved[name])
    stages = {name: sum(a.elapsed_time(b) for a, b in pairs) / 1e3
              for name, pairs in marks.items()}
    kernels = _device_kernels(prof)
    flash = sum(r[2] for r in kernels if "flash_attention" in r[0]) / 1e6
    gemm = sum(r[2] for r in kernels if any(
        m in r[0].lower() for m in GEMM_MARKS)) / 1e6
    device_s = sum(r[2] for r in kernels) / 1e6
    del params
    torch.cuda.empty_cache()
    return {"tokens": batch * seq, "wall_s": wall_s, "profiled_s": prof_s,
            "device_s": device_s, "flash_attention_s": flash,
            "gemm_s": gemm, "rest_s": device_s - flash - gemm,
            "stages_device_s": stages, "busy_share": device_s / prof_s,
            "device_events": sum(r[1] for r in kernels),
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:15]]}


def profile_decode(params, batch: int = 4, steps: int = 8,
                   max_seq: int = 256) -> dict:
    """`decode_step` of the full-width qwen2.5-3b at `batch`: step time
    unprofiled, then `steps` steps under the profiler by kernel class,
    with the host's aten operators per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.models.lm import decode_step, init_decode_state

    cfg = registry.get("qwen2.5-3b")
    state = init_decode_state(cfg, batch, max_seq)
    toks = torch.arange(batch, device="cuda")

    def run(n):
        nonlocal state
        for _ in range(n):
            _, state = decode_step(params, state, toks, cfg)
        torch.cuda.synchronize()

    run(4)
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        prof_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = _device_kernels(prof)
    device_ms = sum(r[2] for r in kernels) / 1e3 / steps
    gemm_ms = sum(r[2] for r in kernels if any(
        m in r[0].lower() for m in GEMM_MARKS)) / 1e3 / steps
    aten = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU
               and e.key.startswith("aten::"))
    return {"batch": batch, "step_ms": step_ms, "profiled_step_ms": prof_ms,
            "device_ms_per_step": device_ms, "gemm_ms_per_step": gemm_ms,
            "busy_share": device_ms / prof_ms,
            "device_events_per_step": sum(r[1] for r in kernels) / steps,
            "aten_ops_per_step": aten / steps,
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:8]]}


def profile_lm_train(steps: int = 3, batch: int = 8, seq: int = 256) -> dict:
    """The full-width qwen2.5-3b train step (float32 masters from seed 0,
    `make_train_step(remat=True)`, default AdamW) at `batch` x `seq`:
    after 2 warm-up steps, the mean of `steps` steps unprofiled, then
    `steps` under the profiler by kernel class, with the device events
    and the host's aten operators a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.trainer import TrainerConfig, init_state

    cfg = registry.get("qwen2.5-3b")
    state = init_state(cfg, TrainerConfig(seed=0))
    step = make_train_step(cfg, remat=True)
    tokens = batch_for(cfg, seq, batch, 0, seed=0, device="cuda")

    def run(n):
        nonlocal state
        for _ in range(n):
            state, _ = step.fn(state, tokens)
        torch.cuda.synchronize()

    run(2)
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        prof_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = _device_kernels(prof)
    device_ms = sum(r[2] for r in kernels) / 1e3 / steps
    gemm_ms = sum(r[2] for r in kernels if any(
        m in r[0].lower() for m in GEMM_MARKS)) / 1e3 / steps
    ops = sorted(((e.key, e.count, e.self_cpu_time_total)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")), key=lambda r: -r[1])
    del state
    torch.cuda.empty_cache()
    return {"tokens": batch * seq, "step_ms": step_ms,
            "profiled_step_ms": prof_ms, "device_ms_per_step": device_ms,
            "gemm_ms_per_step": gemm_ms, "busy_share": device_ms / prof_ms,
            "device_events_per_step": sum(r[1] for r in kernels) / steps,
            "aten_ops_per_step": sum(r[1] for r in ops) / steps,
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:12]],
            "top_aten": [{"name": k, "calls_per_step": c / steps,
                          "self_cpu_ms_per_step": us / 1e3 / steps}
                         for k, c, us in ops[:8]]}


def profile_islands() -> dict:
    """The 4-island explore of the 16 kb cell against the single-island
    explore, each once under the profiler after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.batched_explorer import explore_cells
    from repro_torch.parallel import distributed_explorer as dx

    cell = (ARRAY_SIZE, 0)
    runs = {"islands": lambda: dx.explore_cells_mesh([cell], islands=4),
            "single": lambda: explore_cells([cell])}
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = _device_kernels(prof)
        device_ms = sum(r[2] for r in kernels) / 1e3
        out[name] = {
            "wall_ms": wall_ms, "device_ms": device_ms,
            "nsga2_evolve_ms": sum(r[2] for r in kernels
                                   if "nsga2_evolve" in r[0]) / 1e3,
            "nds_rank_ms": sum(r[2] for r in kernels
                               if "nds_rank" in r[0]) / 1e3,
            "device_events": sum(r[1] for r in kernels),
            "busy_share": device_ms / wall_ms}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this profile runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import DesignRequest, DesignSession

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"gpu: {card}", flush=True)
    request = DesignRequest(array_size=ARRAY_SIZE)
    t0 = time.perf_counter()
    DesignSession().run(request)
    torch.cuda.synchronize()
    print(f"warm-up request (kernel build included): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prof = profile_request(request)
    print(f"request (profiler on): wall {prof['wall_s']:.3f} s, explore "
          f"{prof['explore_s']:.3f} s, layout {prof['layout_s']:.3f} s, "
          f"{prof['net_slots']} net slots", flush=True)
    print(f"  explore: nsga2_evolve_kernel {prof['nsga2_evolve_ms']:.3f} ms "
          f"over {prof['nsga2_evolve_calls']} launch(es)")
    for name, st in prof["stages"].items():
        dev = ("not recorded" if st["device_ms"] is None
               else f"{st['device_ms']:.3f} ms")
        print(f"  stage {name:6s} host {st['host_ms']:10.3f} ms, device {dev}")
    print(f"  layout.route: route_slots_kernel {prof['route_slots_ms']:.3f} ms "
          f"over {prof['route_slots_calls']} launch(es)")
    print(f"device {prof['device_s']:.3f} s, busy share "
          f"{prof['busy_share']:.3f}", flush=True)
    for row in prof["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    train = profile_train()
    by_route = train["acim_matmul_ms_per_step_by_route"]
    print(f"trainer (d 768, 12 layers, {train['spec']}): {train['step_ms']:.2f}"
          f" ms/step unprofiled; profiled {train['profiled_step_ms']:.2f} "
          f"ms/step, device {train['device_ms_per_step']:.2f} ms/step "
          f"(acim_matmul {train['acim_matmul_ms_per_step']:.3f}: by route "
          f"{ {k: round(v, 3) for k, v in by_route.items()} }; memsets "
          f"{train['memset_ms_per_step']:.3f}), busy "
          f"share {train['busy_share']:.3f}, "
          f"{train['launches_per_step']:.0f} device events/step", flush=True)
    for row in train["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    from repro_torch.configs import registry
    from repro_torch.models.lm import init_lm

    params = init_lm(registry.get("qwen2.5-3b"), seed=0, dtype=torch.bfloat16)
    pre = profile_prefill(params)
    print(f"prefill (qwen2.5-3b, 36 layers, 1 x 32768): {pre['wall_s']:.3f} "
          f"s unprofiled, {pre['profiled_s']:.3f} s profiled; device "
          f"{pre['device_s']:.3f} s over {pre['device_events']} events: "
          f"flash_attention {pre['flash_attention_s']:.3f} s "
          f"({pre['flash_attention_s'] / pre['device_s']:.3f}), GEMMs "
          f"{pre['gemm_s']:.3f} s ({pre['gemm_s'] / pre['device_s']:.3f}), "
          f"rest {pre['rest_s']:.3f} s; busy share {pre['busy_share']:.3f}",
          flush=True)
    for row in pre["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    dec = profile_decode(params)
    print(f"decode (qwen2.5-3b, batch {dec['batch']}): "
          f"{dec['step_ms']:.3f} ms/step unprofiled, "
          f"{dec['profiled_step_ms']:.3f} profiled; device "
          f"{dec['device_ms_per_step']:.3f} ms/step (GEMMs "
          f"{dec['gemm_ms_per_step']:.3f}) over "
          f"{dec['device_events_per_step']:.0f} events, "
          f"{dec['aten_ops_per_step']:.0f} aten operators/step on the host;"
          f" busy share {dec['busy_share']:.3f}", flush=True)
    for row in dec["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    del params
    torch.cuda.empty_cache()
    tr = profile_lm_train()
    print(f"train step (qwen2.5-3b full width, float32 masters, remat, "
          f"AdamW, {tr['tokens']} tokens): {tr['step_ms']:.2f} ms/step "
          f"unprofiled, {tr['profiled_step_ms']:.2f} profiled; device "
          f"{tr['device_ms_per_step']:.2f} ms/step (GEMMs "
          f"{tr['gemm_ms_per_step']:.2f}) over "
          f"{tr['device_events_per_step']:.0f} events, "
          f"{tr['aten_ops_per_step']:.0f} aten operators/step on the host;"
          f" busy share {tr['busy_share']:.3f}", flush=True)
    for row in tr["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    for row in tr["top_aten"]:
        print(f"  aten {row['calls_per_step']:8.0f}/step  "
              f"{row['self_cpu_ms_per_step']:9.3f} ms  {row['name']}")
    moe = profile_moe_prefill()
    print(f"prefill (deepseek-v2-lite-16b, 27 layers, 1 x 32768): "
          f"{moe['wall_s']:.3f} s unprofiled, {moe['profiled_s']:.3f} s "
          f"profiled; device {moe['device_s']:.3f} s over "
          f"{moe['device_events']} events: flash_attention (192, 128) "
          f"{moe['flash_attention_s']:.3f} s "
          f"({moe['flash_attention_s'] / moe['device_s']:.3f}), GEMMs "
          f"{moe['gemm_s']:.3f} s ({moe['gemm_s'] / moe['device_s']:.3f}), "
          f"rest {moe['rest_s']:.3f} s; busy share {moe['busy_share']:.3f}",
          flush=True)
    for name, sec in moe["stages_device_s"].items():
        print(f"  stage {name:14s} device {sec:.4f} s "
              f"({sec / moe['device_s']:.3f})")
    for row in moe["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    isl = profile_islands()
    for name, r in isl.items():
        print(f"explore {name} (16384, pop 256 x 80): wall "
              f"{r['wall_ms']:.2f} ms, device {r['device_ms']:.3f} ms "
              f"(nsga2_evolve {r['nsga2_evolve_ms']:.3f}, nds_rank "
              f"{r['nds_rank_ms']:.3f}) over {r['device_events']} events; "
              f"busy share {r['busy_share']:.3f}", flush=True)
    print(json.dumps({"card": card, "profile": prof, "train": train,
                      "prefill": pre, "decode": dec, "lm_train": tr,
                      "moe_prefill": moe, "islands": isl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
