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
   seq 128, batch 8), on the codesign pick's macro (N 256) and on
   `NARROW_SPEC` (N 8, B 3, a point of the 1 kb front), each after 2
   warm-up steps: the mean step time of 5 steps, then 3 steps under the
   profiler with the device kernels with the most time, the
   `acim_matmul` kernels' device time per step by route (wgmma, mma,
   cuda_core; split-K's zeroing memsets beside), and the busy share;
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
   `nds_rank`, device events and the busy share;
10. the full-width paligemma-3b prefill (18 layers, bf16 weights drawn
   on the card from seed 0, 1 x (256 patches + 32768 tokens)), after one
   warm-up: one prefill under the profiler, its device time split into
   the (256, 256) flash attention instantiation, the GEMMs and the rest;
   then by stage (the attention layer with its kernel, the GeGLU MLP, the
   tied head: CUDA events around those model functions);
11. the full-width zamba2-2.7b prefill (54 Mamba2 layers in 9 groups,
   one shared attention + FFN block, bf16 weights drawn on the card from
   seed 0, 1 x 32768), after one warm-up: one prefill under the
   profiler, its device time split into the (80, 80) flash attention
   instantiation, the GEMMs and the rest; then by stage (CUDA events
   around the model functions): the Mamba2 mixer and within it the
   causal conv, the SSD's intra-chunk work, the chunk states, the chunk
   recurrence, the inter-chunk output and the gated norm (the rest of
   the mixer is its projections and elementwise work), the shared block
   and within it the attention layer (its kernel's time from the
   profiler), and the head; then its decode at batch 4 as section 6
   measures qwen2.5-3b's;
12. the full-width whisper-large-v3 prefill (32 encoder and 32 decoder
   layers, bf16 weights drawn on the card from seed 0, 1500 stub frames
   and 1 x 32768 tokens), after one warm-up: one prefill under the
   profiler, its device time split into the (64, 64) flash attention
   instantiation, the GEMMs, the softmax kernels and the rest; then by
   stage (CUDA events around the model functions): the encoder, the
   decoder's self-attention (with its kernel), the cross-attention's K /
   V projections, the cross-attention (its q / o projections, score and
   P.V einsums and float32 softmax) and the MLPs;
13. the full-width xlstm-125m prefill (6 (mLSTM, sLSTM) pairs, bf16
   weights drawn on the card from seed 0, 1 x 2048: the sLSTM's loop
   issues ~20 kernels a position a pair), after one warm-up: one prefill
   under the profiler (device time, GEMMs, busy share), then the stream
   time of the chunkwise mLSTM, of the sLSTM and of its loop over time
   (CUDA events around the model functions, idle gaps included); then
   its decode at batch 4 as section 6 measures qwen2.5-3b's.

    python3 chip_profile.py vlm moe      # only the sections named

Arguments name sections to run (request, train, prefill, decode,
lm_train, moe, islands, vlm, hybrid, audio, ssm); none runs them all.

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
NARROW_SPEC = (128, 8, 16, 3)   # the trainer's mma-route macro (N 8, B 3)
SECTIONS = ("request", "train", "prefill", "decode", "lm_train", "moe",
            "islands", "vlm", "hybrid", "audio", "ssm")
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


def profile_train(steps: int = 3, spec=None) -> dict:
    """Full-width trainer steps under the profiler (after warm-up), on
    `spec` (default: the codesign pick)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import batch_for
    from repro_torch.models.lm import init_lm
    from repro_torch.quant.cim_linear import CIMConfig
    from repro_torch.train import acim_lm

    cfg = acim_lm.build_cfg(768, 12)
    cim = CIMConfig(spec or acim_lm.pick_macro(cfg).spec)
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
    # per route: the two tensor-core kernels and the CUDA-core one
    route_s = {r_: sum(r[2] for r in kernels
                       if f"acim_matmul_{r_}_kernel" in r[0]) / 1e6
               for r_ in ("wgmma", "mma")}
    memset_s = sum(r[2] for r in kernels if "Memset" in r[0]) / 1e6
    return {"spec": str(cim.spec), "step_ms": step_ms,
            "profiled_step_ms": 1e3 * wall / steps,
            "device_ms_per_step": 1e3 * device_s / steps,
            "acim_matmul_ms_per_step": 1e3 * acim_s / steps,
            "acim_matmul_ms_per_step_by_route": {
                **{r_: 1e3 * v / steps for r_, v in route_s.items()},
                "cuda_core": 1e3 * (acim_s - sum(route_s.values())) / steps},
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


def _stage_device_s(fn, ranges: dict, modules: dict) -> dict:
    """Run `fn()` once with each model function of `ranges` ({stage:
    (module key, function name)}) bracketed by CUDA events on the stream:
    {stage: device seconds from its first kernel's start to its last's
    end, summed over its calls}."""
    import torch

    saved, marks = {}, {name: [] for name in ranges}

    def bracketed(name, f):
        def wrapped(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = f(*a, **kw)
            end.record()
            marks[name].append((start, end))
            return out
        return wrapped

    for name, (m, f) in ranges.items():
        saved[name] = getattr(modules[m], f)
        setattr(modules[m], f, bracketed(name, saved[name]))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for name, (m, f) in ranges.items():
            setattr(modules[m], f, saved[name])
    return {name: sum(a.elapsed_time(b) for a, b in pairs) / 1e3
            for name, pairs in marks.items()}


def _profiled_prefill(step, params, batch) -> tuple[float, float, object]:
    """(unprofiled wall s, profiled wall s, the profiler) of one prefill
    after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step.fn(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.fn(params, batch)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.fn(params, batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    return wall_s, prof_s, prof


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
    wall_s, prof_s, prof = _profiled_prefill(step, params, tokens)
    stages = _stage_device_s(lambda: step.fn(params, tokens), MOE_RANGES,
                             {"attention": attention, "mlp": mlp})
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


VLM_RANGES = {"attention": ("attention", "attention_fwd_blockwise"),
              "mlp": ("mlp", "mlp_fwd"),
              "head": ("lm", "lm_logits")}


def profile_vlm_prefill(seq: int = 32768, batch: int = 1) -> dict:
    """One full-width paligemma-3b prefill (18 layers, bf16 weights drawn
    on the card from seed 0, 256 patches before `seq` tokens) under the
    profiler, after a warm-up: its device time by kernel class (the (256,
    256) flash attention instantiation, the GEMMs, the rest); then one
    more prefill with each model function of `VLM_RANGES` bracketed by
    CUDA events (`attention` includes the flash kernel and the
    projections)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, lm, mlp

    cfg = registry.get("paligemma-3b")
    params = lm.init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=batch, seq=seq)
    step = make_prefill_step(cfg, shape)
    data = batch_for(cfg, seq, batch, 0)
    wall_s, prof_s, prof = _profiled_prefill(step, params, data)
    stages = _stage_device_s(lambda: step.fn(params, data), VLM_RANGES,
                             {"attention": attention, "mlp": mlp, "lm": lm})
    kernels = _device_kernels(prof)
    flash = sum(r[2] for r in kernels if "flash_attention" in r[0]) / 1e6
    gemm = sum(r[2] for r in kernels if any(
        m in r[0].lower() for m in GEMM_MARKS)) / 1e6
    device_s = sum(r[2] for r in kernels) / 1e6
    del params
    torch.cuda.empty_cache()
    return {"positions": batch * (seq + cfg.vlm.n_patches),
            "wall_s": wall_s, "profiled_s": prof_s, "device_s": device_s,
            "flash_attention_s": flash, "gemm_s": gemm,
            "rest_s": device_s - flash - gemm, "stages_device_s": stages,
            "busy_share": device_s / prof_s,
            "device_events": sum(r[1] for r in kernels),
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:15]]}


HYBRID_RANGES = {"mamba2": ("mamba2", "mamba2_fwd"),
                 "mamba2.conv": ("mamba2", "_causal_conv"),
                 "mamba2.ssd_intra": ("mamba2", "_ssd_intra"),
                 "mamba2.chunk_states": ("mamba2", "_chunk_states"),
                 "mamba2.recurrence": ("mamba2", "_chunk_recurrence"),
                 "mamba2.ssd_inter": ("mamba2", "_ssd_inter"),
                 "mamba2.gated_norm": ("mamba2", "_gated_rmsnorm"),
                 "shared": ("lm", "_shared_block_fwd"),
                 "shared.attention": ("attention", "attention_fwd_blockwise"),
                 "head": ("lm", "lm_logits")}


def profile_hybrid(seq: int = 32768, batch: int = 1) -> dict:
    """One full-width zamba2-2.7b prefill (bf16 weights drawn on the card
    from seed 0) under the profiler, after a warm-up: its device time by
    kernel class (the (80, 80) flash attention instantiation, the GEMMs,
    the rest); then one more prefill with each model function of
    `HYBRID_RANGES` bracketed by CUDA events; then `profile_decode` of the
    same weights at batch 4."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, lm, mamba2

    name = "zamba2-2.7b"
    cfg = registry.get(name)
    params = lm.init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=batch, seq=seq)
    step = make_prefill_step(cfg, shape)
    data = batch_for(cfg, seq, batch, 0)
    wall_s, prof_s, prof = _profiled_prefill(step, params, data)
    stages = _stage_device_s(lambda: step.fn(params, data), HYBRID_RANGES,
                             {"attention": attention, "lm": lm,
                              "mamba2": mamba2})
    kernels = _device_kernels(prof)
    flash = sum(r[2] for r in kernels if "flash_attention" in r[0]) / 1e6
    gemm = sum(r[2] for r in kernels if any(
        m in r[0].lower() for m in GEMM_MARKS)) / 1e6
    device_s = sum(r[2] for r in kernels) / 1e6
    inner = sum(v for k, v in stages.items() if k.startswith("mamba2."))
    stages["mamba2.projections_and_rest"] = stages["mamba2"] - inner
    stages["shared.attention_kernel"] = flash
    stages["shared.rest"] = stages["shared"] - flash
    del prof, data
    torch.cuda.empty_cache()
    dec = profile_decode(params, name=name)
    del params
    torch.cuda.empty_cache()
    return {"tokens": batch * seq, "wall_s": wall_s, "profiled_s": prof_s,
            "device_s": device_s, "flash_attention_s": flash,
            "gemm_s": gemm, "rest_s": device_s - flash - gemm,
            "stages_device_s": stages, "busy_share": device_s / prof_s,
            "device_events": sum(r[1] for r in kernels),
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:15]],
            "decode": dec}


AUDIO_RANGES = {"encoder": ("whisper", "encode"),
                "self_attention": ("attention", "attention_fwd_blockwise"),
                "cross_kv": ("whisper", "cross_kv"),
                "cross_attention": ("whisper", "cross_attention_fwd"),
                "mlp": ("mlp", "mlp_fwd")}


def profile_audio(seq: int = 32768, batch: int = 1) -> dict:
    """One full-width whisper-large-v3 prefill (bf16 weights drawn on the
    card from seed 0, the batch's 1500 stub frames) under the profiler,
    after a warm-up: its device time by kernel class (the (64, 64) flash
    attention instantiation, the GEMMs, the softmax kernels, the rest);
    then one more prefill with each model function of `AUDIO_RANGES`
    bracketed by CUDA events (`encoder` includes its own attention and
    MLPs, which `mlp` counts too; `self_attention` the flash kernel and
    the projections)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, mlp, whisper

    cfg = registry.get("whisper-large-v3")
    params = whisper.init_whisper(cfg, seed=0, dtype=torch.bfloat16,
                                  draw_on="cuda")
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=batch, seq=seq)
    step = make_prefill_step(cfg, shape)
    data = batch_for(cfg, seq, batch, 0)
    wall_s, prof_s, prof = _profiled_prefill(step, params, data)
    stages = _stage_device_s(lambda: step.fn(params, data), AUDIO_RANGES,
                             {"attention": attention, "mlp": mlp,
                              "whisper": whisper})
    kernels = _device_kernels(prof)
    flash = sum(r[2] for r in kernels if "flash_attention" in r[0]) / 1e6
    gemm = sum(r[2] for r in kernels if any(
        m in r[0].lower() for m in GEMM_MARKS)) / 1e6
    softmax = sum(r[2] for r in kernels if "softmax" in r[0].lower()) / 1e6
    device_s = sum(r[2] for r in kernels) / 1e6
    del params, prof, data
    torch.cuda.empty_cache()
    return {"tokens": batch * seq, "wall_s": wall_s, "profiled_s": prof_s,
            "device_s": device_s, "flash_attention_s": flash,
            "gemm_s": gemm, "softmax_s": softmax,
            "rest_s": device_s - flash - gemm - softmax,
            "stages_device_s": stages, "busy_share": device_s / prof_s,
            "device_events": sum(r[1] for r in kernels),
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:15]]}


SSM_RANGES = {"mlstm": ("xlstm", "mlstm_fwd_chunked"),
              "slstm": ("xlstm", "slstm_fwd"),
              "slstm.loop": ("xlstm", "_slstm_scan"),
              "head": ("lm", "lm_logits")}


def profile_ssm(seq: int = 2048, batch: int = 1) -> dict:
    """One full-width xlstm-125m prefill (bf16 weights drawn on the card
    from seed 0) under the profiler, after a warm-up: device time, GEMMs,
    busy share; then one more prefill with each model function of
    `SSM_RANGES` bracketed by CUDA events (stream time, the idle gaps of
    a host-bound loop included); then `profile_decode` of the same
    weights at batch 4."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import lm, xlstm

    name = "xlstm-125m"
    cfg = registry.get(name)
    params = lm.init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    step = make_prefill_step(cfg, ShapeSpec("ssm", "prefill", seq, batch))
    data = batch_for(cfg, seq, batch, 0)
    wall_s, prof_s, prof = _profiled_prefill(step, params, data)
    stages = _stage_device_s(lambda: step.fn(params, data), SSM_RANGES,
                             {"lm": lm, "xlstm": xlstm})
    kernels = _device_kernels(prof)
    gemm = sum(r[2] for r in kernels if any(
        m in r[0].lower() for m in GEMM_MARKS)) / 1e6
    device_s = sum(r[2] for r in kernels) / 1e6
    del prof, data
    torch.cuda.empty_cache()
    dec = profile_decode(params, name=name)
    del params
    torch.cuda.empty_cache()
    return {"tokens": batch * seq, "wall_s": wall_s, "profiled_s": prof_s,
            "device_s": device_s, "gemm_s": gemm,
            "rest_s": device_s - gemm, "stages_stream_s": stages,
            "busy_share": device_s / prof_s,
            "device_events": sum(r[1] for r in kernels),
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:10]],
            "decode": dec}


def profile_decode(params, batch: int = 4, steps: int = 8,
                   max_seq: int = 256, name: str = "qwen2.5-3b") -> dict:
    """`decode_step` of the full-width config `name` at `batch`: step time
    unprofiled, then `steps` steps under the profiler by kernel class,
    with the host's aten operators per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.models.lm import decode_step, init_decode_state

    cfg = registry.get(name)
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
    want = set(sys.argv[1:]) or set(SECTIONS)
    unknown = want - set(SECTIONS)
    if unknown:
        print(f"FAIL: unknown sections {sorted(unknown)}; known: "
              f"{SECTIONS}", file=sys.stderr)
        return 1
    out = {}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"gpu: {card}", flush=True)
    if "request" in want:
        out["profile"] = _print_request()
    if "train" in want:
        out["train"] = _print_train()
    if want & {"prefill", "decode"}:
        out.update(_print_prefill_decode(want))
    if "lm_train" in want:
        out["lm_train"] = _print_lm_train()
    if "moe" in want:
        out["moe_prefill"] = _print_moe()
    if "islands" in want:
        out["islands"] = _print_islands()
    if "vlm" in want:
        out["vlm_prefill"] = _print_vlm()
    if "hybrid" in want:
        out["hybrid"] = _print_hybrid()
    if "audio" in want:
        out["audio_prefill"] = _print_audio()
    if "ssm" in want:
        out["ssm"] = _print_ssm()
    print(json.dumps({"card": card, **out}))
    return 0


def _print_request() -> dict:
    import torch

    from repro_torch.api import DesignRequest, DesignSession

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
    return prof


def _print_train() -> dict:
    """The trainer on the codesign pick (N 256, the wgmma route) and on
    `NARROW_SPEC` (N 8, the mma route)."""
    from repro_torch.core.acim_spec import MacroSpec

    out = {}
    for name, spec in (("pick", None), ("narrow", MacroSpec(*NARROW_SPEC))):
        out[name] = _print_train_on(spec)
    return out


def _print_train_on(spec) -> dict:
    train = profile_train(spec=spec)
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
    return train


def _print_prefill_decode(want) -> dict:
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.lm import init_lm

    out = {}
    params = init_lm(registry.get("qwen2.5-3b"), seed=0, dtype=torch.bfloat16)
    if "prefill" in want:
        out["prefill"] = _print_prefill(params)
    if "decode" in want:
        out["decode"] = _print_decode(params)
    del params
    torch.cuda.empty_cache()
    return out


def _print_prefill(params) -> dict:
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
    return pre


def _print_decode(params, dec: dict | None = None,
                  name: str = "qwen2.5-3b") -> dict:
    dec = dec or profile_decode(params)
    print(f"decode ({name}, batch {dec['batch']}): "
          f"{dec['step_ms']:.3f} ms/step unprofiled, "
          f"{dec['profiled_step_ms']:.3f} profiled; device "
          f"{dec['device_ms_per_step']:.3f} ms/step (GEMMs "
          f"{dec['gemm_ms_per_step']:.3f}) over "
          f"{dec['device_events_per_step']:.0f} events, "
          f"{dec['aten_ops_per_step']:.0f} aten operators/step on the host;"
          f" busy share {dec['busy_share']:.3f}", flush=True)
    for row in dec["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    return dec


def _print_lm_train() -> dict:
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
    return tr


def _print_moe() -> dict:
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
    return moe


def _print_islands() -> dict:
    isl = profile_islands()
    for name, r in isl.items():
        print(f"explore {name} (16384, pop 256 x 80): wall "
              f"{r['wall_ms']:.2f} ms, device {r['device_ms']:.3f} ms "
              f"(nsga2_evolve {r['nsga2_evolve_ms']:.3f}, nds_rank "
              f"{r['nds_rank_ms']:.3f}) over {r['device_events']} events; "
              f"busy share {r['busy_share']:.3f}", flush=True)
    return isl


def _print_vlm() -> dict:
    vlm = profile_vlm_prefill()
    print(f"prefill (paligemma-3b, 18 layers, 1 x (256 patches + 32768 "
          f"tokens)): {vlm['wall_s']:.3f} s unprofiled, "
          f"{vlm['profiled_s']:.3f} s profiled; device {vlm['device_s']:.3f}"
          f" s over {vlm['device_events']} events: flash_attention (256, "
          f"256) {vlm['flash_attention_s']:.3f} s "
          f"({vlm['flash_attention_s'] / vlm['device_s']:.3f}), GEMMs "
          f"{vlm['gemm_s']:.3f} s ({vlm['gemm_s'] / vlm['device_s']:.3f}), "
          f"rest {vlm['rest_s']:.3f} s; busy share {vlm['busy_share']:.3f}",
          flush=True)
    for name, sec in vlm["stages_device_s"].items():
        print(f"  stage {name:10s} device {sec:.4f} s "
              f"({sec / vlm['device_s']:.3f})")
    for row in vlm["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    return vlm


def _print_hybrid() -> dict:
    hy = profile_hybrid()
    print(f"prefill (zamba2-2.7b, 54 Mamba2 layers, 9 shared calls, 1 x "
          f"32768): {hy['wall_s']:.3f} s unprofiled, {hy['profiled_s']:.3f} "
          f"s profiled; device {hy['device_s']:.3f} s over "
          f"{hy['device_events']} events: flash_attention (80, 80) "
          f"{hy['flash_attention_s']:.3f} s "
          f"({hy['flash_attention_s'] / hy['device_s']:.3f}), GEMMs "
          f"{hy['gemm_s']:.3f} s ({hy['gemm_s'] / hy['device_s']:.3f}), "
          f"rest {hy['rest_s']:.3f} s; busy share {hy['busy_share']:.3f}",
          flush=True)
    for name, sec in hy["stages_device_s"].items():
        print(f"  stage {name:28s} device {sec:.4f} s "
              f"({sec / hy['device_s']:.3f})")
    for row in hy["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    _print_decode(None, hy["decode"], "zamba2-2.7b")
    return hy


def _print_audio() -> dict:
    au = profile_audio()
    print(f"prefill (whisper-large-v3, 32 + 32 layers, 1500 frames, 1 x "
          f"32768): {au['wall_s']:.3f} s unprofiled, {au['profiled_s']:.3f} "
          f"s profiled; device {au['device_s']:.3f} s over "
          f"{au['device_events']} events: flash_attention (64, 64) "
          f"{au['flash_attention_s']:.3f} s "
          f"({au['flash_attention_s'] / au['device_s']:.3f}), GEMMs "
          f"{au['gemm_s']:.3f} s ({au['gemm_s'] / au['device_s']:.3f}), "
          f"softmax {au['softmax_s']:.3f} s "
          f"({au['softmax_s'] / au['device_s']:.3f}), rest "
          f"{au['rest_s']:.3f} s; busy share {au['busy_share']:.3f}",
          flush=True)
    for name, sec in au["stages_device_s"].items():
        print(f"  stage {name:16s} device {sec:.4f} s "
              f"({sec / au['device_s']:.3f})")
    for row in au["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  "
              f"{row['name']}")
    return au


def _print_ssm() -> dict:
    ss = profile_ssm()
    print(f"prefill (xlstm-125m, 6 (mLSTM, sLSTM) pairs, 1 x "
          f"{ss['tokens']}): {ss['wall_s']:.3f} s unprofiled, "
          f"{ss['profiled_s']:.3f} s profiled; device {ss['device_s']:.3f} s "
          f"over {ss['device_events']} events (GEMMs {ss['gemm_s']:.3f} s); "
          f"busy share {ss['busy_share']:.3f}", flush=True)
    for name, sec in ss["stages_stream_s"].items():
        print(f"  stage {name:12s} stream {sec:.4f} s "
              f"({sec / ss['wall_s']:.3f} of the unprofiled wall)")
    for row in ss["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  "
              f"{row['name']}")
    _print_decode(None, ss["decode"], "xlstm-125m")
    return ss


if __name__ == "__main__":
    sys.exit(main())
