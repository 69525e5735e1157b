"""The mesh train step with one position a card, on a machine with four
CUDA devices:

    python3 tools/train_cards.py [--only b,a,c] [--one-card] [--deadline S]

(a) Phases 18, 19 and 21's cut configs (qwen3-8b cut to 8 layers,
    deepseek-v2-lite-16b to 4, zamba2-2.7b to 12, whisper-large-v3 to 8
    + 8, xlstm-125m to 4; full width, 8 x 256, remat) on 1x4 and 2x2
    with FSDP: the mesh on four `cuda:0` positions twice, then one
    position a card, each from the same masters.  Every quantity the two
    one-card runs agree on bit for bit (loss, each reduced grad, each
    master after the step) the four-card run must equal bit for bit; a
    leaf where the one-card runs differ is named and held to
    TP_GRAD_REL_L2 (grad) of the first run's.
(b) qwen3-8b (36 layers), codeqwen1.5-7b (32) and deepseek-v2-lite-16b
    (27) uncut at 8 x 256 on 1x4, 2x2 and 2x2 with FSDP across the four
    cards, weights drawn on card 0 (`steps.init_mesh_state(draw_on=)`,
    a layer at a time), two steps each: each position's state and leaf
    bytes the dry-run's to the byte; each card's peak printed beside
    `dryrun.card_peak_bytes` and under 80 GB; step 0's loss (without
    the MoE's aux loss) within TP_LOSS_RTOL of the prefill path's
    cross-entropy of the same weights in bf16 on one card; every
    reduced grad within TP_GRAD_REL_L2 of 1x4's (deepseek teacher-forced
    to 1x4's routes); each mesh's masters and moments after step 0
    bit-equal to one device's `adamw.update` of the masters on the
    mesh's own grads; step 1's ms and tokens/s.  A mesh whose policy
    is one that ran (2x2 and 2x2-FSDP, FSDP being on from 6e9
    parameters) is named and not run again.
(c) The entry points: `trainer.init_state(mesh=)` of the uncut
    deepseek-v2-lite-16b on 1x4 (the CPU draw), its seconds and each
    card's peak; then, where the disk holds two of its checkpoints,
    `python -m repro_torch.launch.train --arch qwen3-8b --mesh 2x2
    --steps 2` into a directory under `build/` (exit 0, finite losses,
    the checkpoint's bytes and seconds) and the same CLI in process
    resuming it with `--mesh 1x4 --steps 3` (exit 0; the state it
    loads is the checkpoint's masters bit for bit); they are left out,
    and why printed, where the disk cannot hold them or its write rate
    puts them past `--deadline` seconds from the start.

`--one-card` runs the same code with every position on cuda:0, the
uncut configs cut to 2 layers and the CLI on the reduced qwen3-8b: a
rehearsal, not the measurement.  It prints the `nvidia-smi` name and
power limit line first and exits 1 on any mismatch or with fewer than
four cards.
"""
import argparse
import contextlib
import dataclasses
import gc
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.synthetic import batch_for  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.shapes import ShapeSpec  # noqa: E402
from repro_torch.models.common import softmax_cross_entropy  # noqa: E402
from repro_torch.models.registry import build_model, count_params  # noqa
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import gather_shards, make_policy  # noqa

SHAPE = (8, 256)                               # batch, seq
CUT = (("qwen3-8b", 8, None), ("deepseek-v2-lite-16b", 4, None),
       ("zamba2-2.7b", 12, None), ("whisper-large-v3", 8, 8),
       ("xlstm-125m", 4, None))
CUT_MESHES = (((1, 4), None), ((2, 2), True))
UNCUT = ("qwen3-8b", "codeqwen1.5-7b", "deepseek-v2-lite-16b")
UNCUT_MESHES = (((1, 4), None), ((2, 2), None), ((2, 2), True))
CARD_BYTES = 80e9
FIRST = "cuda:0"                   # card 0: draws, one-card runs, checks
CKPT = ROOT / "build" / "train_cards_ckpt"
# the CLI's run: its checkpoint at step 2 and the resumed run's at 3
CKPT_COPIES = 2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rel_l2(g, h) -> float:
    return float(torch.linalg.vector_norm((g - h).float())
                 / torch.linalg.vector_norm(h.float()).clamp_min(1e-30))


def sync() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def reset_peaks() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def peaks(mesh) -> dict:
    """{device: its peak bytes} over the mesh's devices."""
    return {str(d): torch.cuda.max_memory_allocated(d)
            for d in sorted(set(mesh.positions.ravel()), key=str)}


def free() -> None:
    gc.collect()
    for i in range(torch.cuda.device_count()):
        with torch.cuda.device(i):
            torch.cuda.empty_cache()


def mesh_of(shape, positions):
    n = shape[0] * shape[1]
    return make_mesh(shape, ("data", "model"), positions[:n])


def name_of(shape, fsdp) -> str:
    return f"{shape[0]}x{shape[1]}" + ("-fsdp" if fsdp else "")


def cut(full, layers: int, enc: int | None):
    cfg = dataclasses.replace(full, n_layers=layers)
    if enc is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=enc))
    return cfg


# ---------------------------------------------------------------------------
# (a) cut configs: four cards against four positions of one card
# ---------------------------------------------------------------------------
def one_run(cfg, masters: dict, mesh, fsdp, batch) -> dict:
    """One checked step from `masters` (host): loss, metrics, each reduced
    grad and each master after the step, on the host."""
    grads = {}
    step = steps.make_train_step(cfg, mesh, remat=True, fsdp=fsdp,
                                 on_grad=lambda n, g: grads.update(
                                     {n: g.to("cpu")}))
    state = steps.shard_params(masters, step.policy, step.opt_cfg)
    sync()
    t0 = time.perf_counter()
    state, met = step.fn(state, batch)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    after = {n: t.cpu() for n, t in state.full()["params"].items()}
    out = dict(met={k: v.cpu() for k, v in met.items()}, grads=grads,
               masters=after, ms=ms, peak=peaks(mesh))
    del state, step
    free()
    return out


def cut_configs(cards: list, depth: int | None) -> None:
    b, s = SHAPE
    one = [FIRST] * 4
    for name, layers, enc in CUT:
        full = registry.get(name)
        if depth is not None:
            # whole groups of the hybrid family's shared block
            layers = full.hybrid.shared_attn_every if full.hybrid else depth
            enc = enc and depth
        cfg = cut(full, layers, enc)
        model = build_model(cfg).init(seed=0, draw_on=FIRST, device=FIRST)
        masters = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del model
        free()
        batch = batch_for(cfg, s, b, 0, seed=0, device=FIRST)
        for shape, fsdp in CUT_MESHES:
            what = f"(a) {cfg.name} cut to {layers} layers {name_of(shape, fsdp)}"
            r1 = one_run(cfg, masters, mesh_of(shape, one), fsdp, batch)
            r2 = one_run(cfg, masters, mesh_of(shape, one), fsdp, batch)
            agree = {(part, n) for part in ("grads", "masters")
                     for n, x in r1[part].items()
                     if torch.equal(x, r2[part][n])}
            loss_same = torch.equal(r1["met"]["loss"], r2["met"]["loss"])
            del r2
            free()
            r4 = one_run(cfg, masters, mesh_of(shape, cards), fsdp, batch)
            same = differ = 0
            named = []
            for part in ("grads", "masters"):
                for n, x in r1[part].items():
                    if (part, n) in agree:
                        same += 1
                        check(torch.equal(r4[part][n], x),
                              f"{what}: {part[:-1]} {n} on four cards differs "
                              f"from the one-card runs, which agree")
                        continue
                    differ += 1
                    named.append(f"{part[:-1]} {n}")
                    if part == "grads":
                        rel = rel_l2(r4[part][n], x)
                        check(rel <= smoke.TP_GRAD_REL_L2,
                              f"{what}: grad {n} rel L2 {rel} on four cards "
                              f"(tolerance {smoke.TP_GRAD_REL_L2})")
            if loss_same:
                check(torch.equal(r4["met"]["loss"], r1["met"]["loss"]),
                      f"{what}: loss {float(r4['met']['loss'])} on four cards, "
                      f"{float(r1['met']['loss'])} on one")
            print(f"{what}: loss {float(r4['met']['loss']):.6f} on four cards"
                  f" ({'bit-equal to' if loss_same else 'vs'} one card's "
                  f"{float(r1['met']['loss']):.6f}); {same} grads and masters "
                  f"the two one-card runs agree on, each bit-equal on four "
                  f"cards; {differ} they differ on"
                  + (f" ({', '.join(named[:8])}{' ...' if differ > 8 else ''};"
                     f" grads within {smoke.TP_GRAD_REL_L2})" if differ else "")
                  + f"; checked step {r1['ms']:.2f} ms on one card, "
                  f"{r4['ms']:.2f} ms on four; peaks "
                  f"{ {d: round(v / 1e9, 2) for d, v in r4['peak'].items()} } GB",
                  flush=True)
            del r1, r4
            free()
        del masters
        free()


# ---------------------------------------------------------------------------
# (b) the uncut configs
# ---------------------------------------------------------------------------
def prefill_ce(cfg, batch) -> float:
    """The prefill path's loss (CE with the z-loss) of `batch` on the
    bf16 cast of the masters (drawn on card 0 as the mesh's) on card 0."""
    model = build_model(cfg).init(seed=0, draw_on=FIRST, device=FIRST,
                                  dtype=torch.bfloat16)
    b, s = batch["inputs"].shape
    prefill = steps.make_prefill_step(cfg, ShapeSpec("ce", "prefill", s, b),
                                      device=FIRST)
    logits = prefill.fn(model, batch)
    with torch.inference_mode():
        ce = float(softmax_cross_entropy(logits[:, -s:], batch["targets"])[0])
    del model, logits
    free()
    return ce


def gathered(state, name: str, k=None):
    spec = state.specs[name]
    src = [s["params"][name] if k is None else s["opt"][k][name]
           for s in state.shards]
    return gather_shards(src, state.mesh, spec, FIRST)


def uncut_configs(cards: list, layers: int | None) -> None:
    b, s = SHAPE
    for name in UNCUT:
        full = registry.get(name)
        cfg = full if layers is None else cut(full, layers, None)
        moe = cfg.moe is not None
        t_cfg = time.perf_counter()
        batches = [batch_for(cfg, s, b, i, seed=0, device=FIRST)
                   for i in range(2)]
        ce = prefill_ce(cfg, batches[0])
        masters: dict = {}
        ref: dict = {}          # 1x4's reduced grads, on the host
        routes = None
        ran: dict = {}
        for shape, fsdp in UNCUT_MESHES:
            mesh = mesh_of(shape, cards)
            what = f"(b) {cfg.name} {name_of(shape, fsdp)}"
            t_mesh = time.perf_counter()
            policy = make_policy(mesh, cfg, fsdp=fsdp)
            same = [k for k, (sh, pol) in ran.items() if sh == shape
                    and pol.fsdp == policy.fsdp
                    and pol.model_strategy == policy.model_strategy]
            if same:
                print(f"{what}: the policy of {same[0]} (FSDP "
                      f"{policy.fsdp}: on from 6e9 parameters), which ran",
                      flush=True)
                continue
            ran[name_of(shape, fsdp)] = (shape, policy)
            opt_cfg = steps.default_opt_cfg(cfg)
            reset_peaks()
            keep = (lambda n, t: masters.update({n: t.to("cpu")})) \
                if not masters else None
            t0 = time.perf_counter()
            state = steps.init_mesh_state(cfg, policy, opt_cfg, seed=0,
                                          draw_on=FIRST, place=keep)
            sync()
            init_s = time.perf_counter() - t0
            init_peak = peaks(mesh)
            cell = ShapeSpec("train_cards", "train", s, b)
            want = dryrun.position_bytes(cfg, cell, mesh, fsdp=fsdp)
            got = [state.position_bytes(f) for f in range(mesh.size)]
            check(all(g == want["state_bytes"] for g in got),
                  f"{what}: state bytes a position {got}, dry-run "
                  f"{want['state_bytes']}")
            worst = {"rel": 0.0, "name": None, "n": 0}
            grads: dict = {}
            first = not ref

            def on_grad(n, g):
                grads[n] = g.to("cpu")
                if first:
                    ref[n] = grads[n]
                    return
                rel = rel_l2(g, ref[n].to(g.device))
                worst["n"] += 1
                if rel >= worst["rel"]:
                    worst.update(rel=rel, name=n)

            checked = steps.make_train_step(cfg, mesh, remat=True, fsdp=fsdp,
                                            on_grad=on_grad)
            plain = steps.make_train_step(cfg, mesh, remat=True, fsdp=fsdp)
            calls: list = []
            forced = routes if moe else None
            around = smoke._mesh_routes(*shape, cfg.n_layers, forced) \
                if moe else contextlib.nullcontext([])
            reset_peaks()
            sync()
            t0 = time.perf_counter()
            with around as rec:
                state, met = checked.fn(state, batches[0])
            sync()
            ms0 = (time.perf_counter() - t0) * 1e3
            calls.extend(rec)
            peak0 = peaks(mesh)
            if moe and routes is None:
                routes = smoke._group_routes(what, calls, *shape,
                                             cfg.n_layers)
            loss = float(met["loss"]) - (float(met["aux_loss"]) if moe else 0)
            check(abs(loss - ce) <= smoke.TP_LOSS_RTOL * abs(ce),
                  f"{what}: step 0's loss {loss} vs the bf16 prefill's CE {ce}")
            if not first:
                check(worst["n"] == len(ref)
                      and worst["rel"] <= smoke.TP_GRAD_REL_L2,
                      f"{what}: grad {worst['name']} rel L2 {worst['rel']} to "
                      f"1x4's ({worst['n']} leaves compared)")
            for f in range(mesh.size):
                check(checked.held[f] == dryrun.held_bytes(cfg, mesh,
                                                           position=f,
                                                           fsdp=fsdp),
                      f"{what}: position {f}'s leaf bytes are not the "
                      f"dry-run's")
            # each mesh's update: one device's AdamW of the masters on the
            # mesh's own grads, leaf by leaf
            for n in state.specs:
                p = masters[n].to(FIRST, copy=True)
                opt = adamw.init({n: p}, opt_cfg)
                adamw.update({n: grads[n].to(FIRST)}, opt, {n: p},
                             opt_cfg, norm=met["grad_norm"].to(FIRST))
                check(torch.equal(gathered(state, n), p),
                      f"{what}: {n}'s master is not one device's update on "
                      f"the mesh's grads")
                for k in ("m", "v"):
                    check(torch.equal(gathered(state, n, k), opt[k][n]),
                          f"{what}: {n}'s {k} is not one device's update")
                del p, opt
            grads.clear()
            free()
            reset_peaks()
            sync()
            t0 = time.perf_counter()
            state, met1 = plain.fn(state, batches[1])
            sync()
            ms1 = (time.perf_counter() - t0) * 1e3
            peak1 = peaks(mesh)
            reckon = dryrun.card_peak_bytes(cfg, cell, mesh, fsdp=fsdp)
            worst_peak = max(max(peak0.values()), max(peak1.values()),
                             max(init_peak.values()))
            check(worst_peak < CARD_BYTES,
                  f"{what}: a card peaked at {worst_peak / 1e9:.2f} GB")
            line = (f"{what} ({b} x {s}): state a position "
                    f"{want['state_bytes']} bytes = "
                    f"{want['state_bytes'] / 1e9:.4f} GB (the dry-run's), "
                    f"leaves each position reads the dry-run's; placed a "
                    f"layer at a time in {init_s:.2f} s; step 1 "
                    f"{ms1:.2f} ms = {b * s / ms1 * 1e3:.1f} tokens/s (step 0"
                    f" with the grads read out {ms0:.2f} ms); peaks GB "
                    f"(step 1 / step 0 with the checks / placement) vs the "
                    f"dry-run's reckoning (state, grad sums, one layer's "
                    f"gathers): "
                    + ", ".join(f"{d} {peak1[d] / 1e9:.2f} / "
                                f"{peak0[d] / 1e9:.2f} / "
                                f"{init_peak[d] / 1e9:.2f} vs "
                                f"{reckon[d] / 1e9:.2f}" for d in peak1)
                    + f"; loss {float(met['loss']):.6f}"
                    + (f" (aux {float(met['aux_loss']):.6f})" if moe else "")
                    + f", CE vs the bf16 prefill's {ce:.6f}: rel "
                    f"{abs(loss - ce) / ce:.3e} (tolerance "
                    f"{smoke.TP_LOSS_RTOL}); ")
            if worst["n"]:
                line += (f"worst leaf grad rel L2 to 1x4's "
                         f"{worst['rel']:.3e} ({worst['name']}, tolerance "
                         f"{smoke.TP_GRAD_REL_L2}"
                         + (", routes teacher-forced to 1x4's" if moe else "")
                         + "); ")
            line += (f"masters and moments bit-equal to one device's AdamW on "
                     f"the mesh's grads; this mesh "
                     f"{time.perf_counter() - t_mesh:.2f} s")
            print(line, flush=True)
            del state, checked, plain, met, met1
            free()
        masters.clear()
        ref.clear()
        free()
        print(f"(b) {cfg.name}: {time.perf_counter() - t_cfg:.2f} s",
              flush=True)


# ---------------------------------------------------------------------------
# (c) the entry points
# ---------------------------------------------------------------------------
def write_rate(directory: Path, nbytes: int = 2 << 30) -> float:
    """Bytes a second of writing `nbytes` to a file under `directory`,
    synced (the file removed after)."""
    path = directory / "rate.bin"
    block = bytes(64 << 20)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(nbytes // len(block)):
            f.write(block)
        f.flush()
        os.fsync(f.fileno())
    dt = time.perf_counter() - t0
    path.unlink()
    return nbytes / dt


def entry_points(cards: list, one_card: bool, deadline: float) -> None:
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train as train_cli
    from repro_torch.train import trainer

    t_c = time.perf_counter()
    name = "deepseek-v2-lite-16b"
    cfg = registry.reduced(name) if one_card else registry.get(name)
    mesh = mesh_of((1, 4), cards)
    reset_peaks()
    t0 = time.perf_counter()
    state = trainer.init_state(cfg, trainer.TrainerConfig(), mesh=mesh)
    sync()
    init_s = time.perf_counter() - t0
    pk = peaks(mesh)
    check(max(pk.values()) < CARD_BYTES,
          f"(c) init_state: a card peaked at {max(pk.values()) / 1e9:.2f} GB")
    print(f"(c) trainer.init_state({cfg.name}, mesh=1x4): {init_s:.2f} s (the "
          f"CPU draw, each leaf split as drawn); peaks GB "
          f"{ {d: round(v / 1e9, 2) for d, v in pk.items()} }", flush=True)
    del state
    free()

    arch = ["--arch", "qwen3-8b"] + (["--reduced"] if one_card else []) + (
        [] if FIRST.startswith("cuda") else ["--device", FIRST])
    cli = registry.reduced("qwen3-8b") if one_card else registry.get(
        "qwen3-8b")
    # masters and two moments, float32 on disk
    need = 12 * count_params(cli)
    shutil.rmtree(CKPT, ignore_errors=True)
    CKPT.mkdir(parents=True)
    disk = shutil.disk_usage(CKPT).free
    if disk < CKPT_COPIES * need * 1.05:
        print(f"(c) the CLI's two runs left out: the disk under build/ has "
              f"{disk / 1e9:.1f} GB free, its {CKPT_COPIES} checkpoints take "
              f"{CKPT_COPIES * need / 1e9:.1f} GB", flush=True)
        return
    # two checkpoints written and one read, at the disk's write rate, and
    # two draws of the model on the CPU, each as long as init_state's
    rate = write_rate(CKPT)
    reckon = 3 * need / rate + 2 * (time.perf_counter() - t_c)
    if time.perf_counter() + reckon > deadline:
        print(f"(c) the CLI's two runs left out: {disk / 1e9:.1f} GB free "
              f"under build/, written at {rate / 1e9:.2f} GB/s, so its "
              f"checkpoints ({CKPT_COPIES} x {need / 1e9:.1f} GB) and draws "
              f"reckon {reckon:.0f} s, past the run's deadline in "
              f"{deadline - time.perf_counter():.0f} s", flush=True)
        return
    print(f"(c) the disk under build/: {disk / 1e9:.1f} GB free, written at "
          f"{rate / 1e9:.2f} GB/s; the CLI's two runs reckoned {reckon:.0f} s",
          flush=True)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *arch, "--mesh",
         "2x2", "--steps", "2", "--ckpt-dir", str(CKPT)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=3000)
    cli_s = time.perf_counter() - t0
    losses = [float(ln.split()[3]) for ln in run.stdout.splitlines()
              if ln.startswith("step ")]
    check(run.returncode == 0 and losses
          and all(math.isfinite(x) for x in losses)
          and ckpt.latest_step(CKPT) == 2,
          f"(c) launch.train --mesh 2x2: exit {run.returncode}, losses "
          f"{losses}\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    on_disk = sum(p.stat().st_size for p in (CKPT / "step_00000002").iterdir())
    print(f"(c) python -m repro_torch.launch.train {' '.join(arch)} --mesh "
          f"2x2 --steps 2: exit 0 in {cli_s:.2f} s, losses {losses}; its "
          f"checkpoint {on_disk} bytes = {on_disk / 1e9:.2f} GB on disk",
          flush=True)

    # the resume, in process: the state it splits onto 1x4 against the
    # masters it loaded from the checkpoint
    compared = {}
    shard_state = steps.shard_state

    def held_to_loaded(state, policy):
        out = shard_state(state, policy)
        for n, t in out.full()["params"].items():
            compared[n] = torch.equal(t.cpu(), state["params"][n])
        return out

    steps.shard_state = held_to_loaded
    t0 = time.perf_counter()
    try:
        rc = train_cli.main([*arch, "--mesh", "1x4", "--steps", "3",
                             "--ckpt-dir", str(CKPT)])
    finally:
        steps.shard_state = shard_state
    resume_s = time.perf_counter() - t0
    check(rc == 0 and ckpt.latest_step(CKPT) == 3 and compared
          and all(compared.values()),
          f"(c) resume --mesh 1x4: exit {rc}, masters equal to the "
          f"checkpoint's on {sum(compared.values())} of {len(compared)} "
          f"leaves")
    print(f"(c) the same CLI resumed with --mesh 1x4 --steps 3: exit 0 in "
          f"{resume_s:.2f} s; the {len(compared)} masters it loaded onto "
          f"1x4 equal the step-2 checkpoint's bit for bit", flush=True)
    shutil.rmtree(CKPT, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="b,a,c")
    ap.add_argument("--one-card", action="store_true")
    ap.add_argument("--deadline", type=float, default=3600.0,
                    help="seconds from the start by which (c)'s CLI runs "
                         "must be reckoned to end, else they are left out")
    args = ap.parse_args(argv)
    n = torch.cuda.device_count()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    if n < 4 and not args.one_card:
        fail(f"needs four CUDA devices, found {n}")
    cards = [FIRST] * 4 if args.one_card else [f"cuda:{i}"
                                                   for i in range(4)]
    t0 = time.perf_counter()
    for part in args.only.split(","):
        if part == "a":
            cut_configs(cards, 2 if args.one_card else None)
        elif part == "b":
            uncut_configs(cards, 2 if args.one_card else None)
        elif part == "c":
            entry_points(cards, args.one_card, t0 + args.deadline)
        print(f"train_cards ({part}) done at {time.perf_counter() - t0:.2f} s",
              flush=True)
    print(f"train_cards: ok in {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
