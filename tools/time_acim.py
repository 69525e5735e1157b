"""Time the `acim_matmul` routes in turns on the card:

    python3 tools/time_acim.py [TREE]
    python3 tools/time_acim.py --small-n TREE [TREE ...] [--steps]
                               [--options] [--probes] [--splits]
                               [--boundary] [--turns T] [--reps R]

Without `--small-n`: at the trainer's FFN shapes, (1024, 768) @ (768,
3072) and (1024, 3072) @ (3072, 768), on the trainer's operands (+-1
activations, +-1 weights with the instance's mismatch folded in), with
the codesign pick's macro (N 256, B 4) and with N 128, B 5, it prints
the mean of 20 launches of the cuda_core route (`csrc/acim_matmul.cu`)
and of the wgmma route (`csrc/acim_matmul_wgmma.cu`) in turns
(cuda_core, wgmma, wgmma, cuda_core), the wgmma route at each split
factor of K and on operands that take 1, 3 and 9 bf16 passes (+-1
weights; mismatch-folded weights; float activations too), and, as a
scale only, float32 and bf16 `torch.matmul` of the same shapes: the
product without the ADC, not the same function (the port never calls
them).  Then, on mismatch-folded weights, the share of outputs whose
ADC decisions differ from the exact (float64) macro, for the plain
version and both routes, at the pick and at N 16, B 3 (where every +-1
chunk sum = 2 mod 4 sits on a decision boundary before the mismatch).
TREE (default: this checkout) is the root whose `src` and
`chip_smoke.py` are imported.

`--small-n`: the narrow macros, `SMALL_N_SPECS` (N 8 / B 3 and N 4 / B 2,
points of the 1 kb exhaustive front, and N 2 / B 1), at both FFN shapes
on the trainer's operands.  Each TREE's `acim_matmul*.cu` sources are
built with `_build.NVCC_FLAGS` into build/time_acim/ (one nvcc each, all
at once) and its `kernel.acim_matmul` is loaded beside this checkout's
package, bound to its own libraries: the route that TREE takes at that N
(the CUDA-core kernel before the mma route existed, `acim_matmul_mma`
after).  `--steps` adds this checkout's `acim_matmul_mma.cu` with each
design step undone by text substitution (`STEPS`): the ADC as float
magic-constant rint with a float sum, as the IEEE division and `rintf`,
every term product run (no zero-term skip), and the hi product joined
apart at every macro or at none (the kernel joins it where a +-1 chunk
sum can sit on a decision boundary); the masks undone are the CUDA-core
kernel, which a parent TREE runs at these N.  `--splits` adds
this checkout's mma wrapper at each K split 1-4, `--options` the design
options tried beside the kept source (`OPTIONS`, held like it),
`--probes` the source with parts taken out to see where the time goes
(`PROBES`, timed only), `--boundary` the macros `BOUNDARY_SPECS`, whose
+-1 chunk sums often sit on a decision boundary.  Every run is first
held to the plain version (bit-equal on +-1 operands; whole ADC steps on
at most `chip_smoke.ACIM_FLIP_SHARE` of outputs on mismatch-folded
weights, at the boundary macros whole steps only, the share printed;
the share of outputs off the exact float64 macro is printed beside the
plain version's), then timed in turns (every run in every place, then reversed: old, new,
new, old for two): each turn REPS launches queued behind a sleep kernel,
each launch's device ms from CUDA events between launches; the median
over every launch, the least, and turns won against the first TREE.
Each line carries the mma route's bound (`chip_smoke.acim_bound`): the
larger of the bytes at 3.35 TB/s, the bf16 term passes at 989.4 TFLOP/s
and the conversions (M C K / N) at 5 instructions each at 33.5 T a
second, and beside it the same with the kernel's own 3.
The card's name and power limit are printed first; the numbers go to
chiprun_out/time_acim.json too.
"""
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SMALL_N = "--small-n" in sys.argv
if SMALL_N:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
else:
    root = sys.argv[1] if len(sys.argv) > 1 else str(ROOT)
    sys.path[:0] = [root + "/src", root]
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.core.acim_numerics import NoiseParams  # noqa: E402
from repro_torch.core.acim_spec import MacroSpec  # noqa: E402
from repro_torch.kernels.acim_matmul import kernel as ak  # noqa: E402
from repro_torch.kernels.acim_matmul import ops as ao  # noqa: E402
from repro_torch.kernels.acim_matmul import ref as ar  # noqa: E402

CSRC = "src/repro_torch/csrc"
OUT = ROOT / "build" / "time_acim"
# (h, w, l, b): N 8 / B 3 and N 4 / B 2 lie on the 1 kb exhaustive front;
# N 2 / B 1 is in the 1 kb space, off its front.
SMALL_N_SPECS = ((128, 8, 16, 3), (128, 8, 32, 2), (64, 16, 32, 1))
# --boundary: points of the 1 kb front where +-1 chunk sums lie on an ADC
# decision boundary before the mismatch: N 8 / B 1 (-4: 11 % of chunks),
# N 8 / B 2 (-6, -2, 2: 47 %), N 4 / B 1 (-2: 25 %).
BOUNDARY_SPECS = ((128, 8, 16, 1), (128, 8, 16, 2), (128, 8, 32, 1))
# The kernel's ADC and its epilogue, and the float32 ADCs that replace
# them for --steps (a float sum of code * delta; the clamp's ends from
# 2^B - 1).
ADC = r'''  float q;        // 0.75 + rint(s / delta) 2^-24, saturated to [0, 1]
  asm("fma.rn.sat.f32 %0, %1, %2, %3;\n"
      : "=f"(q) : "f"(s), "f"(p.scale), "f"(kQ0));
  acc += __viaddmin_s32_relu(__float_as_int(q), p.bias, p.top);'''
FLOAT_ADC = '''  const float code = {code};
  acc = fmaf(fminf(fmaxf(code, -0.5f * (p.top + 1)), 0.5f * (p.top - 1)),
             p.delta, acc);'''
EPILOGUE = "v[e] = (float)(acc[i][j][2 * h + e] - conv * half) * p.delta;"
FLOAT_SUM = [("using Acc = int;", "using Acc = float;"),
             (EPILOGUE, "v[e] = acc[i][j][2 * h + e];")]
APART = "const bool apart = (2 << b_adc) <= N;"
STEPS = {
    "mma, float magic ADC": FLOAT_SUM + [(ADC, FLOAT_ADC.format(
        code="fmaf(s, p.scale * 16777216.f, 12582912.f) - 12582912.f"))],
    "mma, IEEE div + rintf": FLOAT_SUM + [(ADC, FLOAT_ADC.format(
        code="rintf(__fdiv_rn(s, p.delta))"))],
    "mma, no term skip": [("const int fl = sm.flags[kt & 1];",
                           "const int fl = 15;")],
    "mma, hi apart at every macro": [
        (APART, "const bool apart = true;"),
        ("case 2: err = ACIM_LAUNCH(2, false);",
         "case 2: err = ACIM_LAUNCH(2, true);")],
    "mma, hi apart at none": [(APART, "const bool apart = false;")]}
K_LOOP = ("#pragma unroll 1\n  for (int kk = 0;",
          "#pragma unroll\n  for (int kk = 0;")
# Design options tried beside the kept source (--options; held like it).
OPTIONS = {"mma, k8 loop unrolled": [K_LOOP],
           "mma, 3 stages": [("constexpr int kStages = 2;",
                              "constexpr int kStages = 3;")]}
DISPATCH = "const int fl = sm.flags[kt & 1];"
# Where the time goes (--probes; timed only: their outputs are wrong by
# design): the split without its arithmetic (every warp takes the +-1
# fast path; the products run as for mismatch-folded w), the ADC as one
# integer add.
PROBES = {
    "probe: no split arithmetic": [
        ("if (__all_sync(0xffffffffu, (low & 0xFFFFu) == 0)) {",
         "if (true) {"),
        (DISPATCH, "const int fl = 12;")],
    "probe: loads only": [
        ("uint32_t nz = split_stage(sm, kt % kStages);", "uint32_t nz = 0;"),
        (DISPATCH, "continue;\n    " + DISPATCH)],
    "probe: no products": [(DISPATCH, "continue;\n    " + DISPATCH)],
    "probe: no ADC": [(ADC, "  acc += __float_as_int(s);")]}
def exact(x, w, n, b):
    """The macro's output with every chunk sum exact (float64)."""
    kc = x.shape[1] // n
    s = torch.einsum("mck,ckj->mcj", x.double().reshape(x.shape[0], kc, n),
                     w.double().reshape(kc, n, w.shape[1]))
    delta = 2.0 * n / 2 ** b
    code = torch.round(s / delta).clamp(-(2.0 ** (b - 1)), 2.0 ** (b - 1) - 1)
    return (code * delta).sum(1)


def card_name() -> str:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"gpu: {card}", flush=True)
    return card


def trainer_operands(m, k, cols, spec, g, dev):
    x = torch.where(torch.rand((m, k), generator=g, device=dev) < 0.5,
                    1.0, -1.0)
    w = torch.where(torch.rand((k, cols), generator=g, device=dev) < 0.5,
                    1.0, -1.0)
    wm = ao.mismatch_weights(w, spec, torch.randn(
        (k, cols), generator=g, device=dev), NoiseParams.from_cal())
    return x, w, wm


def routes_main() -> None:
    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for spec in (MacroSpec(512, 32, 2, 4), MacroSpec(256, 64, 2, 5)):
        n, b = spec.n_caps, spec.b_adc
        for m, k, cols in c.ACIM_SHAPES:
            x, w, wm = trainer_operands(m, k, cols, spec, g, dev)
            run = {"cuda_core": lambda: ak.acim_matmul_cuda_core(x, wm, n, b),
                   "wgmma": lambda: ak.acim_matmul_wgmma(x, wm, n, b)}
            turns = {"cuda_core": [], "wgmma": []}
            for name in ("cuda_core", "wgmma", "wgmma", "cuda_core") * 2:
                turns[name].append(c.cuda_ms(run[name], 20))
            splits = {s: c.cuda_ms(
                lambda: ak.acim_matmul_wgmma(x, wm, n, b, s), 20)
                for s in (1, 2, 3, 4, 6) if s <= k // n}
            xf = torch.rand((m, k), generator=g, device=dev) * 2 - 1
            passes = {p_: c.cuda_ms(lambda: ak.acim_matmul_wgmma(xx, ww, n,
                                                                 b), 20)
                      for p_, xx, ww in ((1, x, w), (3, x, wm), (9, xf, wm))}
            xb, wb = x.bfloat16(), wm.bfloat16()
            scale = {"f32_matmul": c.cuda_ms(lambda: torch.matmul(x, wm), 20),
                     "bf16_matmul": c.cuda_ms(lambda: torch.matmul(xb, wb),
                                              20)}
            row = dict(shape=(m, k, cols), n=n, b=b, turns=turns,
                       default_splits=ak.split_k(m, cols, k, n, sms),
                       wgmma_by_splits=splits, wgmma_by_passes=passes,
                       scale_not_same_function=scale)
            out.append(row)
            print(f"AB ({m}, {k}, {cols}) N {n} B {b}: cuda_core "
                  f"{[round(t, 4) for t in turns['cuda_core']]} ms, wgmma "
                  f"{[round(t, 4) for t in turns['wgmma']]} ms (splits "
                  f"{row['default_splits']}); wgmma by splits "
                  f"{ {s: round(t, 4) for s, t in splits.items()} }; wgmma "
                  f"by bf16 passes "
                  f"{({p_: round(t, 4) for p_, t in passes.items()})}; the "
                  f"product without the ADC, a scale and not the same "
                  f"function: f32 torch.matmul {scale['f32_matmul']:.4f} ms, "
                  f"bf16 {scale['bf16_matmul']:.4f} ms", flush=True)

    flips = []
    m, k, cols = c.ACIM_SHAPES[1]
    for spec in (MacroSpec(512, 32, 2, 4), MacroSpec(32, 64, 2, 3)):
        n, b = spec.n_caps, spec.b_adc
        x, _, wm = trainer_operands(m, k, cols, spec, g, dev)
        want, half = exact(x, wm, n, b), n / 2 ** b
        share = {name: float(((fn(x, wm).double() - want).abs() > half)
                              .double().mean())
                 for name, fn in (("plain", lambda a, w_: ar.acim_matmul_ref(
                                      a, w_, n=n, b_adc=b)),
                                  ("cuda_core", lambda a, w_:
                                   ak.acim_matmul_cuda_core(a, w_, n, b)),
                                  ("wgmma", lambda a, w_:
                                   ak.acim_matmul_wgmma(a, w_, n, b)))}
        flips.append(dict(shape=(m, k, cols), n=n, b=b, off_exact=share))
        print(f"exact ({m}, {k}, {cols}) N {n} B {b}: share of outputs off "
              f"the exact macro's ADC decisions {share}", flush=True)
    print(json.dumps({"card": card, "rows": out, "off_exact": flips}))


# ----------------------------------------------------------------------
# --small-n
# ----------------------------------------------------------------------
def _arg(name: str, default: int) -> int:
    return (int(sys.argv[sys.argv.index(name) + 1]) if name in sys.argv
            else default)


def _trees() -> list[str]:
    out, skip = [], False
    for a in sys.argv[1:]:
        if skip:
            skip = False
        elif a in ("--turns", "--reps"):
            skip = True
        elif not a.startswith("--"):
            out.append(a)
    return out


def sources(trees: list[str]) -> dict[str, tuple[str, dict[str, str]]]:
    """{label: (tree, {source name: text})}: each TREE's acim sources, then
    with --steps this checkout's mma source with each step undone."""
    out = {}
    for t in trees:
        out[t] = (t, {p.stem: p.read_text()
                      for p in sorted((Path(t) / CSRC).glob("acim_matmul*.cu"))})
    variants = {}
    for flag, group in (("--steps", STEPS), ("--options", OPTIONS),
                        ("--probes", PROBES)):
        if flag in sys.argv:
            variants.update(group)
    if variants:
        base = (ROOT / CSRC / "acim_matmul_mma.cu").read_text()
        for label, subs in variants.items():
            text = base
            for old, new in subs:
                assert text.count(old) == 1, old
                text = text.replace(old, new)
            out[label] = (str(ROOT), {"acim_matmul_mma": text})
    return out


def build(texts) -> dict[str, dict[str, Path]]:
    """Every source with one nvcc each, all started together."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for i, (label, (_, srcs)) in enumerate(texts.items()):
        libs[label] = {}
        for name, text in srcs.items():
            cu = OUT / f"{name}_{i}.cu"
            cu.write_text(text)
            so = OUT / f"lib{name}_{i}.so"
            libs[label][name] = so
            procs.append((label, name, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for label, name, proc in procs:
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{label} {name}:\n{log}"
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ACIM ptxas {label} {name}: {line.strip()}",
                      flush=True)
    return libs


def wrapper(tree: str, libs: dict[str, Path]):
    """TREE's `kernels/acim_matmul/kernel.py`, loading `libs`."""
    from repro_torch.kernels import _build

    path = Path(tree) / "src/repro_torch/kernels/acim_matmul/kernel.py"
    spec = importlib.util.spec_from_file_location(
        f"ta_{abs(hash((tree, tuple(map(str, libs.values())))))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(
        load=lambda name: ctypes.CDLL(str(libs[name])), launch=_build.launch)
    mod._FNS = {}
    return mod


def held(fn, x, w, wm, n, b, ex, bound=True) -> tuple[float, float]:
    """Fails unless `fn` is bit-equal to plain on +-1 and within whole ADC
    steps of it on mismatch-folded weights, on at most ACIM_FLIP_SHARE of
    outputs where `bound`; returns that share and the share of outputs
    off the exact macro `ex` by more than half a step."""
    got = fn(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, ar.acim_matmul_ref(x, w, n=n, b_adc=b)), \
        "not bit-equal to plain on +-1"
    gm = fn(x, wm)
    share = c._adc_flip_share(gm, ar.acim_matmul_ref(x, wm, n=n, b_adc=b),
                              2.0 * n / 2 ** b)
    assert share <= c.ACIM_FLIP_SHARE or not bound, share
    return share, off_exact(gm, ex, n, b)


def off_exact(got, ex, n, b) -> float:
    return float(((got.double() - ex).abs() > n / 2 ** b).double().mean())


def small_n_main() -> None:
    from time_wavefront import queued_ms

    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    trees = _trees()
    texts = sources(trees)
    libs = build(texts)
    mods = {label: wrapper(tree, libs[label])
            for label, (tree, _) in texts.items()}
    turns, reps = _arg("--turns", 8), _arg("--reps", 20)
    first = next(iter(mods))
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for args in SMALL_N_SPECS + (BOUNDARY_SPECS if "--boundary" in sys.argv
                                 else ()):
        spec = MacroSpec(*args)
        n, b = spec.n_caps, spec.b_adc
        for m, k, cols in c.ACIM_SHAPES:
            x, w, wm = trainer_operands(m, k, cols, spec, g, dev)
            runs = {label: (lambda a, w_, mod=mod: mod.acim_matmul(a, w_, n,
                                                                   b))
                    for label, mod in mods.items()}
            if "--splits" in sys.argv:
                for s in (1, 2, 3, 4):
                    runs[f"mma, {s} splits"] = (
                        lambda a, w_, s=s: ak.acim_matmul_mma(a, w_, n, b, s))
            ex = exact(x, wm, n, b)
            plain_off = off_exact(ar.acim_matmul_ref(x, wm, n=n, b_adc=b),
                                  ex, n, b)
            held_ = {label: (held(fn, x, w, wm, n, b, ex,
                                  args not in BOUNDARY_SPECS)
                             if not label.startswith("probe") else
                             (float("nan"), float("nan")))
                     for label, fn in runs.items()}
            shares = {label: v[0] for label, v in held_.items()}
            del ex
            means = {label: [] for label in runs}
            each = {label: [] for label in runs}
            names = list(runs)
            for turn in range(turns):
                order = names[turn % len(names):] + names[:turn % len(names)]
                for label in (order if turn % 2 == 0 else order[::-1]):
                    ms = queued_ms(lambda: runs[label](x, wm), reps)
                    each[label] += ms
                    means[label].append(sum(ms) / len(ms))
            b_ms, b_by, side = c.acim_bound(m, k, cols, n,
                                            c._term_passes(x, wm))
            b3 = side["bound_adc3_ms"]
            row = dict(shape=(m, k, cols), n=n, b=b, bound_ms=b_ms,
                       bound_by=b_by, **side, runs={},
                       plain_off_exact=plain_off)
            for label in names:
                med = statistics.median(each[label])
                won = sum(a < f for a, f in zip(means[label], means[first]))
                row["runs"][label] = dict(
                    median_ms=med, least_ms=min(each[label]),
                    turn_means=means[label], turns_won=won,
                    flip_share=shares[label], off_exact=held_[label][1])
                print(f"ACIM ({m}, {k}, {cols}) N {n} B {b}: {label}: median "
                      f"{med:.5f} ms, least {min(each[label]):.5f}, turn means "
                      f"{[round(v, 5) for v in means[label]]}; won against "
                      f"{first} {won} of {turns}; flips {shares[label]:.2e}"
                      f" (off exact {held_[label][1]:.2e}, plain "
                      f"{plain_off:.2e}); "
                      f"{b_ms / med:.3f} of the bound {b_ms:.5f} ms "
                      f"({b_by}, the ADC at 5 instructions; at the "
                      f"kernel's 3: {b3:.5f})", flush=True)
            rows.append(row)
    res = {"card": card, "trees": trees, "rows": rows}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "time_acim.json").write_text(json.dumps(res))
    print(json.dumps(res))


if __name__ == "__main__":
    small_n_main() if SMALL_N else routes_main()
