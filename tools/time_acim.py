"""Time the two `acim_matmul` routes in turns on the card:

    python3 tools/time_acim.py [TREE]

At the trainer's FFN shapes, (1024, 768) @ (768, 3072) and (1024, 3072)
@ (3072, 768), on the trainer's operands (+-1 activations, +-1 weights
with the instance's mismatch folded in), with the codesign pick's macro
(N 256, B 4) and with N 128, B 5, it prints the mean of 20 launches of
the cuda_core route (`csrc/acim_matmul.cu`) and of the wgmma route
(`csrc/acim_matmul_wgmma.cu`) in turns (cuda_core, wgmma, wgmma,
cuda_core), the wgmma route at each split factor of K and on operands
that take 1, 3 and 9 bf16 passes (+-1 weights; mismatch-folded weights;
float activations too), and, as a scale only, float32 and bf16
`torch.matmul` of the same shapes: the product without the ADC, not the
same function (the port never calls them).  Then, on mismatch-folded
weights, the share of outputs whose ADC decisions differ from the exact
(float64) macro, for the plain version and both routes, at the pick and
at N 16, B 3 (where every +-1 chunk sum = 2 mod 4 sits on a decision
boundary before the mismatch).
TREE (default: this checkout) is the root whose `src` and
`chip_smoke.py` are imported.
"""
import json
import subprocess
import sys
from pathlib import Path

root = sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).parents[1])
sys.path[:0] = [root + "/src", root]
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.core.acim_numerics import NoiseParams  # noqa: E402
from repro_torch.core.acim_spec import MacroSpec  # noqa: E402
from repro_torch.kernels.acim_matmul import kernel as ak  # noqa: E402
from repro_torch.kernels.acim_matmul import ops as ao  # noqa: E402
from repro_torch.kernels.acim_matmul import ref as ar  # noqa: E402


def exact(x, w, n, b):
    """The macro's output with every chunk sum exact (float64)."""
    kc = x.shape[1] // n
    s = torch.einsum("mck,ckj->mcj", x.double().reshape(x.shape[0], kc, n),
                     w.double().reshape(kc, n, w.shape[1]))
    delta = 2.0 * n / 2 ** b
    code = torch.round(s / delta).clamp(-(2.0 ** (b - 1)), 2.0 ** (b - 1) - 1)
    return (code * delta).sum(1)


card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, timeout=60, check=True).stdout.strip()
print(f"gpu: {card}", flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
sms = torch.cuda.get_device_properties(dev).multi_processor_count
out = []
for spec in (MacroSpec(512, 32, 2, 4), MacroSpec(256, 64, 2, 5)):
    n, b = spec.n_caps, spec.b_adc
    for m, k, cols in c.ACIM_SHAPES:
        x = torch.where(torch.rand((m, k), generator=g, device=dev) < 0.5,
                        1.0, -1.0)
        w = torch.where(torch.rand((k, cols), generator=g, device=dev) < 0.5,
                        1.0, -1.0)
        wm = ao.mismatch_weights(w, spec, torch.randn(
            (k, cols), generator=g, device=dev), NoiseParams.from_cal())
        run = {"cuda_core": lambda: ak.acim_matmul_cuda_core(x, wm, n, b),
               "wgmma": lambda: ak.acim_matmul_wgmma(x, wm, n, b)}
        turns = {"cuda_core": [], "wgmma": []}
        for name in ("cuda_core", "wgmma", "wgmma", "cuda_core") * 2:
            turns[name].append(c.cuda_ms(run[name], 20))
        splits = {s: c.cuda_ms(lambda: ak.acim_matmul_wgmma(x, wm, n, b, s),
                               20)
                  for s in (1, 2, 3, 4, 6) if s <= k // n}
        xf = torch.rand((m, k), generator=g, device=dev) * 2 - 1
        passes = {p_: c.cuda_ms(lambda: ak.acim_matmul_wgmma(xx, ww, n, b),
                                20)
                  for p_, xx, ww in ((1, x, w), (3, x, wm), (9, xf, wm))}
        xb, wb = x.bfloat16(), wm.bfloat16()
        scale = {"f32_matmul": c.cuda_ms(lambda: torch.matmul(x, wm), 20),
                 "bf16_matmul": c.cuda_ms(lambda: torch.matmul(xb, wb), 20)}
        row = dict(shape=(m, k, cols), n=n, b=b, turns=turns,
                   default_splits=ak.split_k(m, cols, k, n, sms),
                   wgmma_by_splits=splits, wgmma_by_passes=passes,
                   scale_not_same_function=scale)
        out.append(row)
        print(f"AB ({m}, {k}, {cols}) N {n} B {b}: cuda_core "
              f"{[round(t, 4) for t in turns['cuda_core']]} ms, wgmma "
              f"{[round(t, 4) for t in turns['wgmma']]} ms (splits "
              f"{row['default_splits']}); wgmma by splits "
              f"{ {s: round(t, 4) for s, t in splits.items()} }; wgmma by "
              f"bf16 passes {({p_: round(t, 4) for p_, t in passes.items()})}"
              f"; the product "
              f"without the ADC, a scale and not the same function: f32 "
              f"torch.matmul {scale['f32_matmul']:.4f} ms, bf16 "
              f"{scale['bf16_matmul']:.4f} ms", flush=True)


flips = []
m, k, cols = c.ACIM_SHAPES[1]
for spec in (MacroSpec(512, 32, 2, 4), MacroSpec(32, 64, 2, 3)):
    n, b = spec.n_caps, spec.b_adc
    x = torch.where(torch.rand((m, k), generator=g, device=dev) < 0.5,
                    1.0, -1.0)
    wm = ao.mismatch_weights(
        torch.where(torch.rand((k, cols), generator=g, device=dev) < 0.5,
                    1.0, -1.0), spec,
        torch.randn((k, cols), generator=g, device=dev),
        NoiseParams.from_cal())
    want, half = exact(x, wm, n, b), n / 2 ** b
    share = {name: float(((fn(x, wm).double() - want).abs() > half)
                          .double().mean())
             for name, fn in (("plain", lambda a, w_: ar.acim_matmul_ref(
                                  a, w_, n=n, b_adc=b)),
                              ("cuda_core", lambda a, w_:
                               ak.acim_matmul_cuda_core(a, w_, n, b)),
                              ("wgmma", lambda a, w_: ak.acim_matmul_wgmma(
                                  a, w_, n, b)))}
    flips.append(dict(shape=(m, k, cols), n=n, b=b, off_exact=share))
    print(f"exact ({m}, {k}, {cols}) N {n} B {b}: share of outputs off the "
          f"exact macro's ADC decisions {share}", flush=True)
print(json.dumps({"card": card, "rows": out, "off_exact": flips}))
