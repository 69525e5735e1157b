"""A torch model of the arithmetic of the `acim_matmul` wgmma route
(`csrc/acim_matmul_wgmma.cu`), shared by `test_torch_acim_split.py`
(imports no JAX).

The kernel splits each float32 operand into three bf16 terms that sum to
it exactly (`split_terms`), and per output tile of TILE x TILE and k-tile
of K_TILE it skips a term whose tile is all zero.  Per k16 step it adds
every remaining term product into the chunk sum s, smallest terms
first; where the running k crosses a multiple of N it adds ADC(s) to
the digital sum and zeroes s.
With `splits` > 1 the chunks are cut into ranges of whole chunks, each
range's digital sum is formed alone and the ranges are added at the end
(here in reverse order: the kernel's atomics add in any order).

Term products are exact in float32; the model sums them with float32
matmuls, as the tensor cores add float32 products, in an order of its
own.
"""
import torch

K_TILE = 64
K_STEP = 16
TILE = 128


def split_terms(v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(hi, mid, lo), float32 tensors of bf16 values: hi = bf16_rn(v),
    mid = bf16_rn(v - hi), lo = v - hi - mid (exact)."""
    v = v.to(torch.float32)
    hi = v.to(torch.bfloat16).to(torch.float32)
    r = v - hi
    mid = r.to(torch.bfloat16).to(torch.float32)
    return hi, mid, r - mid


def _adc(s: torch.Tensor, n: int, b_adc: int) -> torch.Tensor:
    delta = torch.tensor(2.0 * n / 2 ** b_adc, dtype=torch.float32)
    code = torch.round(s / delta).clamp(-(2.0 ** (b_adc - 1)),
                                        2.0 ** (b_adc - 1) - 1.0)
    return code * delta


def _tile(xt, wt, k0: int, k1: int, n: int, b_adc: int) -> torch.Tensor:
    """Digital sum of one output tile over chunks [k0, k1) of K."""
    m, c = xt[0].shape[0], wt[0].shape[1]
    acc = torch.zeros((m, c), dtype=torch.float32)
    s = torch.zeros((m, c), dtype=torch.float32)
    for kt in range(k0, k1, K_TILE):
        ke = min(kt + K_TILE, k1)
        xs = [t for i, t in enumerate(xt) if i == 0 or bool(t[:, kt:ke].any())]
        ws = [t for i, t in enumerate(wt) if i == 0 or bool(t[kt:ke].any())]
        for k in range(kt, ke, K_STEP):
            for a in reversed(xs):          # smallest terms first
                for b in reversed(ws):
                    s = s + a[:, k:k + K_STEP] @ b[k:k + K_STEP]
            if (k + K_STEP - k0) % n == 0:
                acc = acc + _adc(s, n, b_adc)
                s = torch.zeros_like(s)
    return acc


def wgmma_route_model(x: torch.Tensor, w: torch.Tensor, n: int, b_adc: int,
                      splits: int = 1) -> torch.Tensor:
    """x (M, K), w (K, C) float32 on the CPU, N % 16 == 0, K % N == 0.
    Returns (M, C) float32 as the wgmma route computes it."""
    m, k = x.shape
    c = w.shape[1]
    assert n % 16 == 0 and k % n == 0, (n, k)
    xt, wt = split_terms(x), split_terms(w)
    chunks = k // n
    per = -(-chunks // splits) if chunks else 0
    ranges = [(i * per * n, min(k, (i + 1) * per * n))
              for i in range(-(-chunks // per) if per else 1)]
    y = torch.zeros((m, c), dtype=torch.float32)
    for m0 in range(0, m, TILE):
        for c0 in range(0, c, TILE):
            xs = [t[m0:m0 + TILE] for t in xt]
            ws = [t[:, c0:c0 + TILE] for t in wt]
            parts = [_tile(xs, ws, k0, k1, n, b_adc) for k0, k1 in ranges]
            tot = torch.zeros_like(parts[0])
            for p in reversed(parts):
                tot = tot + p
            y[m0:m0 + TILE, c0:c0 + TILE] = tot
    return y
