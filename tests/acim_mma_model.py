"""A torch model of the arithmetic of the `acim_matmul` mma route
(`csrc/acim_matmul_mma.cu`), shared by `test_torch_acim_mma_model.py`
(imports no JAX).

The kernel splits each float32 operand into three bf16 terms that sum to
it exactly (`acim_split_model.split_terms`) and, per output tile of
TILE_M x TILE_N and k-tile of K_TILE, skips the mid and lo terms of an
operand whose tile has none (all three run where any is nonzero).  K runs
in `mma.sync` m16n8k8 steps: lane t = lane % 4 of a warp holds k = 2t and
2t + 1 of the step (`lane_ks`), and the chunk q of a step at chunk size
N is the lanes t with t // (N / 2) == q (`chunk_lanes`); every other
lane's A registers are zeroed (`lane_mask`).  A chunk's term products
chain through C from 0, smallest terms first (`term_order`); at the
macros where a +-1 chunk sum can sit on a decision boundary (`apart`)
the hi x hi product runs apart and one float32 add joins it to the
rest.  The sum s is converted at once by the magic-constant ADC
(`adc_ucode`): q = fma.rn.sat(s, 2^-24 / delta, 0.75) rounds s / delta
half to even into q's last bits and saturates to [0, 1], and the
integer held in q's bits less 0.75's, plus 2^(B-1), is clamped to [0,
2^B - 1] in int32 and added to an integer sum.  The epilogue takes 2^(B-1) off for each of
the tile's conversions (whole k-tiles past K included: zero-filled, each
adds exactly 2^(B-1)) and multiplies by delta.  With `splits` > 1 the
k-tiles are cut into ranges, each range's result formed alone and the
ranges added at the end (here in reverse order: the kernel's atomics add
in any order).

Term products are exact in float32; the model sums a chunk's with a
float32 matmul over its lanes' k, as the tensor cores add float32
products, in an order of its own.
"""
import numpy as np
import torch

from acim_split_model import split_terms

K_STEP = 8                  # k of one mma.sync m16n8k8
LANES = 4                   # threadID_in_group: t = lane % 4
TILE_M, TILE_N, K_TILE = 128, 64, 32
Q0 = 0.75                   # the ADC's offset: q's ulp is 2^-24 in [0.5, 1)
Q0_BITS = 0x3F400000
MMA_N = (2, 4, 8)


def lane_ks(t: int) -> tuple[int, int]:
    """The k of a k8 step that lane t holds, in A and in B."""
    return 2 * t, 2 * t + 1


def chunk_lanes(n: int, q: int) -> list[int]:
    """The lanes t of chunk q of a k8 step at chunk size n."""
    return [t for t in range(LANES) if t // (n // 2) == q]


def lane_mask(n: int, q: int) -> torch.Tensor:
    """(8,) float32: 1 at the k chunk q's lanes hold, 0 where A is
    zeroed."""
    m = torch.zeros(K_STEP)
    for t in chunk_lanes(n, q):
        m[list(lane_ks(t))] = 1.0
    return m


def term_order(nx: int, nw: int) -> list[tuple[int, int]]:
    """(x term, w term) in the order the kernel chains them: smallest
    first (term 0 is hi, 2 is lo)."""
    return [(a, b) for a in reversed(range(nx)) for b in reversed(range(nw))]


def apart(n: int, b_adc: int) -> bool:
    """Whether the kernel joins the hi product by an add of its own: where
    2^(B+1) <= N, the macros at which a +-1 chunk sum can sit on an ADC
    decision boundary."""
    return (2 << b_adc) <= n


def fma_sat(s: torch.Tensor, scale: float) -> torch.Tensor:
    """float32 fma.rn.sat(s, scale, 0.75): one rounding of the exact value
    (s * scale is exact for a power-of-two scale; float64 holds the sum
    exactly wherever a float32 tie could arise), saturated to [0, 1],
    NaN to 0."""
    q = (s.double() * scale + Q0).to(torch.float32)
    return torch.nan_to_num(q, nan=0.0).clamp(0.0, 1.0)


def magic_rint(v: torch.Tensor) -> torch.Tensor:
    """rint half to even of float32 v by the ADC's FFMA (exact for |v| <
    2^22): q's bits less 0.75's."""
    bits = fma_sat(v, 2.0 ** -24).view(torch.int32)
    return (bits - Q0_BITS).to(torch.float32)


def adc_ucode(s: torch.Tensor, n: int, b_adc: int) -> torch.Tensor:
    """int64: the clamped code plus 2^(B-1) the kernel adds for chunk
    sums s (`__viaddmin_s32_relu(bits(q), 2^(B-1) - bits(0.75), 2^B -
    1)`, in int32 as the kernel adds)."""
    q = fma_sat(s, 2.0 ** b_adc / (2 * n) / 2 ** 24)
    code = q.view(torch.int32) + torch.tensor(2 ** (b_adc - 1) - Q0_BITS,
                                              dtype=torch.int32)
    return code.clamp(0, 2 ** b_adc - 1).to(torch.int64)


def adc_value(s: torch.Tensor, n: int, b_adc: int) -> torch.Tensor:
    """ADC(s) as the kernel's integer path gives it, float32."""
    delta = 2.0 * n / 2 ** b_adc
    return ((adc_ucode(s, n, b_adc) - 2 ** (b_adc - 1)).to(torch.float32)
            * delta)


def _terms_used(t: torch.Tensor) -> int:
    """1 if a term tile's mid and lo are all zero, else 3 (kSkipTerms)."""
    return 3 if bool(t[1].any() or t[2].any()) else 1


def _tile(xt, wt, k0: int, k1: int, n: int, b_adc: int) -> torch.Tensor:
    """One output tile over k-tiles [k0, k1): the float32 result."""
    m, c = xt.shape[1], wt.shape[2]
    acc = torch.zeros((m, c), dtype=torch.int64)
    conv = 0
    masks = [lane_mask(n, q) for q in range(K_STEP // n)]
    for kt in range(k0, k1, K_TILE):
        xs, ws = xt[:, :, kt:kt + K_TILE], wt[:, kt:kt + K_TILE]
        nx = _terms_used(xs)
        nw = max(_terms_used(ws), nx)   # x's mid or lo runs all nine
        order = term_order(nx, nw)
        hi_apart = apart(n, b_adc) and len(order) > 1
        for k in range(0, K_TILE, K_STEP):
            for mask in masks:
                s = torch.zeros((m, c), dtype=torch.float32)
                for a, b in order[:-1] if hi_apart else order:
                    s = s + (xs[a, :, k:k + K_STEP] * mask) @ ws[b, k:k + K_STEP]
                if hi_apart:            # (0, 0), from 0, then one add
                    s = s + (xs[0, :, k:k + K_STEP] * mask) @ ws[0, k:k + K_STEP]
                acc += adc_ucode(s, n, b_adc)
                conv += 1
    delta = 2.0 * n / 2 ** b_adc
    return (acc - conv * 2 ** (b_adc - 1)).to(torch.float32) * delta


def mma_route_model(x: torch.Tensor, w: torch.Tensor, n: int, b_adc: int,
                    splits: int = 1) -> torch.Tensor:
    """x (M, K), w (K, C) float32 on the CPU, N in {2, 4, 8}, K % N == 0.
    Returns (M, C) float32 as the mma route computes it."""
    m, k = x.shape
    c = w.shape[1]
    assert n in MMA_N and k % n == 0, (n, k)
    kp = -(-k // K_TILE) * K_TILE            # zero-filled k-tiles
    xt = torch.stack(split_terms(torch.nn.functional.pad(x, (0, kp - k))))
    wt = torch.stack(split_terms(torch.nn.functional.pad(w, (0, 0, 0,
                                                              kp - k))))
    k_tiles = kp // K_TILE
    per = -(-k_tiles // splits) if k_tiles else 0
    ranges = ([(i * per * K_TILE, min(kp, (i + 1) * per * K_TILE))
               for i in range(-(-k_tiles // per))] if per else [(0, 0)])
    y = torch.zeros((m, c), dtype=torch.float32)
    for m0 in range(0, m, TILE_M):
        for c0 in range(0, c, TILE_N):
            xs = xt[:, m0:m0 + TILE_M]
            ws = wt[:, :, c0:c0 + TILE_N]
            parts = [_tile(xs, ws, k0, k1, n, b_adc) for k0, k1 in ranges]
            tot = torch.zeros_like(parts[0])
            for p in reversed(parts):
                tot = tot + p
            y[m0:m0 + TILE_M, c0:c0 + TILE_N] = tot
    return y


def pm1(seed: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.where(
        np.random.default_rng(seed).random(shape) < 0.5, 1.0, -1.0
    ).astype(np.float32))
