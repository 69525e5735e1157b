"""Hold the float32 flash attention route (3xTF32 tensor cores) of the
checkout at TREE against float32 and float64 references on the card, at
the scores of q as drawn and of q scaled by 4 (magnitude ~30):

    python3 tools/flash_accuracy.py TREE

(1) At (4, 4096, 16, 2, 128), (1, 32768, 16, 2, 128) and (4, 4096, 16,
2, 64), causal, through `ops.flash_attention`: the largest |kernel -
flash_attention_ref| and its ratio to the card tests' bound (atol = rtol
= 2e-5), and on the last 256 query rows of KV head 0 (the rows that see
the most keys) the largest error of the kernel and of
`flash_attention_ref` against attention in float64.

(2) At (1, 4096, 1, 1, 128) causal: the kernel against models of its
arithmetic run on the card, each a `wgmma` as the exact (float64) sum of
its products added to the float32 accumulator and rounded toward zero,
as the H100's tensor cores add (`ref.tc_scores` holds the bf16 kernel
to the same rule).  P.V goes into the accumulator, which is flushed into
O in float32: "first design" at the end only, each k8 step's three
products in turn; "kernel" every 512 keys at head dim 128 (every tile
below), the small products (hi.lo, lo.hi) of a chain before its hi.hi
products, as `csrc/flash_attention.cu` now runs; "nearest" the first
design rounded to nearest.  The model whose outputs lie closest to the
kernel's is the one that describes it.
"""
import sys

root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch  # noqa: E402

from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
RTOL = 2e-5


def qkv(seed, b, s, h, kv, dh, q_scale, on=dev):
    g = torch.Generator(device=on).manual_seed(seed)
    q = torch.randn((b, s, h, dh), generator=g, device=on) * q_scale
    k, v = (torch.randn((b, s, kv, dh), generator=g, device=on)
            for _ in range(2))
    return q.to(dev), k.to(dev), v.to(dev)


def exact_rows(q, k, v, rows):
    """Causal attention in float64 for query rows `rows` of (S, Dh) q."""
    s = (q[rows].double() @ k.double().T) / q.shape[-1] ** 0.5
    vis = torch.arange(k.shape[0], device=dev)[None] <= rows[:, None]
    return torch.softmax(torch.where(vis, s, float("-inf")), -1) @ v.double()


def tf32_hi(x):
    return (x.view(torch.int32) & ~0x1fff).view(torch.float32)


def add(acc, part, toward_zero):
    """acc + part (float64) rounded to float32 (toward zero, or nearest)."""
    x = part if acc is None else acc.double() + part
    r = x.float()
    if toward_zero:
        r = torch.where(r.double().abs() > x.abs(),
                        torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def chain(a, b, acc, small_first, toward_zero):
    """acc + a @ b as 3xTF32 `wgmma` k8 steps, in the kernel's order."""
    ah, bh = tf32_hi(a), tf32_hi(b)
    al, bl = tf32_hi(a - ah), tf32_hi(b - bh)
    ks = [slice(k0, k0 + 8) for k0 in range(0, a.shape[-1], 8)]
    hh = [(ah[:, s], bh[s]) for s in ks]
    small = [(x[:, s], y[s]) for s in ks for x, y in ((ah, bl), (al, bh))]
    order = (small + hh if small_first else
             [t for i in range(len(ks)) for t in (hh[i], small[2 * i],
                                                   small[2 * i + 1])])
    for x, y in order:
        acc = add(acc, x.double() @ y.double(), toward_zero)
    return acc


def model(q, k, v, design):
    """The kernel's arithmetic on (S, Dh) float32 q, k, v, causal: P.V
    into the accumulator (rescaled first), flushed into O in float32 as O
    = O cs + acc every `flush` tiles."""
    toward_zero = design != "nearest"
    s_len, dh = q.shape
    bk = 32 if dh > 64 else 64
    if design == "kernel":
        flush, small_first = (512 // bk if dh > 64 else 1), True
    else:
        flush, small_first = s_len, False
    scale = torch.tensor(1.0 / dh ** 0.5).float().item()
    rows = torch.arange(s_len, device=dev)
    acc, out = torch.zeros_like(q), torch.zeros_like(q)
    cs = torch.ones(s_len, device=dev)
    m = torch.full((s_len,), float("-inf"), device=dev)
    l = torch.zeros(s_len, device=dev)
    for n, j0 in enumerate(range(0, s_len, bk)):
        kj, vj = k[j0:j0 + bk], v[j0:j0 + bk]
        sc = chain(q, kj.T.contiguous(), None, small_first,
                   toward_zero) * scale
        vis = (torch.arange(j0, j0 + kj.shape[0], device=dev)[None]
               <= rows[:, None])
        sc = torch.where(vis, sc, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        mu = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(sc - mu[:, None])
        corr = torch.exp(m - mu)
        l = l * corr + p.sum(-1)
        cs = cs * corr
        acc = chain(p, vj, acc * corr[:, None], small_first, toward_zero)
        m = m_new
        if (n + 1) % flush == 0:
            out = torch.addcmul(acc, out, cs[:, None])
            acc, cs = torch.zeros_like(acc), torch.ones_like(cs)
    out = torch.addcmul(acc, out, cs[:, None])
    return out / torch.clamp(l, min=1e-30)[:, None]


for b, s, dh in ((4, 4096, 128), (1, 32768, 128), (4, 4096, 64)):
    for q_scale in (1.0, 4.0):
        q, k, v = qkv(s + dh, b, s, 16, 2, dh, q_scale)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa_ref.flash_attention_ref(q, k, v, causal=True)
        d = (got - want).abs()
        ratio = float((d / (RTOL + RTOL * want.abs())).max())
        rows = torch.arange(s - 256, s, device=dev)
        ex = exact_rows(q[0, :, 0], k[0, :, 0], v[0, :, 0], rows)
        e_k = float((got[0, s - 256:, 0].double() - ex).abs().max())
        e_r = float((want[0, s - 256:, 0].double() - ex).abs().max())
        print(f"ACC {root}: ({b}, {s}, 16, 2, {dh}) causal q x {q_scale:g} "
              f"({fk.route(q.dtype, dh)}): max |kernel - plain| "
              f"{float(d.max()):.3e}, "
              f"{ratio:.3f} of the bound; last 256 rows of head 0 against "
              f"float64: kernel {e_k:.3e}, plain {e_r:.3e}", flush=True)
        del q, k, v, got, want, d

for q_scale in (1.0, 4.0):
    q, k, v = (x[0, :, 0] for x in qkv(11, 1, 4096, 1, 1, 128, q_scale))
    got = fa.flash_attention(q[None, :, None], k[None, :, None],
                             v[None, :, None], causal=True)[0, :, 0]
    ex = exact_rows(q, k, v, torch.arange(4096, device=dev))
    text = [f"float64 {float((got.double() - ex).abs().max()):.3e}"]
    for design in ("first design", "kernel", "nearest"):
        mo = model(q, k, v, design)
        text.append(f"{design} {float((got - mo).abs().max()):.3e} (model - "
                    f"float64 {float((mo.double() - ex).abs().max()):.3e})")
    print(f"ACC {root}: (1, 4096, 1, 1, 128) causal q x {q_scale:g}: max "
          f"|kernel - x| for x = " + "; ".join(text), flush=True)
