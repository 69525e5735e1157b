"""Plain PyTorch versions of the flash attention kernel.

- `attention_ref`: the naive oracle of `repro.kernels.flash_attention.ref`
  (float32 scores, softmax, float32 P.V; output in q's dtype).  It holds
  the whole (S, T) score matrix, so it is for small S only.
- `flash_attention_ref`: the blockwise online softmax with the Pallas
  kernel's arithmetic (`repro.kernels.flash_attention.kernel._kernel`):
  q converted to float32 and scaled, S = q K^T in float32, masked
  scores at -1e30, a running (max, sum, acc) in float32, P.V in float32,
  acc / max(sum, 1e-30) cast to q's dtype once.  It is the plain version
  of the 3xTF32 kernel (`csrc/flash_attention.cu`: float32, and bf16 at
  head dims 16 and 32), which scales each score after its product.
- `flash_attention_tc_ref`: the same online softmax with the tensor-core
  kernel's arithmetic (`csrc/flash_attention_wgmma.cu`: bf16 at q/k and
  v head dims 64 / 64, 80 / 80, 128 / 128, MLA's 192 / 128 and 256 /
  256), over
  the instantiation's key tile (`tc_kv_tile`: the tile decides when the
  running max moves, and so which p round to which bf16): raw float32
  scores summed as the tensor cores sum them (`tc_scores`), scaled
  inside `exp2` with log2(e) / sqrt(Dh of q) by one fused rounding, as
  the kernel's `fmaf`, masked scores at -inf, P rounded to bf16 before a
  float32-accumulated P.V, the output rounded once.  The reference's own `_blockwise_core`
  (src/repro/models/attention.py) rounds P to bf16 too.
  `flash_attention_tc_p` returns its bf16 P, and its `p_bf16` argument
  takes a kernel's P in its place.

On a CUDA device the float32 products must be full float32: keep TF32
off (`torch.backends.cuda.matmul.allow_tf32` stays False, PyTorch's
default), or the plain version would round its operands to 10 bits.

Mask (all three): causal, key k visible to query r when k <= r, plus
bidirectional over the first `prefix_len` positions (r < P and k < P),
as `repro.models.attention._blockwise_core`; no mask when not causal.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30
KV_TILE = 64          # keys per block of `flash_attention_ref` (the 3xTF32
                      # kernel's tile below head dim 128; it changes only
                      # the rounding)
TC_KV_TILE = 128      # keys per block: the tensor-core kernel's tile, but
TC_KV_TILES = {(256, 256): 64,   # where two 128-key stages overflow a block
               (80, 80): 128}    # 80-column tiles: 20 KB + 2 x 40 KB


def tc_kv_tile(head_dim: int, v_head_dim: int | None = None) -> int:
    """Keys per tile of the tensor-core instantiation at q/k and v head
    dims (v's defaults to q/k's)."""
    dv = head_dim if v_head_dim is None else v_head_dim
    return TC_KV_TILES.get((head_dim, dv), TC_KV_TILE)


def score_scale_log2(dh: int) -> float:
    """log2(e) / sqrt(Dh) in float32: the factor of a raw score in the
    tensor-core kernel's `exp2` argument."""
    return float(np.float32(np.log2(np.e) / np.sqrt(dh)))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """q: (BH, S, Dh); k/v: (BH, T, Dh).  `prefix_len` (not in the
    reference, which has no prefix) widens the causal mask."""
    dh = q.shape[-1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / float(np.sqrt(dh))
    if causal:
        sq, t = s.shape[1], s.shape[2]
        ri = torch.arange(sq, device=q.device)[:, None]
        ci = torch.arange(t, device=q.device)[None, :]
        mask = (ci <= ri) | ((ri < prefix_len) & (ci < prefix_len))
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, prefix_len: int = 0,
                        block_k: int = KV_TILE) -> torch.Tensor:
    """q / k: (B, S, H, Dh) / (B, T, KV, Dh), v: (B, T, KV, Dv) with H %
    KV == 0; query head h reads KV head h // (H // KV).  Returns (B, S,
    H, Dv) in q's dtype.

    KV blocks of `block_k` keys; the last may be shorter (no padding).
    When causal, a block is applied only to the query rows that can see
    one of its keys (rows >= the block's first key, or every row while
    the block starts inside the prefix): for the other rows every score
    would be masked, p = exp(-1e30 - m) = 0 and the correction 1, so
    skipping them changes no bit."""
    b, s, h, dh = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    scale = 1.0 / dh ** 0.5
    # (B, KV, S*G, Dh): the G query heads of one KV head are adjacent rows
    qf = (q.float() * scale).reshape(b, s, kvh, g, dh).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(b, kvh, s * g, dh)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    acc = torch.zeros((b, kvh, s * g, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kvh, s * g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, s * g), dtype=torch.float32, device=q.device)
    for j0 in range(0, t, block_k):
        r0 = 0 if not causal or j0 < prefix_len else j0
        if r0 >= s:
            break
        kj, vj = kf[:, :, j0:j0 + block_k], vf[:, :, j0:j0 + block_k]
        sc = torch.matmul(qf[:, :, r0 * g:], kj.transpose(-1, -2))
        if causal:
            ri = torch.arange(r0, s, device=q.device).repeat_interleave(g)
            ci = torch.arange(j0, j0 + kj.shape[2], device=q.device)
            vis = (ci[None] <= ri[:, None]) | (
                (ri[:, None] < prefix_len) & (ci[None] < prefix_len))
            sc = torch.where(vis, sc, NEG_INF)
        m_old = m[:, :, r0 * g:]
        m_new = torch.maximum(m_old, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        l_r = l[:, :, r0 * g:]
        l_r.mul_(corr).add_(p.sum(-1))
        acc_r = acc[:, :, r0 * g:]
        acc_r.mul_(corr[..., None]).add_(torch.matmul(p, vj))
        m_old.copy_(m_new)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(b, kvh, s, g, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, h, dv).to(q.dtype)


def _rows(p: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, H, S, T) -> (B, KV, S*G, T): the plain versions' row order."""
    b, h, s, t = p.shape
    g = h // kvh
    return p.reshape(b, kvh, g, s, t).permute(0, 1, 3, 2, 4).reshape(
        b, kvh, s * g, t)


TC_K_STEP = 16      # head-dim elements a tensor-core product step sums


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def tc_scores(qd: torch.Tensor, kd: torch.Tensor) -> torch.Tensor:
    """q k^T (..., R, T) float32 from float64 q (..., R, D) and k (..., T,
    D) holding bf16 values, summed as the tensor cores sum it: for each
    step of TC_K_STEP head-dim elements (one `wgmma` k16), the exact sum
    of its products (in float64) added to the float32 accumulator,
    rounded toward zero.  On the H100 this leaves P one bf16 step from
    the kernel's on ~6x fewer entries than a float32 product does."""
    acc = None
    for c0 in range(0, qd.shape[-1], TC_K_STEP):
        part = torch.matmul(qd[..., c0:c0 + TC_K_STEP],
                            kd[..., c0:c0 + TC_K_STEP].transpose(-1, -2))
        acc = _toward_zero(part if acc is None else acc.double() + part)
    return acc


def _tc_online(q, k, v, causal, prefix_len, block_k, p_in, p_out):
    b, s, h, dh = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    c2 = score_scale_log2(dh)
    neg_inf = float("-inf")
    qf = q.double().reshape(b, s, kvh, g, dh).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(b, kvh, s * g, dh)
    kf = k.double().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    acc = torch.zeros((b, kvh, s * g, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kvh, s * g), neg_inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, s * g), dtype=torch.float32, device=q.device)
    for j0 in range(0, t, block_k):
        r0 = 0 if not causal or j0 < prefix_len else j0
        if r0 >= s:
            break
        kj, vj = kf[:, :, j0:j0 + block_k], vf[:, :, j0:j0 + block_k]
        sc = tc_scores(qf[:, :, r0 * g:], kj)
        if causal:
            ri = torch.arange(r0, s, device=q.device).repeat_interleave(g)
            ci = torch.arange(j0, j0 + kj.shape[2], device=q.device)
            vis = (ci[None] <= ri[:, None]) | (
                (ri[:, None] < prefix_len) & (ci[None] < prefix_len))
            sc = torch.where(vis, sc, neg_inf)
        m_old = m[:, :, r0 * g:]
        m_new = torch.maximum(m_old, sc.amax(-1))
        m_use = torch.where(m_new == neg_inf, 0.0, m_new)
        # exp2f(fmaf(s, c2, -m c2)): s c2 is exact in float64, one rounding
        arg = sc.double() * c2 - (m_use * c2).double()[..., None]
        p = torch.exp2(arg.float())
        corr = torch.exp2((m_old - m_use) * c2)
        l_r = l[:, :, r0 * g:]
        l_r.mul_(corr).add_(p.sum(-1))
        pb = p.to(torch.bfloat16)
        if p_out is not None:
            p_out[:, :, r0 * g:, j0:j0 + block_k] = pb
        if p_in is not None:
            pb = p_in[:, :, r0 * g:, j0:j0 + block_k]
        acc_r = acc[:, :, r0 * g:]
        acc_r.mul_(corr[..., None]).add_(torch.matmul(pb.float(), vj))
        m_old.copy_(m_new)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(b, kvh, s, g, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, h, dv).to(q.dtype)


def flash_attention_tc_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           prefix_len: int = 0, block_k: int | None = None,
                           p_bf16: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """q / k: (B, S, H, Dh) / (B, T, KV, Dh), v: (B, T, KV, Dv) with H %
    KV == 0; query head h reads KV head h // (H // KV).  Returns (B, S,
    H, Dv) in q's dtype.  With Dv < Dh it equals this function on v
    zero-padded to Dh with the padding sliced off the output (MLA's
    prefill, which the reference pads so).

    Per KV block of `block_k` keys (default: the instantiation's tile,
    `tc_kv_tile(Dh, Dv)`), with c = `score_scale_log2(Dh)`:
    s = q K^T (unscaled; `tc_scores`: per 16 head-dim elements the exact
    sum of the products added to a float32 sum rounded toward zero, as
    `wgmma` accumulates), masked entries -inf, m the running row max of s
    (0 in place of -inf where a row has seen no visible key), p =
    exp2(fma(s, c, -m c)) (one rounding of the argument, as the kernel's
    `fmaf`), corr = exp2((m_old - m) c),
    l = l corr + sum(p) and acc = acc corr + bf16(p) V in float32;
    out = acc / max(l, 1e-30) cast to q's dtype once.  Blocks are skipped
    for rows that see none of their keys, as in `flash_attention_ref`.

    `p_bf16` (B, H, S, T) bf16, if given, is used in P.V in place of
    bf16(p) (m, corr and l stay this function's): with the P a kernel
    fed to its own P.V (`kernel.flash_attention_wgmma_p`), what is left
    between the two is float32 summation order."""
    kvh = k.shape[2]
    p_in = None if p_bf16 is None else _rows(p_bf16, kvh)
    block_k = block_k or tc_kv_tile(q.shape[3], v.shape[3])
    return _tc_online(q, k, v, causal, prefix_len, block_k, p_in, None)


def flash_attention_tc_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, prefix_len: int = 0,
                         block_k: int | None = None) -> torch.Tensor:
    """The bf16(p) that `flash_attention_tc_ref` feeds to P.V, (B, H, S,
    T) bf16: p relative to the running max of its `block_k` block
    (default `tc_kv_tile(Dh, Dv)`), 0 for masked keys and for blocks a row
    does not reach."""
    block_k = block_k or tc_kv_tile(q.shape[3], v.shape[3])
    b, s, h, _ = q.shape
    t, kvh = k.shape[1], k.shape[2]
    p_out = torch.zeros((b, kvh, s * (h // kvh), t), dtype=torch.bfloat16,
                        device=q.device)
    _tc_online(q, k, v, causal, prefix_len, block_k, None, p_out)
    g = h // kvh
    return p_out.reshape(b, kvh, s, g, t).permute(0, 1, 3, 2, 4).reshape(
        b, h, s, t)
