"""Time the flash attention kernels of the checkout at TREE (its own
`src`) on the card, at the shapes of the float32 route and the bf16
instantiations:

    python3 tools/time_flash.py TREE [--tf32x3] [--others] [--dump DIR]
    python3 tools/time_flash.py --compare A B

Through `ops.flash_attention`, so each tree runs its own route: float32
at (1, 32768, 16, 2, 128) causal (3xTF32, or the CUDA-core kernel of a
tree from before it), bf16 at (1, 32768, 16, 2, 32) and (1, 32768, 16, 2,
16) causal on the same route (16 is the reduced configs' head dim), and
bf16 at zamba2's (1, 32768, 32, 32, 80) causal (the (80, 80) `wgmma`
instantiation; contiguous, then with q and k read through RoPE's strides
as the shared block hands them over, then on the q, k and v that
zamba2-2.7b's shared block projects from random inputs with its seed-0
weights drawn on the card; left out with `--tf32x3`), each beside SDPA
on the same inputs (float32 forced to the memory-efficient backend, KV
repeated to the query heads) and its bound (`chip_smoke.bound`: the
bf16 tensor-core peak, float32 as three TF32 products).  With `--others`
it also times the other bf16 `wgmma` instantiations at their paths'
shapes, all causal: (1, 32768, 16, 2, 128) (qwen2.5-3b), (1, 32768, 16,
16, 192 / 128) (deepseek-v2-lite-16b), (1, 33024, 8, 1, 256) with a
prefix of 256 (paligemma-3b's 256 patches; SDPA without the prefix) and
(1, 32768, 16, 2, 64).  It prints three means of a few launches each
(five at head dim 80), in turns with SDPA.

With `--dump DIR` it also saves, for every (Dh, Dv) of `TC_DIM_PAIRS`,
the `wgmma` output and the bf16 P it fed to P.V on seeded small inputs
(`DUMP_CASES`: a ragged causal sequence, k / v longer than q unmasked,
fewer keys than one tile, a prefix that ends inside a tile, one to three
key tiles, q scaled by 4) to DIR/flash_<tree>.pt; `--compare A B` then
says, key by key, whether two such files hold equal tensors.  To compare
two versions, run it on one machine for each tree in turns (A, B, B, A).
"""
import subprocess
import sys
from pathlib import Path

if sys.argv[1] == "--compare":
    import torch

    a, b = (torch.load(p) for p in sys.argv[2:4])
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for key in sorted(a):
        print(f"AB compare {key}: {'equal' if torch.equal(a[key], b[key]) else 'NOT equal'}",
              flush=True)
    sys.exit(0)

root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
SEQ = 32768
# name: (B, S, T, H, KV, causal, prefix_len, q scale)
DUMP_CASES = {"causal_2001": (1, 2001, 2001, 4, 2, True, 0, 1.0),
              "full_777x1201": (2, 777, 1201, 4, 2, False, 0, 1.0),
              "short_100": (2, 100, 100, 2, 1, True, 0, 1.0),
              "prefix_200_of_300": (1, 300, 300, 4, 1, True, 200, 1.0),
              "keys_130_of_400": (1, 400, 130, 4, 4, True, 0, 1.0),
              "q_x4_1000": (1, 1000, 1000, 4, 1, True, 0, 4.0)}


def qkv(seed, b, s, t, h, kv, dh, dtype, dv=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, s, h, dh), (b, t, kv, dh), (b, t, kv, dv or dh))]


def heads(x, rep=1):
    return x.transpose(1, 2).repeat_interleave(rep, 1).contiguous()


def shared_block_qkv():
    """q, k, v of zamba2-2.7b's shared attention on 1 x SEQ random inputs,
    as `lm._shared_block_fwd` projects them."""
    from repro_torch.configs import registry
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm
    from repro_torch.models.lm import _zamba_attn_cfg, init_lm

    cfg = registry.get("zamba2-2.7b")
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    with torch.inference_mode():
        x = torch.randn((1, SEQ, cfg.d_model), generator=g,
                        device=dev).bfloat16()
        sh = params.shared
        return attn._project_qkv(sh.attn, apply_norm(sh.ln1, x, cfg.norm),
                                 _zamba_attn_cfg(cfg),
                                 torch.arange(SEQ, device=dev))


def case(what, dtype, h, kv, dh, reps, rope=False, given=None, dv=None,
         seq=SEQ, prefix_len=0):
    q, k, v = given or qkv(0, 1, seq, seq, h, kv, dh, dtype, dv)
    if rope:                          # heads-major memory, (B, S, n, Dh) view
        q, k = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k))
    qh, kh, vh = heads(q), heads(k, h // kv), heads(v, h // kv)

    def sdpa():
        if dtype == torch.float32:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def kernel():
        return fa.flash_attention(q, k, v, prefix_len=prefix_len)

    route = fk.route(dtype, dh, v.shape[-1])
    ms, lib = [], []
    for _ in range(5 if dh == 80 else 3):      # in turns
        ms.append(round(c.cuda_ms(kernel, reps), 4))
        lib.append(round(c.cuda_ms(sdpa, reps), 4))
    err = float((kernel().float() - sdpa().transpose(1, 2).float()).abs().max())
    flops = 2 * (dh + v.shape[-1]) * h * c._visible_pairs(seq, seq, True,
                                                          prefix_len)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    if dtype == torch.float32:        # three TF32 products a float32 one
        b_ms, b_by = c.bound(nbytes, 3 * flops, c.PEAK_TF32_TC_FLOPS)
    else:
        b_ms, b_by = c.bound(nbytes, flops, c.PEAK_BF16_TC_FLOPS)
    mean = sum(ms) / len(ms)
    print(f"AB {root}: {what} ({route}) ms {ms}; SDPA ms {lib}; bound "
          f"{b_ms:.4f} ms ({b_by}), {b_ms / mean:.3f} of it, "
          f"{mean / (sum(lib) / len(lib)):.3f}x SDPA; max |kernel - SDPA| "
          f"{err:.3e}", flush=True)


smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60)
print(f"AB {root}: card {smi.stdout.strip()}", flush=True)
case(f"float32 (1, {SEQ}, 16, 2, 128) causal", torch.float32, 16, 2, 128, 3)
case(f"bf16 (1, {SEQ}, 16, 2, 32) causal", torch.bfloat16, 16, 2, 32, 5)
case(f"bf16 (1, {SEQ}, 16, 2, 16) causal", torch.bfloat16, 16, 2, 16, 5)
if "--tf32x3" not in sys.argv:
    case(f"bf16 (1, {SEQ}, 32, 32, 80) causal", torch.bfloat16, 32, 32, 80,
         10)
    case(f"bf16 (1, {SEQ}, 32, 32, 80) causal, q / k in RoPE's strides",
         torch.bfloat16, 32, 32, 80, 10, rope=True)
    case(f"bf16 (1, {SEQ}, 32, 32, 80) causal, zamba2-2.7b's shared block's "
         f"q / k / v", torch.bfloat16, 32, 32, 80, 10,
         given=shared_block_qkv())

if "--others" in sys.argv:
    case(f"bf16 (1, {SEQ}, 16, 2, 128) causal", torch.bfloat16, 16, 2, 128,
         10)
    case(f"bf16 (1, {SEQ}, 16, 16, 192 / 128) causal", torch.bfloat16, 16,
         16, 192, 10, dv=128)
    case(f"bf16 (1, {SEQ + 256}, 8, 1, 256) causal, prefix 256",
         torch.bfloat16, 8, 1, 256, 10, seq=SEQ + 256, prefix_len=256)
    case(f"bf16 (1, {SEQ}, 16, 2, 64) causal", torch.bfloat16, 16, 2, 64, 10)

if "--dump" in sys.argv:
    out_dir = Path(sys.argv[sys.argv.index("--dump") + 1])
    out_dir.mkdir(parents=True, exist_ok=True)
    saved = {}
    for dh, dv in fk.TC_DIM_PAIRS:
        for name, (b, s, t, h, kv, causal, pre, scale) in DUMP_CASES.items():
            q, k, v = qkv(1, b, s, t, h, kv, dh, torch.bfloat16, dv)
            q = q * scale
            kw = dict(causal=causal, prefix_len=pre)
            tag = f"{dh}_{dv}_{name}"
            out, p = fk.flash_attention_wgmma_p(q, k, v, **kw)
            saved[f"{tag}_out"], saved[f"{tag}_p"] = out.cpu(), p.cpu()
            saved[f"{tag}_out_nodump"] = fk.flash_attention_wgmma(
                q, k, v, **kw).cpu()
    tag = Path(root).resolve().name
    torch.save(saved, out_dir / f"flash_{tag}.pt")
    print(f"AB {root}: saved {len(saved)} tensors to {out_dir}", flush=True)
