"""Time the flash attention kernels of the checkout at TREE (its own
`src`) on the card, at the shapes of the float32 route and the (80, 80)
instantiation:

    python3 tools/time_flash.py TREE [--tf32x3] [--others] [--dump DIR]

Through `ops.flash_attention`, so each tree runs its own route: float32
at (1, 32768, 16, 2, 128) causal (3xTF32, or the CUDA-core kernel of a
tree from before it), bf16 at (1, 32768, 16, 2, 32) causal on the same
route, and bf16 at zamba2's (1, 32768, 32, 32, 80) causal (the (80, 80)
`wgmma` instantiation; contiguous, then with q and k read through RoPE's
strides as the shared block hands them over, then on the q, k and v
that zamba2-2.7b's shared block projects from random inputs with its
seed-0 weights drawn on the card; left out with `--tf32x3`), each beside
SDPA on the same inputs
(float32 forced to the memory-efficient backend, KV repeated to the
query heads).  With `--others` it also times the other bf16
instantiations at their paths' shapes: (1, 32768, 16, 2, 128), (1,
32768, 16, 16, 192 / 128) and (1, 32768, 8, 1, 256), all causal.  It
prints three means of a few launches each (five at head dim 80).  With `--dump DIR` it also
saves the (80, 80) instantiation's output and the bf16 P it fed to P.V
on seeded small inputs to DIR/flash80_<tree>.pt; `--compare A B` then
says whether two such files hold equal tensors.  To compare two
versions, run it on one machine for each tree in turns (A, B,
B, A).
"""
import sys
from pathlib import Path

if sys.argv[1] == "--compare":
    import torch

    a, b = (torch.load(p) for p in sys.argv[2:4])
    for key in a:
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


def case(what, dtype, h, kv, dh, reps, rope=False, given=None, dv=None):
    q, k, v = given or qkv(0, 1, SEQ, SEQ, h, kv, dh, dtype, dv)
    if rope:                          # heads-major memory, (B, S, n, Dh) view
        q, k = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k))
    qh, kh, vh = heads(q), heads(k, h // kv), heads(v, h // kv)

    def sdpa():
        if dtype == torch.float32:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    route = fk.route(dtype, dh, v.shape[-1])
    ms, lib = [], []
    for _ in range(5 if dh == 80 else 3):      # in turns
        ms.append(round(c.cuda_ms(lambda: fa.flash_attention(q, k, v), reps), 4))
        lib.append(round(c.cuda_ms(sdpa, reps), 4))
    err = float((fa.flash_attention(q, k, v).float()
                 - sdpa().transpose(1, 2).float()).abs().max())
    print(f"AB {root}: {what} ({route}) ms {ms}; SDPA ms {lib}; max |kernel "
          f"- SDPA| {err:.3e}", flush=True)


case(f"float32 (1, {SEQ}, 16, 2, 128) causal", torch.float32, 16, 2, 128, 3)
case(f"bf16 (1, {SEQ}, 16, 2, 32) causal", torch.bfloat16, 16, 2, 32, 5)
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
    case(f"bf16 (1, {SEQ}, 8, 1, 256) causal", torch.bfloat16, 8, 1, 256, 10)

if "--dump" in sys.argv:
    out_dir = Path(sys.argv[sys.argv.index("--dump") + 1])
    out_dir.mkdir(parents=True, exist_ok=True)
    saved = {}
    for name, (b, s, t, h, kv, causal) in {
            "causal_4001": (1, 4001, 4001, 4, 4, True),
            "full_777x1201": (2, 777, 1201, 4, 2, False)}.items():
        q, k, v = qkv(1, b, s, t, h, kv, 80, torch.bfloat16)
        out, p = fk.flash_attention_wgmma_p(q, k, v, causal=causal)
        saved[f"{name}_out"], saved[f"{name}_p"] = out.cpu(), p.cpu()
        saved[f"{name}_out_nodump"] = fk.flash_attention_wgmma(
            q, k, v, causal=causal).cpu()
    tag = Path(root).resolve().name
    torch.save(saved, out_dir / f"flash80_{tag}.pt")
    print(f"AB {root}: saved {sorted(saved)} to {out_dir}", flush=True)
