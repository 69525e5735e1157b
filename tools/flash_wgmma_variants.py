"""Build variants of the bf16 tensor-core flash attention kernel
(`src/repro_torch/csrc/flash_attention_wgmma.cu`), each with one step of
its consumer schedule undone, and time them on the card in turns beside
SDPA, at the paths' shapes of the two instantiations the schedule was
redesigned for:

    python3 tools/flash_wgmma_variants.py [--base TREE] [--all] [--ab]

Variants: the source as it stands; with `--base`, TREE's source (its
`src/repro_torch/csrc/flash_attention_wgmma.cu`: say, of the commit a
change starts from);
"no pairs" (256 / 256 without its clusters of two query heads that
multicast K and V); "no overlap" (each consumer waits for its P.V before
its softmax: `wgmma_wait<1>` made `wgmma_wait<0>`); "ping-pong nowhere"
and "ping-pong everywhere" (the consumers' turns by named barriers, the
`ping_pong` predicate, off or on at every head dim); "rescale every
tile" (O multiplied by corr on every tile, the skip's vote forced true);
"registers 40 / 232" (the producer's and consumers' `setmaxnreg` of the
loop before this schedule).  `--ab` keeps the source and the base only,
for twice the turns.  Each is built with `_build.NVCC_FLAGS` into
build/variants_wgmma/, all at once, and its ptxas lines of the
non-dumping instantiations (registers, spills) and every warning
printed.

Shapes, causal: (1, 33024, 8, 1, 256 / 256) with a prefix of 256
(paligemma-3b's 1 x (256 + 32768) prefill) and (1, 32768, 16, 16, 192 /
128) (deepseek-v2-lite-16b's 1 x 32768); with `--all` also (1, 32768, 16,
2, 128 / 128) (qwen2.5-3b's), (1, 32768, 16, 2, 64 / 64) and (1, 32768,
32, 32, 80 / 80) (zamba2-2.7b's).  Each variant's output at each shape is
checked bit-equal to the source's; SDPA runs causal without the prefix,
KV repeated to the query heads.  `TURNS` turns of `REPS` launches of
each, every name in every place of the order by turns, timed launch by
launch: each turn's mean, and the median and least launch over all
turns (on the H100 the turns of one binary vary by ~5 %: read medians).
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

SRC = "src/repro_torch/csrc/flash_attention_wgmma.cu"
WAIT1 = ("    wgmma_wait<1>();                  // S_kt has landed",
         "    wgmma_wait<0>();                  // S_kt has landed")
TURNS_AT = "  return dh == 80 && dv == 80;"
VOTE = ("if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))",
        "if (true)")
REGS = ("constexpr int kProducerRegs = 24, kConsumerRegs = 240;",
        "constexpr int kProducerRegs = 40, kConsumerRegs = 232;")
PAIRS = ("if (KV > 0 && H % KV == 0 && (H / KV) % 2 == 0)", "if (false)")
VARIANTS = {"as it stands": [], "no pairs": [PAIRS], "no overlap": [WAIT1],
            "ping-pong nowhere": [(TURNS_AT, "  return false;")],
            "ping-pong everywhere": [(TURNS_AT, "  return true;")],
            "rescale every tile": [VOTE],
            "registers 40 / 232": [REGS]}
REPS = 10
TURNS = 8
# (label, B, S, H, KV, Dh, Dv, prefix)
SHAPES = [("256 / 256", 1, 33024, 8, 1, 256, 256, 256),
          ("192 / 128", 1, 32768, 16, 16, 192, 128, 0)]
MORE = [("128 / 128", 1, 32768, 16, 2, 128, 128, 0),
        ("64 / 64", 1, 32768, 16, 2, 64, 64, 0),
        ("80 / 80", 1, 32768, 32, 32, 80, 80, 0)]


def sources() -> dict[str, str]:
    src = (ROOT / SRC).read_text()
    out = {}
    for name, subs in VARIANTS.items():
        if "--ab" in sys.argv and subs:
            continue
        text = src
        for old, new in subs:
            assert old in text, old
            text = text.replace(old, new)
        out[name] = text
    if "--base" in sys.argv:
        tree = Path(sys.argv[sys.argv.index("--base") + 1])
        out["base"] = (tree / SRC).read_text()
    return out


def build(texts: dict[str, str]) -> dict[str, object]:
    out_dir = ROOT / "build" / "variants_wgmma"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        lib = out_dir / f"libv{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        report(name, log)
        f = ctypes.CDLL(str(lib)).flash_attention_wgmma
        f.argtypes = fk._ARGTYPES["flash_attention_wgmma"]
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def report(name: str, log: str) -> None:
    """The ptxas lines of each non-dumping instantiation, and every
    warning."""
    inst = None
    for line in log.splitlines():
        if "warning" in line:
            print(f"VAR {name}: {line.strip()}", flush=True)
        hit = re.search(r"flash_attention_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                        r"ELb([01])E", line)
        if hit:
            inst = hit.groups()
        elif inst and inst[3] == "0" and ("spill" in line or "Used" in line):
            print(f"VAR {name}: <{inst[0]}, {inst[1]}, {inst[2]}> "
                  f"{line.strip()}", flush=True)


def launch_ms(fn, reps: int) -> list[float]:
    """Device ms of each of `reps` back-to-back calls of `fn` (after one
    warm-up call), from CUDA events between the launches."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]


def inputs(dev, b, s, h, kv, dh, dv):
    g = torch.Generator(device=dev).manual_seed(0)
    return [torch.randn(shape, generator=g, device=dev).bfloat16()
            for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dv))]


def main() -> None:
    fns = build(sources())
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"VAR card: {smi.stdout.strip()}", flush=True)
    for label, b, s, h, kv, dh, dv, pre in SHAPES + (
            MORE if "--all" in sys.argv else []):
        q, k, v = inputs(dev, b, s, h, kv, dh, dv)
        out = torch.empty((b, s, h, dv), dtype=torch.bfloat16, device=dev)
        strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                          *v.stride()[:3])
        scale = fa_ref.score_scale_log2(dh)

        def call(f):
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            rc = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   strides, b, s, s, h, kv, dh, dv, 1, pre, scale, None,
                   stream)
            assert rc == 0, rc

        call(fns["as it stands"])
        torch.cuda.synchronize()
        want = out.clone()
        for name, f in fns.items():
            call(f)
            torch.cuda.synchronize()
            print(f"VAR {label}: {name} output "
                  f"{'equal' if torch.equal(out, want) else 'NOT equal'} to "
                  f"the source's", flush=True)
        qh, kh, vh = (x.transpose(1, 2).repeat_interleave(r, 1).contiguous()
                      for x, r in ((q, 1), (k, h // kv), (v, h // kv)))
        runs = {name: (lambda f=f: call(f)) for name, f in fns.items()}
        runs["SDPA"] = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)
        ms = {name: [] for name in runs}
        launches = {name: [] for name in runs}
        names = list(runs)
        for turn in range(TURNS * (2 if "--ab" in sys.argv else 1)):
            # each name takes each place in the order by turns
            order = names[turn % len(names):] + names[:turn % len(names)]
            for name in (order if turn % 2 == 0 else order[::-1]):
                each = launch_ms(runs[name], REPS)
                launches[name] += each
                ms[name].append(round(sum(each) / REPS, 4))
        pairs = c._visible_pairs(s, s, True, pre)
        flops = 2 * (dh + dv) * h * b * pairs
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2
        b_ms, b_by = c.bound(nbytes, flops, c.PEAK_BF16_TC_FLOPS)
        print(f"VAR {label} ({b}, {s}, {h}, {kv}) causal prefix {pre}: bound "
              f"{b_ms:.4f} ms ({b_by}: {flops:.4e} flops)", flush=True)
        for name, t in ms.items():
            each = sorted(launches[name])
            med = each[len(each) // 2]
            print(f"VAR {label}: {name} ms {t}; median launch {med:.4f} "
                  f"(min {each[0]:.4f}), {b_ms / med:.3f} of the bound",
                  flush=True)
        del q, k, v, qh, kh, vh, out, want


if __name__ == "__main__":
    main()
