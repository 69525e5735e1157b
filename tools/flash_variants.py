"""Build variants of the 3xTF32 flash attention kernel
(`src/repro_torch/csrc/flash_attention.cu`), each with one tuning constant
changed, and time them on the card in turns at (1, 32768, 16, 2, 128)
causal float32, beside their largest error against `flash_attention_ref`
over the card tests' bound (atol = rtol = 2e-5) with q as drawn and
scaled by 4:

    python3 tools/flash_variants.py

Variants: the source as it stands; O flushed from the tensor cores'
accumulator every 256 keys, every 1024 and never (`kFlushKeys`); the
producer warpgroup at 104 and 112 registers a thread (`producer_regs`).
Each is built with `_build.NVCC_FLAGS` into build/variants/, all at once,
and its ptxas spill line printed.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

FLUSH = "constexpr int kFlushKeys = 512;"
PRODUCER = ("__host__ __device__ constexpr int producer_regs(int) "
            "{ return 120; }")
VARIANTS = {"as it stands": [],
            "flush every 256 keys": [(FLUSH, FLUSH.replace("512", "256"))],
            "flush every 1024 keys": [(FLUSH, FLUSH.replace("512", "1024"))],
            "no flush": [(FLUSH, FLUSH.replace("512", "(1 << 30)"))],
            "producer 104": [(PRODUCER, PRODUCER.replace("120", "104"))],
            "producer 112": [(PRODUCER, PRODUCER.replace("120", "112"))]}

src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
out_dir = ROOT / "build" / "variants"
out_dir.mkdir(parents=True, exist_ok=True)
procs = {}
for i, (name, subs) in enumerate(VARIANTS.items()):
    text = src
    for old, new in subs:
        assert old in text, old
        text = text.replace(old, new)
    cu = out_dir / f"v{i}.cu"
    cu.write_text(text)
    procs[name] = (out_dir / f"libv{i}.so", subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"libv{i}.so"),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
fns = {}
for name, (lib, proc) in procs.items():
    log, _ = proc.communicate()
    assert proc.returncode == 0, log
    lines = log.splitlines()
    spill = [lines[j + 1].strip() for j, line in enumerate(lines[:-1])
             if "Function properties" in line and "ILi128EfE" in line]
    print(f"VAR {name}: Dh 128 float32 {spill}", flush=True)
    f = ctypes.CDLL(str(lib)).flash_attention
    f.argtypes = fk._ARGTYPES["flash_attention"]
    f.restype = ctypes.c_int
    fns[name] = f

dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
b, s, h, kv, dh = 1, 32768, 16, 2, 128
k = torch.randn((b, s, kv, dh), generator=g, device=dev)
v = torch.randn((b, s, kv, dh), generator=g, device=dev)
out = torch.empty((b, s, h, dh), device=dev)
strides = (ctypes.c_longlong * 9)(s * h * dh, h * dh, dh,
                                  *k.stride()[:3], *v.stride()[:3])
scale = float(torch.tensor(1.0 / dh ** 0.5).float())


def call(f, q):
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
           b, s, s, h, kv, dh, 0, 1, 0, scale, stream)
    assert rc == 0, rc


for q_scale in (1.0, 4.0):
    q = torch.randn((b, s, h, dh), generator=g, device=dev) * q_scale
    want = fa_ref.flash_attention_ref(q, k, v)
    for name, f in fns.items():
        call(f, q)
        torch.cuda.synchronize()
        ratio = float(((out - want).abs() / (2e-5 + 2e-5 * want.abs())).max())
        print(f"VAR {name}: q x {q_scale:g}: {ratio:.3f} of the bound",
              flush=True)
ms = {name: [] for name in fns}
for order in (list(fns), list(reversed(fns)), list(fns)):
    for name in order:
        ms[name].append(round(c.cuda_ms(lambda: call(fns[name], q), 3), 3))
for name, t in ms.items():
    print(f"VAR {name}: ms {t}", flush=True)
