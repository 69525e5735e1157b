"""Build the port's CUDA sources with `nvcc` and load them with `ctypes`.

Each `repro_torch/csrc/<name>.cu` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The library lands in `build/kernels/` at the repository root, named by
a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built at import time: the first
wrapper call on a CUDA tensor builds what it needs, and `build_all`
starts one `nvcc` per source at once for callers that want everything
up front.  Every C entry point returns `cudaGetLastError()` after its
launch; `launch` calls one with its tensor's device current and
`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("pareto_dom", "maze_route", "acim_matmul", "acim_matmul_wgmma",
           "acim_matmul_mma", "flash_attention", "flash_attention_wgmma")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build on a machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library of `names`, one `nvcc` each, all
    started together.  Returns {name: compiler output} for the sources
    built now (the `-Xptxas -v` register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _start(n) for n in names if not _target(n).exists()}
    logs = {}
    for n, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{log}")
        os.replace(tmp, out)
        (BUILD_DIR / f"{out.stem}.log").write_text(log)
        logs[n] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero `cudaError_t` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of tensor `t`'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(t, fn, what: str, *args) -> None:
    """Call the C entry point `fn(*args, stream)` with tensor `t`'s device
    current and that device's current stream last, then `check` its
    return code.  An entry point launches on the calling thread's current
    device, and CUDA refuses a launch into a stream of another device, so
    every wrapper's C call goes through here: a kernel then runs on
    `cuda:1` or on any card of a mesh, whichever device is current."""
    import torch

    with torch.cuda.device(t.device):
        check(fn(*args, stream_ptr(t)), what)
