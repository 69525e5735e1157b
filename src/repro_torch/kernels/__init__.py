"""Hand-written Hopper kernels of the port, one family per folder.

Each family keeps the shape of the JAX package's kernel families:
`ref.py` holds the plain PyTorch version, `kernel.py` the `ctypes`
wrapper of the CUDA C++ kernel in `repro_torch/csrc/`, and `ops.py`
pads the inputs and calls the wrapper.  A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches its
kernel or raises.

`LAUNCHES` counts kernel launches by kernel name.  A wrapper adds one
through `count_launch` where it launches its kernel and nowhere else,
so a caller that zeroes the counts before a run can show which kernels
the run went through.  The design service launches from several
threads at once, so the increment holds `LOCK` (a bare `+= 1` on the
Counter is a read-modify-write that can lose updates between threads).
Each wrapper module loads its library once, under a lock of its own.
"""
import collections
import threading

LAUNCHES: collections.Counter = collections.Counter()
LOCK = threading.Lock()


def count_launch(name: str, n: int = 1) -> None:
    """Add `n` launches of kernel `name` to `LAUNCHES`, under `LOCK`."""
    with LOCK:
        LAUNCHES[name] += n
