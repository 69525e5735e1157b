"""Hand-written Hopper kernels of the port, one family per folder.

Each family keeps the shape of the JAX package's kernel families:
`ref.py` holds the plain PyTorch version, `kernel.py` the `ctypes`
wrapper of the CUDA C++ kernel in `repro_torch/csrc/`, and `ops.py`
pads the inputs and calls the wrapper.  A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches its
kernel or raises.

`LAUNCHES` counts kernel launches by kernel name.  A wrapper adds one
where it launches its kernel and nowhere else, so a caller that zeroes
the counts before a run can show which kernels the run went through.
"""
import collections

LAUNCHES: collections.Counter = collections.Counter()
