"""Where the time of one `nsga2_evolve` launch goes, by phase, on the card:

    python3 tools/evolve_phases.py

It copies `src/repro_torch/csrc/pareto_dom.cu` into `build/phase/`,
inserts `clock64` stamps after the block barrier that ends each phase of
the generation loop (thread 0 of block 0 adds the cycles since the last
stamp to a device counter), builds the copy with the port's nvcc flags,
runs the 16 kb request's dispatch (one cell, pop 256, 80 generations) ten
times through the port's wrapper on that library, and prints the cycles
per launch of each phase and their share.  The stamps serialise nothing
beyond the barriers already there; the shipped kernel is not touched.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pareto_dom import kernel  # noqa: E402

OUT = ROOT / "build" / "phase"
# (phase, source line after which its stamp goes): each line ends the
# barrier that closes the phase.
STAMPS = (
    ("tournament", "      win[i] = x_better ? x : y;\n    }\n    __syncthreads();\n"),
    ("variation + estimator",
     "      cur.f[P + i] = objectives(h, l, b, cal);\n    }\n"
     "    __syncthreads();\n"),
    ("rank build", "  for (int j = tid; j < n; j += nthr) rank[j] = -1;\n"
                   "  __syncthreads();\n"),
    ("rank peel", "    ++front;\n    if (!__syncthreads_or(left)) break;\n"
                  "  }\n"),
    ("crowding keys", "                    : kPadKey;\n  }\n"
                      "  __syncthreads();\n"),
    ("crowding sort", "  bitonic_sort(keys, n2, 4);\n"),
    ("crowding fronts", "    if (s == n - 1 || key_rank(keys[s + 1]) != r) "
                        "fend[r] = s;\n  }\n  __syncthreads();\n"),
    ("crowding distances", "    dist[k * n + key_index(row[s])] = d;\n  }\n"
                           "  __syncthreads();\n"),
    ("crowding sum", "        dist[3 * n + i]);\n  __syncthreads();\n"),
    ("selection keys", "                    : kPadKey;\n    __syncthreads();\n"),
    ("selection sort", "    bitonic_sort(keys, L.N2, 1);\n"),
    ("gather", "      nxt.rank[s] = cur.rank[i];\n    }\n"
               "    __syncthreads();\n"),
)


def instrumented_source() -> str:
    src = (_build.CSRC / "pareto_dom.cu").read_text()

    def after(anchor: str, text: str) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)

    after("constexpr uint64_t kPadKey = ~0ull;  // sorts after every real key\n",
          "__device__ unsigned long long g_cyc[16];\n"
          "__shared__ long long s_t0;\n"
          "#define PT(n) do { if (threadIdx.x == 0) { const long long t_ = "
          "clock64(); if (blockIdx.x == 0) g_cyc[n] += t_ - s_t0; s_t0 = t_; "
          "} } while (0)\n")
    after("  uint32_t* alive = reinterpret_cast<uint32_t*>(base + L.alive);\n",
          "  if (threadIdx.x == 0) s_t0 = clock64();\n")
    for k, (_, anchor) in enumerate(STAMPS):
        after(anchor, f"  PT({k});\n")
    return src + ("\nextern \"C\" int phase_cycles(unsigned long long* out) {\n"
                  "  cudaError_t e = cudaMemcpyFromSymbol(out, g_cyc, "
                  "sizeof(g_cyc));\n"
                  "  unsigned long long z[16] = {0};\n"
                  "  cudaMemcpyToSymbol(g_cyc, z, sizeof(z));\n"
                  "  return (int)e;\n}\n")


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "pareto_dom.cu").write_text(instrumented_source())
    lib_path = OUT / "libpareto_dom_phases.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(OUT / "pareto_dom.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.pareto_dom_smem_limit.restype = i
    lib.nsga2_evolve_bytes.argtypes = [i, i]
    lib.nsga2_evolve_bytes.restype = sz
    lib.nsga2_evolve.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.nsga2_evolve.restype = i
    lib.phase_cycles.argtypes = [p]
    kernel._LIB = lib
    dev = torch.device("cuda")
    space, statics, genes, objs, draws = chip_smoke.evolve_inputs(
        dev, (16384,), 256, 80)
    cycles = (ctypes.c_ulonglong * 16)()
    kernel.nsga2_evolve(draws, genes, objs, space, statics)
    torch.cuda.synchronize()
    lib.phase_cycles(cycles)
    reps = 10
    for _ in range(reps):
        kernel.nsga2_evolve(draws, genes, objs, space, statics)
    torch.cuda.synchronize()
    lib.phase_cycles(cycles)
    total = sum(cycles[k] for k in range(len(STAMPS))) / reps
    print(f"nsga2_evolve phases, 16 kb dispatch (pop 256 x 80), cycles per "
          f"launch of block 0 over {reps} launches: {total:.0f} in all")
    for k, (name, _) in enumerate(STAMPS):
        c = cycles[k] / reps
        print(f"  {name:22s} {c:12.0f}  {c / total:.3f}")
    ms = chip_smoke.cuda_ms(lambda: kernel.nsga2_evolve(
        draws, genes, objs, space, statics), 20)
    print(f"instrumented launch: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
