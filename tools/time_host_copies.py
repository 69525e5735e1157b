"""Time `chip_smoke.py` phase 18 (the "tp" train step of qwen3-8b on
1x1, 1x4 and 2x2-FSDP meshes of the card) with its host copies in
page-locked and in pageable memory, in turns, after phase 17:

    python3 tools/time_host_copies.py

Phase 18 keeps the float32 masters and the 1x1 step's grads on the host
and moves them across PCIe once a mesh.  `chip_smoke._pinned_buffers`
puts them in one page-locked buffer; this swaps it for pageable tensors
of the same shapes in turns (pageable, pinned, pinned, pageable) and
prints each phase's wall time and its per-mesh lines (the state's
upload, the step with and without the grads read out, the peak).  The
losses, grads and bytes are checked as in the smoke, so both sides must
print the same numerics.  Needs one card; ~3 min.
"""
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def pageable(like: dict) -> dict:
    return {n: torch.empty(t.shape, dtype=t.dtype) for n, t in like.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    pinned = chip_smoke._pinned_buffers
    t0 = time.perf_counter()
    chip_smoke.mesh_train_phase("card")
    print(f"phase 17 wall {time.perf_counter() - t0:.2f} s", flush=True)
    for name, fn in (("pageable", pageable), ("pinned", pinned),
                     ("pinned", pinned), ("pageable", pageable)):
        chip_smoke._pinned_buffers = fn
        t0 = time.perf_counter()
        out = chip_smoke.tp_train_phase("card")
        print(f"== phase 18 {name}: {time.perf_counter() - t0:.2f} s {out}",
              flush=True)
    chip_smoke._pinned_buffers = pinned
    return 0


if __name__ == "__main__":
    sys.exit(main())
