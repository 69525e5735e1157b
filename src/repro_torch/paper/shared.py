"""What the paper drivers share: the device argument, a clock read after
the card has finished its queued work, and the card's name and power
limit printed beside a time."""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch.device import resolve_device


def device_args(argv, doc: str) -> argparse.Namespace:
    """`--device` (default the card) parsed from `argv`."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the driver runs (default cuda)")
    return ap.parse_args(argv)


def clock(device: torch.device) -> float:
    """`time.perf_counter()` once `device` has run its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def card_line(device) -> str:
    """`card=<name>, <power limit>` as nvidia-smi gives them for a CUDA
    device, else `card=<device type>`: printed beside every time."""
    device = resolve_device(device)
    if device.type != "cuda":
        return f"card={device.type}"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return f"card={out.stdout.splitlines()[device.index or 0].strip()}"


def fmt(row: dict) -> str:
    """A row as the reference's drivers print it: floats to 4 digits."""
    return ",".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items())
