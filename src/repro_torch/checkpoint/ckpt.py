"""Atomic checkpoints in the reference's on-disk format.

Counterpart of `repro.checkpoint.ckpt`; a checkpoint written by either
package restores in the other.  Layout:

    <dir>/step_<n>/       (n as %08d)
        manifest.json     step, leaf names, shapes, dtypes, the tree's
                          structure fingerprint, extra
        arrays.npz        one entry per leaf
    <dir>/LATEST          atomic pointer file (rename-committed)

A tree is a nested dict (the reference's pytree of dicts, e.g. the
train state `convert.train_state_tree` gives).  Leaves are named by the
reference's `jax.tree_util.keystr` of their path (`['params']['blocks']
['attn']['wq']`); bfloat16 leaves are widened to float32 on disk (npz
has no bfloat16) and the manifest keeps "bfloat16"; `restore` casts
back to the target's dtype.  `tree_fingerprint` is the reference's
sha256 of `str(treedef)`, which for nested dicts is
`PyTreeDef({'a': *, 'b': {'c': *}})` with keys sorted.

Atomic: a step is written to `step_<n>.tmp.<pid>`, fsync'd and renamed,
then LATEST is renamed over; `latest_step` falls back to scanning when
LATEST points at a step that never landed.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import zipfile
from typing import Any

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    """{keystr path: leaf} in the pytree's order (dict keys sorted)."""
    flat = {}
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            flat.update(_flatten(v, name))
        else:
            flat[name] = v
    return flat


def _treedef_str(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_str(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def tree_fingerprint(tree: dict) -> str:
    """The reference's structure hash of a pytree of dicts."""
    spec = f"PyTreeDef({_treedef_str(tree)})"
    return hashlib.sha256(spec.encode()).hexdigest()[:16]


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf (tensor, array, or a function of no arguments giving one)
    -> (array as written to disk, dtype name as the manifest keeps it)."""
    if callable(leaf):
        leaf = leaf()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str | os.PathLike, step: int, tree: dict, *,
         extra: dict | None = None) -> pathlib.Path:
    """Write `tree` as step `step` and point LATEST at it.  A leaf may be
    a function of no arguments: it is called when its entry is written,
    so only one leaf need be on the host at a time."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:08d}"
    tmp = d / f"step_{step:08d}.tmp.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    shapes, dtypes = {}, {}
    # np.savez's layout: one `<name>.npy` member a leaf, zip64, stored
    with zipfile.ZipFile(tmp / "arrays.npz", "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, leaf in _flatten(tree).items():
            arr, dtype = _host(leaf)
            shapes[name], dtypes[name] = list(arr.shape), dtype
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
            del arr
    with open(tmp / "arrays.npz", "rb") as f:
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "tree_fingerprint": tree_fingerprint(tree),
        "names": sorted(shapes),
        "shapes": shapes,
        "dtypes": dtypes,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    with open(tmp / "manifest.json", "rb") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    latest_tmp = d / f"LATEST.tmp.{os.getpid()}"
    latest_tmp.write_text(final.name)
    latest_tmp.rename(d / "LATEST")
    return final


def latest_step(directory: str | os.PathLike) -> int | None:
    d = pathlib.Path(directory)
    ptr = d / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (d / name / "manifest.json").exists():
        # fall back to scanning (LATEST may point at a preempted write)
        steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                       if (p / "manifest.json").exists())
        return steps[-1] if steps else None
    return int(name.split("_")[1])


def restore(directory: str | os.PathLike, step: int, target: dict) -> dict:
    """Step `step` as a tree like `target` (leaves with `.shape` and a
    torch `.dtype`: tensors, `launch.shapes.TensorSpec`s): CPU tensors of
    the target's dtypes.  Raises if the tree structures or a shape
    differ."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest["tree_fingerprint"] != tree_fingerprint(target):
        raise ValueError("checkpoint tree structure mismatch")
    flat = {}
    with np.load(d / "arrays.npz") as data:
        for name, struct in _flatten(target).items():
            arr = data[name]
            if tuple(arr.shape) != tuple(struct.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(struct.shape)}")
            flat[name] = torch.from_numpy(arr).to(struct.dtype)
    return _unflatten(target, flat)


def _unflatten(target: dict, flat: dict, prefix: str = "") -> dict:
    return {k: (_unflatten(v, flat, f"{prefix}[{k!r}]")
                if isinstance(v, dict)
                else flat[f"{prefix}[{k!r}]"])
            for k, v in sorted(target.items())}
