"""Carry the reference's state into the port.

The design flow has no weights: its state is the calibration and the
request.  The LM substrate has weights (the reference's `init_lm`
pytree, or `init_whisper`'s), an optimizer state and an architecture
config.  These
functions take the JAX package's values in plain form (numpy arrays,
dicts) so the two packages can compute on the same operands, and give
the port's weights and train state back in the reference's stacked
layout (so a checkpoint moves both ways); they import nothing of the
JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.request import DesignRequest
from repro_torch.configs import base as configs
from repro_torch.core.estimator import CalOperands
from repro_torch.core.nsga2 import SpaceOperands
from repro_torch.launch.shapes import TensorSpec
from repro_torch.models.lm import STACKED


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def space_operands_from_numpy(d: dict):
    """The reference's `SpaceOperands` or `CalOperands` leaves as numpy
    arrays -> the port's tensors.

    `d` maps the reference's field names to arrays: the 14
    `CalOperands` fields give a `CalOperands`; `array_size`, `gene_lo`,
    `gene_hi` and `cal` (a dict of the 14) give a `SpaceOperands`.
    Leaves keep their shape, so a batch stacked by the reference stays
    a batch (one leading cell dimension)."""
    if "cal" in d:
        return SpaceOperands(
            array_size=_tensor(d["array_size"]).to(torch.float32),
            gene_lo=_tensor(d["gene_lo"]).to(torch.int32),
            gene_hi=_tensor(d["gene_hi"]).to(torch.int32),
            cal=space_operands_from_numpy(d["cal"]))
    return CalOperands(**{k: _tensor(d[k]).to(torch.float32)
                          for k in CalOperands._fields})


def request_from_dict(d: dict) -> DesignRequest:
    """The reference's `DesignRequest.to_dict()` -> the port's request."""
    return DesignRequest.from_dict(d)


_SUB_CONFIGS = {"moe": configs.MoEConfig, "mla": configs.MLAConfig,
                "ssm": configs.SSMConfig, "xlstm": configs.XLSTMConfig,
                "hybrid": configs.HybridConfig, "encdec": configs.EncDecConfig,
                "vlm": configs.VLMConfig}


def arch_config_from_dict(d: dict) -> configs.ArchConfig:
    """`dataclasses.asdict` of the reference's `ArchConfig` -> the port's."""
    d = dict(d)
    for k, cls in _SUB_CONFIGS.items():
        if d.get(k) is not None:
            d[k] = cls(**d[k])
    return configs.ArchConfig(**d)


# ---------------------------------------------------------------------------
# LM weights and the train state: the reference's stacked pytree <-> the
# port's per-layer tensors
# ---------------------------------------------------------------------------
def _leaf_tensor(x) -> torch.Tensor:
    return x.detach().clone() if isinstance(x, torch.Tensor) else _tensor(x)


def _is_quantized(v) -> bool:
    return isinstance(v, dict) and set(v) == {"q", "s"}


def _paths(tree: dict, prefix: tuple = ()):
    """(path, leaf) of a nested dict in key order; a quantized moment
    `{"q", "s"}` is one leaf."""
    for k, v in tree.items():
        if isinstance(v, dict) and not _is_quantized(v):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat: dict) -> dict:
    """{path tuple: leaf} -> nested dicts with sorted keys (the order of a
    JAX pytree of dicts)."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def order(t):
        return {k: order(t[k]) if isinstance(t[k], dict) else t[k]
                for k in sorted(t)}

    return order(tree)


def _unstack(tree: dict) -> dict:
    """A tree in the reference's layout (numpy or torch leaves; the
    leaves of `blocks`, `enc_blocks` and `dec_blocks` (`lm.STACKED`)
    stacked on a leading layer axis) -> {state-dict name: leaf}: layer
    i's slice becomes `blocks.<i>.<path>` (`enc_blocks.<i>.<path>`, ...);
    a quantized moment stays a `{"q", "s"}` dict of tensors."""
    out = {}
    for path, leaf in _paths(tree):
        items = leaf.items() if _is_quantized(leaf) else ((None, leaf),)
        for sub, x in items:
            if path[0] in STACKED:
                rest = ".".join(path[1:])
                pieces = [(f"{path[0]}.{i}.{rest}", x[i])
                          for i in range(x.shape[0])]
            else:
                pieces = [(".".join(path), x)]
            for name, y in pieces:
                if sub is None:
                    out[name] = _leaf_tensor(y)
                else:
                    out.setdefault(name, {})[sub] = _leaf_tensor(y)
    return out


def _stack_fns(named: dict, spec: bool = False) -> dict:
    """{state-dict name: tensor or quantized dict} -> {reference path: a
    function of no arguments giving the stacked leaf on the CPU}, or with
    `spec` the leaf's `TensorSpec` (nothing copied)."""
    layers: dict = {}
    flat = {}
    for name, v in named.items():
        items = v.items() if _is_quantized(v) else ((None, v),)
        for sub, t in items:
            tail = () if sub is None else (sub,)
            top, _, rest = name.partition(".")
            if top in STACKED:
                i, _, rest = rest.partition(".")
                path = (top,) + tuple(rest.split(".")) + tail
                layers.setdefault(path, {})[int(i)] = t
            else:
                flat[tuple(name.split(".")) + tail] = (
                    TensorSpec(tuple(t.shape), t.dtype) if spec
                    else lambda t=t: t.detach().cpu())
    for path, by_layer in layers.items():
        ts = [by_layer[i] for i in range(len(by_layer))]
        flat[path] = (
            TensorSpec((len(ts),) + tuple(ts[0].shape), ts[0].dtype) if spec
            else lambda ts=ts: torch.stack([t.detach().cpu() for t in ts]))
    return flat


def lm_params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """The reference's `init_lm` (or `init_whisper`) pytree with numpy
    leaves -> a state dict of `repro_torch.models.lm.LM` (or
    `repro_torch.models.whisper.Whisper`) (`load_state_dict`).

    `blocks` (whisper's `enc_blocks` and `dec_blocks`) holds every
    layer's leaves stacked on a leading layer axis; layer i's slice
    becomes `blocks.<i>.<path>`.  Nested dicts become dotted names; the
    leaves keep their dtype (float32)."""
    return _unstack(tree)


def lm_params_to_numpy(params) -> dict:
    """The inverse of `lm_params_from_numpy`: an `LM` or `Whisper` (or its
    state dict) -> the reference's pytree, numpy leaves, the layer
    subtrees stacked.
    numpy has no bfloat16: bf16 leaves are widened to float32 (the
    reference's checkpoint widens them on disk the same way)."""
    named = dict(params.named_parameters()) if isinstance(
        params, torch.nn.Module) else params
    return _to_numpy(_nest({p: f() for p, f in _stack_fns(named).items()}))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def opt_state_from_numpy(tree: dict) -> dict:
    """The reference's AdamW state `{"m", "v", "count"}` (numpy leaves)
    -> the port's (`repro_torch.optim.adamw`): moments keyed by `LM`
    state-dict names, count an int32 0-dim tensor."""
    return {"m": _unstack(tree["m"]), "v": _unstack(tree["v"]),
            "count": torch.as_tensor(np.asarray(tree["count"]),
                                     dtype=torch.int32).clone()}


def opt_state_to_numpy(opt: dict) -> dict:
    """The inverse of `opt_state_from_numpy` (bf16 moments widened to
    float32 as in `lm_params_to_numpy`)."""
    return _to_numpy(train_state_tree({"opt": opt})["opt"])


def train_state_tree(state: dict, *, lazy: bool = False,
                     spec: bool = False) -> dict:
    """The port's train state (`train.trainer.init_state`: an `LM`, the
    AdamW state, the step) -> the reference's train-state pytree
    `{"opt": {"count", "m", "v"}, "params", "step"}` with CPU tensor
    leaves, `blocks` stacked.  With `lazy`, each leaf is a function of no
    arguments that makes it, so a checkpoint holds one stacked leaf in
    host memory at a time (`checkpoint.ckpt.save` calls them); with
    `spec`, each leaf is its `TensorSpec` (a `ckpt.restore` target)."""
    flat = {}
    if "params" in state:
        params = state["params"]
        named = dict(params.named_parameters()) if isinstance(
            params, torch.nn.Module) else params
        flat.update({("params",) + p: f
                     for p, f in _stack_fns(named, spec).items()})
    scalars = {}
    if "opt" in state:
        opt = state["opt"]
        for k in ("m", "v"):
            flat.update({("opt", k) + p: f
                         for p, f in _stack_fns(opt[k], spec).items()})
        scalars[("opt", "count")] = opt["count"]
    if "step" in state:
        scalars[("step",)] = torch.as_tensor(state["step"], dtype=torch.int32)
    for path, t in scalars.items():
        flat[path] = (TensorSpec((), torch.int32) if spec
                      else lambda t=t: t.detach().cpu())
    if spec or lazy:
        return _nest(flat)
    return _nest({p: f() for p, f in flat.items()})


def load_train_state(tree: dict, state: dict) -> dict:
    """Copy a train-state pytree in the reference's layout (numpy or
    tensor leaves, as `checkpoint.ckpt.restore` gives it) into the port's
    `state` in place: parameters (a module, or a dict of tensors keyed
    by state-dict names), moments, count and step.  Shapes must match;
    values are cast to the state's dtypes."""
    params = state["params"]
    named = dict(params.named_parameters()) if isinstance(
        params, torch.nn.Module) else params
    src = _unstack(tree["params"])
    if set(src) != set(named):
        raise ValueError(f"parameters differ: {sorted(set(src) ^ set(named))}")
    with torch.no_grad():
        for n, p in named.items():
            _copy_leaf(p, src[n], n)
        for k in ("m", "v"):
            mom = _unstack(tree["opt"][k])
            for n, dst in state["opt"][k].items():
                if isinstance(dst, dict):
                    for sub in ("q", "s"):
                        _copy_leaf(dst[sub], mom[n][sub], f"{k}.{n}.{sub}")
                else:
                    _copy_leaf(dst, mom[n], f"{k}.{n}")
    state["opt"]["count"] = _leaf_tensor(tree["opt"]["count"]).to(
        torch.int32).to(state["opt"]["count"].device)
    state["step"] = _leaf_tensor(tree["step"]).to(torch.int32).to(
        torch.as_tensor(state["step"]).device)
    return state


def _copy_leaf(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))
