"""Dry-run: every (arch x shape x production mesh) cell sized without
running it.

Counterpart of `repro.launch.dryrun` without XLA.  The reference lowers
and compiles each cell on 512 forced host devices and reads XLA's memory
and cost analyses and the collectives of the compiled HLO; the port has
no compiler to ask, so each cell records (JSON in `runs/dryrun_torch/`):
  * `memory`: the bytes one position holds as arguments, exact to the
    byte: its shards of the state (`steps.make_train_state_struct`; for
    prefill and decode the bf16 serving weights, and the decode state
    under `decode_state_specs`) and of the batch (`batch_specs`), and
    `fits_80gb` on them.  Temporaries are not modeled: `temp_bytes` is
    null, so a cell that fits here can still run out at run time;
  * `analytic`: the roofline model's FLOPs and HBM bytes
    (`roofline_model.cell_cost`) over the H100's peaks
    (`core/constants.py`);
  * `collectives`: the bytes a position sends in the port's sharded
    train step (`steps.make_train_step(cfg, mesh)`), as ring collectives
    would move them: per microbatch, each parameter's all-gather ((n -
    1) / n of its gathered bytes, n its distinct pieces, a position
    reading the one it holds from itself; under tensor
    parallelism a leaf split on whole units over "model" is gathered
    over the other axes only, its "model" piece of 1 / m of it, a packed
    leaf's cut (`sharding.model_cut`) from the positions that hold its
    parts, and a leaf that only a group's first position uses not at
    all on the others), a layer's leaf's re-gather for its backward
    ("re-gather": the same bytes again; the leaves outside the layers
    are gathered once), its grad's reduce-scatter (the all-gather's
    bytes) and,
    among the r positions holding one piece, an all-reduce (2 (r - 1) /
    r of the piece); and under tensor parallelism over a "model" axis of
    m > 1 the activations' collectives of each model group
    (`tensor_parallel.activation_collectives`: a layer's attention and
    MLP partials all-reduced forward and backward (the MoE's combine
    with its always-on FFNs' columns, the Mamba2 mixer's `out_proj` and
    its norm's sum of squares, the mLSTM's `down`, whisper's
    cross-attention), the attention's again in remat's recompute, the
    mLSTM's all-gathers and reduce-scatters, the sLSTM's broadcast and
    reduce, the embedding's and the cross-entropy's); for the MoE
    family over dp groups of more than one, each MoE layer's router
    statistics all-reduced over the dp axes once a microbatch (2 E + 1
    float32: the load-balance term is the whole microbatch's); with int8
    moments, for each leaf split on its last dimension, each moment's
    block maxima all-reduced among its column pieces once a step (the
    scale row a position holds, float32; `steps.split_last`).
    `collective_s` puts them on one NVLink direction (450 GB/s) where
    the mesh fits one node (`NODE_POSITIONS`, the eight cards of an
    H100 node); the production meshes span 32 and
    64 nodes, and links between nodes are not modeled (no inter-node
    bandwidth is stated in the repo), so their `collective_s` is null
    while their bytes are recorded.  Null for prefill and decode, which
    have no sharded step in the port;
  * `roofline`: the terms, the dominant one, the 6 N D model FLOPs, the
    useful-FLOPs ratio and the roofline fraction, under the reference's
    keys, and `dominant_over`, the terms the dominant one and the
    roofline fraction were taken over: compute and memory only wherever
    `collective_s` is null.
`gathered_bytes`, `grad_sum_bytes` and `card_peak_bytes` reckon what a
position holds at once in the step, beside the state: one layer's
gathered leaves and those outside the layers, and its grad sums; the
peak leaves out activations and what backward keeps of them, the bf16
copies the model makes of float32 leaves, logits and the cross-entropy's
temporaries, AdamW's temporaries of one leaf, the batch, and what the
allocator caches or fragments.
The reference's `collective_bytes` parses HLO text; the port has no HLO,
so it has no counterpart.  The reference's keys with nothing to report
here (`lower_s`, `compile_s`, `cost`, `hlo_bytes`) are null.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only]
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import registry as creg
from repro_torch.core.constants import (H100_HBM_BW, H100_NVLINK_BW,
                                        H100_PEAK_BF16_FLOPS)
from repro_torch.launch import shapes as shp
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import STACKED, n_stacked_layers, stacked_ndim
from repro_torch.models.registry import build_model, count_params, meta_model
from repro_torch.parallel import tensor_parallel
from repro_torch.parallel.sharding import (cut_overlaps, holders,
                                           make_policy, model_cut,
                                           model_local, shard_count,
                                           shard_shape)

RUNS = pathlib.Path(__file__).resolve().parents[3] / "runs" / "dryrun_torch"
FITS_BYTES = 80e9         # the H100's 80 GB of HBM3
NODE_POSITIONS = 8        # cards on one NVLink domain (an H100 node)


def model_flops(cfg, shape: shp.ShapeSpec) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = batch tokens per
    step."""
    n = count_params(cfg, active_only=cfg.moe is not None)
    if shape.kind == "train":
        return 6.0 * n * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n * shape.batch * shape.seq
    return 2.0 * n * shape.batch        # decode: one token per sequence


def analytic_terms(cfg, shape: shp.ShapeSpec, chips: int) -> dict:
    from repro_torch.launch.roofline_model import cell_cost

    cost = cell_cost(cfg, shape)
    return {
        "flops_global": cost.flops,
        "hbm_bytes_global": cost.hbm_bytes,
        "compute_s": cost.flops / (chips * H100_PEAK_BF16_FLOPS),
        "memory_s": cost.hbm_bytes / (chips * H100_HBM_BW),
    }


def _leaves(tree, specs):
    """(leaf, spec) pairs of a struct tree and its spec tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k])
    else:
        yield tree, specs


def _shard_bytes(mesh, pairs) -> int:
    """One position's bytes of (`TensorSpec` or host int, spec) pairs; a
    host int is the reference's int32 scalar.  Raises `ValueError` where
    a dim does not divide (the batch specs carry no guard)."""
    total = 0
    for leaf, spec in pairs:
        if not hasattr(leaf, "shape"):
            total += 4
            continue
        shape = tuple(leaf.shape)
        for e, n in zip(spec, shape):
            parts = shard_count(mesh, (e,))
            if n % parts:
                raise ValueError(f"a dim of {n} over {parts} positions")
        itemsize = torch.empty((), dtype=leaf.dtype).element_size()
        total += int(np.prod(shard_shape(mesh, spec, shape))) * itemsize
    return total


@functools.lru_cache(maxsize=None)
def _serving_params(cfg) -> dict:
    """The bf16 serving weights' `TensorSpec` tree (kept per config; not
    to be modified)."""
    return convert.train_state_tree(
        {"params": meta_model(cfg, torch.bfloat16)}, spec=True)["params"]


def position_bytes(cfg, shape: shp.ShapeSpec, mesh, **step_kw) -> dict:
    """The argument bytes one position of `mesh` holds for the cell:
    `state_bytes` (train: its shards of params, moments, count and step
    under `make_policy(mesh, cfg, fsdp=, model_strategy=)`; prefill
    and decode: of the bf16 serving weights, and decode's state),
    `batch_bytes` (train and prefill: its rows of the batch; decode: of
    the tokens) and their sum `argument_bytes`."""
    policy = _policy(cfg, mesh, step_kw)
    if shape.kind == "train":
        struct, specs = steps_mod.make_train_state_struct(
            cfg, policy, step_kw.get("opt_cfg")
            or steps_mod.default_opt_cfg(cfg))
        state = _shard_bytes(mesh, _leaves(struct, specs))
    else:
        params = _serving_params(cfg)
        state = _shard_bytes(mesh, _leaves(params,
                                           policy.param_specs(params)))
    if shape.kind == "decode":
        dstate = build_model(cfg).init_decode_state(shape.batch, shape.seq,
                                                    device="meta")
        state += _shard_bytes(mesh, _leaves(
            dstate, policy.decode_state_specs(dstate, shape.batch)))
        rules = policy.activation_rules(decode_batch=shape.batch)
        tokens = shp.TensorSpec((shape.batch,), torch.int32)
        batch = _shard_bytes(mesh, [(tokens, (rules["batch"],))])
    else:
        bstruct = shp.batch_struct(cfg, shape)
        if shape.kind == "prefill":
            bstruct.pop("targets")
        batch = _shard_bytes(mesh, _leaves(bstruct,
                                           policy.batch_specs(bstruct)))
    return {"state_bytes": state, "batch_bytes": batch,
            "argument_bytes": state + batch}


def _policy(cfg, mesh, step_kw: dict):
    return make_policy(mesh, cfg, fsdp=step_kw.get("fsdp"),
                       model_strategy=step_kw.get("model_strategy", "tp"))


def _model_group(cfg, mesh, policy):
    """(m, the `tensor_parallel.Layout`) of the step's model groups: m
    the positions a group, the layout None where m is 1 or the family
    has no local form."""
    specs = policy.named_param_specs(
        steps_mod._master_named(cfg, steps_mod.meta_params(cfg)))
    dp = int(np.prod([mesh.shape[a] for a in policy.dp_axes]))
    m = mesh.size // dp
    return m, (tensor_parallel.layout(cfg, specs, mesh) if m > 1 else None)


def _group_first(mesh, policy, flat: int) -> bool:
    """Whether position `flat` is its model group's first (its "model"
    coordinate 0 where "model" is outside the dp axes)."""
    return ("model" not in mesh.axis_names or "model" in policy.dp_axes
            or mesh.coords(flat)["model"] == 0)


def _gather_dtype(name: str, p, cast: bool) -> torch.dtype:
    """The dtype a leaf moves in: `COMPUTE_DTYPE` where the compute cast
    takes it (float32 of stacked rank >= 2), else its own."""
    return steps_mod.COMPUTE_DTYPE if (
        cast and p.dtype == torch.float32
        and stacked_ndim(name, p) >= 2) else p.dtype


def _held(cfg, mesh, policy, named: dict, specs: dict, m: int, lay,
          flat: int, cast: bool) -> dict:
    """{name: (the bytes position `flat` holds of it for its loss, the
    bytes of it it reads from other positions)}: a whole leaf, its
    "model" piece or its cut, in the gather's dtype; none of a leaf
    only a group's first position uses, where `flat` is not that."""
    first = _group_first(mesh, policy, flat)
    out = {}
    for name, p in named.items():
        if lay is not None and not first and \
                tensor_parallel.first_only(cfg, name):
            continue
        spec = specs[name]
        n = shard_count(mesh, spec)
        item = torch.empty((), dtype=_gather_dtype(name, p, cast)
                           ).element_size()
        nbytes = p.numel() * item
        local = lay is not None and model_local(mesh, cfg, name, spec)
        cut = model_cut(mesh, cfg, name, spec, tuple(p.shape), flat) \
            if local else None
        if cut is not None:
            held = int(np.prod([sum(s.stop - s.start for s in segs)
                                for segs in cut])) * item
            read = sum(int(np.prod([s.stop - s.start for s in src])) * item
                       for _, owners, src, _ in cut_overlaps(
                           mesh, spec, tuple(p.shape), cut)
                       if flat not in owners)
        elif local:
            pieces = n // m
            held, read = nbytes // m, (pieces - 1) / pieces * nbytes / m
        else:
            held, read = nbytes, (n - 1) / n * nbytes
        out[name] = (held, read)
    return out


def held_bytes(cfg, mesh, *, position: int = 0, **step_kw) -> dict:
    """{name: bytes} of the leaves position `position` holds for its loss
    in the step's model group (`steps.TrainStep.held` after a call)."""
    policy = _policy(cfg, mesh, step_kw)
    cast = policy.compute_dtype_cast or step_kw.get("cast_bf16", False)
    named = steps_mod._master_named(cfg, steps_mod.meta_params(cfg))
    m, lay = _model_group(cfg, mesh, policy)
    held = _held(cfg, mesh, policy, named, policy.named_param_specs(named),
                 m, lay, position, cast)
    return {n: h for n, (h, _) in held.items()}


def gathered_bytes(cfg, mesh, *, position: int = 0, **step_kw) -> dict:
    """The most bytes of gathered leaves position `position` holds at
    once in the step: its leaves outside the blocks (`outside`: the
    embedding, head, final norm, zamba2's shared block, whisper's
    norms and tables), gathered for the whole forward and backward, and
    one block's (`block`: the largest layer of `lm.STACKED`), gathered
    where it runs and again for its backward; `alive` their sum, which
    `steps.TrainStep.alive` stays within."""
    out, block = 0, {}
    for name, nbytes in held_bytes(cfg, mesh, position=position,
                                   **step_kw).items():
        head = name.split(".", 2)
        if head[0] in STACKED:
            key = (head[0], head[1])
            block[key] = block.get(key, 0) + nbytes
        else:
            out += nbytes
    most = max(block.values(), default=0)
    return {"outside": out, "block": most, "alive": out + most}


def grad_sum_bytes(cfg, mesh, *, position: int = 0, **step_kw) -> int:
    """The bytes of the grad sums position `position` holds in the step
    (`steps.TrainStep.sum_bytes`): one a distinct piece of every leaf
    whose first holder it is, in `steps.accum_dtype`."""
    policy = _policy(cfg, mesh, step_kw)
    named = steps_mod._master_named(cfg, steps_mod.meta_params(cfg))
    specs = policy.named_param_specs(named)
    item = torch.empty((), dtype=steps_mod.accum_dtype(cfg)).element_size()
    total = 0
    for name, p in named.items():
        shape = shard_shape(mesh, specs[name], tuple(p.shape))
        firsts = sum(owners[0] == position for owners in
                     holders(mesh, specs[name]).values())
        total += firsts * int(np.prod(shape)) * item
    return total


def card_peak_bytes(cfg, shape: shp.ShapeSpec, mesh, **step_kw) -> dict:
    """{device: the bytes the step holds on it at once, as reckoned}:
    over the positions on that device, each one's state
    (`position_bytes`), grad sums (`grad_sum_bytes`) and gathered
    leaves at once (`gathered_bytes`).  Left out: activations and what
    backward keeps of them (remat: one (B, S, D) input a layer), the
    bf16 copies the model makes of float32 leaves, logits and the
    cross-entropy's temporaries, AdamW's float32 temporaries of one leaf,
    the batch, and what the allocator caches or fragments."""
    step_kw = {k: v for k, v in step_kw.items() if k != "microbatches"}
    state = position_bytes(cfg, shape, mesh, **step_kw)["state_bytes"]
    out: dict = {}
    for f in range(mesh.size):
        dev = str(mesh.device(f))
        out[dev] = out.get(dev, 0) + state + grad_sum_bytes(
            cfg, mesh, position=f, **step_kw) + gathered_bytes(
            cfg, mesh, position=f, **step_kw)["alive"]
    return out


def train_collectives(cfg, mesh, *, microbatches: int,
                      shape: shp.ShapeSpec | None = None, remat: bool = True,
                      position: int = 0, **step_kw) -> dict:
    """The bytes position `position` (default 0, a model group's first)
    sends in the port's sharded train step (see the module's docstring)
    on a batch of `shape` (needed for the activations' collectives of
    model groups), by collective kind, and how many of each it runs."""
    policy = _policy(cfg, mesh, step_kw)
    cast = policy.compute_dtype_cast or step_kw.get("cast_bf16", False)
    named = steps_mod._master_named(cfg, steps_mod.meta_params(cfg))
    specs = policy.named_param_specs(named)
    m, lay = _model_group(cfg, mesh, policy)
    kinds = ("all-gather", "re-gather", "reduce-scatter", "all-reduce") + \
        tensor_parallel.ACTIVATION_KINDS + ("router all-reduce",
                                            "scale all-reduce")
    out = {k: 0.0 for k in kinds}
    count = {k: 0 for k in out}
    held = _held(cfg, mesh, policy, named, specs, m, lay, position, cast)
    for name, p in named.items():
        n = shard_count(mesh, specs[name])
        r = mesh.size // n
        _, read = held.get(name, (0, 0.0))
        if read > 0:
            kinds = ("all-gather", "reduce-scatter") + (
                ("re-gather",) if name.split(".", 1)[0] in STACKED else ())
            for kind in kinds:
                out[kind] += microbatches * read
                count[kind] += microbatches
        if r > 1:
            nbytes = p.numel() * torch.empty(
                (), dtype=_gather_dtype(name, p, cast)).element_size()
            out["all-reduce"] += microbatches * 2 * (r - 1) / r * nbytes / n
            count["all-reduce"] += microbatches
    if lay is not None:
        if shape is None:
            raise ValueError("the activations' collectives need the shape")
        rows = shape.batch // (microbatches * (mesh.size // m))
        for kind, (sent, calls) in tensor_parallel.activation_collectives(
                cfg, lay, m, rows, shape.seq, remat=remat).items():
            out[kind] = microbatches * sent
            count[kind] = microbatches * calls
    dp = mesh.size // m
    if cfg.moe is not None and dp > 1:
        layers = microbatches * n_stacked_layers(cfg)
        out["router all-reduce"] = layers * 2 * (dp - 1) / dp * (
            2 * cfg.moe.n_experts + 1) * 4
        count["router all-reduce"] = layers
    opt_cfg = step_kw.get("opt_cfg") or steps_mod.default_opt_cfg(cfg)
    for name in steps_mod.split_last(mesh, specs, opt_cfg):
        # each moment's block maxima, the scale row a position holds,
        # all-reduced among the r column pieces once a step
        spec, shape = specs[name], tuple(named[name].shape)
        r = shard_count(mesh, spec[-1:])
        row = shape[:-1] + (-(-shape[-1] // opt_cfg.quant_block),)
        nbytes = int(np.prod(shard_shape(mesh, spec[:-1] + (None,), row))) * 4
        out["scale all-reduce"] += 2 * 2 * (r - 1) / r * nbytes
        count["scale all-reduce"] += 2
    return {"bytes": out, "count": count,
            "total_bytes": sum(out.values())}


def collective_seconds(coll: dict | None, mesh) -> float | None:
    """`coll`'s bytes a position over one NVLink direction where `mesh`
    fits one node; None where it spans nodes (links between nodes are
    not modeled) or where there are no collectives."""
    if coll is None or mesh.size > NODE_POSITIONS:
        return None
    return coll["total_bytes"] / H100_NVLINK_BW


def _step_kw(cfg, shape: shp.ShapeSpec, variant: str) -> dict:
    kw = dict(microbatches=shp.microbatches_for(cfg, shape))
    if variant == "perf":
        kw.update(steps_mod.PERF_TRAIN_OVERRIDES.get(cfg.name, {}))
    return kw


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             variant: str = "", out_dir=None) -> dict:
    """One cell's record, written to `out_dir` (default `RUNS`) as
    `<arch>__<shape>__<mesh>[__<variant>].json`."""
    cfg = creg.get(arch)
    shape = shp.SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_dir = pathlib.Path(out_dir or RUNS)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    out_path = out_dir / (f"{creg.canonical(arch)}__{shape_name}__{mesh_name}"
                          f"{suffix}.json")
    ok, why = shp.applicable(cfg, shape)
    rec = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind}
    if not ok:
        rec.update(status="skip", reason=why)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    kw = _step_kw(cfg, shape, variant) if shape.kind == "train" else {}
    try:
        mem = position_bytes(cfg, shape, mesh, **kw)
    except ValueError as e:       # a batch that does not divide the dp axes
        rec.update(status="error", error=f"ValueError: {e}")
        out_path.write_text(json.dumps(rec, indent=1))
        return rec
    coll = (train_collectives(cfg, mesh, shape=shape, **kw)
            if shape.kind == "train" else None)
    ana = analytic_terms(cfg, shape, chips)
    terms = {"compute_s": ana["compute_s"], "memory_s": ana["memory_s"],
             "collective_s": collective_seconds(coll, mesh)}
    modeled = {k: v for k, v in terms.items() if v is not None}
    dominant = max(modeled, key=modeled.get)
    mf = model_flops(cfg, shape)
    rec.update(
        status="ok", chips=chips, lower_s=None, compile_s=None,
        memory={**mem, "output_bytes": None, "temp_bytes": None,
                "alias_bytes": None, "total_bytes": mem["argument_bytes"],
                "fits_80gb": bool(mem["argument_bytes"] < FITS_BYTES)},
        cost=None,
        analytic=ana,
        collectives=coll,
        roofline={**terms, "dominant": dominant,
                  "dominant_over": sorted(modeled),
                  "model_flops_global": mf,
                  "useful_flops_ratio": mf / max(ana["flops_global"], 1.0),
                  "roofline_fraction": mf / max(ana["flops_global"], 1.0)
                  * ana["compute_s"] / max(max(modeled.values()), 1e-30)},
        hlo_bytes=None,
    )
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape, on both production meshes")
    ap.add_argument("--multi-pod-only", action="store_true",
                    help="only the 2x16x16 multi-pod mesh")
    ap.add_argument("--variant", default="",
                    help="'perf' applies PERF_TRAIN_OVERRIDES; results get a "
                         "__perf suffix")
    ap.add_argument("--out-dir", default=None,
                    help=f"where the records go (default {RUNS})")
    args = ap.parse_args(argv)

    archs = creg.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(shp.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [True] if args.multi_pod_only else [False, True]

    rows = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, variant=args.variant,
                               out_dir=args.out_dir)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r, sent = rec["roofline"], rec["collectives"]
                    coll = r["collective_s"]
                    if coll is not None:
                        coll_txt = f"coll={coll:.3e}s "
                    elif sent is not None:     # bytes, no link modeled
                        coll_txt = (f"coll={sent['total_bytes'] / 1e9:.2f}GB"
                                    f"/dev,unmodeled ")
                    else:
                        coll_txt = "coll=none "
                    over = "" if coll is not None else " (of comp, mem)"
                    extra = (f"dom={r['dominant'] + over:<25s} "
                             f"comp={r['compute_s']:.3e}s "
                             f"mem={r['memory_s']:.3e}s " + coll_txt
                             + f"bytes/dev="
                             f"{rec['memory']['total_bytes'] / 1e9:.2f}GB")
                elif status == "error":
                    extra = rec["error"][:140]
                else:
                    extra = rec.get("reason", "")
                print(f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:10s} "
                      f"{status:5s} {extra}", flush=True)
                rows.append(rec)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    n_skip = sum(r["status"] == "skip" for r in rows)
    print(f"\n{n_ok} ok, {n_err} error, {n_skip} skip / {len(rows)} cells")
    return rows


if __name__ == "__main__":
    main()
