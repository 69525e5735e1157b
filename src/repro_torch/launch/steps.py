"""Step builders: the train step, the prefill forward and the decode step
of every family of the LM substrate (dense, MoE, VLM, hybrid, SSM, and
the audio family's encoder-decoder).

Counterpart of `repro.launch.steps`.  The reference jits each step with
the sharding policy of a mesh; the port runs eagerly.  Its prefill and
decode run on one device.  Its train step runs on one device
(`make_train_step(cfg)`) or over a mesh (`make_train_step(cfg, mesh)`,
`launch.mesh.Mesh`: positions of this one process, repeats allowed):
each position holds its shards of the parameters and AdamW moments
under the policy's specs (`parallel.sharding`) and takes its rows of
every microbatch.  Under ZeRO-3 (`model_strategy="fsdp"`) and where the
"model" axis is 1, each position gathers the whole parameters (ZeRO-3:
cast to bf16 before the gather) and runs the loss and the backward
alone.  Under tensor parallelism (`model_strategy="tp"`, the default)
over a "model" axis larger than 1, the positions of a dp index form a
model group that runs one microbatch in lockstep: each position
gathers its "model" piece of the heads, FFN, experts, vocabulary and
mixers over the dp / FSDP axes (a packed leaf's cut: `sharding
.model_cut`) and runs them, partial sums all-reduced
(`parallel.tensor_parallel`).  The
MoE family's load-balance loss is taken over the whole microbatch: its
dp groups' router statistics are summed before the aux loss, and the
microbatch takes one backward.  Each grad is reduce-scattered into the
owning shards as it lands; AdamW then runs on each position's shards
under the global grad norm.
The train step reaches no kernel of ours: the reference's train step
reaches no Pallas kernel either (dense attention, products outside any
kernel), so it is PyTorch and cuBLAS.
"""
from __future__ import annotations

import dataclasses
import functools
import types
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch import shapes as shp
from repro_torch.launch.shapes import ShapeSpec, TensorSpec
from repro_torch.models import lm, whisper
from repro_torch.models.registry import build_model, meta_model
from repro_torch.optim import adamw
from repro_torch.parallel import tensor_parallel
from repro_torch.parallel.sharding import (ShardingPolicy, cut_overlaps,
                                           full_shape, gather_cut,
                                           gather_over, gather_shards,
                                           holders, make_policy, model_cut,
                                           model_local, pieces_in, region,
                                           shard_count, shard_key,
                                           shard_shape, shard_slices,
                                           shard_tensor)


def default_opt_cfg(cfg: ArchConfig) -> adamw.AdamWConfig:
    """Per-arch optimizer memory policy (the reference's): int8 blockwise
    moments for the 480B config, bf16 moments for granite-34b."""
    if cfg.name == "arctic-480b":
        return adamw.AdamWConfig(quantized_moments=True)
    if cfg.name == "granite-34b":
        return adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    return adamw.AdamWConfig()


# master-parameter dtype of a config's leaves of stacked rank >= 2, where
# it is not float32 (the reference's: bf16 for the 480B config, which
# with int8 moments is what fits its sharded state).  Read by the state
# of a mesh (`make_train_state_struct`, `shard_params`); the one-device
# step keeps float32 masters for every config.
PARAM_DTYPE = {"arctic-480b": torch.bfloat16}

# The reference's per-arch logical-rule overrides for training.  Data
# only: they place activations, so they change no result, and the port's
# mesh step places its activations by construction.  It follows the
# policy's "batch" (rows over the dp axes), "heads", "kv_heads", "ffn"
# and "vocab" (over "model" where the policy splits their leaves on
# whole units, `parallel.sharding.model_local`; else the KV heads a
# position's queries read, or the whole leaf) rules; every other rule,
# these two's "embed_carry" among them, it does not (the residual stream
# is whole on every position of a model group).
ARCH_TRAIN_RULES = {
    "arctic-480b": {"embed_carry": "model"},
    "granite-34b": {"embed_carry": "model"},
}

# The reference's per-cell train overrides: ZeRO-3 (the model axis joins
# the FSDP axis, bf16 gathers) and fewer microbatches for the <= 3B
# configs, bf16 parameter casts for arctic.  `launch.train --perf` and
# the dry-run's `variant="perf"` apply them.
PERF_TRAIN_OVERRIDES = {
    "arctic-480b": dict(microbatches=1, cast_bf16=True),
    "qwen2.5-3b": dict(microbatches=1, model_strategy="fsdp"),
    "xlstm-125m": dict(microbatches=1, model_strategy="fsdp"),
    "paligemma-3b": dict(microbatches=1, model_strategy="fsdp"),
    "zamba2-2.7b": dict(microbatches=2, model_strategy="fsdp"),
    "whisper-large-v3": dict(microbatches=1, model_strategy="fsdp"),
}

# The dtype of the compute cast: ZeRO-3's (`ShardingPolicy
# .compute_dtype_cast`, before the gathers) and `cast_bf16`'s.  Read at
# each call, so a float32 cast can be set (with a float32 `lm.BACKBONE`)
# to hold the sharded step's arithmetic tightly.
COMPUTE_DTYPE = torch.bfloat16


def accum_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.name == "arctic-480b" else torch.float32


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainStep:
    fn: Callable[[object, dict], tuple[object, dict]]  # (state, batch) -> ...
    batch_struct: dict       # train_4k's batch as `shapes.TensorSpec`s
    opt_cfg: adamw.AdamWConfig
    device: torch.device     # the one device, or the mesh's first position
    policy: ShardingPolicy | None = None   # a mesh's step only
    # a mesh's step: {position: {name: bytes of the leaf its last loss
    # read}}, written by each call
    held: dict = dataclasses.field(default_factory=dict)


def _view(module: nn.Module, tensors: dict, prefix: str = ""):
    """`module`'s structure with `tensors[name]` at each parameter: a tree
    of namespaces that the model functions read like the module
    (`p.attn.wq`), a `ModuleList` a list.  A namespace, not the module
    with swapped parameters, so a block recomputed under remat reads the
    same tensors."""
    if isinstance(module, nn.ModuleList):
        return [_view(m, tensors, f"{prefix}{i}.")
                for i, m in enumerate(module)]
    out = types.SimpleNamespace()
    for name, _ in module.named_parameters(recurse=False):
        setattr(out, name, tensors[prefix + name])
    for name, m in module.named_children():
        setattr(out, name, _view(m, tensors, f"{prefix}{name}."))
    return out


def _casts(name: str, t) -> bool:
    """Whether the compute cast takes this leaf: float32 of stacked rank
    >= 2 (the reference's `p.ndim >= 2 and p.dtype == float32`)."""
    return t.dtype == torch.float32 and lm.stacked_ndim(name, t) >= 2


def _cast_view(module: nn.Module, dtype: torch.dtype):
    """`module`'s parameters as a `_view`, each float32 leaf of stacked
    rank >= 2 cast to `dtype` (differentiable: the grads reach the
    float32 masters through the cast)."""
    return _view(module, {n: p.to(dtype) if _casts(n, p) else p
                          for n, p in module.named_parameters()})


def make_train_state_struct(cfg: ArchConfig, policy: ShardingPolicy,
                            opt_cfg: adamw.AdamWConfig) -> tuple[dict, dict]:
    """The train state's shapes and dtypes in the reference's layout
    (`{"opt": {"count", "m", "v"}, "params", "step"}`, every layer's
    leaves stacked; `shapes.TensorSpec` leaves) and the spec of each
    leaf under `policy`, from the model on the `meta` device: nothing
    allocated.  Masters take `PARAM_DTYPE` (arctic's bf16); a quantized
    moment is `{"q", "s"}`, "q" with its parameter's spec and "s" with
    that spec but its last entry None."""
    named = _master_named(cfg, meta_params(cfg))
    struct = convert.train_state_tree(
        {"params": named, "opt": adamw.init(named, opt_cfg), "step": 0},
        spec=True)
    pspecs = policy.param_specs(struct["params"])

    def moment_specs(tree):
        if isinstance(tree, dict):
            return {k: moment_specs(v) for k, v in tree.items()}
        if not opt_cfg.quantized_moments:
            return tree
        return {sub: _moment_spec(tree, sub) for sub in ("q", "s")}

    mspecs = moment_specs(pspecs)
    return struct, {"opt": {"count": (), "m": mspecs, "v": mspecs},
                    "params": pspecs, "step": ()}


@functools.lru_cache(maxsize=None)
def _meta_params(cfg: ArchConfig) -> tuple:
    return tuple(meta_model(cfg).named_parameters())


def meta_params(cfg: ArchConfig) -> dict:
    """{state-dict name: parameter on `meta`} of `cfg`'s model (kept per
    config: arctic's meta model takes seconds to build)."""
    return dict(_meta_params(cfg))


def _master_named(cfg: ArchConfig, named: dict) -> dict:
    """The masters of a mesh's state: `named` with `PARAM_DTYPE` applied
    to the float32 leaves of stacked rank >= 2."""
    pdt = PARAM_DTYPE.get(cfg.name)
    if pdt is None:
        return named
    return {n: p.to(pdt) if _casts(n, p) else p for n, p in named.items()}


# ---------------------------------------------------------------------------
# the train state of a mesh
# ---------------------------------------------------------------------------
class _Gathered:
    """A leaf of a `MeshState`, gathered onto the CPU when read: the
    tensor-like leaf `convert.train_state_tree(lazy=True)` takes, so a
    checkpoint holds one whole leaf in host memory at a time."""

    def __init__(self, shards: list, mesh, spec: tuple):
        self.shards, self.mesh, self.spec = shards, mesh, spec
        self.dtype = shards[0].dtype
        self.shape = torch.Size(full_shape(mesh, spec, tuple(shards[0].shape)))

    def detach(self):
        return self

    def cpu(self) -> torch.Tensor:
        return gather_shards(self.shards, self.mesh, self.spec, "cpu")


def _moment_spec(spec: tuple, sub: str | None) -> tuple:
    return spec[:-1] + (None,) if sub == "s" and spec else spec


@dataclasses.dataclass
class MeshState:
    """A train state split over a mesh: `shards[f]` is position f's
    (flat, row-major) `{"params": {name: shard}, "opt": AdamW state of
    its shards, "step": int32 0-dim}` on its device, names the `LM`'s
    (or `Whisper`'s) state-dict names, `specs` each parameter's spec
    under `policy` (`ShardingPolicy.named_param_specs`).  A replicated
    piece is held by every position that holds it."""
    policy: ShardingPolicy
    specs: dict
    shards: list

    @property
    def mesh(self):
        return self.policy.mesh

    def full(self) -> dict:
        """The state in the one-device layout with `_Gathered` leaves
        (`convert.train_state_tree(state.full(), lazy=True)` writes a
        checkpoint in the reference's layout); count and step are the
        first position's."""
        sh = self.shards

        def leaves(get):
            return {n: _Gathered([get(s, n) for s in sh], self.mesh, spec)
                    for n, spec in self.specs.items()}

        opt = {"count": sh[0]["opt"]["count"]}
        for k in ("m", "v"):
            if _quantized(sh[0]["opt"][k]):
                opt[k] = {n: {sub: _Gathered(
                    [s["opt"][k][n][sub] for s in sh], self.mesh,
                    _moment_spec(spec, sub)) for sub in ("q", "s")}
                    for n, spec in self.specs.items()}
            else:
                opt[k] = leaves(lambda s, n, k=k: s["opt"][k][n])
        return {"params": leaves(lambda s, n: s["params"][n]), "opt": opt,
                "step": sh[0]["step"]}

    def position_bytes(self, flat: int) -> int:
        """Bytes of position `flat`'s shards: parameters, moments, count
        and step."""
        s = self.shards[flat]
        ts = list(s["params"].values()) + [s["opt"]["count"], s["step"]]
        for k in ("m", "v"):
            for t in s["opt"][k].values():
                ts += list(t.values()) if isinstance(t, dict) else [t]
        return sum(t.numel() * t.element_size() for t in ts)


def _quantized(moments: dict) -> bool:
    return isinstance(next(iter(moments.values())), dict)


def split_last(mesh, specs: dict, opt_cfg: adamw.AdamWConfig) -> dict:
    """{name: its positions' groups} of the leaves whose int8 moments
    are split on their last dimension: a group is the positions that
    hold the same rows (coordinates equal but on the last entry's axes),
    one a column piece, which all-reduce their block maxima (empty
    without int8 moments)."""
    if not opt_cfg.quantized_moments:
        return {}
    out = {}
    for n, spec in specs.items():
        if not spec or shard_count(mesh, spec[-1:]) == 1:
            continue
        last = spec[-1]
        cols = set(last if isinstance(last, tuple) else (last,))
        groups: dict = {}
        for f in range(mesh.size):
            c = mesh.coords(f)
            groups.setdefault(tuple(v for a, v in c.items() if a not in cols),
                              []).append(f)
        out[n] = list(groups.values())
    return out


def column_offset(mesh, spec: tuple, width: int, flat: int) -> int:
    """Position `flat`'s first column of a leaf `width` wide under
    `spec` (0 where the last dimension is whole)."""
    if not spec:
        return 0
    key = shard_key(mesh, spec, mesh.coords(flat))[-1]
    return key * (width // shard_count(mesh, spec[-1:]))


def scale_all_reduce(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The int8 moments' block maxima of one leaf's column pieces, their
    max on each piece's position (`tensor_parallel.all_reduce_max`)."""
    return tensor_parallel.all_reduce_max(parts)


def shard_params(named: dict, policy: ShardingPolicy,
                 opt_cfg: adamw.AdamWConfig) -> MeshState:
    """A fresh train state on `policy`'s mesh: the parameters `named` (a
    dict of tensors, state-dict names; `PARAM_DTYPE` applied) split by
    their specs, a copy of each piece on each of its positions, zero
    AdamW moments like each position's shards, step 0."""
    mesh = policy.mesh
    named = _master_named(policy.cfg, named)
    specs = policy.named_param_specs(named)
    shards = [{"params": {}} for _ in range(mesh.size)]
    with torch.no_grad():
        for n, p in named.items():
            for f, t in enumerate(shard_tensor(p.detach(), mesh, specs[n])):
                shards[f]["params"][n] = t
    widths = {n: p.shape[-1] for n, p in named.items() if p.dim()}
    for f, s in enumerate(shards):
        s["opt"] = adamw.init(s["params"], opt_cfg, widths=widths)
        s["step"] = torch.zeros((), dtype=torch.int32, device=mesh.device(f))
    return MeshState(policy, specs, shards)


def shard_state(state: dict, policy: ShardingPolicy) -> MeshState:
    """A one-device train state (`train.trainer.init_state`'s layout,
    e.g. loaded from a checkpoint) split onto `policy`'s mesh: parameters
    and moments by their specs, count and step on every position."""
    mesh = policy.mesh
    params = state["params"]
    named = dict(params.named_parameters()) if isinstance(
        params, nn.Module) else params
    specs = policy.named_param_specs(named)
    shards = [{"params": {}, "opt": {"m": {}, "v": {}}}
              for _ in range(mesh.size)]
    with torch.no_grad():
        for n, p in named.items():
            for f, t in enumerate(shard_tensor(p.detach(), mesh, specs[n])):
                shards[f]["params"][n] = t
            for k in ("m", "v"):
                mom = state["opt"][k][n]
                subs = mom.items() if isinstance(mom, dict) else [(None, mom)]
                for sub, t in subs:
                    pieces = shard_tensor(t, mesh, _moment_spec(specs[n], sub))
                    for f, piece in enumerate(pieces):
                        if sub is None:
                            shards[f]["opt"][k][n] = piece
                        else:
                            shards[f]["opt"][k].setdefault(n, {})[sub] = piece
    for f, s in enumerate(shards):
        dev = mesh.device(f)
        s["opt"]["count"] = state["opt"]["count"].to(dev, copy=True)
        s["step"] = torch.as_tensor(state["step"]).to(
            dev, torch.int32, copy=True)
    return MeshState(policy, specs, shards)


def make_train_step(cfg: ArchConfig, mesh=None, *,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    microbatches: int = 1, remat: bool = True,
                    fsdp: bool | None = None, model_strategy: str = "tp",
                    cast_bf16: bool = False, device=None,
                    on_grad: Callable[[str, torch.Tensor], None] | None = None
                    ) -> TrainStep:
    """The train step on `device` (CUDA when None, raising without it),
    or over `mesh` (`launch.mesh.Mesh`; then `device` is unused).  The
    reference's signature, with `device` and `on_grad` added and without
    `extra_rules` (activation rules change no result; see
    `ARCH_TRAIN_RULES`).

    `fn(state, batch)` takes `state = {"params": the model, "opt": adamw
    state, "step": int32 0-dim tensor}` (`train.trainer.init_state`; on
    a mesh a `MeshState`, `init_state(..., mesh=)` / `shard_params`) and
    a batch of `inputs` / `targets` (B, S) (the VLM's also `patches` (B,
    P, D), the audio family's `frames` (B, F, D)); it runs the model's
    loss (`lm_loss`, `paligemma_loss` for the VLM, `whisper_loss` for the
    audio family: dense attention, bf16 products, remat per block when
    `remat`, for the hybrid family per group with each Mamba2 layer
    inside it; the SSM family's mLSTM chunkwise, as the reference's),
    backward and AdamW,
    writes the parameters and moments in place (the reference donates
    its state) and returns (state, metrics): `lm_loss`'s metrics, AdamW's
    and `loss`, 0-dim tensors on the device.

    With `microbatches` > 1 the batch's rows are cut into that many
    consecutive slices; their grads are summed in `.grad` (float32, the
    dense configs' `accum_dtype`, from zero as the reference's `gacc`)
    and divided by the count, the loss is their mean and the other
    metrics are the last microbatch's.  `cast_bf16` (and
    `model_strategy="fsdp"`, ZeRO-3's cast) runs the loss on a
    `COMPUTE_DTYPE` (bf16) cast of the float32 leaves of stacked rank >=
    2.  On a mesh see `_mesh_train_step`: `fsdp` goes to `make_policy`
    (None: on from 6e9 parameters, as the reference's) and
    `on_grad(name, grad)` is called with each parameter's whole reduced
    grad before AdamW; one device raises on either.

    One device and a 1x1 mesh are two code paths for one step (equal bit
    for bit, `tests/test_torch_sharded_train.py`); running the first as
    the second waits for a measurement (ROADMAP item 6.10)."""
    opt_cfg = opt_cfg or default_opt_cfg(cfg)
    if mesh is not None:
        return _mesh_train_step(
            cfg, mesh, opt_cfg=opt_cfg, microbatches=microbatches,
            remat=remat, cast=cast_bf16, model_strategy=model_strategy,
            fsdp=fsdp, on_grad=on_grad)
    for name, v in (("on_grad", on_grad), ("fsdp", fsdp)):
        if v is not None:
            raise ValueError(f"{name} is read by a mesh's step only")
    dev = resolve_device(device)
    api = build_model(cfg, remat=remat, mlstm_chunked=(cfg.family == "ssm"))
    cast = cast_bf16 or model_strategy == "fsdp"

    def loss_fn(params, mb: dict):
        if cast:
            params = _cast_view(params, COMPUTE_DTYPE)
        return api.loss(params, mb)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        named = dict(model.named_parameters())
        for p in named.values():
            p.grad = None
        batch = {k: v.to(dev) for k, v in batch.items()}
        rows = batch["inputs"].shape[0]
        if rows % microbatches:
            raise ValueError(f"batch of {rows} rows in {microbatches} "
                             f"microbatches")
        per = rows // microbatches
        loss = None
        for i in range(microbatches):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            mb_loss, metrics = loss_fn(model, mb)
            mb_loss.backward()
            mb_loss = mb_loss.detach()
            loss = mb_loss if loss is None else loss + mb_loss
        grads = {n: p.grad for n, p in named.items()}
        if microbatches > 1:
            loss = loss / microbatches
            for g in grads.values():
                g.div_(microbatches)
        _, state["opt"], opt_metrics = adamw.update(grads, state["opt"],
                                                    named, opt_cfg)
        for p in named.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, **opt_metrics, loss=loss)
        state["step"] = state["step"] + 1
        return state, metrics

    return TrainStep(fn=train_step,
                     batch_struct=shp.batch_struct(cfg, shp.SHAPES["train_4k"]),
                     opt_cfg=opt_cfg, device=dev)


def _mesh_train_step(cfg: ArchConfig, mesh, *, opt_cfg: adamw.AdamWConfig,
                     microbatches: int, remat: bool, cast: bool,
                     model_strategy: str, fsdp: bool | None,
                     on_grad) -> TrainStep:
    """The train step over `mesh`, the reference's jitted step executed
    group by group from this thread.

    A group is the positions of one dp index (the dp axes: "pod" and
    "data", and "model" under ZeRO-3): one position each, unless "tp"
    puts a "model" axis of m > 1 outside them.  Group k takes rows [i
    per + k r, i per + (k + 1) r) of microbatch i (per = B /
    microbatches, r = per / dp, first axis major: how `jax.jit` cuts a
    batch sharded over `dp_axes`), every position of it the same rows.
    A group of one position gathers every parameter whole onto its
    device (each piece from its first holder; under ZeRO-3's
    `compute_dtype_cast` cast to `COMPUTE_DTYPE` before the move) and
    runs the loss and the backward.  A group of m runs the local form
    (`tensor_parallel.group_loss`): each position gathers its "model"
    piece of each leaf that the policy splits on whole units over the
    other axes (`gather_over`; its own shard where nothing is to
    gather), its cut of a packed leaf (`gather_cut` of `model_cut`'s
    columns, from the positions that hold them), every other leaf whole
    and nothing of a leaf only the group's first position uses
    (`tensor_parallel.first_only`), and the group's graph all-reduces
    the partial sums.  `TrainStep.held` records the bytes of each
    position's leaves.  The MoE family runs every group's forward of a
    microbatch (`lm.lm_loss_parts`, `tensor_parallel.group_parts`), then
    one backward of the microbatch's loss: the mean of the groups'
    cross-entropies plus `lm.router_aux` of their router statistics
    summed layer by layer (`tensor_parallel.router_all_reduce`), the
    reference's loss over the microbatch's whole rows; its groups'
    gathers are alive together until that backward.  As
    each leaf's grad lands (`register_post_accumulate_grad_hook`; a local
    leaf's grad is its "model" piece, a cut's its parts of several
    pieces) its pieces are added into one sum a distinct piece, on the
    piece's first holder, in `accum_dtype`, and the grad is freed.  The
    sums are divided by dp x microbatches (one loss a group); AdamW's
    clip reads the global grad norm, each distinct piece's squares
    summed once; then every position updates
    its own shards with the grads of its pieces (replicas of a piece get
    the same bits, so they stay equal).  The loss is the mean of the
    groups' microbatch losses, the other metrics the last microbatch's
    averaged over the groups (`ppl_proxy` from the mean `nll`; the MoE
    family's `aux_loss` the last microbatch's, of its whole rows).
    Raises `ValueError` where a batch's rows do not split into the
    microbatches and dp groups, and for the MoE family where a dp
    group's rows x seq a microbatch are not whole dispatch groups of
    `moe.group_size` tokens (then the groups' dispatch would differ from
    the whole microbatch's).  Int8 moments of a leaf split on its last
    dimension (`split_last`) are quantized with the whole leaf's block
    scales: each position reduces its new moments' columns to block
    maxima, the positions holding the same rows all-reduce them
    (`scale_all_reduce`), and each quantizes its own columns; every
    such position then holds the leaf's whole row of scales, as the
    reference's state does."""
    policy = make_policy(mesh, cfg, fsdp=fsdp, model_strategy=model_strategy)
    api = build_model(cfg, remat=remat, mlstm_chunked=(cfg.family == "ssm"))
    cast = cast or policy.compute_dtype_cast
    structure = meta_model(cfg)
    masters = _master_named(cfg, meta_params(cfg))
    specs = policy.named_param_specs(masters)
    split = split_last(mesh, specs, opt_cfg)
    pieces = {n: list(holders(mesh, s).items()) for n, s in specs.items()}
    shapes = {n: tuple(p.shape) for n, p in masters.items()}
    dp = int(np.prod([mesh.shape[a] for a in policy.dp_axes]))
    m = mesh.size // dp
    lay = tensor_parallel.layout(cfg, specs, mesh) if m > 1 else None
    local = {n: lay is not None and model_local(mesh, cfg, n, s)
             for n, s in specs.items()}
    acc_dt = accum_dtype(cfg)
    dev0 = mesh.device(0)
    moe = cfg.moe is not None

    def dp_index(f: int) -> int:
        c, k = mesh.coords(f), 0
        for a in policy.dp_axes:
            k = k * mesh.shape[a] + c[a]
        return k

    groups = [[] for _ in range(dp)]
    for f in range(mesh.size):
        groups[dp_index(f)].append(f)

    @functools.lru_cache(maxsize=None)
    def cut_of(name: str, f: int):
        """Position f's cut of a packed local leaf, else None."""
        if not local[name]:
            return None
        return model_cut(mesh, cfg, name, specs[name], shapes[name], f)

    @functools.lru_cache(maxsize=None)
    def covers(name: str, f: int) -> tuple:
        """(key, first holder, index in the grad, index in the piece or
        None for all of it) of each piece of `name` that position f's
        tensor covers: all of them for a whole leaf, those inside its
        "model" piece for a local one, parts of several for a cut."""
        spec, shape = specs[name], shapes[name]
        if cut_of(name, f) is not None:
            return tuple((key, owners[0], dst, src) for key, owners, src, dst
                         in cut_overlaps(mesh, spec, shape, cut_of(name, f)))
        if not local[name]:
            return tuple((key, owners[0], shard_slices(mesh, spec, shape, key),
                          None) for key, owners in pieces[name])
        return tuple((key, owners[0], at, None) for key, owners, at in
                     pieces_in(mesh, spec, shape,
                               region(mesh, spec, shape, f)))

    def train_step(state: MeshState, batch: dict) -> tuple[MeshState, dict]:
        if state.specs != specs or state.mesh is not mesh:
            raise ValueError("the state was sharded for another mesh or "
                             "policy than this step's")
        rows, seq = batch["inputs"].shape[:2]
        if rows % (microbatches * dp):
            raise ValueError(f"batch of {rows} rows in {microbatches} "
                             f"microbatches over {dp} dp positions")
        per = rows // microbatches
        r = per // dp
        if moe and dp > 1 and (r * seq) % cfg.moe.group_size:
            raise ValueError(
                f"{cfg.name}: a dp group's {r} rows x {seq} tokens a "
                f"microbatch are not whole dispatch groups of "
                f"{cfg.moe.group_size} tokens (the groups would differ from "
                f"the whole microbatch's)")
        sums: dict = {n: {} for n in specs}

        def reducer(name: str, f: int):
            where = covers(name, f)

            def hook(t: torch.Tensor) -> None:
                g, t.grad = t.grad, None
                for key, owner, at, within in where:
                    piece = g[at]
                    dev = mesh.device(owner)
                    if within is not None:       # a part of the piece
                        if key not in sums[name]:
                            sums[name][key] = torch.zeros(
                                shard_shape(mesh, specs[name], shapes[name]),
                                dtype=acc_dt, device=dev)
                        sums[name][key][within] += piece.to(dev, acc_dt)
                    elif key in sums[name]:
                        sums[name][key].add_(piece.to(dev, acc_dt))
                    else:
                        sums[name][key] = piece.to(dev, acc_dt, copy=True)
            return hook

        def leaves(f: int, use_local: bool, first: bool = True) -> dict:
            """Position f's leaves for its loss, each a leaf of the graph
            with its grad hook (None for a leaf that only a group's first
            position uses, where f is not that)."""
            dev, held = mesh.device(f), {}
            with torch.no_grad():
                for n, spec in specs.items():
                    if use_local and not first and \
                            tensor_parallel.first_only(cfg, n):
                        held[n] = None
                        continue
                    owned = [s["params"][n] for s in state.shards]
                    dt = COMPUTE_DTYPE if cast and _casts(n, owned[0]) \
                        else None
                    c = cut_of(n, f) if use_local else None
                    if c is not None:
                        held[n] = gather_cut(owned, mesh, spec, c, f, dev, dt)
                    elif use_local and local[n]:
                        held[n] = gather_over(owned, mesh, spec, f, dev, dt)
                    else:
                        held[n] = gather_shards(owned, mesh, spec, dev, dt,
                                                flat=f)
            step.held[f] = {n: t.numel() * t.element_size()
                            for n, t in held.items() if t is not None}
            for n, t in held.items():
                if t is not None:
                    t.requires_grad_(True)
                    t.register_post_accumulate_grad_hook(reducer(n, f))
            return held

        def forward(members: list, mbs: list) -> tuple:
            """One group's forward: (loss, metrics, each MoE layer's
            `RouterStats`); the MoE family's loss is its cross-entropy
            alone, its aux loss the step's, over the whole microbatch.
            The graph holds the group's gathered leaves until its
            backward."""
            if lay is not None:
                views = [_view(structure, leaves(f, True, k == 0))
                         for k, f in enumerate(members)]
                if moe:
                    return tensor_parallel.group_parts(views, mbs, cfg, lay,
                                                       remat=remat)
                return (*tensor_parallel.group_loss(views, mbs, cfg, lay,
                                                    remat=remat), [])
            view = _view(structure, leaves(members[0], False))
            if moe:
                return lm.lm_loss_parts(view, mbs[0], cfg, remat=remat)
            return (*api.loss(view, mbs[0]), [])

        loss, last = None, []
        for i in range(microbatches):
            last, outs = [], []
            for k, members in enumerate(groups):
                lo = i * per + k * r
                mbs = [{n: v[lo:lo + r].to(mesh.device(f))
                        for n, v in batch.items()} for f in members]
                out = forward(members, mbs)
                if moe:
                    outs.append(out)
                    continue
                # every family but the MoE: one backward a group, so a
                # group's gathers are freed before the next group's
                mb_loss, metrics, _ = out
                del out
                mb_loss.backward()
                mb_loss = mb_loss.detach().to(dev0)
                loss = mb_loss if loss is None else loss + mb_loss
                last.append({n: v.detach().to(dev0)
                             for n, v in metrics.items()})
                del metrics
            if moe:
                # the MoE family: every group's forward, then one backward
                # of the microbatch's loss, the mean of the groups'
                # cross-entropies plus the aux loss of the whole
                # microbatch's router statistics
                stats = [tensor_parallel.router_all_reduce(list(layer), dev0)
                         for layer in zip(*(o[2] for o in outs))]
                aux = lm.router_aux(cfg, stats, dev0)
                ce = outs[0][0].to(dev0)
                for o in outs[1:]:
                    ce = ce + o[0].to(dev0)
                mb_loss = ce / dp + aux
                last = [{n: v.detach().to(dev0) for n, v in o[1].items()}
                        for o in outs]
                mb_aux = aux.detach()
                del outs, stats, ce, aux
                mb_loss.backward()
                mb_loss = mb_loss.detach()
                loss = mb_loss if loss is None else loss + mb_loss
        n_losses = microbatches if moe else microbatches * dp
        if n_losses > 1:
            loss = loss / n_losses
        for by_key in sums.values():
            for s in by_key.values():
                s.div_(n_losses)
        metrics = last[0]
        if dp > 1:
            metrics = {k: sum(m[k] for m in last) / dp for k in metrics}
            metrics["ppl_proxy"] = torch.exp(torch.clamp(metrics["nll"],
                                                         max=20.0))
        if moe:
            metrics["aux_loss"] = mb_aux
        if on_grad is not None:
            for n, spec in specs.items():
                at = [None] * mesh.size
                for key, owners in pieces[n]:
                    for f in owners:
                        at[f] = sums[n][key]
                on_grad(n, gather_shards(at, mesh, spec, dev0))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(s.to(torch.float32)))
                               .to(dev0) for by_key in sums.values()
                               for s in by_key.values()))
        ups = [adamw.Update(sh["opt"], sh["params"], opt_cfg,
                            gnorm.to(mesh.device(f)))
               for f, sh in enumerate(state.shards)]
        for n, spec in specs.items():
            at = [column_offset(mesh, spec, shapes[n][-1], f)
                  if n in split else 0 for f in range(mesh.size)]
            new = []
            for f, up in enumerate(ups):
                grad = sums[n][shard_key(mesh, spec, mesh.coords(f))]
                m2, v2 = up.leaf(n, grad.to(mesh.device(f)), offset=at[f])
                if n in split:
                    new.append((m2, v2))
                else:
                    up.store(n, "m", m2)
                    up.store(n, "v", v2)
                del m2, v2
            # int8 moments split on their last dimension: each position's
            # block maxima of its columns, all-reduced over the positions
            # holding the same rows, then each quantizes its own columns
            # with the leaf's scales
            for i, which in enumerate(("m", "v")):
                for group in split.get(n, ()):
                    amax = scale_all_reduce([adamw.block_absmax(
                        new[f][i], opt_cfg.quant_block, offset=at[f],
                        width=shapes[n][-1]) for f in group])
                    for f, a in zip(group, amax):
                        ups[f].store(n, which, new[f][i], offset=at[f],
                                     amax=a)
            del new
        opt_metrics = None
        for sh, up in zip(state.shards, ups):
            om = up.finish()
            sh["step"] = sh["step"] + 1
            opt_metrics = opt_metrics or {k: v.to(dev0) for k, v in om.items()}
        return state, dict(metrics, **opt_metrics, loss=loss)

    step = TrainStep(fn=train_step,
                     batch_struct=shp.batch_struct(cfg, shp.SHAPES["train_4k"]),
                     opt_cfg=opt_cfg, device=dev0, policy=policy)
    return step


# ---------------------------------------------------------------------------
# prefill (forward-only logits)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PrefillStep:
    fn: Callable[[torch.nn.Module, dict], torch.Tensor]
    # the shape's batch: inputs (B, S); the VLM's also patches (B, P, D),
    # the audio family's frames (B, F, D)
    batch_shapes: dict[str, tuple[int, ...]]
    device: torch.device


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec, *,
                      device=None) -> PrefillStep:
    """Forward-only logits of the prefill shape `shape` on `device`
    (CUDA when None, raising without it).

    `fn(params, batch)` returns the logits of `lm_hidden(params,
    batch["inputs"], cfg, attn_impl="blockwise")` under
    `torch.inference_mode()`: logits at every position, in the hidden
    dtype (bf16).  The hybrid family's prefill runs its Mamba2 layers'
    chunked SSD and the shared block's blockwise attention (zamba2-2.7b:
    head dim 80, `flash_attention_wgmma` at (80, 80) on the card); the SSM
    family's its mLSTM chunkwise and its sLSTM's loop over time.  The
    VLM family's batch also carries `patches` (B, P, D), prepended as
    `prefix_embeds` (attention bidirectional over them):
    its logits cover the P + S positions, patches included, as the
    reference's do.  The audio family's carries `frames` (B, F, D): the
    encoder runs over them (dense attention), then the decoder over the
    tokens with blockwise self-attention (whisper-large-v3: head dim 64,
    `flash_attention_wgmma` at (64, 64) on the card) and dense
    cross-attention.  `params` is the model on the step's device, as
    its `init(device=..., dtype=torch.bfloat16)` gives the serving
    weights."""
    dev = resolve_device(device)
    build_model(cfg)
    shapes = {"inputs": (shape.batch, shape.seq)}
    if cfg.family == "vlm":
        shapes["patches"] = (shape.batch, cfg.vlm.n_patches, cfg.d_model)
    if cfg.family == "audio":
        shapes["frames"] = (shape.batch, cfg.encdec.enc_frames, cfg.d_model)

    def prefill(params, batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            if cfg.family == "audio":
                enc = whisper.encode(params, batch["frames"].to(dev), cfg)
                return whisper.decode_fwd(params, batch["inputs"].to(dev),
                                          enc, cfg, attn_impl="blockwise")
            prefix = (batch["patches"].to(dev) if cfg.family == "vlm"
                      else None)
            hidden, _ = lm.lm_hidden(params, batch["inputs"].to(dev), cfg,
                                     prefix_embeds=prefix,
                                     attn_impl="blockwise",
                                     mlstm_chunked=(cfg.family == "ssm"))
            return lm.lm_logits(params, hidden, cfg)

    return PrefillStep(fn=prefill, batch_shapes=shapes, device=dev)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeStep:
    fn: Callable[[torch.nn.Module, dict, torch.Tensor],
                 tuple[torch.Tensor, dict]]
    init_state: Callable[[], dict]   # a fresh decode state of the shape
    tokens_shape: tuple[int, ...]    # (B,)
    device: torch.device


def make_serve_step(cfg: ArchConfig, shape: ShapeSpec, *,
                    device=None) -> ServeStep:
    """One decode step of the decode shape `shape` (batch B, cache of
    `shape.seq` positions) on `device` (CUDA when None, raising without
    it): `fn(params, state, tokens)` is `decode_step` (logits (B, V)
    float32, the state written in place), `init_state()` the zeroed
    state (`init_decode_state`); `params` are the serving weights."""
    dev = resolve_device(device)
    api = build_model(cfg)
    return ServeStep(
        fn=api.decode_step,
        init_state=lambda: api.init_decode_state(shape.batch, shape.seq,
                                                 device=dev),
        tokens_shape=(shape.batch,), device=dev)
