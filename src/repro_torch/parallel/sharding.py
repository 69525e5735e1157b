"""Sharding policy: parameter specs, activation logical-axis rules, and
batch / decode-state specs per (arch x mesh); and the placement of a
tensor's shards on a mesh's positions.

Counterpart of `repro.parallel.sharding`, rule for rule.  Scheme (axes:
optional "pod" outer-DP, "data" DP/FSDP, "model" TP/EP/SP):
  * TP over "model" for head/ffn/vocab/expert-packed weight dims;
  * EP: expert-stacked tensors shard their expert axis over "model";
  * FSDP over "data" for the other large weight dim (params + Adam state) —
    on by default for >= `fsdp_threshold` params;
  * activations: batch over ("pod","data"); heads (or attention seq when
    head count doesn't divide TP) over "model";
  * decode caches: batch over DP when batch >= dp size, else cache sequence
    over "model" (split-KV decode).

Every dim is sharded only when divisible by the axis size — `_maybe` guards
all rules, so the same policy is valid on any mesh.

A spec is a plain tuple, one entry per dimension: an axis name, a tuple
of names (the dimension split over their product, the first axis
major), or None.  The rules match on the reference's tree paths
(`"['blocks']['attn']['wq']"`), so they take trees in the reference's
layout: the port's parameters through `convert` (`param_specs` of
`convert.train_state_tree(state, spec=True)["params"]`), where every
layer's leaves stack on a leading layer axis.  `named_param_specs` gives
each per-layer tensor of the port its stacked leaf's spec without the
leading layer entry.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

PyTree = Any


def _keystr(path: tuple) -> str:
    """The reference's `jax.tree_util.keystr` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def _is_leaf(x) -> bool:
    return not isinstance(x, dict) or set(x) == {"q", "s"}


def _map_with_path(fn, tree, path: tuple = ()):
    """`fn(keystr, leaf)` over a nested dict's leaves; a leaf is anything
    that is not a dict."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(_keystr(path), tree)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def P(*entries) -> tuple:
    """A spec from its entries, normalized as the reference's
    `PartitionSpec`: a tuple of one axis is that axis, an empty one
    None."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else None if e == () else e for e in entries)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardingPolicy:
    mesh: Any                  # launch.mesh.Mesh (abstract or placed)
    cfg: ArchConfig
    fsdp: bool
    # "tp": Megatron tensor parallel over "model" (baseline).
    # "fsdp": ZeRO-3 — the model axis joins the FSDP axis; per-layer weight
    #   all-gather replaces per-layer activation all-reduce.
    model_strategy: str = "tp"

    @property
    def dp_axes(self) -> tuple[str, ...]:
        axes = tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)
        if self.model_strategy == "fsdp" and "model" in self.mesh.axis_names:
            axes = axes + ("model",)     # ZeRO-3: model axis joins DP
        return axes

    @property
    def tp(self) -> str | None:
        if self.model_strategy != "tp":
            return None
        return "model" if "model" in self.mesh.axis_names else None

    def axis_size(self, name: str | None) -> int:
        if name is None:
            return 1
        return self.mesh.shape[name]

    # -- helpers ----------------------------------------------------------
    def _maybe(self, axis, dim: int):
        if axis is None:
            return None
        if isinstance(axis, tuple):
            sz = int(np.prod([self.mesh.shape[a] for a in axis]))
        else:
            sz = self.mesh.shape[axis]
        return axis if dim % sz == 0 and dim >= sz else None

    @property
    def fsdp_axis(self):
        if self.model_strategy == "fsdp":
            axes = tuple(a for a in ("data", "model")
                         if a in self.mesh.axis_names)
            return axes or None
        return "data" if (self.fsdp and "data" in self.mesh.axis_names) else None

    @property
    def compute_dtype_cast(self) -> bool:
        """ZeRO-3: cast the whole parameter tree to bf16 up front so the
        per-layer all-gathers move bf16, not the f32 master."""
        return self.model_strategy == "fsdp"

    # -- logical activation rules ------------------------------------------
    def activation_rules(self, *, decode_batch: int | None = None) -> dict:
        cfg = self.cfg
        tp = self.tp
        heads_ok = tp and cfg.n_heads % self.axis_size(tp) == 0
        kv_ok = tp and cfg.n_kv_heads % self.axis_size(tp) == 0
        if cfg.mla is not None:
            kv_ok = False   # MLA cache is headless: always split-KV on seq
        # head padding: when H doesn't divide TP but rounding up costs
        # <= 25% extra attention FLOPs, run attention in merged repeat-KV
        # form with H padded to the next TP multiple (arctic: 56 -> 64).
        padded_heads = None
        if tp and not heads_ok:
            ts = self.axis_size(tp)
            hp = -(-cfg.n_heads // ts) * ts
            if hp <= 1.25 * cfg.n_heads and hp % cfg.n_kv_heads == 0:
                padded_heads = hp
        rules = {
            "batch": self.dp_axes or None,
            "seq": None,
            "embed": None,
            "vocab": tp,
            "heads": tp if heads_ok else None,
            "merged_heads": tp if (heads_ok or padded_heads) else None,
            "padded_heads": padded_heads,      # int | None (not an axis)
            "kv_heads": tp if kv_ok else None,
            "head_dim": None,
            # context parallelism fallback for awkward head counts
            "qseq": None if (heads_ok or padded_heads) else tp,
            "kvseq": None,
            "ffn": tp,
            "experts": tp,
            "moe_groups": self.dp_axes or None,
            "cap": None,
            "inner": tp,        # mamba/xlstm inner dim
            "ssm_heads": (tp if (cfg.ssm and
                                 (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim)
                                 % self.axis_size(tp) == 0) else None) if tp else None,
            "state": None,
            "frames": None,
            # split-KV decode: when KV heads don't divide TP, the cache
            # shards its sequence axis over "model" instead (always-on for
            # decode — the cache dominates decode memory).
            "cache_seq": None if kv_ok else tp,
            "logits_seq": None,
            "embed_carry": None,
        }
        if decode_batch is not None:
            dp = int(np.prod([self.mesh.shape[a] for a in self.dp_axes])) or 1
            if decode_batch % dp != 0 or decode_batch < dp:
                rules["batch"] = None
                rules["cache_seq"] = tp      # split-KV decode
        return rules

    # -- parameter specs -----------------------------------------------------
    def param_spec(self, path: str, shape: tuple[int, ...]) -> tuple:
        """The spec of the parameter at reference path `path` (a keystr,
        `"['blocks']['attn']['wq']"`) of the stacked `shape`."""
        cfg = self.cfg
        tp = self.tp
        fa = self.fsdp_axis
        nd = len(shape)

        def spec(*names):
            """Right-align names onto dims (stacked layer dims -> None)."""
            names = list(names)[-nd:] if len(names) > nd else list(names)
            pad = [None] * (nd - len(names))
            return P(*pad, *[self._maybe(a, shape[i + len(pad)])
                             for i, a in enumerate(names)])

        replicated = (None,) * nd
        # --- MoE expert-stacked tensors (L, E, d, f) / router ---
        is_expert = (cfg.moe is not None and "'ffn'" in path
                     and not any(k in path for k in
                                 ("'shared'", "'dense'", "'router'")))
        if "'router'" in path:
            return spec(fa, None)
        if is_expert:
            if any(k in path for k in ("'wi'", "'wg'")):
                return spec(tp, fa, None)      # (E, d, f): EP + FSDP
            if "'wo'" in path:
                return spec(tp, None, fa)
            # shared / dense sub-mlps fall through to dense rules
        if any(k in path for k in ("'wi'", "'wg'")):
            return spec(fa, tp)
        if "'wo'" in path and "attn" not in path and "xattn" not in path:
            return spec(tp, fa)
        # --- attention ---
        if "'attn'" in path or "'xattn'" in path or "'mlstm'" in path:
            if any(k in path for k in ("'wq'", "'wk'", "'wv'", "'up'",
                                       "'gate'", "'w_if'")):
                return spec(fa, tp)
            if any(k in path for k in ("'wo'", "'down'")):
                return spec(tp, fa)
            if any(k in path for k in ("'w_dkv'", "'w_kr'")):
                return spec(fa, tp)
            if any(k in path for k in ("'w_uk'", "'w_uv'")):
                return spec(None, tp)
            if any(k in path for k in ("'bq'", "'bk'", "'bv'")):
                return spec(tp)
            if "'conv_w'" in path:
                return spec(None, tp)
        if "'slstm'" in path:
            if "'w_gates'" in path:
                return spec(fa, None)
            # r_gates stays replicated, as in the reference (sharding its
            # output dim over "model" raised the traffic there)
            if "'down'" in path:
                return spec(None, fa)
            return replicated
        # --- mamba ---
        if "'mamba'" in path:
            if "'in_proj'" in path:
                return spec(fa, tp)
            if "'out_proj'" in path:
                return spec(tp, fa)
            if "'conv_w'" in path:
                return spec(None, tp)
            if "'conv_b'" in path:
                return spec(tp)
            return replicated
        # --- embeddings / head ---
        if path.endswith("['emb']"):
            return spec(tp, fa)
        if path.endswith("['head']"):
            return spec(fa, tp)
        if "'pos_emb'" in path:
            return spec(None, fa)
        return replicated

    def param_specs(self, params_shape: PyTree) -> PyTree:
        """Spec tree aligned with a parameter tree in the reference's
        layout (leaves with a `.shape`: `TensorSpec`s, tensors)."""
        return _map_with_path(lambda path, leaf: self.param_spec(
            path, _shape(leaf)), params_shape)

    def named_param_specs(self, named: dict) -> dict[str, tuple]:
        """{state-dict name: spec} of the port's parameters (`named`, a
        dict of tensors or `TensorSpec`s keyed by `LM` / `Whisper`
        state-dict names): each stacked leaf's spec, a per-layer tensor
        (`blocks.<i>.…`) taking it without the leading layer entry."""
        from repro_torch.convert import _stack_fns
        from repro_torch.models.lm import STACKED

        stacked = {path: self.param_spec(_keystr(path), tuple(ts.shape))
                   for path, ts in _stack_fns(named, spec=True).items()}
        out = {}
        for name in named:
            top, _, rest = name.partition(".")
            if top in STACKED:
                _, _, rest = rest.partition(".")
                out[name] = stacked[(top,) + tuple(rest.split("."))][1:]
            else:
                out[name] = stacked[tuple(name.split("."))]
        return out

    # -- batch specs -----------------------------------------------------
    def batch_specs(self, batch_shape: dict) -> dict:
        """Every batch leaf's leading (batch) dim over the dp axes, with
        no divisibility guard (as the reference's)."""
        return _map_with_path(
            lambda path, leaf: P(self.dp_axes or None,
                                 *[None] * (len(_shape(leaf)) - 1)),
            batch_shape)

    # -- decode state specs ------------------------------------------------
    def decode_state_specs(self, state_shape: PyTree, decode_batch: int) -> PyTree:
        """Spec tree of a decode state (`init_decode_state`'s layout, the
        reference's: caches stacked on a leading layer axis; a host int
        `pos` is a scalar)."""
        rules = self.activation_rules(decode_batch=decode_batch)
        tp = self.tp
        batch_ax = rules["batch"]
        cache_seq_ax = rules["cache_seq"]

        def rule(path: str, shape: tuple[int, ...]) -> tuple:
            nd = len(shape)
            if shape == ():
                return ()
            # stacked leading layer axis -> None
            if ("['k']" in path or "['v']" in path) and "conv" not in path:
                # (L, B, KV, S, Dh)
                if nd == 5:
                    kv = self._maybe(rules["kv_heads"], shape[2])
                    return (None, self._maybe(batch_ax, shape[1]), kv,
                            self._maybe(cache_seq_ax, shape[3]) if kv is None
                            else None, None)
            if "'c_kv'" in path or "'k_rope'" in path:
                # (L, B, S, dim)
                return (None, self._maybe(batch_ax, shape[1]),
                        self._maybe(cache_seq_ax, shape[2]), None)
            if "cross_k" in path or "cross_v" in path:
                # (L, B, F, H, Dh)
                return (None, self._maybe(batch_ax, shape[1]), None,
                        self._maybe(rules["heads"], shape[3]), None)
            if "'ssm'" in path and nd == 4:
                return (None, self._maybe(batch_ax, shape[1]),
                        self._maybe(rules["ssm_heads"], shape[2]), None)
            if "'ssm'" in path and nd == 5:
                return (None, self._maybe(batch_ax, shape[1]),
                        self._maybe(rules["ssm_heads"], shape[2]), None, None)
            if "'conv'" in path and nd == 4:          # (L, B, K, C)
                return (None, self._maybe(batch_ax, shape[1]), None,
                        self._maybe(tp, shape[3]))
            if "'c'" in path and nd == 5:             # mlstm C (L,B,H,dv,dk)
                return (None, self._maybe(batch_ax, shape[1]), None,
                        self._maybe(tp, shape[3]), None)
            if nd >= 2:
                return tuple([None, self._maybe(batch_ax, shape[1])]
                             + [None] * (nd - 2))
            return (None,) * nd

        return _map_with_path(lambda path, leaf: P(*rule(path, _shape(leaf))),
                              state_shape)


def make_policy(mesh, cfg: ArchConfig, *, fsdp: bool | None = None,
                fsdp_threshold: int = 6_000_000_000,
                model_strategy: str = "tp") -> ShardingPolicy:
    if fsdp is None:
        from repro_torch.models.registry import count_params

        fsdp = count_params(cfg) >= fsdp_threshold
    return ShardingPolicy(mesh=mesh, cfg=cfg, fsdp=fsdp,
                          model_strategy=model_strategy)


# ---------------------------------------------------------------------------
# shards on positions
# ---------------------------------------------------------------------------
def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_count(mesh, spec: tuple) -> int:
    """How many distinct shards `spec` cuts a tensor into on `mesh`."""
    return int(np.prod([mesh.shape[a] for e in spec for a in _axes(e)]))


def shard_key(mesh, spec: tuple, coords: dict[str, int]) -> tuple[int, ...]:
    """Which piece of each dimension the position at `coords` holds: the
    index over the entry's axes, row-major (the first axis major), as a
    `NamedSharding` cuts."""
    key = []
    for e in spec:
        k = 0
        for a in _axes(e):
            k = k * mesh.shape[a] + coords[a]
        key.append(k)
    return tuple(key)


def shard_slices(mesh, spec: tuple, shape: tuple[int, ...],
                 key: tuple[int, ...]) -> tuple[slice, ...]:
    """The index of piece `key` of a tensor of `shape` under `spec`."""
    out = []
    for e, k, n in zip(spec, key, shape):
        parts = int(np.prod([mesh.shape[a] for a in _axes(e)]))
        step = n // parts
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


def shard_shape(mesh, spec: tuple, shape: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(n // shard_count(mesh, (e,)) for e, n in zip(spec, shape))


def full_shape(mesh, spec: tuple, piece: tuple[int, ...]) -> tuple[int, ...]:
    """The whole tensor's shape from one piece's under `spec`."""
    return tuple(n * shard_count(mesh, (e,)) for e, n in zip(spec, piece))


def holders(mesh, spec: tuple) -> dict[tuple[int, ...], list[int]]:
    """{piece key: the flat indices of the positions holding it}, keys
    in the order of their first holder."""
    out: dict[tuple[int, ...], list[int]] = {}
    for flat in range(mesh.size):
        out.setdefault(shard_key(mesh, spec, mesh.coords(flat)), []).append(flat)
    return out


def shard_tensor(t: torch.Tensor, mesh, spec: tuple) -> list[torch.Tensor]:
    """`t`'s pieces under `spec`, one for each position of `mesh` (flat
    order), each a copy on its position's device."""
    return [t[shard_slices(mesh, spec, t.shape,
                           shard_key(mesh, spec, mesh.coords(f)))]
            .to(mesh.device(f), copy=True) for f in range(mesh.size)]


def gather_shards(shards: list[torch.Tensor], mesh, spec: tuple,
                  device, dtype: torch.dtype | None = None, *,
                  flat: int | None = None) -> torch.Tensor:
    """The whole tensor from its pieces (`shards`, one a position, flat
    order) on `device`, as `_gather` reads them: for position `flat`
    where given (its own pieces from itself), else each from its first
    holder."""
    first = shards[0]
    shape = full_shape(mesh, spec, tuple(first.shape))
    return _gather(shards, mesh, spec, shape,
                   tuple(slice(0, n) for n in shape), flat, device, dtype)


def kept_spec(spec: tuple) -> tuple:
    """`spec` with only its "model" split left: an entry without "model"
    becomes None.  An entry that mixes "model" and other axes raises
    `ValueError` (no policy of the "tp" strategy makes one)."""
    out = []
    for e in spec:
        axes = _axes(e)
        if axes == ("model",):
            out.append(e)
        elif "model" in axes:
            raise ValueError(f"spec entry {e!r} mixes 'model' with other axes")
        else:
            out.append(None)
    return tuple(out)


def region(mesh, spec: tuple, shape: tuple[int, ...],
           flat: int) -> tuple[slice, ...]:
    """The index, in a tensor of whole `shape`, of the part position
    `flat` holds when only the "model" axis of `spec` splits it."""
    kept = kept_spec(spec)
    return shard_slices(mesh, kept, shape,
                        shard_key(mesh, kept, mesh.coords(flat)))


def pieces_in(mesh, spec: tuple, shape: tuple[int, ...],
              part: tuple[slice, ...]) -> list[tuple]:
    """The pieces of a tensor of whole `shape` under `spec` that lie in
    `part` (a `region`): (key, holders, the piece's index within
    `part`), keys in `holders`' order."""
    out = []
    for key, owners in holders(mesh, spec).items():
        at = shard_slices(mesh, spec, shape, key)
        if all(p.start <= a.start and a.stop <= p.stop
               for a, p in zip(at, part)):
            out.append((key, owners, tuple(
                slice(a.start - p.start, a.stop - p.start)
                for a, p in zip(at, part))))
    return out


def gather_over(shards: list[torch.Tensor], mesh, spec: tuple, flat: int,
                device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Position `flat`'s part of the tensor with only the "model" split
    kept (`region`): gathered whole over every other axis of `spec` (the
    dp / FSDP axes) onto `device`, its "model" piece left as it is, as
    `_gather` reads it."""
    first = shards[0]
    shape = full_shape(mesh, spec, tuple(first.shape))
    return _gather(shards, mesh, spec, shape, region(mesh, spec, shape, flat),
                   flat, device, dtype)


def _gather(shards: list[torch.Tensor], mesh, spec: tuple,
            shape: tuple[int, ...], part: tuple[slice, ...],
            flat: int | None, device,
            dtype: torch.dtype | None) -> torch.Tensor:
    """`part` of the tensor of whole `shape` from the pieces inside it
    on `device`.  Each piece is read from position `flat` where it holds
    it, else from its first holder (replicas hold the same bits), and
    cast to `dtype` (where given) before it moves, as ZeRO-3 gathers in
    the compute dtype.  Where the part is one piece that `flat` holds on
    `device` and no cast applies, the result shares that shard's storage
    (a detached alias: no copy)."""
    inside = pieces_in(mesh, spec, shape, part)
    if flat is not None and len(inside) == 1 and flat in inside[0][1]:
        own = shards[flat]
        if dtype in (None, own.dtype) and own.device == torch.device(device):
            return own.detach()
    out = torch.empty(tuple(s.stop - s.start for s in part),
                      dtype=dtype or shards[0].dtype, device=device)
    for _, owners, at in inside:
        piece = shards[flat if flat in owners else owners[0]]
        if dtype is not None:
            piece = piece.to(dtype)
        out[at] = piece.to(device)
    return out


def model_local(mesh, cfg: ArchConfig, name: str, spec: tuple) -> bool:
    """Whether parameter `name` (a state-dict name of the LM or of
    `whisper.Whisper`) is split over "model" on whole units, so a
    position can use its piece (or, for a packed leaf, its cut:
    `model_cut`) as it stands (tensor parallelism): the columns of
    `blocks.<i>.attn.wq` / `bq` and the rows of `attn.wo` where the heads
    divide the axis, the columns of `attn.wk` / `wv` / `bk` / `bv` where
    the KV heads do, the MLP's `ffn.wi` / `wg` / `bi` columns and
    `ffn.wo` rows, the rows of `emb` and the columns of `head` (the
    vocabulary).  False for every other leaf, and for these where `spec`
    does not split them over "model" (the policy's `_maybe`) or splits
    another dimension: e.g. the single KV head of an MQA config, which
    the policy splits inside the head dimension.  MLA's `attn.wq`,
    `w_uk` and `w_uv` columns and `wo` rows are local where the heads
    divide the axis; its `w_dkv` and `w_kr`, split inside the latent, and
    its `kv_norm` are not.  The MoE's experts `ffn.wi` / `wg` / `wo` (E,
    ., .) are local where the spec splits dimension 0, whole experts;
    the always-on `ffn.shared` and `ffn.dense` split as an MLP's, local
    where each of them is split (their partial sums share one
    all-reduce); `ffn.router` is not.

    The hybrid family's Mamba2 `mamba.in_proj` / `conv_w` / `conv_b`
    (columns) and `out_proj` (rows) are local where its SSM heads divide
    the axis (the policy's "ssm_heads") with one B/C group, and its
    shared block's `shared.attn.*` / `shared.ffn.*` as a layer's
    attention (its own head counts) and MLP.  The SSM family's mLSTM
    `mlstm.up` / `gate` / `conv_w` / `wq` / `wk` / `wv` / `w_if`
    (columns) and `down` (rows) are local where its heads divide the
    axis.  whisper's `enc_blocks.<i>` and `dec_blocks.<i>` attention and
    MLP are a layer's, its cross-attention `dec_blocks.<i>.xattn.wq` /
    `wk` / `wv` (columns) and `wo` (rows) where the heads divide.  The
    replicated leaves (`a_log`, `dt_bias`, `d_skip`, the norms,
    `mlstm.b_if` / `conv_b`, the whole sLSTM, `pos_emb`) are not."""
    dims = [i for i, e in enumerate(spec) if "model" in _axes(e)]
    if len(dims) != 1 or ("model",) != _axes(spec[dims[0]]):
        return False
    m, dim, parts = mesh.shape["model"], dims[0], name.split(".")
    last = len(spec) - 1
    if name in ("emb", "head"):
        return dim == (0 if name == "emb" else 1)
    if parts[0] == "shared" and cfg.hybrid is not None:
        # zamba2's shared block, unstacked: a layer with its own heads
        parts = ["blocks", "shared"] + parts[1:]
        cfg = dataclasses.replace(cfg, n_heads=cfg.hybrid.attn_heads,
                                  n_kv_heads=cfg.hybrid.attn_kv_heads)
    if len(parts) < 4 or parts[0] not in ("blocks", "enc_blocks",
                                          "dec_blocks"):
        return False
    sub, leaf = parts[2], parts[-1]
    if sub == "mamba" and len(parts) == 4:
        s = cfg.ssm
        if (s.expand * cfg.d_model // s.head_dim) % m or s.n_groups != 1:
            return False
        if leaf in ("in_proj", "conv_w", "conv_b"):
            return dim == last
        return leaf == "out_proj" and dim == 0
    if sub == "mlstm" and len(parts) == 4:
        if cfg.n_heads % m:
            return False
        if leaf in ("up", "gate", "conv_w", "wq", "wk", "wv", "w_if"):
            return dim == last
        return leaf == "down" and dim == 0
    if sub == "xattn" and len(parts) == 4:
        return leaf in ("wq", "wk", "wv", "wo") and cfg.n_heads % m == 0 \
            and dim == (0 if leaf == "wo" else last)
    if sub == "attn" and len(parts) == 4:
        if cfg.mla is not None:
            return (leaf in ("wq", "w_uk", "w_uv", "wo")
                    and cfg.n_heads % m == 0
                    and dim == (0 if leaf == "wo" else last))
        if leaf in ("wq", "bq", "wo"):
            return cfg.n_heads % m == 0 and dim == (0 if leaf == "wo"
                                                    else last)
        if leaf in ("wk", "wv", "bk", "bv"):
            return cfg.n_kv_heads % m == 0 and dim == last
        return False
    if sub != "ffn":
        return False
    if cfg.moe is not None and len(parts) == 4:
        return leaf in ("wi", "wg", "wo") and dim == 0
    if cfg.moe is not None:
        mo = cfg.moe
        widths = [w for w in (mo.n_shared * mo.d_ff_expert, mo.dense_ff) if w]
        if len(parts) != 5 or parts[3] not in ("shared", "dense") or not all(
                w % m == 0 and w >= m for w in widths):
            return False
    elif len(parts) != 4:
        return False
    if leaf in ("wi", "wg", "bi"):
        return dim == last
    return leaf == "wo" and dim == 0


def model_cut(mesh, cfg: ArchConfig, name: str, spec: tuple,
              shape: tuple[int, ...], flat: int):
    """Position `flat`'s cut of a packed local leaf (`model_local`), whose
    contiguous "model" piece is not its heads' columns: for each
    dimension the segments of the whole leaf it holds, in order (every
    dimension but the last gathered whole over the other axes, as
    `region`).  With j its "model" coordinate of m: the Mamba2
    `in_proj` (D, 2 D_i + 2 G N + H) packs [x, z, B, C, dt], so position
    j holds the x, z and dt columns of its heads [j H / m, (j + 1) H / m)
    and the whole B and C (one group, used by every head); `conv_w` /
    `conv_b` (D_i + 2 G N) its x columns and B, C; the mLSTM's `w_if`
    (inner, 2 H) packs [input gates, forget gates]: its heads' of each.
    None for every other leaf (its cut is its `region`)."""
    parts = name.split(".")
    if (len(parts) != 4 or parts[0] != "blocks"
            or (parts[2], parts[3]) not in (
                ("mamba", "in_proj"), ("mamba", "conv_w"),
                ("mamba", "conv_b"), ("mlstm", "w_if"))
            or not model_local(mesh, cfg, name, spec)):
        return None
    j, m = mesh.coords(flat)["model"], mesh.shape["model"]

    def own(lo: int, n: int) -> slice:
        return slice(lo + j * n // m, lo + (j + 1) * n // m)

    if parts[2] == "mlstm":
        nh = shape[-1] // 2
        cols = (own(0, nh), own(nh, nh))
    else:
        s = cfg.ssm
        di = s.expand * cfg.d_model
        gn = s.n_groups * s.state
        cols = (own(0, di),)
        if parts[3] == "in_proj":
            cols += (own(di, di), slice(2 * di, 2 * di + 2 * gn),
                     own(2 * di + 2 * gn, di // s.head_dim))
        else:
            cols += (slice(di, di + 2 * gn),)
    reg = region(mesh, spec, shape, flat)
    return tuple((r,) for r in reg[:-1]) + (cols,)


def cut_overlaps(mesh, spec: tuple, shape: tuple[int, ...],
                 cut: tuple) -> list[tuple]:
    """The parts of the pieces of a tensor of whole `shape` under `spec`
    that lie in `cut` (`model_cut`'s segments): (key, holders, index in
    the piece, index in the cut's tensor), keys in `holders`' order."""
    out = []
    for key, owners in holders(mesh, spec).items():
        at = shard_slices(mesh, spec, shape, key)
        per_dim = []
        for a, segs in zip(at, cut):
            pairs, off = [], 0
            for sg in segs:
                lo, hi = max(a.start, sg.start), min(a.stop, sg.stop)
                if lo < hi:
                    pairs.append((slice(lo - a.start, hi - a.start),
                                  slice(off + lo - sg.start,
                                        off + hi - sg.start)))
                off += sg.stop - sg.start
            per_dim.append(pairs)
        for combo in itertools.product(*per_dim):
            out.append((key, owners, tuple(c[0] for c in combo),
                        tuple(c[1] for c in combo)))
    return out


def gather_cut(shards: list[torch.Tensor], mesh, spec: tuple, cut: tuple,
               flat: int, device,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """Position `flat`'s cut (`model_cut`) of the tensor whose pieces
    are `shards` on `device`: each part read from `flat` where it holds
    it, else from its first holder, cast to `dtype` (where given) before
    it moves, as `_gather` reads them."""
    shape = full_shape(mesh, spec, tuple(shards[0].shape))
    out = torch.empty(tuple(sum(s.stop - s.start for s in segs)
                            for segs in cut),
                      dtype=dtype or shards[0].dtype, device=device)
    for _, owners, src, dst in cut_overlaps(mesh, spec, shape, cut):
        piece = shards[flat if flat in owners else owners[0]][src]
        if dtype is not None:
            piece = piece.to(dtype)
        out[dst] = piece.to(device)
    return out
