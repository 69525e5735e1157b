"""The port's sharding policy (`parallel.sharding`, `launch.mesh`,
`launch.steps.make_train_state_struct`, `parallel.axes`) held exactly to
the reference's on every config.

The reference's policy runs on a `jax.sharding.AbstractMesh` (no
devices needed) of the same shape as the port's abstract `Mesh`; its
`PartitionSpec`s are compared entry for entry with the port's spec
tuples, leaf by leaf under the reference's tree paths.  Meshes: (1, 1),
(2, 4) and (16, 16) over ("data", "model") and (2, 16, 16) over ("pod",
"data", "model"); `fsdp` True / False / None; strategy "tp" / "fsdp".
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as rregistry
from repro.launch import shapes as rshapes
from repro.launch import steps as rsteps
from repro.models.registry import build_model as rbuild
from repro.parallel import axes as raxes
from repro.parallel.sharding import make_policy as rpolicy
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import (Mesh, dp_size, make_mesh,
                                     make_production_mesh)
from repro_torch.models.registry import build_model, meta_model
from repro_torch.parallel import axes as taxes
from repro_torch.parallel.sharding import make_policy as tpolicy
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x1", "2x4", "16x16", "2x16x16"]
POLICIES = [(fsdp, strategy) for fsdp in (True, False, None)
            for strategy in ("tp", "fsdp")]
FAMILY_DECODE = ("qwen2_5_3b", "deepseek_v2_lite_16b", "arctic_480b",
                 "paligemma_3b", "zamba2_2_7b", "xlstm_125m",
                 "whisper_large_v3")


def _specs(tree) -> dict:
    """{keystr: spec tuple} of a reference tree of PartitionSpecs or
    NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(
            x, (jax.sharding.PartitionSpec, jax.sharding.NamedSharding)))[0]
    return {jax.tree_util.keystr(p): tuple(getattr(s, "spec", s))
            for p, s in leaves}


def _flat(tree, pre="") -> dict:
    """{keystr: leaf} of the port's nested dicts (a spec tuple or a
    `TensorSpec` is a leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}[{k!r}]"))
        else:
            out[f"{pre}[{k!r}]"] = v
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return jax.eval_shape(rbuild(rregistry.get(name)).init, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port_params(name):
    return convert.train_state_tree(
        {"params": meta_model(registry.get(name))}, spec=True)["params"]


def _pair(name, shape, axes, fsdp, strategy):
    return (rpolicy(AbstractMesh(shape, axes), rregistry.get(name),
                    fsdp=fsdp, model_strategy=strategy),
            tpolicy(Mesh(shape, axes), registry.get(name), fsdp=fsdp,
                    model_strategy=strategy))


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", rregistry.ARCH_IDS)
def test_policy_matches_reference(name, shape, axes):
    """`param_specs` leaf by leaf, `activation_rules` at decode batch
    None / 1 / 128, `batch_specs` of train_4k and prefill_32k, and the
    policy's properties, for every (fsdp, strategy)."""
    for fsdp, strategy in POLICIES:
        rp, tp = _pair(name, shape, axes, fsdp, strategy)
        assert (tp.fsdp, tp.dp_axes, tp.tp, tp.fsdp_axis,
                tp.compute_dtype_cast) == (rp.fsdp, rp.dp_axes, rp.tp,
                                           rp.fsdp_axis, rp.compute_dtype_cast)
        want = _specs(rp.param_specs(_ref_params(name)))
        got = _flat(tp.param_specs(_port_params(name)))
        assert got == want, (fsdp, strategy)
        for decode_batch in (None, 1, 128):
            assert tp.activation_rules(decode_batch=decode_batch) == \
                rp.activation_rules(decode_batch=decode_batch)
        for shp_name in ("train_4k", "prefill_32k"):
            rb = rshapes.batch_struct(rregistry.get(name),
                                      rshapes.SHAPES[shp_name])
            tb = tshapes.batch_struct(registry.get(name),
                                      tshapes.SHAPES[shp_name])
            assert _flat(tp.batch_specs(tb)) == _specs(rp.batch_specs(rb))


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", FAMILY_DECODE)
def test_decode_state_specs_match_reference(name, shape, axes):
    """One decode state per family (MLA's latent cache, the hybrid's
    Mamba2 states and shared caches, the SSM's recurrent states,
    whisper's cross caches), at decode batch 128 and 1 (split-KV)."""
    for batch in (128, 1):
        rstate = jax.eval_shape(functools.partial(
            rbuild(rregistry.get(name)).init_decode_state, batch, 4096))
        tstate = build_model(registry.get(name)).init_decode_state(
            batch, 4096, device="meta")
        for fsdp, strategy in POLICIES[:2]:
            rp, tp = _pair(name, shape, axes, fsdp, strategy)
            want = _specs(rp.decode_state_specs(rstate, batch))
            got = _flat(tp.decode_state_specs(tstate, batch))
            assert got == want, (batch, strategy)


def _ref_struct(name, shape, axes, strategy):
    cfg = rregistry.get(name)
    pol = rpolicy(AbstractMesh(shape, axes), cfg, model_strategy=strategy)
    struct, _ = rsteps.make_train_state_struct(cfg, pol,
                                               rsteps.default_opt_cfg(cfg))
    leaves = jax.tree_util.tree_flatten_with_path(struct)[0]
    return {jax.tree_util.keystr(p): (tuple(s.shape), np.dtype(s.dtype).name,
                                      tuple(s.sharding.spec))
            for p, s in leaves}


@pytest.mark.parametrize("shape,axes", MESHES[1:], ids=MESH_IDS[1:])
@pytest.mark.parametrize("name", rregistry.ARCH_IDS)
def test_train_state_struct_matches_reference(name, shape, axes):
    """Shapes, dtypes and specs of every leaf of the train state: arctic's
    bf16 masters (`PARAM_DTYPE`) and int8 moments `{"q", "s"}` included."""
    cfg = registry.get(name)
    for strategy in ("tp", "fsdp"):
        pol = tpolicy(Mesh(shape, axes), cfg, model_strategy=strategy)
        struct, specs = tsteps.make_train_state_struct(
            cfg, pol, tsteps.default_opt_cfg(cfg))
        flat_s, flat_p = _flat(struct), _flat(specs)
        assert set(flat_s) == set(flat_p)
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."),
                   flat_p[k]) for k, v in flat_s.items()}
        assert got == _ref_struct(name, shape, axes, strategy), strategy
    if name == "arctic_480b":
        assert flat_s["['params']['blocks']['attn']['wq']"].dtype \
            == torch.bfloat16
        assert flat_s["['opt']['m']['blocks']['attn']['wq']['q']"].dtype \
            == torch.int8


def test_step_tables_match_reference():
    assert tsteps.ARCH_TRAIN_RULES == rsteps.ARCH_TRAIN_RULES
    assert tsteps.PERF_TRAIN_OVERRIDES == rsteps.PERF_TRAIN_OVERRIDES
    assert set(tsteps.PARAM_DTYPE) == set(rsteps.PARAM_DTYPE)


def test_named_param_specs_drop_the_layer_entry():
    """A per-layer tensor takes its stacked leaf's spec without the
    leading layer entry; an unstacked one its own."""
    cfg = registry.get("qwen3_8b")
    pol = tpolicy(Mesh((2, 4), ("data", "model")), cfg, fsdp=True)
    named = dict(meta_model(cfg).named_parameters())
    got = pol.named_param_specs(named)
    stacked = _flat(pol.param_specs(_port_params("qwen3_8b")))
    assert got["blocks.3.attn.wq"] == stacked["['blocks']['attn']['wq']"][1:]
    assert got["blocks.0.ffn.wo"] == ("model", "data")
    assert got["emb"] == stacked["['emb']"]
    assert all(len(got[n]) == p.dim() for n, p in named.items())


def test_axes_rules_match_reference():
    rules = {"batch": ("pod", "data"), "heads": "model", "ffn": "model",
             "seq": None}
    names = ("batch", "seq", "heads", "ffn", None)
    want = tuple(raxes._spec_from(rules, names))
    assert taxes._spec_from(rules, names) == want == (
        ("pod", "data"), None, "model", None, None)
    mesh = Mesh((2, 2), ("data", "model"))
    assert taxes.resolve(names) is None and taxes.current_rules() is None
    with taxes.set_rules(mesh, rules):
        assert taxes.resolve(names) == want
        assert taxes.current_rules()[0] is mesh
        x = torch.ones(2)
        assert taxes.logical(x, "batch") is x
    assert taxes.current_rules() is None


def test_meshes(monkeypatch):
    pm = make_production_mesh(multi_pod=True)
    rm = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert pm.axis_names == rm.axis_names and pm.shape == dict(rm.shape)
    assert pm.positions is None and dp_size(pm) == 32
    assert dp_size(make_production_mesh()) == 16
    m = make_mesh((2, 2), ("data", "model"), device="cpu")
    assert m.positions.shape == (2, 2) and m.size == 4
    assert [str(d) for d in m.positions.ravel()] == ["cpu"] * 4
    assert m.coords(3) == {"data": 1, "model": 1}
    assert tuple(m.positions.ravel()) == (torch.device("cpu"),) * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data", "model"), ["cpu"] * 3)
