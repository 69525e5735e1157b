"""The port's checkpoints (`checkpoint.ckpt`, with `convert`'s train-state
trees) held against the reference's `repro.checkpoint.ckpt` on the CPU:
a checkpoint written by either package restores in the other with equal
tensors (exactly: they are copies of the same bits), on the reduced
qwen2.5 config's train state with float32, bf16 and int8-blockwise
moments.  The tree fingerprints agree, LATEST falls back alike, and
bf16 leaves are widened to float32 on disk with "bfloat16" kept in the
manifest.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import TrainerConfig, init_state
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

NAME = "qwen2_5_3b"
KINDS = {"f32": (radamw.AdamWConfig(), tadamw.AdamWConfig()),
         "bf16": (radamw.AdamWConfig(moment_dtype=jnp.bfloat16),
                  tadamw.AdamWConfig(moment_dtype=torch.bfloat16)),
         "int8": (radamw.AdamWConfig(quantized_moments=True),
                  tadamw.AdamWConfig(quantized_moments=True))}


def _np(v) -> np.ndarray:
    """A leaf as numpy, bf16 widened to float32 (exact)."""
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


def _leaves(tree):
    return {jax.tree_util.keystr(p): _np(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_state(kind: str, seed: int = 0):
    """A reference train state after one AdamW update on random grads
    (non-zero moments, count 1, step 7)."""
    cfg = rregistry.reduced(NAME)
    rcfg = KINDS[kind][0]
    p = rlm.init_lm(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), p)
    p, opt, _ = radamw.update(g, radamw.init(p, rcfg), p, rcfg)
    return {"params": p, "opt": opt, "step": jnp.int32(7)}


def _port_state(kind: str):
    tcfg = TrainerConfig(opt=KINDS[kind][1], seed=3)
    return init_state(registry.reduced(NAME), tcfg, device="cpu")


@pytest.mark.parametrize("kind", list(KINDS))
def test_fingerprints_agree(kind):
    ref, port = _ref_state(kind), _port_state(kind)
    tree = convert.train_state_tree(port, spec=True)
    assert tckpt.tree_fingerprint(tree) == rckpt._treedef_fingerprint(ref)
    assert tckpt.tree_fingerprint(convert.train_state_tree(port)) == \
        rckpt._treedef_fingerprint(ref)


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_checkpoint_restores_in_port(tmp_path, kind):
    ref = _ref_state(kind)
    rckpt.save(tmp_path, 7, ref, extra={"arch": "ref"})
    assert tckpt.latest_step(tmp_path) == 7
    state = _port_state(kind)
    target = convert.train_state_tree(state, spec=True)
    convert.load_train_state(tckpt.restore(tmp_path, 7, target), state)
    assert int(state["step"]) == 7 and int(state["opt"]["count"]) == 1
    got = _leaves(convert.train_state_tree(state))
    want = _leaves(ref)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if kind == "bf16":
        assert state["opt"]["m"]["blocks.0.attn.wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_checkpoint_restores_in_reference(tmp_path, kind):
    state = _port_state(kind)
    # one port update, so the moments are not zero
    named = dict(state["params"].named_parameters())
    g = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(1))
         for n, p in named.items()}
    tadamw.update(g, state["opt"], named, KINDS[kind][1])
    state["step"] = torch.tensor(5, dtype=torch.int32)
    tckpt.save(tmp_path, 5, convert.train_state_tree(state, lazy=True),
               extra={"arch": "port"})
    assert rckpt.latest_step(tmp_path) == 5
    struct = jax.eval_shape(lambda: _ref_state(kind))
    back = rckpt.restore(tmp_path, 5, struct)
    got, want = _leaves(back), _leaves(convert.train_state_tree(state))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert jax.tree.map(lambda a: a.dtype, back) == \
        jax.tree.map(lambda s: s.dtype, struct)
    man = json.loads((tmp_path / "step_00000005" / "manifest.json")
                     .read_text())
    name = "['opt']['m']['blocks']['attn']['wq']"
    if kind == "bf16":
        assert man["dtypes"][name] == "bfloat16"
        with np.load(tmp_path / "step_00000005" / "arrays.npz") as data:
            assert data[name].dtype == np.float32
    if kind == "int8":
        assert man["dtypes"][name + "['q']"] == "int8"
    assert man["shapes"]["['params']['blocks']['attn']['wq']"] == [2, 64, 64]
    assert man["extra"] == {"arch": "port"}


def test_manifests_agree(tmp_path):
    """The same state written by both packages: equal manifests (names,
    shapes, dtypes, fingerprint) and equal arrays."""
    state = _port_state("f32")
    ref = jax.tree.map(jnp.asarray, convert.train_state_tree(state))
    ref = jax.tree.map(lambda a: a.astype(jnp.int32)
                       if a.dtype == jnp.int32 else a, ref)
    rckpt.save(tmp_path / "r", 2, ref)
    tckpt.save(tmp_path / "t", 2, convert.train_state_tree(state))
    mr, mt = (json.loads((tmp_path / d / "step_00000002" / "manifest.json")
                         .read_text()) for d in ("r", "t"))
    assert mr == mt
    with np.load(tmp_path / "r" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "t" / "step_00000002" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_roundtrip_and_latest_fallback(tmp_path):
    state = _port_state("f32")
    tckpt.save(tmp_path, 3, convert.train_state_tree(state, lazy=True))
    tckpt.save(tmp_path, 6, convert.train_state_tree(state, lazy=True))
    assert tckpt.latest_step(tmp_path) == rckpt.latest_step(tmp_path) == 6
    # LATEST pointing at a step that never landed: both scan
    (tmp_path / "LATEST").write_text("step_00000009")
    assert tckpt.latest_step(tmp_path) == rckpt.latest_step(tmp_path) == 6
    assert tckpt.latest_step(tmp_path / "none") is None
    other = _port_state("f32")
    with torch.no_grad():
        for p in other["params"].parameters():
            p.zero_()
    target = convert.train_state_tree(other, spec=True)
    convert.load_train_state(tckpt.restore(tmp_path, 6, target), other)
    for (n, a), (_, b) in zip(state["params"].named_parameters(),
                              other["params"].named_parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore(tmp_path, 6, {"params": target["params"]})
    bad = convert.train_state_tree(_port_state("bf16"), spec=True)
    bad["params"]["emb"] = bad["params"]["emb"]._replace(shape=(3, 3))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path, 6, bad)


def test_params_convert_both_ways():
    """`lm_params_to_numpy` inverts `lm_params_from_numpy` on the
    reference's `init_lm` tree."""
    rp = jax.tree.map(np.asarray, rlm.init_lm(jax.random.key(4),
                                              rregistry.reduced(NAME)))
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(rp))
    assert jax.tree.structure(back) == jax.tree.structure(rp)
    for (k, a), b in zip(_leaves(rp).items(), _leaves(back).values()):
        assert a.dtype == b.dtype and np.array_equal(a, b), k
