"""What the mesh train step keeps in memory, and the order of its grad
sums, on CPU positions (`launch.steps`).

* The mesh state is placed a layer at a time (`steps.init_mesh_state`,
  `trainer.init_state(mesh=)`): bit-equal to `shard_params` of the whole
  draw, and no whole leaf outlives its layer's split.
* A step keeps one block's gathered leaves alive at a time, and the
  leaves outside the blocks (`TrainStep.alive` within
  `dryrun.gathered_bytes`), with and without remat; the dry-run's peak
  reckoning (`dryrun.card_peak_bytes`) adds the step's own counts.
* The grad hooks fired in a shuffled order from several Python threads
  give the in-order step's sums bit for bit (`steps.GradSums`).

The reduced configs of every family on 1x4, 2x2, 2x2 with FSDP and
ZeRO-3 (2x2 of the "fsdp" strategy).
"""
import functools
import random
import threading

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data.synthetic import batch_for
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import make_policy
from repro_torch.train import trainer
from repro_torch.train.trainer import TrainerConfig

ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "paligemma-3b",
         "zamba2-2.7b", "xlstm-125m", "whisper-large-v3")
MESHES = {"1x4": ((1, 4), {}), "2x2": ((2, 2), {}),
          "2x2-fsdp": ((2, 2), dict(fsdp=True)),
          "zero3": ((2, 2), dict(model_strategy="fsdp"))}
BATCH = 8


def _seq(cfg) -> int:
    return 64 if cfg.moe is not None else 32


@functools.lru_cache(maxsize=None)
def _masters(arch: str) -> dict:
    cfg = registry.reduced(arch)
    model = trainer.registry.build_model(cfg).init(seed=0, device="cpu")
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), device="cpu")


def _assert_states_equal(a: tsteps.MeshState, b: tsteps.MeshState) -> None:
    assert a.specs == b.specs and len(a.shards) == len(b.shards)
    for sa, sb in zip(a.shards, b.shards):
        assert list(sa["params"]) == list(sb["params"])
        for part in ("params",):
            for n in sa[part]:
                x, y = sa[part][n], sb[part][n]
                assert x.dtype == y.dtype and x.device == y.device, n
                assert torch.equal(x, y), n
        for k in ("m", "v"):
            assert list(sa["opt"][k]) == list(sb["opt"][k])
            for n, x in sa["opt"][k].items():
                y = sb["opt"][k][n]
                if isinstance(x, dict):
                    for sub in x:
                        assert torch.equal(x[sub], y[sub]), (k, n, sub)
                else:
                    assert x.dtype == y.dtype and torch.equal(x, y), (k, n)
        assert torch.equal(sa["opt"]["count"], sb["opt"]["count"])
        assert torch.equal(sa["step"], sb["step"])
        assert sa["step"].dtype == sb["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# (a) the state placed a layer at a time
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_init_state_places_a_layer_at_a_time(arch, mesh, monkeypatch):
    """`init_mesh_state` (and `trainer.init_state(mesh=)` where the
    trainer's policy is the mesh's) equals `shard_params` of the whole
    draw bit for bit; each layer's whole leaves are split while that
    layer is placed and none outlives it (every parameter of a placed
    part is left empty), so the whole float32 leaves alive at once are at
    most the largest layer's."""
    cfg = registry.reduced(arch)
    shape, kw = MESHES[mesh]
    m = _mesh(shape)
    policy = make_policy(m, cfg, fsdp=kw.get("fsdp"),
                         model_strategy=kw.get("model_strategy", "tp"))
    opt_cfg = tsteps.default_opt_cfg(cfg)
    want = tsteps.shard_params({n: t.clone() for n, t in
                                _masters(arch).items()}, policy, opt_cfg)
    parts, whole = [], []
    place, leaf = tlm._place, tlm._leaf

    def placed(module, prefix, device, dtype, place_=None):
        nbytes = sum(p.numel() * p.element_size() for p in module.parameters())
        out = place(module, prefix, device, dtype, place_)
        if place_ is not None:          # not the meta model's
            assert all(p.numel() == 0 for p in out.parameters())
            parts.append((prefix, nbytes))
        return out

    def one(name, t, device, dtype, place_=None):
        out = leaf(name, t, device, dtype, place_)
        if place_ is not None:
            assert out.numel() == 0
            parts.append((name, t.numel() * t.element_size()))
        return out

    def seen(name, t):
        whole.append(name)

    monkeypatch.setattr(tlm, "_place", placed)
    monkeypatch.setattr(tlm, "_leaf", one)
    got = tsteps.init_mesh_state(cfg, policy, opt_cfg, place=seen)
    monkeypatch.undo()
    _assert_states_equal(got, want)
    assert sorted(whole) == sorted(want.specs)      # each leaf once
    names = dict(tsteps.meta_params(cfg))
    layer = max(sum(p.numel() * p.element_size() for n, p in names.items()
                    if n.startswith(prefix)) for prefix, _ in parts)
    assert max(b for _, b in parts) == layer
    assert len(parts) == len({p for p, _ in parts})
    if "fsdp" not in kw:
        st = trainer.init_state(cfg, TrainerConfig(
            model_strategy=kw.get("model_strategy", "tp")), mesh=m)
        _assert_states_equal(st, want)


# ---------------------------------------------------------------------------
# (b) one block's gathers alive at a time
# ---------------------------------------------------------------------------
def _step(arch, mesh, remat=True, on_grad=None):
    cfg = registry.reduced(arch)
    shape, kw = MESHES[mesh]
    m = _mesh(shape)
    step = tsteps.make_train_step(cfg, m, remat=remat, on_grad=on_grad, **kw)
    state = tsteps.shard_params({n: t.clone() for n, t in
                                _masters(arch).items()}, step.policy,
                                step.opt_cfg)
    batch = batch_for(cfg, _seq(cfg), BATCH, 0, seed=0)
    state, met = step.fn(state, batch)
    return cfg, m, kw, step, state, met


def _blocks(held: dict) -> set:
    return {tuple(n.split(".")[:2]) for n in held
            if n.split(".")[0] in tlm.STACKED}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_block_of_gathers_alive_at_a_time(arch, mesh, remat):
    """Each position's gathered bytes alive at once stay within one
    block's plus the leaves outside the blocks (`dryrun.gathered_bytes`),
    below every leaf it reads (what the step held before); the grad sums
    and the state are the dry-run's to the byte, and the card's reckoned
    peak is their sum."""
    cfg, m, kw, step, state, _ = _step(arch, mesh, remat=remat)
    total = {}
    for f in range(m.size):
        want = dryrun.gathered_bytes(cfg, m, position=f, **kw)
        read = sum(step.held[f].values())
        assert step.held[f] == dryrun.held_bytes(cfg, m, position=f, **kw)
        assert want["outside"] < step.alive[f] <= want["alive"] <= read
        # more than one block: less than every leaf at once
        assert (want["alive"] < read) == (len(_blocks(step.held[f])) > 1)
        sums = dryrun.grad_sum_bytes(cfg, m, position=f, **kw)
        assert step.sum_bytes[f] == sums
        total[f] = state.position_bytes(f) + sums + want["alive"]
    shape = ShapeSpec("t", "train", _seq(cfg), BATCH)
    assert dryrun.card_peak_bytes(cfg, shape, m, **kw) == {
        "cpu": sum(total.values())}
    assert sum(step.sum_bytes.values()) == sum(
        t.numel() * 4 for t in _masters(arch).values())


# ---------------------------------------------------------------------------
# (c) the grad sums' order under threads
# ---------------------------------------------------------------------------
def _outcome(arch, mesh, **kw):
    grads = {}
    _, _, _, _, state, met = _step(
        arch, mesh, on_grad=lambda n, g: grads.__setitem__(n, g.clone()),
        **kw)
    full = state.full()
    return (met, grads,
            {n: t.cpu() for n, t in full["params"].items()},
            {k: {n: t.cpu() for n, t in full["opt"][k].items()}
             for k in ("m", "v")})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mesh", ["1x4", "2x2", "2x2-fsdp"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_grad_sums_are_independent_of_the_hooks_threads(arch, mesh, seed,
                                                        monkeypatch):
    """Each backward's grad hooks held back, then fired in a shuffled
    order from four Python threads: loss, metrics, reduced grads,
    masters and moments equal the in-order step's bit for bit."""
    want = _outcome(arch, mesh)
    calls, rng = [], random.Random(seed)
    add, end = tsteps.GradSums.add, tsteps.GradSums.end

    def held_back(self, name, f, grad):
        calls.append((self, name, f, grad.clone()))

    def shuffled(self):
        mine = [c for c in calls if c[0] is self]
        calls[:] = [c for c in calls if c[0] is not self]
        rng.shuffle(mine)
        go = threading.Barrier(4)

        def fire(part):
            go.wait()
            for c in part:
                add(*c)

        threads = [threading.Thread(target=fire, args=(mine[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        end(self)

    monkeypatch.setattr(tsteps.GradSums, "add", held_back)
    monkeypatch.setattr(tsteps.GradSums, "end", shuffled)
    got = _outcome(arch, mesh)
    (mw, gw, pw, ow), (mg, gg, pg, og) = want, got
    assert set(mw) == set(mg)
    for k in mw:
        assert torch.equal(mw[k], mg[k]), k
    for a, b in ((gw, gg), (pw, pg), (ow["m"], og["m"]), (ow["v"], og["v"])):
        assert list(a) == list(b)
        for n in a:
            assert torch.equal(a[n], b[n]), n


def test_grad_sums_wait_for_the_contributions_ahead():
    """`GradSums` on a hand-made order: contributions that land early
    wait, converted, until those ahead of them are added; `end` adds
    what is left in order, one whose predecessor never landed too."""
    mesh = _mesh((1, 3))
    key = (0,)

    def covers(name, f):
        return ((key, 0, (slice(None),), None),)

    sums = tsteps.GradSums(covers, {"w": (3,)}, mesh, torch.float32)
    g = [torch.tensor([1.0, 2.0, 3.0]), torch.tensor([-1e8, 1.0, 1e8]),
         torch.tensor([1e8, 0.5, -1e8])]
    sums.begin({("w", key): [(2, 0), (1, 0), (0, 0)]})
    for f in (0, 1, 2):
        sums.add("w", f, g[f])
    sums.end()
    want = g[2] + g[1] + g[0]
    assert torch.equal(sums.sums["w"][key], want)
    assert not torch.equal(want, g[0] + g[1] + g[2])
    sums = tsteps.GradSums(covers, {"w": (3,)}, mesh, torch.float32)
    sums.begin({("w", key): [(2, 0), (1, 0), (0, 0)]})
    for f in (0, 1):
        sums.add("w", f, g[f])
    sums.end()
    assert torch.equal(sums.sums["w"][key], g[1] + g[0])


def test_int8_moments_and_bf16_masters_of_init_mesh_state(monkeypatch):
    """Int8 moments and bf16 masters (arctic's `PARAM_DTYPE`, patched in
    for the reduced config) placed a layer at a time equal
    `shard_params`'s."""
    cfg = registry.reduced("qwen2.5-3b")
    monkeypatch.setitem(tsteps.PARAM_DTYPE, cfg.name, torch.bfloat16)
    m = _mesh((1, 4))
    policy = make_policy(m, cfg)
    opt_cfg = adamw.AdamWConfig(quantized_moments=True)
    want = tsteps.shard_params({n: t.clone() for n, t in
                                _masters("qwen2.5-3b").items()}, policy,
                               opt_cfg)
    _assert_states_equal(tsteps.init_mesh_state(cfg, policy, opt_cfg), want)
