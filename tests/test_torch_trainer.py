"""The port's fault-tolerant trainer (`train.trainer`, `launch.train`) and
what it stands on (`data.synthetic.SyntheticStream`, `launch.shapes`,
`models.registry` accounting) on the CPU.

Restart exactness is held bitwise: a run preempted through
`PreemptionGuard` and resumed from its checkpoint gives the losses of
an uninterrupted run exactly (the reference's own restart tests fail on
this JAX, so the port is held to itself, as the reference's tests hold
the reference).  The shape tables and the parameter counts are held
equal to the reference's; the counts come from shapes only (the full
qwen2.5-3b and qwen3-8b are never drawn).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.launch import shapes as rshapes
from repro.models import registry as rmodels
from repro_torch.configs import registry
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.launch import shapes as tshapes
from repro_torch.models import registry as tmodels
from repro_torch.runtime.fault_tolerance import (RESTART_EXIT_CODE,
                                                 FailureInjector,
                                                 PreemptionGuard,
                                                 SimulatedNodeFailure,
                                                 run_supervised)
from repro_torch.train.trainer import TrainerConfig, train
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

ROOT = Path(__file__).resolve().parents[1]


def _tcfg(path, steps=6, ckpt_every=4):
    return TrainerConfig(seq=32, global_batch=4, total_steps=steps,
                         ckpt_every=ckpt_every, ckpt_dir=str(path),
                         log_every=0)


def test_resume_is_bitwise_identical(tmp_path):
    cfg = registry.reduced("qwen2.5-3b")
    ref = train(cfg, _tcfg(tmp_path / "ref"), device="cpu")
    assert ref.exit_code == 0 and ref.steps_run == 6

    guard = PreemptionGuard()

    def on_step(step, metrics):
        if step == 2:
            guard.request()

    r1 = train(cfg, _tcfg(tmp_path / "int"), guard=guard, on_step=on_step,
               device="cpu")
    assert r1.exit_code == RESTART_EXIT_CODE and r1.steps_run == 3
    r2 = train(cfg, _tcfg(tmp_path / "int"), device="cpu")
    assert r2.exit_code == 0 and r2.steps_run == 3
    np.testing.assert_array_equal(np.asarray(r1.losses + r2.losses),
                                  np.asarray(ref.losses))
    assert all(np.isfinite(ref.losses))


def test_injected_node_failure_supervised(tmp_path):
    cfg = registry.reduced("qwen3-8b")
    injector = FailureInjector(fail_at_steps=(5,))
    calls = []

    def run_once():
        calls.append(1)
        inj = injector if len(calls) == 1 else None
        return train(cfg, _tcfg(tmp_path, steps=8), injector=inj,
                     device="cpu").exit_code

    code = run_supervised(run_once, max_restarts=2, backoff_s=0.0)
    assert code == 0
    assert len(calls) == 2   # failed once, restarted once
    assert injector.fired == [("train", 5, "node")]


def test_failure_without_supervisor_raises(tmp_path):
    cfg = registry.reduced("qwen3-8b")
    with pytest.raises(SimulatedNodeFailure):
        train(cfg, _tcfg(tmp_path), injector=FailureInjector(
            fail_at_steps=(2,)), device="cpu")


def test_train_cli_runs_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2.5-3b", "--reduced", "--device", "cpu", "--steps", "4",
           "--seq", "32", "--batch", "2", "--ckpt-dir", str(tmp_path),
           "--ckpt-every", "2"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "step     0 loss" in out.stdout
    assert (tmp_path / "LATEST").read_text() == "step_00000004"
    bad = subprocess.run(cmd + ["--mesh", "2x1"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert bad.returncode != 0 and "1x1" in bad.stderr


def test_trainer_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(registry.reduced("qwen2.5-3b"), _tcfg(tmp_path))


def test_synthetic_stream_is_deterministic_and_slices_hosts():
    cfg = DataConfig(vocab=512, seq=16, global_batch=8, seed=3)
    a, b = SyntheticStream(cfg), SyntheticStream(cfg)
    for step in (0, 5):
        x, y = a.global_batch(step), b.global_batch(step)
        assert torch.equal(x["inputs"], y["inputs"])
        assert torch.equal(x["inputs"][:, 1:], x["targets"][:, :-1])
        assert x["inputs"].shape == (8, 16)
        assert int(x["inputs"].max()) < 512
    assert not torch.equal(a.global_batch(0)["inputs"],
                           a.global_batch(1)["inputs"])
    full = a.global_batch(2)
    parts = [a.host_batch(2, process_index=i, process_count=4)
             for i in range(4)]
    for k in full:
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k])
    assert torch.equal(a.host_batch(2)["targets"], full["targets"])


def test_shapes_match_reference():
    assert tshapes.MICROBATCHES == rshapes.MICROBATCHES
    for name in ("qwen2_5_3b", "qwen3_8b"):
        rc, tc = rregistry.get(name), registry.get(name)
        for sname, spec in tshapes.SHAPES.items():
            rs = rshapes.SHAPES[sname]
            assert tshapes.applicable(tc, spec) == rshapes.applicable(rc, rs)
            assert tshapes.microbatches_for(tc, spec) == \
                rshapes.microbatches_for(rc, rs)
            want = rshapes.batch_struct(rc, rs)
            got = tshapes.batch_struct(tc, spec)
            assert set(got) == set(want)
            for k in want:
                assert got[k].shape == want[k].shape
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype)


@pytest.mark.parametrize("name", ["qwen2_5_3b", "qwen3_8b"])
def test_param_counts_match_reference(name):
    for get in ("get", "reduced"):
        rc = getattr(rregistry, get)(name)
        tc = getattr(registry, get)(name)
        assert tmodels.count_params(tc) == rmodels.count_params(rc)
        assert tmodels.count_params(tc, active_only=True) == \
            rmodels.count_params(rc, active_only=True)
        assert tmodels.embedding_params(tc) == rmodels.embedding_params(rc)
        assert tc.n_params() == rc.n_params()
        assert tc.n_active_params() == rc.n_active_params()
    if name == "qwen2_5_3b":
        assert registry.get(name).n_params() == 3_397_103_616


def test_build_model_loss_matches_lm_loss():
    cfg = registry.reduced("qwen2.5-3b")
    api = tmodels.build_model(cfg, remat=True)
    params = api.init(seed=1, device="cpu")
    batch = SyntheticStream(DataConfig(cfg.vocab, 16, 2)).global_batch(0)
    loss, met = api.loss(params, batch)
    from repro_torch.models.lm import lm_loss
    want, _ = lm_loss(params, batch, cfg)
    assert torch.equal(loss.detach(), want.detach())
    assert float(met["aux_loss"]) == 0.0
    with pytest.raises(NotImplementedError):
        tmodels.build_model(dataclasses.replace(cfg, family="ssm"))


def test_serve_step_is_decode_step():
    """`make_serve_step` on the decode shape: `fn` is `decode_step` over a
    fresh state of the shape's batch and cache length."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm

    cfg = registry.reduced("qwen2.5-3b")
    params = lm.init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    shape = dataclasses.replace(tshapes.SHAPES["decode_32k"], batch=2,
                                seq=16)
    step = make_serve_step(cfg, shape, device="cpu")
    assert step.tokens_shape == (2,)
    state, want_state = step.init_state(), lm.init_decode_state(
        cfg, 2, 16, device="cpu")
    assert state["caches"]["k"].shape == want_state["caches"]["k"].shape
    toks = torch.tensor([3, 7])
    for _ in range(3):
        got, state = step.fn(params, state, toks)
        want, want_state = lm.decode_step(params, want_state, toks, cfg)
        assert torch.equal(got, want)
        toks = got.argmax(-1)
    assert state["pos"] == 3
