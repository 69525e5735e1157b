"""The port's LM examples, `examples/torch/serve_acim.py` (continuous
batching over the decode step) and `examples/torch/train_acim_lm.py`
(the CIM-in-the-loop LM with checkpoints and auto-resume), at their smoke
budgets on the CPU.  Neither imports JAX or the reference package; the
serving example's completions are held to `ServeEngine`'s own on the same
weights, and a training run stopped after a checkpoint and resumed ends
with the parameters of a run that never stopped, bit for bit.
"""
import importlib.util
import pathlib

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.acim_lm import build_cfg
from repro_torch.models.lm import init_lm

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(name: str):
    path = REPO / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_example_on_the_cpu(capsys):
    _load("serve_acim").main(["--device", "cpu", "--smoke"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("3 completions, 12 tokens in "), out
    cfg = registry.reduced("qwen2.5-3b")
    eng = ServeEngine(cfg, build_model(cfg).init(seed=0, device="cpu"),
                      slots=3, max_seq=128, device="cpu")
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=[3 + uid, 7, 11], max_new=4))
    want = sorted(eng.run(max_steps=512), key=lambda c: c.uid)
    assert out[1:] == [f"  req {c.uid}: {c.tokens}" for c in want]


def _params(path) -> dict:
    like = {"params": dict(init_lm(build_cfg(64, 1), seed=0,
                                   device="cpu").named_parameters())}
    return ckpt.restore(path, ckpt.latest_step(path), like)["params"]


def test_train_example_resumes_bitwise(capsys, tmp_path):
    mod = _load("train_acim_lm")
    whole, part = tmp_path / "whole", tmp_path / "part"
    mod.main(["--device", "cpu", "--smoke", "--ckpt-dir", str(whole)])
    out = capsys.readouterr().out
    assert "codesign pick: MacroSpec(" in out
    assert "step    3 loss " in out
    assert "done — CIM-in-the-loop training converged" in out
    assert ckpt.latest_step(whole) == 3
    mod.main(["--device", "cpu", "--smoke", "--steps", "2", "--ckpt-dir",
              str(part)])
    assert ckpt.latest_step(part) == 1
    mod.main(["--device", "cpu", "--smoke", "--ckpt-dir", str(part)])
    out = capsys.readouterr().out
    assert f"resumed from step 1 in {part}" in out
    assert ckpt.latest_step(part) == 3
    got, want = _params(part), _params(whole)
    assert set(got) == set(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
