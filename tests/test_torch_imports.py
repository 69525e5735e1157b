"""The port stands alone: no module of `repro_torch` (nor the chip
scripts) imports JAX or the JAX package, and its entry points refuse to run
without a CUDA device unless given one."""
import ast
import pathlib
import subprocess
import sys
import warnings

import pytest
import torch

from repro_torch.api import DesignSession

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


# The port's lint, operator CLI, docs checker, design-flow examples and
# LM examples (serving, CIM-in-the-loop training).
EXTRAS = ([ROOT / "tools" / name for name in
           ("repro_torch_lint.py", "repro_torch_ctl.py",
            "check_docs_torch.py")]
          + sorted((ROOT / "examples" / "torch").glob("*.py")))


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_profile.py"] + EXTRAS


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_tools_and_examples_load_no_jax():
    """The port's lint, operator CLI, docs checker, design-flow and LM
    examples load without JAX or the JAX package."""
    code = (
        "import importlib.util, sys\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('m', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n")
    assert len(EXTRAS) == 9 and all(p.exists() for p in EXTRAS)
    out = subprocess.run([sys.executable, "-c", code, *map(str, EXTRAS)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_paper_drivers_are_checked():
    """The paper drivers (`repro_torch.paper`, the counterparts of
    `benchmarks/`' result drivers) are among the sources checked below
    and the modules the first test imports."""
    names = {p.name for p in (PKG / "paper").glob("*.py")}
    assert {"fig8_layouts.py", "fig9_design_space.py", "fig10_sota.py",
            "snr_mc.py", "table2_flow.py", "roofline.py", "run.py"} <= names
    assert set((PKG / "paper").glob("*.py")) <= set(_sources())


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_session_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DesignSession()
    assert DesignSession(device="cpu").device.type == "cpu"


def test_prefill_without_cuda_raises(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.reduced("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_prefill_step(cfg, SHAPES["prefill_32k"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm(cfg, dtype=torch.bfloat16)
    assert make_prefill_step(cfg, SHAPES["prefill_32k"],
                             device="cpu").device.type == "cpu"


@pytest.mark.parametrize("rel", ["optim/adamw.py", "checkpoint/ckpt.py",
                                 "train/trainer.py", "launch/train.py",
                                 "launch/steps.py"])
def test_training_stack_is_checked(rel):
    """The training stack's modules are among the sources checked above
    and import neither JAX nor the JAX package."""
    path = PKG / rel
    assert path in _sources()
    test_no_jax_or_reference_import(path)


@pytest.mark.parametrize("rel", ["analysis/core.py", "analysis/callgraph.py",
                                 "analysis/trace_purity.py",
                                 "analysis/lock_discipline.py",
                                 "analysis/schema_drift.py"])
def test_analysis_is_checked(rel):
    """The static-analysis modules are among the sources checked above
    and import neither JAX nor the JAX package."""
    path = PKG / rel
    assert path in _sources()
    test_no_jax_or_reference_import(path)


def test_explorer_shims_without_cuda_raise(monkeypatch):
    """Item 7's entry points run on the card unless given a device."""
    from repro_torch import api
    from repro_torch.core import explorer, nsga2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(api, "_DEFAULT_SESSION", None)
    cfg = nsga2.NSGA2Config(4096, pop_size=8, generations=1)
    for build in (lambda: explorer.explore(4096),
                  lambda: explorer.explore_sizes((4096,)),
                  lambda: explorer.distill_and_layout(4096),
                  lambda: nsga2.run(cfg),
                  lambda: nsga2.init_population(0, cfg)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(RuntimeError, match="CUDA"):
                build()
    assert nsga2.run(cfg, device="cpu").genes.shape == (8, 3)


def test_train_step_without_cuda_raises(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.launch.train import main
    from repro_torch.train.trainer import TrainerConfig, init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.reduced("qwen2.5-3b")
    for build in (lambda: make_train_step(cfg),
                  lambda: make_serve_step(cfg, SHAPES["decode_32k"]),
                  lambda: init_state(cfg, TrainerConfig()),
                  lambda: main(["--arch", "qwen2.5-3b", "--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert make_train_step(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["whisper-large-v3", "xlstm-125m"])
def test_audio_and_ssm_entry_points_without_cuda_raise(arch, monkeypatch):
    """The audio and SSM families' entry points run on the card unless
    given a device: each raises without one, and runs on `cpu`."""
    from repro_torch.configs import registry
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import whisper, xlstm
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.reduced(arch)
    api = build_model(cfg)
    builds = [lambda: api.init(),
              lambda: api.init_decode_state(2, 8),
              lambda: make_prefill_step(cfg, SHAPES["prefill_32k"]),
              lambda: make_serve_step(cfg, SHAPES["decode_32k"]),
              lambda: ServeEngine(cfg, None)]
    if cfg.family == "audio":
        builds.append(lambda: whisper.init_whisper_decode_state(cfg, 1, 8))
    else:
        builds += [lambda: xlstm.init_mlstm_state(cfg, 1),
                   lambda: xlstm.init_slstm_state(cfg, 1)]
    for build in builds:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    params = api.init(device="cpu", dtype=torch.bfloat16)
    state = api.init_decode_state(2, 8, device="cpu")
    logits, state = api.decode_step(params, state,
                                    torch.zeros(2, dtype=torch.long))
    assert tuple(logits.shape) == (2, cfg.vocab) and state["pos"] == 1
