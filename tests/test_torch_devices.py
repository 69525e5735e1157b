"""Kernels launch on their tensors' device, and a mesh holds one device
type.

An entry point of the port's CUDA libraries launches on the calling
thread's current device, and CUDA refuses a launch into a stream of
another device; so every wrapper's C call goes through
`kernels._build.launch`, which makes the tensor's device current first.
These tests hold that with no card: the guard is monkeypatched, the
wrappers are driven with `meta` tensors (their kernel branch, with a
stand-in library) and the wrapper sources are read.  The `cuda` tests
need two or four cards and skip with fewer.
"""
import ast
import contextlib
import pathlib
import types

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.acim_matmul import kernel as am
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.maze_route import kernel as mr
from repro_torch.kernels.pareto_dom import kernel as pd
from repro_torch.parallel import distributed_explorer as dx

KERNELS = pathlib.Path(pd.__file__).resolve().parents[1]
# C entry points that launch a kernel, by wrapper file
ENTRIES = {"pareto_dom": {"nds_rank", "dominance_matrix", "nsga2_evolve"},
           "maze_route": {"wavefront", "trace_paths", "route_slots"},
           "acim_matmul": {"acim_matmul", "acim_matmul_wgmma",
                           "acim_matmul_mma"},
           "flash_attention": {"name"}}   # `_fn(name)`: both routes


def test_launch_makes_the_tensors_device_current(monkeypatch):
    seen = []

    @contextlib.contextmanager
    def guard(device):
        seen.append(("enter", torch.device(device)))
        yield
        seen.append(("exit", torch.device(device)))

    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: f"stream of {t.device}")
    t = types.SimpleNamespace(device=torch.device("cuda:1"))

    def entry(*args):
        seen.append(("call", args))
        return 0

    _build.launch(t, entry, "entry", 1, 2)
    assert seen == [("enter", torch.device("cuda:1")),
                    ("call", (1, 2, "stream of cuda:1")),
                    ("exit", torch.device("cuda:1"))]
    with pytest.raises(RuntimeError, match="bad: CUDA error 700"):
        _build.launch(t, lambda *a: 700, "bad")


@pytest.mark.parametrize("family", sorted(ENTRIES))
def test_every_c_call_goes_through_launch(family):
    """Read from the source: each launching entry point is called only as
    `_build.launch`'s function argument, whose first argument is one of
    the wrapper's tensors, and no wrapper reads a stream itself."""
    src = (KERNELS / family / "kernel.py").read_text()
    assert "stream_ptr" not in src
    tree = ast.parse(src)
    launched = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            if node.func.attr in ENTRIES[family] and not (
                    isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ("_build",)):
                # a direct call of a launching entry point
                raise AssertionError(f"{family}: {ast.unparse(node)} is "
                                     f"not made through _build.launch")
            if ast.unparse(node.func) == "_build.launch":
                first, fn_arg = node.args[0], node.args[1]
                assert isinstance(first, ast.Name) and first.id in params, \
                    ast.unparse(node)
                # lib.<entry>, _lib().<entry> or _fn(<entry name>)
                launched.add(fn_arg.attr if isinstance(fn_arg, ast.Attribute)
                             else ast.unparse(fn_arg.args[0]).strip("'\""))
    assert launched == ENTRIES[family], (family, launched)


class _FakeLib:
    """Stands in for a built library: host queries answer generously,
    entry points are never reached (`_build.launch` is patched)."""

    def __getattr__(self, name):
        if name.endswith("_smem_limit"):
            return lambda: 1 << 30
        if name.endswith("_bytes"):
            return lambda *a: 0
        return lambda *a: pytest.fail(f"{name} called outside launch")


@pytest.fixture
def launches(monkeypatch):
    seen = []
    monkeypatch.setattr(_build, "launch", lambda t, fn, what, *a:
                        seen.append((what, t.device)))
    monkeypatch.setattr(pd, "_lib", lambda: _FakeLib())
    monkeypatch.setattr(mr, "_lib", lambda: _FakeLib())
    monkeypatch.setattr(am, "_fn", lambda name: None)
    monkeypatch.setattr(fa, "_fn", lambda name: None)
    monkeypatch.setattr(am, "_count", lambda name: None)
    # the device checks of acim_matmul's output and of flash_attention's
    # inputs name cuda; meta stands in for it here
    monkeypatch.setattr(am, "_out", lambda x, w: torch.empty(
        (x.shape[0], w.shape[1]), device=x.device))
    monkeypatch.setattr(fa, "_check", lambda *a: None)
    for mod in (pd, mr, fa):
        monkeypatch.setattr(mod, "count_launch", lambda name, n=1: None)
    return seen


def test_wrappers_launch_on_their_tensors_device(launches):
    """Each wrapper's kernel branch (`meta` tensors take it as a card's
    would) hands `_build.launch` the tensor whose device the launch
    needs."""
    meta = torch.device("meta")
    f = torch.empty((2, 64, 4), device=meta)
    pd.nds_rank(f)
    pd.dominance_matrix(f)
    occ = torch.empty((2, 8, 8), dtype=torch.bool, device=meta)
    mr.wavefront(occ, torch.empty_like(occ))
    x = torch.empty((16, 32), device=meta)
    w = torch.empty((32, 16), device=meta)
    am.acim_matmul_cuda_core(x, w, 16, 4)
    am.acim_matmul_wgmma(x, w, 16, 4, splits=1)
    am.acim_matmul_mma(x, w, 8, 3, splits=1)
    q = torch.empty((1, 64, 2, 64), dtype=torch.bfloat16, device=meta)
    kv = torch.empty((1, 64, 1, 64), dtype=torch.bfloat16, device=meta)
    fa.flash_attention_tf32x3(q.float(), kv.float(), kv.float())
    fa.flash_attention_wgmma(q, kv, kv)
    assert launches == [
        ("nds_rank", meta), ("dominance_matrix", meta), ("wavefront", meta),
        ("acim_matmul", meta), ("acim_matmul_wgmma", meta),
        ("acim_matmul_mma", meta),
        ("flash_attention", meta), ("flash_attention_wgmma", meta)]


def test_mesh_refuses_mixed_device_types():
    with pytest.raises(ValueError, match="one device type"):
        dx.as_mesh(("cuda:0", "cpu"))
    with pytest.raises(ValueError, match="one device type"):
        dx.explore_cells_mesh([(4096, 0)], mesh=("cpu", "cuda:0"),
                              islands=2)
    assert dx.as_mesh(("cpu", "cpu")) == (torch.device("cpu"),) * 2
    assert dx.as_mesh(["cuda:0", "cuda:1"]) == (torch.device("cuda", 0),
                                                torch.device("cuda", 1))


@pytest.mark.cuda
def test_islands_on_two_cards_equal_one_position():
    """8 islands on ("cuda:0", "cuda:1"): the ring migrates between the
    cards and the fronts equal one position's; every launch on cuda:1
    runs with cuda:1 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cells = [(16384, 0)]
    kw = dict(islands=8, migrate_every=10, pop_size=96, generations=30)
    one, f1 = dx.explore_cells_mesh(cells, mesh=("cuda:0",), **kw)
    two, f2 = dx.explore_cells_mesh(cells, mesh=("cuda:0", "cuda:1"), **kw)
    assert (f1["mesh_devices"], f2["mesh_devices"]) == (1, 2)
    assert one[cells[0]].to_rows() == two[cells[0]].to_rows()


@pytest.mark.cuda
def test_session_on_the_second_card():
    """`DesignSession(device="cuda:1")` runs every kernel of the request on
    the second card (one `nsga2_evolve` and one `route_slots` launch) and
    gives the first card's rows; the thread's current device is left as
    it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.api import DesignRequest, DesignSession
    from repro_torch.kernels import LAUNCHES

    req = DesignRequest(array_size=16384)
    want = DesignSession(device="cuda:0").run(req)
    before = torch.cuda.current_device()
    LAUNCHES.clear()
    got = DesignSession(device="cuda:1").run(req)
    assert torch.cuda.current_device() == before
    assert (LAUNCHES["nsga2_evolve"], LAUNCHES["route_slots"]) == (1, 1)
    assert got.summary() == want.summary()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b"])
def test_mesh_step_on_four_cards_equals_one_card(arch):
    """The reduced config's 1x4 train step with one position a card
    (autograd runs a backward thread a card, the grad sums' order fixed
    by `steps.GradSums`) equals the same mesh on four cuda:0 positions
    bit for bit: loss, every reduced grad and every master after it that
    two one-card runs agree on (all but two at most)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    cfg = registry.reduced(arch)
    masters = {n: p.detach().cpu() for n, p in steps.build_model(cfg).init(
        seed=0, device="cpu").named_parameters()}
    batch = batch_for(cfg, 64, 8, 0, seed=0, device="cuda:0")

    def run(positions):
        grads = {}
        mesh = make_mesh((1, 4), ("data", "model"), positions)
        step = steps.make_train_step(cfg, mesh, on_grad=lambda n, g:
                                     grads.update({n: g.cpu()}))
        state = steps.shard_params(masters, step.policy, step.opt_cfg)
        state, met = step.fn(state, batch)
        return met["loss"].cpu(), grads, {
            n: t.cpu() for n, t in state.full()["params"].items()}

    one, again = run(["cuda:0"] * 4), run(["cuda:0"] * 4)
    four = run([f"cuda:{i}" for i in range(4)])
    assert torch.equal(one[0], four[0]) or not torch.equal(one[0], again[0])
    agreed = 0
    for a, b, c in zip(one[1:], again[1:], four[1:]):
        assert list(a) == list(c)
        for n in a:
            # a leaf the card's own atomics leave apart between two
            # one-card runs is not held bitwise
            if torch.equal(a[n], b[n]):
                agreed += 1
                assert torch.equal(a[n], c[n]), n
    assert agreed >= len(one[1]) + len(one[2]) - 2
