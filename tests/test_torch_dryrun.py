"""The port's dry-run (`launch/dryrun.py`): every cell sized without
running it.  A record carries the reference's ok-record keys (read from
the reference's source: its compiled run needs 512 forced host devices);
its bytes a position equal the sum of that position's shard bytes, which
a state actually split on CPU positions holds to the byte; `--all` over
both production meshes takes seconds."""
import ast
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.parallel.sharding import make_policy, shard_count
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

REF = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" / \
    "launch" / "dryrun.py"


def _reference_ok_keys() -> tuple[set, set]:
    """The keys of the reference's ok record and of its `roofline`, from
    its `rec.update(status="ok", ...)` call and its `terms` dict."""
    tree = ast.parse(REF.read_text())
    top, roof = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "update" and any(k.arg == "status" for k in node.keywords):
            kws = {k.arg: k.value for k in node.keywords}
            if isinstance(kws["status"], ast.Constant) \
                    and kws["status"].value == "ok":
                top = set(kws)
                roof |= {k.value for k in kws["roofline"].keys
                         if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", "") == "terms":
            roof |= {k.value for k in node.value.keys}
    return top | {"arch", "shape", "mesh", "kind"}, roof


@pytest.mark.parametrize("arch,shape", [("qwen2.5-3b", "train_4k"),
                                        ("zamba2-2.7b", "long_500k"),
                                        ("deepseek-v2-lite-16b",
                                         "decode_32k")])
def test_run_cell_records_the_reference_keys(tmp_path, arch, shape):
    rec = dryrun.run_cell(arch, shape, False, out_dir=tmp_path)
    top, roof = _reference_ok_keys()
    assert rec["status"] == "ok" and set(rec) == top
    assert set(rec["roofline"]) == roof | {"dominant_over"}
    assert json.loads(next(tmp_path.glob("*.json")).read_text()) == rec
    mem = rec["memory"]
    assert mem["temp_bytes"] is None and mem["total_bytes"] == \
        mem["argument_bytes"] == mem["state_bytes"] + mem["batch_bytes"]
    assert mem["fits_80gb"] == (mem["argument_bytes"] < 80e9)
    if shape == "train_4k":    # "tp" over model 16: partials all-reduced
        assert rec["collectives"]["bytes"]["activation all-reduce"] > 0
    # no collective term: the dominant one is of compute and memory
    r = rec["roofline"]
    assert r["collective_s"] is None
    assert r["dominant_over"] == ["compute_s", "memory_s"]
    assert r["dominant"] == max(("compute_s", "memory_s"), key=r.get)
    skip = dryrun.run_cell("qwen2.5-3b", "long_500k", True, out_dir=tmp_path)
    assert skip["status"] == "skip"


def test_position_bytes_are_the_sum_of_shard_bytes():
    """Production cell: the state and batch bytes a position holds are
    the sum over leaves of numel / pieces x itemsize."""
    cfg = registry.get("qwen2.5-3b")
    mesh = Mesh((2, 16, 16), ("pod", "data", "model"))
    shape = tshapes.SHAPES["train_4k"]
    got = dryrun.position_bytes(cfg, shape, mesh)
    pol = make_policy(mesh, cfg)
    struct, specs = tsteps.make_train_state_struct(
        cfg, pol, tsteps.default_opt_cfg(cfg))
    want = sum(int(np.prod(leaf.shape)) // shard_count(mesh, spec)
               * torch.empty((), dtype=leaf.dtype).element_size()
               for leaf, spec in dryrun._leaves(struct, specs))
    assert got["state_bytes"] == want
    assert got["batch_bytes"] == 2 * (256 // 32) * 4096 * 4


@pytest.mark.parametrize("shape,strategy", [((2, 2), "fsdp"), ((4, 1), "tp"),
                                            ((1, 1), "tp")])
def test_position_bytes_match_a_sharded_state(shape, strategy):
    """A state split on CPU positions holds exactly the bytes predicted
    for each position (replicated leaves counted on every holder)."""
    cfg = registry.reduced("qwen2.5-3b")
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    step = tsteps.make_train_step(cfg, mesh, model_strategy=strategy)
    model = tsteps.build_model(cfg).init(seed=0, device="cpu")
    state = tsteps.shard_params(dict(model.named_parameters()), step.policy,
                                step.opt_cfg)
    want = dryrun.position_bytes(
        cfg, tshapes.ShapeSpec("t", "train", 32, 8), mesh,
        model_strategy=strategy)
    for f in range(mesh.size):
        assert state.position_bytes(f) == want["state_bytes"]
    assert want["batch_bytes"] == 2 * (8 // mesh.size) * 32 * 4


def test_train_collectives_of_zero3(tmp_path):
    """ZeRO-3 on 16 x 16 (the "perf" variant): every split parameter's
    bf16 gather and grad reduce-scatter send (n - 1) / n of it a
    microbatch.  The mesh spans 32 nodes and links between nodes are
    not modeled, so collective_s is null and the dominant term is of
    compute and memory; on a mesh of one node the same bytes go over
    NVLink."""
    cfg = registry.get("qwen2.5-3b")
    rec = dryrun.run_cell("qwen2.5-3b", "train_4k", False, variant="perf",
                          out_dir=tmp_path)
    coll = rec["collectives"]
    assert coll["bytes"]["all-gather"] == coll["bytes"]["reduce-scatter"] > 0
    assert rec["roofline"]["collective_s"] is None
    assert rec["roofline"]["dominant_over"] == ["compute_s", "memory_s"]
    assert coll["bytes"]["all-gather"] <= 2 * cfg.n_params() * 255 / 256
    assert (tmp_path / "qwen2_5_3b__train_4k__pod16x16__perf.json").exists()
    node = Mesh((2, 4), ("data", "model"))
    assert dryrun.collective_seconds(coll, node) == \
        coll["total_bytes"] / 450e9
    assert dryrun.collective_seconds(coll, Mesh((16, 16), ("data", "model"))) \
        is None
    assert dryrun.collective_seconds(None, node) is None


def test_all_cells_in_seconds(tmp_path, capsys):
    t0 = time.perf_counter()
    rows = dryrun.main(["--all", "--out-dir", str(tmp_path)])
    took = time.perf_counter() - t0
    assert len(rows) == 80 and took < 60
    skips = [r for r in rows if r["status"] == "skip"]
    assert len(skips) == 16 and all(r["shape"] == "long_500k" for r in skips)
    assert sum(r["status"] == "ok" for r in rows) == 64
    assert "64 ok, 0 error, 16 skip / 80 cells" in capsys.readouterr().out
    assert len(list(tmp_path.glob("*.json"))) == 80
    multi = dryrun.main(["--all", "--multi-pod-only", "--out-dir",
                         str(tmp_path)])
    assert len(multi) == 40 and all(r["mesh"] == "pod2x16x16" for r in multi)


def test_perf_variant_cells(tmp_path, capsys):
    """`--all --variant perf`: ZeRO-3 joins "model" to the dp axes, so on
    2 x 16 x 16 the train batch of 256 does not divide 512 positions and
    those five cells are errors (the batch specs carry no guard, as the
    reference's); the five configs' 16 x 16 train cells record their
    collective bytes, and so do the other dense configs' and the MoE
    configs' "tp" train cells on both meshes."""
    rows = dryrun.main(["--all", "--variant", "perf", "--out-dir",
                        str(tmp_path)])
    errors = [r for r in rows if r["status"] == "error"]
    zero3 = {n for n, o in tsteps.PERF_TRAIN_OVERRIDES.items()
             if o.get("model_strategy") == "fsdp"}
    assert {r["arch"] for r in errors} == zero3
    assert all(r["shape"] == "train_4k" and r["mesh"] == "pod2x16x16"
               and "256 over 512" in r["error"] for r in errors)
    sent = [r for r in rows if r["status"] == "ok" and r["collectives"]]
    tp = {n for n in registry.ARCH_IDS if registry.get(n).family in
          ("dense", "vlm", "moe") and registry.get(n).name not in zero3}
    assert {(r["arch"], r["mesh"]) for r in sent} == {
        (n, "pod16x16") for n in zero3} | {
        (registry.get(n).name, mesh) for n in tp
        for mesh in ("pod16x16", "pod2x16x16")}
    assert "59 ok, 5 error, 16 skip / 80 cells" in capsys.readouterr().out
