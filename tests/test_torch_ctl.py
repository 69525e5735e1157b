"""The port's operator and user tools: `tools/repro_torch_ctl.py`,
`tools/repro_torch_lint.py`, `tools/check_docs_torch.py` and
`examples/torch/*.py`, on the CPU.

`metrics`, `gantt` and `cache stats` of the port's CLI print the lines
`tools/repro_ctl.py` prints, on the same snapshot, trace and cache
files, written once by the reference's `drain` and once by the port's.
The port's `drain --device cpu` lands what `DesignSession.run_many`
computes; the linter and the docs checker pass the tree and each flags
a fault planted in a copy; the examples run at their smoke budgets.
"""
import importlib.util
import json
import pathlib
import shutil

import pytest

from repro_torch.api import (ArtifactCache, DesignRequest, DesignSession,
                             Requirements)

REPO = pathlib.Path(__file__).resolve().parents[1]
# Two small requests (4096, pop 48 x 10 generations), the second keeping
# a few specs, so the plain CPU routing stays under a second a request.
REQUESTS = [
    DesignRequest(array_size=4096, pop_size=48, generations=10,
                  requirements=Requirements(min_snr_db=25.0, min_tops=0.3)),
    DesignRequest(array_size=4096, pop_size=48, generations=10, seed=1,
                  requirements=Requirements(min_snr_db=17.0, min_tops=0.4)),
]


def _load(rel: str):
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ctl():
    return _load("tools/repro_torch_ctl.py")


@pytest.fixture(scope="module")
def ref_ctl():
    return _load("tools/repro_ctl.py")


@pytest.fixture(scope="module")
def drained(tmp_path_factory, ctl, ref_ctl):
    """Telemetry and cache of one drain of REQUESTS by each package:
    {"port": (out_dir, cache_dir), "ref": (...)}."""
    root = tmp_path_factory.mktemp("drain")
    reqs = root / "requests.json"
    reqs.write_text(json.dumps({"requests": [r.to_dict()
                                             for r in REQUESTS]}))
    out = {}
    for name, mod, extra in (("port", ctl, ["--device", "cpu"]),
                             ("ref", ref_ctl, [])):
        tel, cache = root / f"{name}_tel", root / f"{name}_cache"
        rc = mod.main(["drain", str(reqs), "--out-dir", str(tel),
                       "--cache-dir", str(cache), "--max-coalesce", "2",
                       *extra])
        assert rc == 0
        out[name] = (tel, cache)
    return out


def _lines(capsys, mod, argv):
    capsys.readouterr()
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


CLI_CASES = {
    "metrics": lambda tel, cache: ["metrics",
                                   str(tel / "service_metrics.json")],
    "metrics_all": lambda tel, cache: ["metrics", "--all",
                                       str(tel / "service_metrics.json")],
    "metrics_prometheus": lambda tel, cache: [
        "metrics", "--prometheus", str(tel / "service_metrics.json")],
    "gantt": lambda tel, cache: ["gantt", str(tel / "service_trace.json")],
    "gantt_ascii": lambda tel, cache: ["gantt", "--ascii", "--control",
                                       str(tel / "service_trace.json")],
    "gantt_stage_totals": lambda tel, cache: [
        "gantt", "--stage-totals", str(tel / "service_trace.json")],
    "cache_stats": lambda tel, cache: ["cache", str(cache), "stats"],
}


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_prints_the_reference_lines(capsys, ctl, ref_ctl, drained,
                                        writer, case):
    argv = CLI_CASES[case](*drained[writer])
    rc_port, port = _lines(capsys, ctl, argv)
    rc_ref, ref = _lines(capsys, ref_ctl, argv)
    assert (rc_port, port) == (rc_ref, ref)
    assert port.strip()


def test_drain_lands_run_many(drained):
    tel, cache_dir = drained["port"]
    cache = ArtifactCache(cache_dir)
    want = DesignSession(device="cpu").run_many(REQUESTS)
    assert len(cache) == len(REQUESTS)
    for r in REQUESTS:
        got = cache.get(r)
        assert got is not None and got.ok
        assert got.summary() == want[r].summary()
    metrics = json.loads((tel / "service_metrics.json").read_text())
    assert metrics["schema"] == 1
    assert (tel / "service_gantt.json").exists()


def test_cache_actions(capsys, ctl, tmp_path, drained):
    _, cache_dir = drained["port"]
    root = tmp_path / "cache"
    shutil.copytree(cache_dir, root)
    rc, out = _lines(capsys, ctl, ["cache", str(root), "prune",
                                   "--max-entries", "1"])
    assert rc == 0 and out.startswith("pruned 1 of 2 entries")
    rc, out = _lines(capsys, ctl, ["cache", str(root), "clear"])
    assert rc == 0 and out.startswith("cleared 1 entries")
    assert not list(root.glob("*.json"))


# -- the linter and the docs checker ----------------------------------

@pytest.fixture(scope="module")
def lint():
    return _load("tools/repro_torch_lint.py")


def test_lint_strict_passes_the_tree(capsys, lint):
    rc, out = _lines(capsys, lint, ["--strict"])
    assert rc == 0, out
    assert "0 finding(s)" in out


def test_lint_lists_rules(capsys, lint):
    rc, out = _lines(capsys, lint, ["--list-rules"])
    assert rc == 0
    for rule in ("host-sync", "host-guard", "lock-order", "schema-drift"):
        assert rule in out
    assert "set-iteration" in out and "not checked" in out


PLANTS = {
    # a host sync after the CPU fence of a kernel wrapper
    "host-sync": ("src/repro_torch/kernels/pareto_dom/kernel.py",
                  "    lib = _lib()\n    packed_in_smem =",
                  "    lib = _lib()\n    c = int(f.sum().item())\n"
                  "    packed_in_smem ="),
    # the plain version reached on the card
    "host-guard": ("src/repro_torch/kernels/pareto_dom/kernel.py",
                   "    out = torch.empty((c, p, p), dtype=torch.bool, "
                   "device=f.device)",
                   "    out = ref.dominance_matrix_ref(f)"),
    # a new serialized field without a schema bump
    "schema-drift": ("src/repro_torch/api/session.py",
                     '"error": self.error}',
                     '"error": self.error, "host": "here"}'),
    # a suppression left over after its finding went
    "bad-suppression": ("src/repro_torch/core/pareto.py",
                        "INF = float(\"inf\")",
                        "INF = float(\"inf\")  "
                        "# lint: disable=host-sync -- nothing here"),
}


@pytest.mark.parametrize("rule", sorted(PLANTS))
def test_lint_flags_a_planted_fault(capsys, lint, tmp_path, rule):
    shutil.copytree(REPO / "src" / "repro_torch",
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rel, old, new = PLANTS[rule]
    path = tmp_path / rel
    text = path.read_text()
    assert text.count(old) == 1
    path.write_text(text.replace(old, new))
    rc, out = _lines(capsys, lint, ["--root", str(tmp_path), "--strict"])
    assert rc == 1, out
    assert f"[{rule}]" in out and rel in out


@pytest.fixture(scope="module")
def check_docs():
    return _load("tools/check_docs_torch.py")


def test_check_docs_passes_the_tree(capsys, check_docs):
    rc, out = _lines(capsys, check_docs, [])
    assert rc == 0, out


def test_check_docs_flags_planted_faults(capsys, check_docs, tmp_path):
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    shutil.copy(REPO / "src/repro_torch/core/explorer.py", core)
    n = len((core / "explorer.py").read_text().splitlines())
    (tmp_path / "README.md").write_text("\n".join([
        "`repro_torch.core.explorer.explore` resolves,",
        "`repro_torch.core.explorer.ParetoResult.filter` too,",
        "`repro_torch.core.no_such_module` does not,",
        f"`src/repro_torch/core/explorer.py:{n}` resolves,",
        f"`src/repro_torch/core/explorer.py:{n - 1}-{n + 1}` does not,",
        "[a link](missing.md) does not.", ""]))
    rc, out = _lines(capsys, check_docs, ["--root", str(tmp_path)])
    assert rc == 3, out
    assert "README.md:3: unresolvable module reference" in out
    assert "README.md:5: line reference" in out
    assert "README.md:6: broken link target: missing.md" in out


# -- the design-flow examples -----------------------------------------

EXAMPLES = {
    "quickstart": ("solutions survive", "DRC clean=True"),
    "layout_flow": ("(a) H=128 W=128 L=2 B=3", "batched: 1 layouts"),
    "design_service": ("1 explorer dispatch(es)", "edge-snr"),
    "codesign_sweep": ("#macros@1tok/us", "arctic-480b"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(capsys, monkeypatch, tmp_path, name):
    monkeypatch.chdir(tmp_path)
    mod = _load(f"examples/torch/{name}.py")
    capsys.readouterr()
    mod.main(["--device", "cpu", "--smoke"])
    out = capsys.readouterr().out
    for text in EXAMPLES[name]:
        assert text in out, out
