"""The port's static analysis (`repro_torch.analysis`) held against the
JAX package's (`repro.analysis`).

Lock discipline and suppression handling give the reference's findings
(rule, path, line, message) on the reference's own fixtures under
`tests/fixtures/analysis/`, read only.  Kernel-path purity, which has
no JAX counterpart to hold it to, is pinned to bad / good fixture pairs
under `tests/fixtures/analysis_torch/`.  The schema-drift cases run on
the reference's schema fixtures parsed under the port's module name,
the committed manifest must equal the reference's, and the live port
tree must scan clean under `strict` (the gate of
`tools/repro_torch_lint.py --strict`).
"""
import json
import pathlib

import pytest

from repro.analysis import core as rcore
from repro.analysis import lock_discipline as rlocks
from repro_torch.analysis import run_all
from repro_torch.analysis import core as tcore
from repro_torch.analysis import lock_discipline as tlocks
from repro_torch.analysis import schema_drift, trace_purity

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "fixtures" / "analysis"
FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"
REF_FIXTURE_FILES = sorted(p.name for p in REF_FIXTURES.glob("*.py"))


def _as_tuples(findings):
    return [(f.rule, f.path, f.line, f.message) for f in findings]


def _both(fname, root=REF_FIXTURES, name=None):
    """The same file parsed by the reference's and the port's core."""
    ref = rcore.parse_file(root / fname, root=root, name=name)
    port = tcore.parse_file(root / fname, root=root, name=name)
    return {ref.name: ref}, {port.name: port}


def _mod(fname, name):
    m = tcore.parse_file(FIXTURES / fname, root=FIXTURES, name=name)
    return {m.name: m}


def _rules(findings):
    return {f.rule for f in findings}


@pytest.mark.parametrize("fname", REF_FIXTURE_FILES)
def test_lock_discipline_matches_reference(fname):
    rmods, tmods = _both(fname)
    assert _as_tuples(tlocks.run(tmods)) == _as_tuples(rlocks.run(rmods))


def test_port_locks_resolve():
    """The port's locks are known to the pass: the sanitizer-aware
    factories' and the raw `threading.Lock` globals, and the service's
    canonical `_lock -> stats_lock` acquisition order."""
    mods = tcore.load_tree(REPO)
    reg = tlocks._Registry(mods)
    assert "LOCK" in reg.module_locks["repro_torch.kernels"]
    assert "_FNS_LOCK" in \
        reg.module_locks["repro_torch.kernels.acim_matmul.kernel"]
    assert "_LIB_LOCK" in \
        reg.module_locks["repro_torch.kernels.maze_route.kernel"]
    assert "_GRID_SIG_LOCK" in reg.module_locks["repro_torch.api.session"]
    svc = next(c for c in reg.classes if c.name == "DesignService")
    # make_condition(self._lock) guards the same mutex as _lock
    for cond in ("_work", "_done_cv"):
        assert svc.locks[cond].canonical == "DesignService._lock"
    edges, _, reacquire = tlocks._order_edges(mods, reg)
    assert "DesignSession.stats_lock" in edges["DesignService._lock"]
    assert reacquire == []


def test_lock_fixture_flags_every_family():
    _, tmods = _both("locks_bad.py")
    found = tlocks.run(tmods)
    assert _rules(found) == {"unguarded-attr", "lock-order",
                             "lock-reacquire"}
    assert len([f for f in found if f.rule == "unguarded-attr"]) == 2


@pytest.mark.parametrize("fname", REF_FIXTURE_FILES)
def test_suppressions_on_fixtures_match_reference(fname):
    rmods, tmods = _both(fname)
    for strict in (False, True):
        rk, rs = rcore.apply_suppressions(rlocks.run(rmods), rmods,
                                          strict=strict)
        tk, ts = tcore.apply_suppressions(tlocks.run(tmods), tmods,
                                          strict=strict)
        assert _as_tuples(tk) == _as_tuples(rk)
        assert _as_tuples(ts) == _as_tuples(rs)


SUPPRESSION_TEXTS = {
    "line_with_reason":
        "x = 1  # lint: disable=unguarded-attr -- fixture\n",
    "above_with_reason":
        "# lint: disable=lock-order -- fixture\nx = 1\n",
    "file_level": "# lint: disable-file=lock-reacquire -- helper\nx = 1\n",
    "reasonless_unknown_unused": "\n".join([
        "a = 1  # lint: disable=unguarded-attr",
        "b = 2  # lint: disable=not-a-rule -- why",
        "c = 3  # lint: disable=schema-drift -- why", ""]),
    "docstring_mention":
        '"""Docs show: # lint: disable=lock-order -- like so."""\n',
    "two_rules": "x = 1  # lint: disable=lock-order,host-guard -- both\n",
}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_TEXTS))
def test_suppression_handling_matches_reference(tmp_path, case):
    path = tmp_path / "m.py"
    path.write_text(SUPPRESSION_TEXTS[case])
    lines = path.read_text().count("\n")
    probes = [("unguarded-attr", 1), ("lock-order", 2), ("host-guard", 1),
              ("lock-reacquire", lines), ("schema-drift", 1)]
    out = []
    for core in (rcore, tcore):
        m = core.parse_file(path, root=tmp_path)
        findings = [core.Finding(r, m.rel, ln, "probe") for r, ln in probes]
        for strict in (False, True):
            kept, sup = core.apply_suppressions(findings, {m.name: m},
                                                strict=strict)
            out.append((_as_tuples(kept), _as_tuples(sup)))
    assert out[:2] == out[2:]


def test_inert_rule_suppression_is_reported(tmp_path):
    """A disable of a rule the port does not check (it guards a jit
    tracer) is a bad suppression under strict, with the reason."""
    p = tmp_path / "m.py"
    p.write_text("x = 1  # lint: disable=set-iteration -- why\n")
    m = tcore.parse_file(p, root=tmp_path)
    kept, _ = tcore.apply_suppressions([], {m.name: m}, strict=True)
    assert [f.rule for f in kept] == ["bad-suppression"]
    assert "not checked under eager PyTorch" in kept[0].message
    assert set(tcore.INERT_RULES) == (set(rcore.RULES) - set(tcore.RULES))


class TestKernelPathPurity:
    def test_host_sync_bad_flags_every_family(self):
        mods = _mod("host_sync_bad.py", "repro_torch.kernels.fake.kernel")
        found = trace_purity.run(mods)
        assert _rules(found) == {"host-sync"}
        assert sorted(f.line for f in found) == [13, 19, 20, 21, 22, 23]
        # the helper is reached through the entry function
        assert any("_extent" in f.message for f in found)

    def test_host_sync_good_is_clean(self):
        mods = _mod("host_sync_good.py", "repro_torch.kernels.fake.kernel")
        assert trace_purity.run(mods) == []

    def test_host_guard_bad(self):
        mods = _mod("host_guard_bad.py", "repro_torch.kernels.fake.ops")
        found = trace_purity.run(mods)
        assert _rules(found) == {"host-guard"}
        assert sorted(f.line for f in found) == [12, 16]
        assert "except" in min(found, key=lambda f: f.line).message

    def test_host_guard_good_is_clean(self):
        mods = _mod("host_guard_good.py", "repro_torch.kernels.fake.ops")
        assert trace_purity.run(mods) == []

    @pytest.mark.parametrize("fname", ["host_sync_bad.py",
                                       "host_guard_bad.py"])
    def test_rules_apply_only_to_kernel_modules(self, fname):
        mods = _mod(fname, "repro_torch.eda.fake_router")
        assert trace_purity.run(mods) == []


class TestSchemaDrift:
    def _run(self, tmp_path, fname, manifest_from="schema_base.py"):
        base = tcore.parse_file(REF_FIXTURES / manifest_from,
                                root=REF_FIXTURES,
                                name="repro_torch.telemetry.spans")
        (tmp_path / "src/repro_torch/analysis").mkdir(parents=True)
        schema_drift.write_manifest(tmp_path, {base.name: base})
        live = tcore.parse_file(REF_FIXTURES / fname, root=REF_FIXTURES,
                                name="repro_torch.telemetry.spans")
        return schema_drift.run({live.name: live}, root=tmp_path)

    def test_unchanged_schema_is_clean(self, tmp_path):
        assert self._run(tmp_path, "schema_base.py") == []

    def test_field_change_without_bump_is_drift(self, tmp_path):
        found = self._run(tmp_path, "schema_drifted.py")
        assert _rules(found) == {"schema-drift"}
        assert "TraceExport.to_dict:host" in found[0].message

    def test_bump_with_stale_manifest_is_stale(self, tmp_path):
        found = self._run(tmp_path, "schema_bumped.py")
        assert _rules(found) == {"manifest-stale"}

    def test_missing_manifest_is_stale(self, tmp_path):
        live = tcore.parse_file(REF_FIXTURES / "schema_base.py",
                                root=REF_FIXTURES,
                                name="repro_torch.telemetry.spans")
        found = schema_drift.run({live.name: live}, root=tmp_path)
        assert _rules(found) == {"manifest-stale"}

    def test_manifest_equals_reference(self):
        """The port reads and writes the reference's artifacts and traces:
        every field set and version is the reference's."""
        port = json.loads((REPO / schema_drift.MANIFEST_PATH).read_text())
        ref = json.loads(
            (REPO / "src/repro/analysis/schema_manifest.json").read_text())
        assert port == ref

    def test_committed_manifest_matches_live_tree(self):
        committed = json.loads(
            (REPO / schema_drift.MANIFEST_PATH).read_text())
        assert schema_drift.extract(tcore.load_tree(REPO)) == committed


def test_self_scan_is_clean():
    """Zero kept findings over src/repro_torch under strict."""
    kept, suppressed = run_all(REPO, strict=True)
    assert kept == [], "\n".join(f.render() for f in kept)
    # every suppression is live: the kernel paths' needed syncs and the
    # plain-version helpers named in docs/torch_static_analysis.md
    assert {f.rule for f in suppressed} <= {"host-sync", "host-guard"}
