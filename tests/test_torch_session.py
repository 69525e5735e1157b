"""The port's `DesignSession.run` end to end on the CPU against the
reference: front inside the exhaustive front, layout rows equal to the
reference's rows for the same specs, same request hash, and an
artifact the reference loads."""
import dataclasses
import json

import numpy as np
import pytest

from repro.api import request as rrequest
from repro.api import session as rsession
from repro.core import explorer as rexplorer
from repro.core import pareto as rpareto
from repro.core.acim_spec import MacroSpec as RSpec
from repro.eda import batched_flow as rflow
from repro_torch import convert
from repro_torch.api import DesignRequest, DesignSession, Requirements
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

# leaves at most 3 specs of the 4096 front, so the plain CPU routing
# stays quick
REQ = dict(array_size=4096, pop_size=64, generations=10, seed=2)
REQS = dict(min_snr_db=17.0, min_tops=0.4)


@pytest.fixture(scope="module")
def run():
    session = DesignSession(device="cpu")
    req = DesignRequest(**REQ, requirements=Requirements(**REQS))
    return session, req, session.run(req)


def test_front_inside_exhaustive_front(run):
    _, _, art = run
    genes, objs = rexplorer.full_design_space(4096)
    mask = np.asarray(rpareto.non_dominated_mask(objs))
    true = {tuple(int(v) for v in g) for g, m in zip(np.asarray(genes), mask)
            if m}
    found = {(int(np.log2(s.h)), int(np.log2(s.l)), s.b_adc)
             for s in art.pareto.specs}
    assert 1 <= len(found) <= 4 and found <= true
    assert all(m >= 0.4 for m in art.pareto.metrics["tops"])


def test_rows_equal_reference_rows(run):
    _, _, art = run
    specs = [RSpec(*s.as_tuple()) for s in art.pareto.specs]
    want = rflow.generate_layouts(specs, engine="concurrent").metrics_rows()
    assert list(art.layout_rows) == want
    prov = art.provenance
    assert prov.route_engine == "scan" and prov.new_traces == 0
    assert prov.route_rounds == art.layouts.routing.rounds > 0


def test_request_hash_and_artifact_interchange(run, tmp_path):
    _, req, art = run
    ref_req = rrequest.DesignRequest(
        **REQ, requirements=rrequest.Requirements(**REQS))
    assert req.sha() == ref_req.sha()
    assert convert.request_from_dict(ref_req.to_dict()) == req
    path = tmp_path / "artifact.json"
    art.to_json(path)
    loaded = rsession.DesignArtifact.from_dict(json.loads(path.read_text()))
    assert loaded.request == ref_req
    assert loaded.layout_rows == art.layout_rows
    assert [s.as_tuple() for s in loaded.pareto.specs] == \
        [s.as_tuple() for s in art.pareto.specs]
    assert dataclasses.asdict(loaded.provenance) == \
        dataclasses.asdict(art.provenance)


def test_front_cache_and_stages(run):
    session, req, art = run
    again = session.run(req)
    assert again.provenance.front_cache_hit
    assert again.layout_rows == art.layout_rows
    fronts = session.fronts_for([dataclasses.replace(req, layout=False)])
    assert len(next(iter(fronts.values()))) >= len(art.pareto)
    assert session.stats["explorer_dispatches"] == 1
    assert session.stats["front_cache_hits"] >= 2
    with pytest.raises(ValueError):
        session.run(dataclasses.replace(
            req, requirements=Requirements(min_tops=1e9)))


def test_run_many_buckets_equal_single_runs(run):
    """Two requests through the grid-shape buckets give each request the
    rows its own single-batch run gives."""
    session, req, art = run
    other = dataclasses.replace(req, seed=5)
    arts = session.run_many([req, other])
    assert arts[req].layout_rows == art.layout_rows
    solo = DesignSession(device="cpu").run(other)
    assert arts[other].layout_rows == solo.layout_rows
    assert [s.as_tuple() for s in arts[other].pareto.specs] == \
        [s.as_tuple() for s in solo.pareto.specs]
