"""Batched layout flow parity on three small 4096 specs: placement
tensors and masks, DRC counts, nets, routing occupancy and the metrics
rows equal the reference's, whose two routing engines agree."""
import numpy as np
import pytest

from repro.core.acim_spec import MacroSpec as RSpec
from repro.eda import batched_flow as rflow
from repro.eda import placer as rplacer
from repro_torch.core.acim_spec import MacroSpec as TSpec
from repro_torch.eda import batched_flow as tflow
from repro_torch.eda import placer as tplacer
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

SPECS = [(64, 64, 2, 3), (128, 32, 4, 2), (512, 8, 8, 4)]


@pytest.fixture(scope="module")
def flows():
    rspecs = [RSpec(*s) for s in SPECS]
    ref = rflow.generate_layouts(rspecs, engine="concurrent")
    scan = rflow.generate_layouts(rspecs, engine="scan")
    port = tflow.generate_layouts([TSpec(*s) for s in SPECS], device="cpu")
    return ref, scan, port


def test_reference_engines_agree(flows):
    ref, scan, _ = flows
    assert ref.metrics_rows() == scan.metrics_rows()
    np.testing.assert_array_equal(ref.routing.occ_count, scan.routing.occ_count)


def test_placement_tensors_and_drc(flows):
    ref, _, port = flows
    assert tuple(port.dims) == tuple(ref.dims)
    assert tuple(port.geom) == tuple(ref.geom)
    for name in rplacer.LayoutOperands._fields:
        np.testing.assert_array_equal(getattr(port.ops, name).numpy(),
                                      np.asarray(getattr(ref.ops, name)))
    for cat in tplacer.CATEGORIES:
        for i in range(2):
            np.testing.assert_array_equal(port.tensors[cat][i].numpy(),
                                          np.asarray(ref.tensors[cat][i]),
                                          err_msg=cat)
    np.testing.assert_array_equal(port.drc_overlaps, ref.drc_overlaps)
    np.testing.assert_array_equal(port.drc_oob, ref.drc_oob)
    assert port.drc_clean.all()


def test_nets_equal_reference(flows):
    ref, _, port = flows
    kw = dict(dims=ref.dims, geom=ref.geom, coarse=64)
    want = rflow._nets_program(ref.tensors, ref.ops, **kw)
    got = tflow._nets_program(port.tensors, port.ops, **kw)
    for name in tflow.NetBatch._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_routing_and_rows_equal_reference(flows):
    ref, _, port = flows
    np.testing.assert_array_equal(port.routing.occ_count, ref.routing.occ_count)
    np.testing.assert_array_equal(port.routing.grids, ref.routing.grids)
    assert port.routing.engine == "scan"
    assert port.metrics_rows() == ref.metrics_rows()
    assert port.netlist_stats == ref.netlist_stats


def test_single_spec_place_equals_reference():
    for s in SPECS:
        a, b = rplacer.place(RSpec(*s)), tplacer.place(TSpec(*s))
        assert (a.width, a.height) == (b.width, b.height)
        assert [(r.name, r.cell, r.x, r.y, r.w, r.h) for r in a.rects] == \
            [(r.name, r.cell, r.x, r.y, r.w, r.h) for r in b.rects]


def test_concurrent_engine_not_ported():
    with pytest.raises(NotImplementedError):
        tflow.generate_layouts([TSpec(*SPECS[0])], engine="concurrent",
                               device="cpu")
