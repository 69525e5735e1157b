"""The port's roofline model (`launch/roofline_model.py`) and the
dry-run's analytic terms held to the reference's, cell by cell: the
cost terms of all ten configs at the four shapes equal the reference's
to rtol 1e-12 (the port counts per-layer leaves, the reference stacked
ones; the integer counts are the same).  Only the peaks differ: the
port's are the H100's."""
import pytest

from repro.configs import registry as rregistry
from repro.launch import dryrun as rdryrun
from repro.launch import roofline_model as rroof
from repro.launch import shapes as rshapes
from repro_torch.configs import registry
from repro_torch.core import constants
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import roofline_model as troof
from repro_torch.launch import shapes as tshapes
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

RTOL = 1e-12


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= RTOL * abs(b)


@pytest.mark.parametrize("name", rregistry.ARCH_IDS)
def test_cell_cost_matches_reference(name):
    rc, tc = rregistry.get(name), registry.get(name)
    assert troof.matmul_params(tc) == rroof.matmul_params(rc)
    for shape in rshapes.SHAPES:
        want = rroof.cell_cost(rc, rshapes.SHAPES[shape])
        got = troof.cell_cost(tc, tshapes.SHAPES[shape])
        assert _close(got.flops, want.flops), (shape, got, want)
        assert _close(got.hbm_bytes, want.hbm_bytes), (shape, got, want)
        assert _close(tdryrun.model_flops(tc, tshapes.SHAPES[shape]),
                      rdryrun.model_flops(rc, rshapes.SHAPES[shape]))


@pytest.mark.parametrize("name", ["qwen2_5_3b", "arctic_480b"])
def test_analytic_terms_on_h100_peaks(name):
    tc = registry.get(name)
    shape = tshapes.SHAPES["train_4k"]
    cost = troof.cell_cost(tc, shape)
    ana = tdryrun.analytic_terms(tc, shape, 256)
    assert ana["flops_global"] == cost.flops
    assert ana["compute_s"] == cost.flops / (
        256 * constants.H100_PEAK_BF16_FLOPS)
    assert ana["memory_s"] == cost.hbm_bytes / (256 * constants.H100_HBM_BW)
    assert (constants.H100_PEAK_BF16_FLOPS, constants.H100_HBM_BW,
            constants.H100_NVLINK_BW) == (989.4e12, 3.35e12, 450e9)
