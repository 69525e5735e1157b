"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here needs a CUDA device (the kernels have no CPU
mode) and skips without one; this file imports nothing of JAX, so it
also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import DesignRequest, DesignSession, Requirements
from repro_torch.core import pareto
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.maze_route import kernel as mr
from repro_torch.kernels.maze_route import ref as mr_ref
from repro_torch.kernels.pareto_dom import ops as pd_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _objectives(p, seed, dev):
    rng = np.random.default_rng(seed)
    f = np.empty((2, p, 4), np.float32)
    f[0] = rng.integers(0, 5, (p, 4))
    f[1] = rng.normal(size=(p, 4))
    f[1, p // 2:p // 2 + 5] = f[1, :5]
    f[:, -3:] = np.inf
    return torch.from_numpy(f).to(dev)


@pytest.mark.parametrize("p", [37, 512, 2048])
def test_pareto_kernels_match_plain(p, dev):
    f = _objectives(p, p, dev)
    n0 = LAUNCHES["nds_rank"], LAUNCHES["dominance_matrix"]
    assert torch.equal(pd_ops.non_dominated_rank(f),
                       pareto.non_dominated_rank(f))
    assert torch.equal(pd_ops.dominance_matrix(f), pareto.dominance_matrix(f))
    assert (LAUNCHES["nds_rank"], LAUNCHES["dominance_matrix"]) == \
        (n0[0] + 1, n0[1] + 1)


def test_route_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    o = torch.rand((4, 122, 274), generator=g, device=dev) < 0.2
    s = torch.zeros_like(o)
    s[torch.arange(4, device=dev), torch.tensor([0, 60, 121, 7], device=dev),
      torch.tensor([0, 100, 273, 9], device=dev)] = True
    n0 = LAUNCHES["wavefront"]
    dist = mr.wavefront(o, s)
    assert LAUNCHES["wavefront"] == n0 + 1
    assert torch.equal(dist, mr_ref.wavefront_distance_ref(o, s))
    grids = torch.tensor([[100, 200], [122, 274], [50, 60], [30, 20]],
                         dtype=torch.int32, device=dev)
    assert torch.equal(mr.wavefront(o, s, grids, 122 * 274),
                       mr_ref.wavefront_distance_ref(o, s, grids))
    big_o = torch.rand((1, 122, 1090), generator=g, device=dev) < 0.2
    big_s = torch.zeros_like(big_o)
    big_s[0, 60, 500] = True                      # global-memory branch
    assert torch.equal(mr.wavefront(big_o, big_s),
                       mr_ref.wavefront_distance_ref(big_o, big_s))
    rng = np.random.default_rng(0)
    tgts = torch.tensor(np.stack([rng.integers(0, 122, (4, 2)),
                                  rng.integers(0, 274, (4, 2))], -1),
                        dtype=torch.int32, device=dev)
    tmask = torch.tensor([[True, True], [True, False]] * 2, device=dev)
    nmask = torch.tensor([True, True, True, False], device=dev)
    bufs = [[torch.zeros((4, 122, 274), dtype=torch.int32, device=dev)]
            + [torch.zeros(4, dtype=torch.int32, device=dev)
               for _ in range(3)] for _ in range(2)]
    mr.trace_paths(dist, tgts, tmask, nmask, *bufs[0])
    mr_ref.trace_paths_ref(dist, tgts, tmask, nmask, *bufs[1])
    for a, b in zip(*bufs):
        assert torch.equal(a, b)


def test_session_on_cuda_equals_cpu_rows(dev):
    """Same specs, same rows: the kernels route exactly like the plain
    versions (the fronts may differ: CUDA and CPU Philox streams do)."""
    req = DesignRequest(array_size=4096, pop_size=64, generations=10,
                        requirements=Requirements(min_snr_db=17.0,
                                                  min_tops=0.4))
    LAUNCHES.clear()
    art = DesignSession().run(req)
    assert min(LAUNCHES[k] for k in ("nds_rank", "wavefront",
                                     "trace_paths")) > 0
    cpu = DesignSession(device="cpu").layout(art.pareto.specs)
    assert list(art.layout_rows) == cpu.metrics_rows()
