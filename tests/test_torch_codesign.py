"""The port's codesign loop held against the JAX reference on the CPU.

`extract_gemms` and `mapping_utilization` are integer / float64
arithmetic on the config: equal.  The scoring of one front runs the same
Python over the same float32 metric arrays, so the picks are equal and
the floats agree to rtol 1e-6 (the throughput estimate is float32 on
both sides, a few ulps apart)."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.configs import registry as creg
from repro.core import codesign as rcd
from repro.core import explorer as rexplorer
from repro.core.acim_spec import MacroSpec as RSpec
from repro_torch import convert
from repro_torch.core import codesign as tcd
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.core.explorer import ParetoResult
from repro_torch.train import acim_lm
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)


def _port_cfg(cfg):
    return convert.arch_config_from_dict(dataclasses.asdict(cfg))


def _acim_lm_cfg():
    """The trainer's full-width config, built on the reference side."""
    from repro.configs.base import ArchConfig

    return ArchConfig(**dataclasses.asdict(acim_lm.build_cfg(768, 12)))


CONFIGS = {**{n: creg.get(n) for n in creg.ARCH_IDS},
           "acim_lm_768x12": _acim_lm_cfg()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_extract_gemms_and_utilization(name):
    cfg = CONFIGS[name]
    want = rcd.extract_gemms(cfg)
    got = tcd.extract_gemms(_port_cfg(cfg))
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(g) for g in want]
    for h, w, l, b in [(512, 128, 4, 5), (256, 64, 2, 4), (2048, 8, 32, 5)]:
        for gr, gt in zip(want, got):
            assert tcd.mapping_utilization(MacroSpec(h, w, l, b), gt) == \
                rcd.mapping_utilization(RSpec(h, w, l, b), gr)


class _StubSession:
    """A session whose every request returns one given front."""

    def __init__(self, front):
        self.front, self.requests = front, []

    def run(self, req):
        self.requests.append(req)
        return types.SimpleNamespace(pareto=self.front)


def _golden_fronts(min_snr_db=3.0):
    genes, objs = rexplorer.full_design_space(16384)
    ref = rexplorer.pareto_result_from_population(
        16384, np.asarray(genes), np.asarray(objs)).filter(
            min_snr_db=min_snr_db)
    port = ParetoResult(16384, tuple(MacroSpec(*s.as_tuple())
                                     for s in ref.specs),
                        {k: np.array(v, copy=True)
                         for k, v in ref.metrics.items()})
    return ref, port


@pytest.mark.parametrize("name", ["acim_lm_768x12", "qwen2_5_3b",
                                  "deepseek_v2_lite_16b", "xlstm_125m",
                                  "zamba2_2_7b"])
def test_recommendation_equal_on_one_front(name):
    ref_front, port_front = _golden_fronts()
    cfg = CONFIGS[name]
    rs, ts = _StubSession(ref_front), _StubSession(port_front)
    want = rcd.recommend_macro(cfg, array_size=16384, min_snr_db=3.0,
                               pop_size=96, generations=25, session=rs)
    got = tcd.recommend_macro(_port_cfg(cfg), array_size=16384,
                              min_snr_db=3.0, pop_size=96, generations=25,
                              session=ts)
    assert ts.requests[0].to_dict() == rs.requests[0].to_dict()
    assert got.arch == want.arch
    assert got.spec.as_tuple() == want.spec.as_tuple()
    assert got.macro_count_for_rate == want.macro_count_for_rate
    for f in ("snr_db", "eff_tops", "eff_tops_per_w", "utilization"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, err_msg=f)


def test_empty_front_raises():
    _, port_front = _golden_fronts(min_snr_db=100.0)
    with pytest.raises(ValueError, match="SNR floor"):
        tcd.score_front(acim_lm.build_cfg(768, 12), port_front)


def test_recommend_macro_on_cpu_session_picks_from_the_true_front():
    """The example's request through the port's explorer (plain path):
    its pick lies on the exhaustive 16 kb front and meets the floor."""
    ref_front, _ = _golden_fronts()
    rec = acim_lm.pick_macro(acim_lm.build_cfg(768, 12), device="cpu")
    assert rec.spec.as_tuple() in {s.as_tuple() for s in ref_front.specs}
    assert rec.snr_db >= 3.0 and rec.macro_count_for_rate >= 1


def test_recommend_macro_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcd.recommend_macro(acim_lm.build_cfg(64, 1), array_size=4096,
                            pop_size=8, generations=1)
