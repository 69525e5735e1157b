"""The paper drivers (`repro_torch.paper`) held against the reference's
drivers under `benchmarks/` on the same inputs, on the CPU.

Fig. 8: the rows of the sequential layout flow equal the reference's key
for key (but the clock): integers and booleans exactly, floats within
rtol 1e-6 (the estimator's `log10` / `pow` differ by ulps between
libraries).  Fig. 9 and Fig. 10 run the port's session with the
reference's draws (`torch_port_helpers.JaxDraws` under the reference's
cell keys, injected as the session's sweep program) and the reference's
jitted estimator inside the NSGA-II loop (XLA's fused form differs from
the eager one by ulps, which can flip a selection): the same rows; with
the port's own Philox draws each front lies inside the exhaustive one.
SNR: the analytic column within rtol 1e-6; the Monte-Carlo SNR fed the
reference's operands and noise draws within 1e-4 dB of the reference's
(float32 variances summed in another order); with the port's draws
within the reference test's 2.0 dB band.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig8_layouts as rfig8
from benchmarks import fig9_design_space as rfig9
from benchmarks import fig10_sota as rfig10
from benchmarks import snr_mc as rsnr
from repro.core import acim_numerics as ran
from repro.core import explorer as rexplorer
from repro.core import nsga2 as rnsga2
from repro.core import pareto as rpareto
from repro.core.acim_spec import MacroSpec as RSpec
from repro_torch.api import session as tsession
from repro_torch.core import acim_numerics as tan
from repro_torch.core import estimator as test
from repro_torch.core import nsga2 as tnsga2
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.launch import dryrun
from repro_torch.paper import (fig8_layouts, fig9_design_space, fig10_sota,
                               roofline, snr_mc)
from torch_port_helpers import JaxDraws

RTOL = 1e-6
SNR_BAND = 2.0       # tests/test_acim_numerics.py's band


def _assert_rows(got, want, skip=()):
    assert list(got) == [k for k in want if k not in skip]
    for k in got:
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
        else:
            assert got[k] == want[k] and type(got[k]) is type(want[k]), k


@pytest.fixture
def reference_draws(monkeypatch):
    """The session's sweep program drawing with `jax.random` under the
    reference's cell keys (`jax.random.key(seed)`), and the NSGA-II loop
    evaluating with the reference's jitted estimator."""
    def sweep(seeds, spaces, *, statics, n_gens):
        draws = JaxDraws([jax.random.key(int(sd)) for sd in seeds])
        return tnsga2.run_cell(draws, spaces, statics=statics, n_gens=n_gens)

    ev = jax.jit(rnsga2.evaluate_op)
    rspaces = {}

    def evaluate(genes, space):
        out = []
        for g, s in zip(genes.numpy(), space.array_size.tolist()):
            sp = rspaces.setdefault(int(s), rnsga2.space_operands(
                rnsga2.NSGA2Config(array_size=int(s))))
            out.append(np.asarray(ev(jnp.asarray(g), sp)))
        return torch.from_numpy(np.stack(out))

    monkeypatch.setattr(tsession, "sweep_program", sweep)
    monkeypatch.setattr(tnsga2, "evaluate_op", evaluate)


def test_fig8_rows_equal_reference():
    got = fig8_layouts.run(device="cpu")
    want = rfig8.run()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_rows({k: v for k, v in g.items() if k != "layout_seconds"},
                     w, skip=("layout_seconds",))
        assert g["layout_seconds"] > 0


def test_fig9_rows_with_reference_draws(reference_draws):
    kw = dict(sizes=(4096, 16384), pop=48, gens=10)
    got, want = fig9_design_space.run(device="cpu", **kw), rfig9.run(**kw)
    assert list(got) == list(want)
    for s in want:
        _assert_rows(got[s], want[s])


def _exhaustive(size: int) -> set:
    genes, objs = rexplorer.full_design_space(size)
    mask = np.asarray(rpareto.non_dominated_mask(objs))
    return {(1 << int(h), 1 << int(l), int(b))
            for (h, l, b), m in zip(np.asarray(genes), mask) if m}


def test_fig9_philox_fronts_inside_exhaustive():
    """At the driver's own budget (pop 192 x 60 generations) the port's
    Philox draws find fronts inside the exhaustive ones, one dispatch
    for both sizes."""
    sizes = (4096, 16384)
    session = tsession.DesignSession(device="cpu")
    rows = fig9_design_space.run(sizes=sizes, session=session)
    fronts = session.fronts_for(fig9_design_space.requests(sizes, 192, 60))
    assert session.stats["explorer_dispatches"] == 1
    for req, res in fronts.items():
        keys = {(s.h, s.l, s.b_adc) for s in res.specs}
        assert keys and keys <= _exhaustive(req.array_size)
        assert rows[req.array_size]["n_pareto"] == len(res)


def test_fig9_trends_equal_reference():
    got = fig9_design_space.trend_checks(device="cpu")
    assert got == rfig9.trend_checks()
    assert len(got) == 8 and all(got.values())


def test_fig10_with_reference_draws(reference_draws):
    got = fig10_sota.run(sizes=(4096,), device="cpu")
    want = rfig10.run(sizes=(4096,))
    assert got["sota_matched"] == want["sota_matched"]
    _assert_rows({k: v for k, v in got.items() if k != "sota_matched"},
                 want, skip=("sota_matched",))


@pytest.mark.parametrize("h,l,b", rsnr.POINTS)
def test_snr_analytic_column(h, l, b):
    np.testing.assert_allclose(float(test.snr_total_db(h, l, b)),
                               float(rsnr.estimator.snr_total_db(h, l, b)),
                               rtol=RTOL)


def _reference_draws(spec, rows=256, cols=64, seed=0):
    """The reference `mc_snr_db`'s operands and noise draws (its keys
    and shapes), as torch tensors."""
    k = spec.n_caps
    key = jax.random.key
    x = jnp.where(jax.random.bernoulli(key(seed), 0.5, (rows, k)), 1.0, -1.0)
    w = jnp.where(jax.random.bernoulli(key(seed + 1), 0.5, (k, cols)), 1.0,
                  -1.0)
    mm = jax.random.normal(key(seed + 2), (1, k, cols), jnp.float32)
    th = jax.random.normal(key(seed + 3), (rows, 1, cols), jnp.float32)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return t(x), t(w), tan.NoiseDraws(t(mm), t(th))


@pytest.mark.parametrize("h,l,b", rsnr.POINTS[:4])
def test_mc_snr_with_reference_draws(h, l, b):
    x, w, draws = _reference_draws(MacroSpec(h, 64, l, b))
    got = snr_mc.mc_snr_db(MacroSpec(h, 64, l, b), device="cpu", x=x, w=w,
                           draws=draws)
    want = rsnr.mc_snr_db(RSpec(h, 64, l, b))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_mc_snr_noiseless_with_reference_operands():
    """`noisy=False` goes through `acim_matmul` (its plain version on the
    CPU): the reference's clean SNR on the same operands, and the noisy
    run at most 0.5 dB above it (the reference test's B = 8 point)."""
    spec = MacroSpec(1024, 2, 2, 8)
    x, w, _ = _reference_draws(spec)
    clean = snr_mc.mc_snr_db(spec, noisy=False, device="cpu", x=x, w=w)
    np.testing.assert_allclose(
        clean, rsnr.mc_snr_db(RSpec(1024, 2, 2, 8), noisy=False), atol=1e-4)
    y = ran.acim_matmul_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                            RSpec(1024, 2, 2, 8))
    np.testing.assert_array_equal(
        tan.acim_matmul_ref(x, w, spec).numpy(), np.asarray(y))
    assert snr_mc.mc_snr_db(spec, device="cpu") <= clean + 0.5


@pytest.mark.parametrize("h,l,b", rsnr.POINTS[:4])
def test_mc_snr_philox_within_band(h, l, b):
    mc = snr_mc.mc_snr_db(MacroSpec(h, 64, l, b), device="cpu")
    assert abs(mc - float(test.snr_total_db(h, l, b))) < SNR_BAND


def test_roofline_table_of_two_records(tmp_path):
    """Two records of `dryrun.run_cell` (one ok, one skip) in a
    directory: one line each under the header, `fits_80gb`."""
    ok = dryrun.run_cell("qwen2.5-3b", "train_4k", False, out_dir=tmp_path)
    skip = dryrun.run_cell("qwen2.5-3b", "long_500k", False,
                           out_dir=tmp_path)
    assert (ok["status"], skip["status"]) == ("ok", "skip")
    lines = roofline.table(runs=tmp_path).splitlines()
    assert lines[0] == roofline.HEADER and "fits_80gb" in lines[0]
    assert len(lines) == 3
    by_shape = {ln.split(",")[1]: ln.split(",") for ln in lines[1:]}
    got = by_shape["train_4k"]
    ro = ok["roofline"]
    assert got[:3] == ["qwen2.5-3b", "train_4k", "ok"]
    assert float(got[3]) == pytest.approx(ro["compute_s"], rel=1e-3)
    assert got[8] == str(ok["memory"]["fits_80gb"])
    assert by_shape["long_500k"][2] == "skip"
    assert roofline.rows(mesh="pod2x16x16", runs=tmp_path) == []
    assert json.loads((tmp_path / "qwen2_5_3b__train_4k__pod16x16.json")
                      .read_text())["status"] == "ok"


def test_run_py_on_the_cpu(tmp_path):
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.paper.run", "--device", "cpu",
         "--skip", "fig8,fig9,fig10,table2"], capture_output=True,
        text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "#### snr_model_vs_mc" in out.stdout
    assert "h,l,b_adc,analytic_db,mc_db,delta_db" in out.stdout
    assert "#### roofline (from runs/dryrun_torch)" in out.stdout
