"""The port's GPipe schedule (`parallel/pipeline.py`) on CPU positions
held to the reference's sequential model in `jax.numpy` on the same
numpy inputs: outputs to 1e-5, grads against `jax.grad` to 1e-4.  The
reference's own pipeline test fails on this JAX (its `shard_map` over
forced host devices), so the sequential model is the yardstick, as in
that test: S 4, M 8, B 2, D 16; also M < S and S = 1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel.pipeline import bubble_fraction as rbubble
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)


def test_bubble_fraction():
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)
    assert bubble_fraction(1, 8) == 0.0
    for s, m in ((4, 8), (2, 3), (8, 1)):
        assert bubble_fraction(s, m) == rbubble(s, m)


@pytest.mark.parametrize("stages,micro", [(4, 8), (4, 2), (1, 8)],
                         ids=["S4-M8", "M-below-S", "S1"])
def test_pipeline_matches_sequential_and_grads(stages, micro):
    b, d = 2, 16
    rng = np.random.default_rng(stages * 10 + micro)
    w = (0.3 * rng.standard_normal((stages, d, d))).astype(np.float32)
    xs = rng.standard_normal((micro, b, d)).astype(np.float32)

    def ref_fwd(w):
        y = jnp.asarray(xs)
        for i in range(stages):
            y = jnp.tanh(y @ w[i])
        return y

    want = np.asarray(ref_fwd(jnp.asarray(w)))
    want_g = np.asarray(jax.grad(lambda w: jnp.sum(ref_fwd(w) ** 2))(
        jnp.asarray(w)))

    mesh = make_mesh((stages,), ("stage",), device="cpu")
    tw = torch.tensor(w, requires_grad=True)
    out = pipeline_apply(mesh, "stage", lambda wi, x: torch.tanh(x @ wi),
                         tw, torch.tensor(xs))
    assert tuple(out.shape) == (micro, b, d)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), want_g, atol=1e-4, rtol=1e-4)


def test_pipeline_stage_params_tree_and_other_axes():
    """A dict of stage parameters, and a stage axis beside another mesh
    axis (the stages are the positions along it, the others at 0)."""
    rng = np.random.default_rng(0)
    w = torch.tensor(0.3 * rng.standard_normal((2, 8, 8)), dtype=torch.float32)
    bias = torch.tensor(rng.standard_normal((2, 8)), dtype=torch.float32)
    xs = torch.tensor(rng.standard_normal((3, 2, 8)), dtype=torch.float32)
    mesh = make_mesh((2, 2), ("data", "stage"), device="cpu")
    out = pipeline_apply(mesh, "stage",
                         lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                         {"w": w, "b": bias}, xs)
    want = xs
    for i in range(2):
        want = torch.tanh(want @ w[i] + bias[i])
    torch.testing.assert_close(out, want, rtol=0, atol=0)
