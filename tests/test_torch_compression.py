"""The port's int8 error-feedback compression (`runtime/compression.py`)
held to the reference's: `compress_decompress` bit-equal at several
shapes and blocks with non-zero error feedback; the cross-pod mean
bit-equal on a (1, 1, 1) pod mesh with identical grads, the identity
without a "pod" axis, and over steps the accumulated output within one
quantization step a block of the accumulated grads (error feedback
keeps the sum unbiased)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as rcomp
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import compression as tcomp
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)


@pytest.mark.parametrize("block", [256, 64])
@pytest.mark.parametrize("shape", [(1000,), (256, 3), (3, 7, 129)],
                         ids=["1000", "256x3", "3x7x129"])
def test_compress_decompress_bit_equal(shape, block):
    rng = np.random.default_rng(sum(shape) + block)
    g = rng.standard_normal(shape).astype(np.float32)
    ef = (0.01 * rng.standard_normal(shape)).astype(np.float32)
    want, want_ef = rcomp.compress_decompress(jnp.asarray(g),
                                              jnp.asarray(ef), block)
    got, got_ef = tcomp.compress_decompress(torch.from_numpy(g),
                                            torch.from_numpy(ef), block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_ef.numpy(), np.asarray(want_ef))
    assert not np.all(ef == 0)


def _tree(rng):
    return {"a": rng.standard_normal((300,)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 130)).astype(np.float32)}}


def test_cross_pod_bit_equal_on_one_pod():
    rng = np.random.default_rng(1)
    g = _tree(rng)
    ef = jax.tree.map(lambda a: 0.01 * a, _tree(rng))
    rmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    want, want_ef = rcomp.cross_pod_allreduce_compressed(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, ef), rmesh)
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    tg = jax.tree.map(torch.from_numpy, g)
    tef = jax.tree.map(torch.from_numpy, ef)
    got, got_ef = tcomp.cross_pod_allreduce_compressed([tg], [tef], mesh)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [k.key for k in path]
        a, e = got[0], got_ef[0]
        for k in keys:
            a, e = a[k], e[k]
        we = want_ef
        for k in keys:
            we = we[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        np.testing.assert_array_equal(e.numpy(), np.asarray(we))


def test_cross_pod_identity_without_pod_axis():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    g, ef = [{"a": torch.ones(3)}], [{"a": torch.zeros(3)}]
    out, out_ef = tcomp.cross_pod_allreduce_compressed(g, ef, mesh)
    assert out is g and out_ef is ef
    zeros = tcomp.init_error_feedback({"w": torch.ones(2, 3,
                                                       dtype=torch.bfloat16)})
    assert zeros["w"].dtype == torch.float32 and not zeros["w"].any()


def test_error_feedback_keeps_the_sum():
    """Two pods, three steps: sum of outputs vs sum of the pods' mean
    grads differs by the mean final feedback, under one quantization step
    (the block's scale) everywhere."""
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device="cpu")
    rng = np.random.default_rng(7)
    ef = [tcomp.init_error_feedback(torch.zeros(1000)) for _ in range(2)]
    total_out, total_g = torch.zeros(1000), torch.zeros(1000)
    scales = []
    for _ in range(3):
        gs = [torch.tensor(rng.standard_normal(1000), dtype=torch.float32)
              for _ in range(2)]
        out, ef = tcomp.cross_pod_allreduce_compressed(gs, ef, mesh)
        torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
        total_out += out[0]
        total_g += (gs[0] + gs[1]) / 2
        scales.append(max(float(g.abs().max()) for g in gs) / 127)
    gap = (total_out - total_g).abs()
    assert float(gap.max()) <= max(scales) * 1.0
    assert float(gap.max()) > 0
