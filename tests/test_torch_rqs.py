"""sbi_tpu_torch's RQ spline against sbi_tpu's, on the CPU.

The port's plain version and its autograd.Function (which on a CPU tensor
runs the plain version) are held against the JAX jnp reference and the
Pallas kernel in interpret mode, on the same numpy inputs. The CUDA kernel
itself runs only on the card: ``chip_smoke.py`` holds it against the plain
version there.

Tolerances: y 1e-5 and log|det| 1e-4 absolute (both sides float32; softmax
and cumulative sums run in another order, so knots differ by a few ulp and
the log-det, a difference of logs, loses a little more); gradients 1e-5
absolute plus 1e-4 relative (the gradient of log|det| carries the spline's
second derivative, whose float32 rounding differs by up to ~1e-4 relative
between the frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.neural_nets.estimators.flows import rational_quadratic_spline as jax_rqs
from sbi_tpu.ops.rqs_pallas import rational_quadratic_spline_pallas
from sbi_tpu_torch.ops import rqs
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

B = 3.0
Y_ATOL, LD_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4, 1e-5, 1e-4
# Spline parameters of std 0.5: wider than the conditioners of the NSF path
# give. With std >~1 some bins are ~500x steeper than wide and a float32
# knot that moves by one ulp moves y by ~1e-4 in either framework, so no
# two float32 implementations agree to 1e-5 there.
PARAM_SCALE = 0.5
NONDEFAULT = dict(min_bin_width=1e-2, min_bin_height=5e-3, min_derivative=1e-2)


def _inputs(K, rows=48, cols=3, seed=0):
    """x (rows, cols) inside, outside and exactly at +-B; parameters as
    slices of one (rows, cols, 3K-1) array, as the conditioner emits them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4.0, 4.0, size=(rows, cols)).astype(np.float32)
    x.flat[:6] = [-B, B, -B - 1e-3, B + 1e-3, -10.0, 10.0]
    p = (PARAM_SCALE * rng.normal(size=(rows, cols, 3 * K - 1))).astype(np.float32)
    return x, p[..., :K], p[..., K:2 * K], p[..., 2 * K:]


def _torch(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _loss(y, ld):
    return (y**2).sum() + ld.sum()


@pytest.mark.parametrize("K", [4, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_jax_reference(inverse, K):
    x, w, h, d = _inputs(K)
    y_j, ld_j = jax_rqs(*map(jnp.asarray, (x, w, h, d)), inverse=inverse,
                        tail_bound=B, use_pallas=False)
    y_t, ld_t = rqs.rational_quadratic_spline_plain(*_torch(x, w, h, d), inverse, B)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=Y_ATOL, rtol=0)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=LD_ATOL, rtol=0)
    # outside the bounds: identity with log-det 0; at the bounds: inside
    np.testing.assert_array_equal(y_t.numpy().flat[2:6], x.flat[2:6])
    np.testing.assert_array_equal(ld_t.numpy().flat[2:6], 0.0)


@pytest.mark.parametrize("K", [4, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_wrapper_matches_pallas_interpret(inverse, K, monkeypatch):
    """The TPU kernel itself, run by Pallas's interpreter on the CPU."""
    monkeypatch.setenv("SBI_TPU_PALLAS_INTERPRET", "1")
    x, w, h, d = _inputs(K, seed=1)
    y_p, ld_p = rational_quadratic_spline_pallas(*map(jnp.asarray, (x, w, h, d)), inverse, B)
    y_t, ld_t = rqs.rational_quadratic_spline(*_torch(x, w, h, d), inverse, B)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_p), atol=Y_ATOL, rtol=0)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_p), atol=LD_ATOL, rtol=0)


@pytest.mark.parametrize("K", [4, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_gradients_match_jax(inverse, K):
    x, w, h, d = _inputs(K, seed=2)
    g_j = jax.grad(
        lambda *a: _loss(*jax_rqs(*a, inverse=inverse, tail_bound=B, use_pallas=False)),
        argnums=(0, 1, 2, 3),
    )(*map(jnp.asarray, (x, w, h, d)))
    leaves = _torch(x, w, h, d, grad=True)
    _loss(*rqs.rational_quadratic_spline(*leaves, inverse, B)).backward()
    # At exactly +-B the spline meets its linear tail at a clip: whether the
    # outer knot rounds to just below or just above B decides whether the
    # clip passes the gradient, in either framework. Those two elements are
    # held to finiteness only.
    at_bound = np.abs(x) == B
    for leaf, g in zip(leaves, g_j):
        got, want = leaf.grad.numpy(), np.asarray(g)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[~at_bound], want[~at_bound], atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_nondefault_constants_match_jax(inverse):
    x, w, h, d = _inputs(4, seed=3)
    y_j, ld_j = jax_rqs(*map(jnp.asarray, (x, w, h, d)), inverse=inverse,
                        tail_bound=B, use_pallas=False, **NONDEFAULT)
    y_t, ld_t = rqs.rational_quadratic_spline(*_torch(x, w, h, d), inverse, B, **NONDEFAULT)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=Y_ATOL, rtol=0)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=LD_ATOL, rtol=0)


def test_round_trip_and_cpu_launch_count():
    """Forward then inverse gives back x; on the CPU the wrapper runs the
    plain version and launches nothing."""
    rqs.forward_launches = rqs.inverse_launches = 0
    x, w, h, d = _torch(*_inputs(10, seed=4))
    y, ld = rqs.rational_quadratic_spline(x, w, h, d, False)
    back, ild = rqs.rational_quadratic_spline(y, w, h, d, True)
    assert torch.allclose(back, x, atol=1e-4)
    assert torch.allclose(ld + ild, torch.zeros_like(ld), atol=1e-3)
    assert (rqs.forward_launches, rqs.inverse_launches) == (0, 0)


def test_wrapper_rejects_bad_inputs():
    x, w, h, d = _torch(*_inputs(10))
    with pytest.raises(TypeError):
        rqs.rational_quadratic_spline(x.double(), w.double(), h.double(), d.double())
    with pytest.raises(ValueError, match="shape"):
        rqs.rational_quadratic_spline(x, w, h, d[..., :-1])
    with pytest.raises(ValueError, match="contiguous"):
        wt = w.transpose(0, 1).contiguous().transpose(0, 1)  # same shape, rows stride 1
        rqs.rational_quadratic_spline(x, wt.transpose(-1, -2).contiguous().transpose(-1, -2), h, d)
    with pytest.raises(ValueError, match="num_bins"):
        rqs.rational_quadratic_spline(x, w[..., :1], h[..., :1], d[..., :0])
    with pytest.raises(ValueError, match="one device"):
        rqs.rational_quadratic_spline(x, w.to("meta"), h, d)
    with pytest.raises(TypeError):
        rqs.rational_quadratic_spline(x, w, h.double(), d)
    with pytest.raises(ValueError, match="shape"):
        rqs.rational_quadratic_spline(x, w, h[..., :-1], d)
    with pytest.raises(ValueError, match="shape"):
        rqs.rational_quadratic_spline(x[:-1], w, h, d)


@pytest.mark.parametrize("inverse", [False, True])
def test_no_grad_path_equals_grad_path(inverse):
    """Without a gradient to record the wrapper skips the autograd.Function;
    both paths give the same values, and only the second records a graph."""
    x, w, h, d = _inputs(10, seed=5)
    with torch.no_grad():
        y0, ld0 = rqs.rational_quadratic_spline(*_torch(x, w, h, d), inverse, B)
    y1, ld1 = rqs.rational_quadratic_spline(*_torch(x, w, h, d), inverse, B)  # no input requires grad
    leaves = _torch(x, w, h, d, grad=True)
    y2, ld2 = rqs.rational_quadratic_spline(*leaves, inverse, B)
    assert y0.grad_fn is None and y1.grad_fn is None and y2.grad_fn is not None
    for a, b in ((y0, y2), (ld0, ld2), (y1, y2), (ld1, ld2)):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_largest_bin_count_and_beyond():
    """K = MAX_BINS runs (on the CPU, the plain version); one more raises."""
    K = rqs.MAX_BINS
    x, w, h, d = _torch(*_inputs(K, rows=4, cols=2, seed=6))
    y, ld = rqs.rational_quadratic_spline(x, w, h, d)
    assert torch.isfinite(y).all() and torch.isfinite(ld).all()
    pad = torch.zeros(4, 2, 1)
    with pytest.raises(ValueError, match="num_bins"):
        rqs.rational_quadratic_spline(x, torch.cat([w, pad], -1), torch.cat([h, pad], -1),
                                      torch.cat([d, pad], -1))


def test_grad_path_cpu_launches_nothing():
    """With inputs that require gradients the wrapper goes through the
    autograd.Function; on the CPU that runs the plain version, forward and
    backward, and launches nothing."""
    rqs.forward_launches = rqs.inverse_launches = 0
    for inverse in (False, True):
        leaves = _torch(*_inputs(10, seed=8), grad=True)
        _loss(*rqs.rational_quadratic_spline(*leaves, inverse)).backward()
        assert all(leaf.grad is not None for leaf in leaves)
    assert (rqs.forward_launches, rqs.inverse_launches) == (0, 0)
