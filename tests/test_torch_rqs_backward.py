"""The RQ spline's hand-derived gradient, on the CPU.

``rational_quadratic_spline_vjp_plain`` is the plain version of the CUDA
backward kernel: the reverse mode of the spline written out by hand. It is
held against ``jax.vjp`` of the JAX package's jnp reference (what ``_bwd``
in ``sbi_tpu/ops/rqs_pallas.py`` computes) and against torch autograd of
the port's plain forward, on the same numpy inputs and upstream gradients.
The CUDA kernel itself runs only on the card, where ``chip_smoke.py`` holds
it against autograd through the plain version.

Inputs lie inside the bounds, outside them, exactly at +-B and exactly at
interior knots (the knots of the port's plain version). Tolerances:

- against torch autograd: 1e-5 absolute plus 1e-5 relative. Both compute
  in float32 from bit-identical knots, so even the tie rules agree (half
  the gradient at theta = 0 or 1 and at x = +-B, as ``jnp.clip``); only the
  order of the adjoint's products and sums differs.
- against ``jax.vjp``: 1e-4 absolute plus 1e-4 relative. The gradient of
  log|det| carries the spline's second derivative, whose float32 rounding
  differs by up to ~1e-4 relative between the frameworks, and d log|det|/dx
  is a difference of terms of order 10, which leaves up to ~6e-5 absolute
  on these inputs (torch autograd of the plain forward differs from JAX by
  as much). Elements at exactly +-B or at a knot are held to finiteness
  only there: whether JAX's float32 knot rounds one ulp above or below
  decides the bin and the tie rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.neural_nets.estimators.flows import rational_quadratic_spline as jax_rqs
from sbi_tpu_torch.ops import rqs
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

B = 3.0
TORCH_ATOL, TORCH_RTOL = 1e-5, 1e-5
JAX_ATOL, JAX_RTOL = 1e-4, 1e-4
NONDEFAULT = dict(min_bin_width=1e-2, min_bin_height=5e-3, min_derivative=1e-2)


def _inputs(K, inverse, seed, rows=48, cols=3, consts=None):
    """x (rows, cols), parameters as slices of one (rows, cols, 3K-1) array
    of std 0.5, upstream gradients; x.flat[:6] at and beyond the bounds,
    x.flat[6:18] exactly at an interior knot of its own element."""
    consts = consts or {}
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4.0, 4.0, size=(rows, cols)).astype(np.float32)
    x.flat[:6] = [-B, B, -B - 1e-3, B + 1e-3, -10.0, 10.0]
    p = (0.5 * rng.normal(size=(rows, cols, 3 * K - 1))).astype(np.float32)
    w, h, d = p[..., :K], p[..., K:2 * K], p[..., 2 * K:]
    min_bin = consts.get("min_bin_height" if inverse else "min_bin_width", rqs.DEFAULT_MIN_BIN_WIDTH)
    _, knots = rqs._knots(torch.tensor(h if inverse else w), min_bin, B)
    knots = knots.numpy().reshape(rows * cols, K + 1)
    at_knot = np.zeros(x.size, bool)
    for i in range(6, 18):
        x.flat[i] = knots[i, 1 + i % (K - 1)]
        at_knot[i] = True
    gy = rng.normal(size=x.shape).astype(np.float32)
    gl = rng.normal(size=x.shape).astype(np.float32)
    return (x, w, h, d, gy, gl), at_knot.reshape(x.shape)


def _vjp(arrays, inverse, consts=None):
    return rqs.rational_quadratic_spline_vjp_plain(
        *(torch.tensor(a) for a in arrays), inverse, B, **(consts or {}))


def _autograd(arrays, inverse, consts=None):
    x, w, h, d, gy, gl = (torch.tensor(a) for a in arrays)
    leaves = [t.requires_grad_(True) for t in (x, w, h, d)]
    y, ld = rqs.rational_quadratic_spline_plain(*leaves, inverse, B, **(consts or {}))
    return torch.autograd.grad((y, ld), leaves, (gy, gl))


def _jax_vjp(arrays, inverse, consts=None):
    x, w, h, d, gy, gl = map(jnp.asarray, arrays)
    _, vjp = jax.vjp(lambda *a: jax_rqs(*a, inverse=inverse, tail_bound=B, use_pallas=False,
                                        **(consts or {})), x, w, h, d)
    return vjp((gy, gl))


@pytest.mark.parametrize("K", [4, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_vjp_matches_torch_autograd(inverse, K):
    arrays, at_knot = _inputs(K, inverse, seed=K)
    got = _vjp(arrays, inverse)
    want = _autograd(arrays, inverse)
    for g, a in zip(got, want):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=TORCH_ATOL, rtol=TORCH_RTOL)
    # The tie rule at a knot is live: theta = 0 there, and the gradient
    # through theta is halved in both versions.
    x, w, h, d = (torch.tensor(a) for a in arrays[:4])
    _, knots = rqs._knots(h if inverse else w, rqs.DEFAULT_MIN_BIN_WIDTH, B)
    lo = torch.gather(knots, -1, rqs._bin(x, knots)[..., None])[..., 0]
    assert bool((x == lo)[torch.tensor(at_knot)].all())


@pytest.mark.parametrize("K", [4, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_vjp_matches_jax(inverse, K):
    arrays, at_knot = _inputs(K, inverse, seed=10 + K)
    got = _vjp(arrays, inverse)
    want = _jax_vjp(arrays, inverse)
    x = arrays[0]
    exact = (np.abs(x) == B) | at_knot
    outside = np.abs(x) > B
    for g, a in zip(got, want):
        g, a = g.numpy(), np.asarray(a)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[~exact], a[~exact], atol=JAX_ATOL, rtol=JAX_RTOL)
    # Outside the bounds: the identity, so x takes the upstream gradient of
    # y and the parameters nothing.
    np.testing.assert_array_equal(got[0].numpy()[outside], arrays[4][outside])
    for g in got[1:]:
        assert (g.numpy()[outside] == 0).all()


@pytest.mark.parametrize("inverse", [False, True])
def test_vjp_nondefault_constants(inverse):
    arrays, at_knot = _inputs(4, inverse, seed=20, consts=NONDEFAULT)
    got = _vjp(arrays, inverse, NONDEFAULT)
    for g, a in zip(got, _autograd(arrays, inverse, NONDEFAULT)):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=TORCH_ATOL, rtol=TORCH_RTOL)
    exact = (np.abs(arrays[0]) == B) | at_knot
    for g, a in zip(got, _jax_vjp(arrays, inverse, NONDEFAULT)):
        np.testing.assert_allclose(g.numpy()[~exact], np.asarray(a)[~exact],
                                   atol=JAX_ATOL, rtol=JAX_RTOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_wrapper_backward_runs_vjp_and_skips_unasked(inverse):
    """On the CPU the autograd.Function's backward is the plain VJP, and it
    returns no gradient for an input that does not ask for one."""
    arrays, _ = _inputs(10, inverse, seed=30)
    want = _vjp(arrays, inverse)
    x, w, h, d, gy, gl = (torch.tensor(a) for a in arrays)
    for asked in ((True, False, False, False), (False, True, True, True), (True,) * 4):
        leaves = [t.clone().requires_grad_(a) for t, a in zip((x, w, h, d), asked)]
        y, ld = rqs.rational_quadratic_spline(*leaves, inverse, B)
        torch.autograd.backward((y, ld), (gy, gl))
        for leaf, a, g in zip(leaves, asked, want):
            if a:
                torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)
            else:
                assert leaf.grad is None


def test_vjp_runs_in_float64():
    """chip_smoke.py holds the kernel's gradients to float64 autograd; the
    plain VJP agrees with it there too."""
    arrays, _ = _inputs(10, False, seed=40)
    arrays64 = [a.astype(np.float64) for a in arrays]
    got = rqs.rational_quadratic_spline_vjp_plain(*(torch.tensor(a) for a in arrays64), False, B)
    x, w, h, d, gy, gl = (torch.tensor(a) for a in arrays64)
    leaves = [t.requires_grad_(True) for t in (x, w, h, d)]
    want = torch.autograd.grad(rqs.rational_quadratic_spline_plain(*leaves, False, B), leaves, (gy, gl))
    for g, a in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("inverse", [False, True])
def test_gradient_at_a_zero_derivative_parameter_matches_jax(inverse):
    """An unnormalized derivative of exactly 0: softplus'(0) = 1/2 (jax's
    logaddexp), in the plain forward's autograd and in the plain VJP. The
    plain forward once took max(u, 0) with clamp, whose autograd gives the
    whole gradient at 0, and doubled this gradient."""
    arrays, _ = _inputs(4, inverse, seed=50)
    arrays[3][...] = 0.0
    want = np.asarray(_jax_vjp(arrays, inverse)[3])
    exact = (np.abs(arrays[0]) == B)[..., None].repeat(3, -1)
    for got in (_autograd(arrays, inverse)[3], _vjp(arrays, inverse)[3]):
        np.testing.assert_allclose(got.numpy()[~exact], want[~exact], atol=JAX_ATOL, rtol=JAX_RTOL)
