"""The spline's vmap rule against sbi_tpu's ``_rqs_flat_fn``, on the CPU.

``torch.func.vmap`` of the port's spline (the ``vmap`` rules of its
autograd Functions, the counterpart of the TPU kernel's ``custom_vmap``
merge) is held against ``jax.vmap`` of ``rational_quadratic_spline_pallas``
run by Pallas's interpreter, which goes through ``_rqs_flat_fn``'s own
rule, for every mix of batched and unbatched arguments that rule handles;
``vmap(grad)`` against ``jax.vmap(jax.grad)`` and against each member's
plain VJP. On the CPU the merge shows only in call counts: under ``vmap``
the plain forward and the plain VJP run once per spline call, never once
per member, and never on a ``torch.func``-wrapped tensor (the raw CUDA
launchers would fail on one).

Tolerances, as test_torch_rqs.py states them: y 1e-5 and log|det| 1e-4
absolute; gradients 1e-5 absolute plus 1e-4 relative, elements exactly at
the tail bound held to finiteness only. Against the port's own per-member
calls: equal bit for bit (the same plain arithmetic on the same elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.ops.rqs_pallas import rational_quadratic_spline_pallas
from sbi_tpu_torch.ops import rqs

from .test_torch_rqs import B, GRAD_ATOL, GRAD_RTOL, LD_ATOL, PARAM_SCALE, Y_ATOL
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

K_BINS = 10
MEMBERS, ROWS, COLS = 4, 6, 3


def _inputs(seed=0):
    """x (M, R, C) inside, outside and at +-B; parameters as slices of one
    (M, R, C, 3K-1) array, as the ensemble's conditioners give them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4.0, 4.0, size=(MEMBERS, ROWS, COLS)).astype(np.float32)
    x.flat[:6] = [-B, B, -B - 1e-3, B + 1e-3, -10.0, 10.0]
    p = (PARAM_SCALE * rng.normal(size=(MEMBERS, ROWS, COLS, 3 * K_BINS - 1))).astype(np.float32)
    return x, p


def _split(p):
    return p[..., :K_BINS], p[..., K_BINS:2 * K_BINS], p[..., 2 * K_BINS:]


class _Counted:
    """Wraps the plain forward and VJP: counts their calls and raises on a
    ``torch.func``-wrapped argument; the raw launchers raise if called."""

    def __init__(self, monkeypatch):
        self.forward = self.vjp = 0
        plain, vjp = rqs.rational_quadratic_spline_plain, rqs.rational_quadratic_spline_vjp_plain

        def unwrapped(tensors):
            assert not any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors)

        def counted_plain(*args, **kwargs):
            unwrapped(args[:4])
            self.forward += 1
            return plain(*args, **kwargs)

        def counted_vjp(*args, **kwargs):
            unwrapped(args[:6])
            self.vjp += 1
            return vjp(*args, **kwargs)

        def no_launch(*args, **kwargs):
            raise AssertionError("a raw CUDA launcher was called on the CPU")

        monkeypatch.setattr(rqs, "rational_quadratic_spline_plain", counted_plain)
        monkeypatch.setattr(rqs, "rational_quadratic_spline_vjp_plain", counted_vjp)
        monkeypatch.setattr(rqs, "_launch", no_launch)
        monkeypatch.setattr(rqs, "_launch_backward", no_launch)


# Which of (x, w, h, d) carry the member axis, as _rule's in_batched does.
MIXES = {
    "all": (0, 0, 0, 0),
    "x_unbatched": (None, 0, 0, 0),
    "params_unbatched": (0, None, None, None),
    "widths_only": (None, 0, None, None),
}


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("inverse", [False, True])
def test_vmap_matches_pallas_custom_vmap(inverse, mix, monkeypatch):
    monkeypatch.setenv("SBI_TPU_PALLAS_INTERPRET", "1")
    counted = _Counted(monkeypatch)
    x, p = _inputs(seed=1)
    args = (x, *_split(p))
    dims = MIXES[mix]
    # An unbatched argument is member 0's slice.
    args = [a if d == 0 else a[0] for a, d in zip(args, dims)]
    y_j, ld_j = jax.vmap(
        lambda *a: rational_quadratic_spline_pallas(*a, inverse, B), in_axes=dims,
    )(*map(jnp.asarray, args))
    y_t, ld_t = torch.func.vmap(
        lambda *a: rqs.rational_quadratic_spline(*a, inverse, B), in_dims=dims,
    )(*map(torch.as_tensor, args))
    assert counted.forward == 1
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=Y_ATOL, rtol=0)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=LD_ATOL, rtol=0)


def _loss(spline, x, p, gy, gl):
    y, ld = spline(x, *_split(p))
    return (y * gy).sum() + (ld * gl).sum()


@pytest.mark.parametrize("inverse", [False, True])
def test_vmap_grad_matches_jax_and_the_plain_vjp(inverse, monkeypatch):
    monkeypatch.setenv("SBI_TPU_PALLAS_INTERPRET", "1")
    x, p = _inputs(seed=2)
    rng = np.random.default_rng(3)
    gy = rng.normal(size=x.shape).astype(np.float32)
    gl = rng.normal(size=x.shape).astype(np.float32)
    g_j = jax.vmap(jax.grad(
        lambda *a: _loss(lambda *s: rational_quadratic_spline_pallas(*s, inverse, B), *a),
        argnums=(0, 1)))(*map(jnp.asarray, (x, p, gy, gl)))
    counted = _Counted(monkeypatch)
    g_t = torch.func.vmap(torch.func.grad(
        lambda *a: _loss(lambda *s: rqs.rational_quadratic_spline(*s, inverse, B), *a),
        argnums=(0, 1)))(*map(torch.as_tensor, (x, p, gy, gl)))
    assert (counted.forward, counted.vjp) == (1, 1)
    at_bound = np.abs(x) == B
    for got, want in zip(g_t, g_j):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[~at_bound], want[~at_bound], atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # Each member's plain VJP, called directly: the same numbers exactly.
    for m in range(MEMBERS):
        gx, gw, gh, gd = rqs.rational_quadratic_spline_vjp_plain(
            *map(torch.as_tensor, (x[m], *_split(p[m]), gy[m], gl[m])), inverse, B)
        assert torch.equal(g_t[0][m], gx)
        assert torch.equal(g_t[1][m], torch.cat([gw, gh, gd], dim=-1))


def test_merged_values_equal_member_calls_and_keep_the_row_layout(monkeypatch):
    """The merge of a vmapped call hands the plain version (the kernel, on
    the card) the members' slices of one row as one (M * R * C, 3K-1)
    span: the kernel's 16-byte tile load. Its values equal the members'
    separate calls bit for bit."""
    x, p = (torch.as_tensor(a) for a in _inputs(seed=4))
    layouts = []
    plain = rqs.rational_quadratic_spline_plain

    def recording(x_, w_, h_, d_, *rest):
        layouts.append((tuple(x_.shape), rqs.tile_load(w_, h_, d_)))
        return plain(x_, w_, h_, d_, *rest)

    monkeypatch.setattr(rqs, "rational_quadratic_spline_plain", recording)
    for inverse in (False, True):
        layouts.clear()
        y, ld = torch.func.vmap(lambda a, q: rqs.rational_quadratic_spline(a, *_split(q), inverse))(x, p)
        assert layouts == [((MEMBERS, ROWS, COLS), "one_span")]
        for m in range(MEMBERS):
            y_m, ld_m = rqs.rational_quadratic_spline(x[m], *_split(p[m]), inverse)
            assert torch.equal(y[m], y_m) and torch.equal(ld[m], ld_m)


def test_nested_vmap_and_other_in_dims_launch_once(monkeypatch):
    counted = _Counted(monkeypatch)
    x, p = (torch.as_tensor(a) for a in _inputs(seed=5))
    spline = lambda a, q: rqs.rational_quadratic_spline(a, *_split(q))
    y_nested, _ = torch.func.vmap(torch.func.vmap(spline))(x, p)
    assert counted.forward == 1
    y_dim1, _ = torch.func.vmap(spline, in_dims=(1, 1))(x, p)  # rows as the vmapped axis
    assert counted.forward == 2
    y_plain, _ = rqs.rational_quadratic_spline_plain(x, *_split(p))
    assert torch.equal(y_nested, y_plain)
    assert torch.equal(y_dim1, y_plain.transpose(0, 1))


def test_transforms_without_vmap_go_through_the_function(monkeypatch):
    """``torch.func.grad`` alone and ``vmap`` under ``no_grad`` unwrap their
    tensors too; the no-grad path for plain tensors is unchanged."""
    counted = _Counted(monkeypatch)
    x, p = (torch.as_tensor(a) for a in _inputs(seed=6))
    g = torch.func.grad(lambda q: rqs.rational_quadratic_spline(x[0], *_split(q))[1].sum())(p[0])
    assert (counted.forward, counted.vjp) == (1, 1) and bool(torch.isfinite(g).all())
    with torch.no_grad():
        torch.func.vmap(lambda a, q: rqs.rational_quadratic_spline(a, *_split(q)))(x, p)
        rqs.rational_quadratic_spline(x, *_split(p))
    assert (counted.forward, counted.vjp) == (3, 1)
