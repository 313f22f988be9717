"""sbi_tpu_torch's variational inference against sbi_tpu's, on the CPU.

Deterministic parity, on the JAX package's weights (perturbed by
N(0, 0.1^2), so that the zero-initialised heads are not the identity)
bridged into the port:

- the five q families (``maf``, ``nsf`` at dim 2 and 1, ``gaussian``,
  ``gaussian_diag``, ``nice``): ``log_prob`` at given points, and the
  inverse pass (``sample_and_log_prob``) from the same base noise, made by
  ``jax.random.normal`` from the JAX package's key and handed to the port:
  within 1e-5 absolute plus 1e-5 relative (a perturbed spline's log-prob
  reaches 30 nats, where the two float32 computations, whose sums over the
  bins run in another order, differ by up to 5e-6 relative);
- the four divergences on the same particles (those the same noise gives
  through q): the loss within 1e-5 absolute plus 1e-5 relative, as the
  values it averages, and its gradient in every parameter within 1e-4
  absolute plus 1e-3 relative to the parameter's largest;

The optimizer, the amortized loss, ``sample_with="vi"`` and ``q="naf"``
are in test_torch_vi_posterior.py, the fits in test_torch_vi_fit.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference.posteriors import vi_posterior as jvi
from sbi_tpu.samplers.vi import vi_divergence_optimizers as jdiv
from sbi_tpu_torch.inference.posteriors import vi_posterior as tvi
from sbi_tpu_torch.neural_nets.estimators.base import functional
from sbi_tpu_torch.utils.params_bridge import load_flax_flow
from sbi_tpu_torch.samplers.vi import vi_divergence_optimizers as tdiv

from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
RTOL = 1e-5  # values of log-probs and losses (module docstring)
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
MEAN = np.array([0.8, -1.2], np.float32)  # tests/test_vi.py's target
COV = np.array([[1.0, 0.6], [0.6, 1.5]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)
Q_CASES = [("maf", 2), ("nsf", 2), ("nsf", 1), ("gaussian", 2), ("gaussian_diag", 2), ("nice", 2),
           ("nice", 3)]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)


@functools.lru_cache(maxsize=None)
def q_pair(q, dim, seed=0):
    """(JAX module, its perturbed params, the port's q with them)."""
    module, params = jvi._make_q_flow(dim, q, jax.random.PRNGKey(seed))
    params = _perturbed(params, seed)
    tq = load_flax_flow(tvi._make_q_flow(dim, q, device="cpu"), params)
    return module, jax.tree_util.tree_map(jnp.asarray, params), tq


def _gauss(xp):
    prec, mean = xp.asarray(PREC), xp.asarray(MEAN)
    return lambda th: -0.5 * (((th - mean) @ prec) * (th - mean)).sum(-1)


@pytest.mark.parametrize("q, dim", Q_CASES)
def test_q_family_log_prob_and_inverse_match_jax(q, dim):
    module, params, tq = q_pair(q, dim)
    points = np.random.default_rng(1).normal(size=(64, dim)).astype(np.float32) * 1.5
    want = jax.jit(lambda p, t: module.apply(p, t, None, method="log_prob"))(params, jnp.asarray(points))
    with torch.no_grad():
        got = tq.log_prob(torch.tensor(points), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

    key = jax.random.PRNGKey(2)
    u, log_q = jax.jit(lambda p: module.apply(p, key, 64, None, method="sample_and_log_prob"))(params)
    z = torch.tensor(np.asarray(jax.random.normal(key, (64, dim))))
    with torch.no_grad():
        tu, tlog_q = tq.inverse_and_log_prob(z)
    np.testing.assert_allclose(tu.numpy(), np.asarray(u[:, 0]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tlog_q.numpy(), np.asarray(log_q[:, 0]), atol=ATOL, rtol=RTOL)
    assert sum(p.numel() for p in tq.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))


def _grads_to_port(jgrads, q, dim):
    """The JAX gradient tree, in the port's parameter layout."""
    holder = load_flax_flow(tvi._make_q_flow(dim, q, device="cpu"), jax.tree_util.tree_map(
        np.asarray, jgrads))
    return dict(holder.named_parameters())


def _assert_grads_close(got, want):
    for name, g in got.items():
        w = want[name].detach()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL + GRAD_RTOL * float(
            w.abs().max()), rtol=0, err_msg=name)


@pytest.mark.parametrize("method", ["rKL", "IW", "fKL", "alpha"])
@pytest.mark.parametrize("q", ["nsf", "maf"])
def test_divergences_on_the_same_particles_match_jax(method, q):
    dim, n = 2, 64
    module, params, tq = q_pair(q, dim)
    key = jax.random.PRNGKey(3)

    def jsample(p, k, m):
        u, log_q = module.apply(p, k, m, None, method="sample_and_log_prob")
        return u[:, 0, :], log_q[:, 0]

    jlog_prob = lambda p, u: module.apply(p, u, None, method="log_prob")
    jloss = lambda p: jdiv.get_VI_method(method)(p, key, jsample, jlog_prob, _gauss(jnp), n)
    want, jgrads = jax.value_and_grad(jloss)(params)

    count = (n // 8) * 8 if method == "IW" else n
    z = torch.tensor(np.asarray(jax.random.normal(key, (count, dim))))
    from_noise = functional(tq, lambda: tq.inverse_and_log_prob(z))
    tparams = {k: v.detach().clone().requires_grad_(True) for k, v in tq.named_parameters()}

    def tsample(p, g, m):
        assert m == count
        return from_noise(p)

    tlog_prob = functional(tq, lambda u: tq.log_prob(u, None))
    loss = tdiv.get_VI_method(method)(tparams, None, tsample, tlog_prob, _gauss(torch), n)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), atol=ATOL, rtol=RTOL)
    _assert_grads_close({k: v.grad for k, v in tparams.items()}, _grads_to_port(jgrads, q, dim))
