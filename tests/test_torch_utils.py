"""sbi_tpu_torch's substrate against sbi_tpu's, on the CPU: distributions,
transforms, z-scoring and its warnings, generators, and the simulators.

Deterministic functions are compared at float32 tolerances (1e-5). The
simulators draw their noise from framework-specific generators, so they
are compared by moments: the means of 4,000 draws for one theta agree
within 5 standard errors.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.simulators.tasks import slcp_simulator as jax_slcp
from sbi_tpu.simulators.tasks import two_moons_simulator as jax_two_moons
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu.utils import MultivariateNormal as JaxMVN
from sbi_tpu.utils.sbiutils import standardizing_transform as jax_standardizing
from sbi_tpu.utils.sbiutils import warn_if_invalid_for_zscoring as jax_warn
from sbi_tpu.utils.sbiutils import z_score_stats as jax_z_score_stats
from sbi_tpu.utils.transforms import mcmc_transform as jax_mcmc_transform
from sbi_tpu_torch.simulators import get_task, slcp_simulator, two_moons_simulator
from sbi_tpu_torch.utils import BoxUniform, MultivariateNormal, mcmc_transform, seed_all_backends
from sbi_tpu_torch.utils.sbiutils import (
    next_generator,
    standardizing_transform,
    warn_if_invalid_for_zscoring,
    z_score_stats,
)
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("structured", [False, True])
def test_z_score_transforms_match_jax(structured):
    rng = np.random.default_rng(6)
    batch = (rng.normal(size=(200, 3)) * [1.0, 5.0, 0.1] + [0.0, 2.0, -1.0]).astype(np.float32)
    m_j, s_j = jax_z_score_stats(jnp.asarray(batch), structured)
    m_t, s_t = z_score_stats(torch.as_tensor(batch), structured)
    _close(m_t, m_j)
    _close(s_t, s_j)  # the population std, as jnp.std
    tf_j = jax_standardizing(jnp.asarray(batch), structured)
    tf_t = standardizing_transform(torch.as_tensor(batch), structured)
    for a, b in zip(tf_t.forward_and_log_det(torch.as_tensor(batch)),
                    tf_j.forward_and_log_det(jnp.asarray(batch))):
        _close(a, b)


@pytest.mark.parametrize("case", ["single", "constant", "outlier", "clean"])
def test_zscore_warnings_match_jax(case):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(100, 3)).astype(np.float32)
    if case == "single":
        x = x[:1]
    elif case == "constant":
        x[:, 1] = 2.0
    elif case == "outlier":
        x[0, 2] = 1e4
    caught = []
    for fn, arr in ((jax_warn, jnp.asarray(x)), (warn_if_invalid_for_zscoring, torch.as_tensor(x))):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn(arr)
        caught.append([str(w.message) for w in rec])
    assert caught[0] == caught[1]
    assert bool(caught[1]) == (case != "clean")


def test_box_uniform_and_transform_match_jax():
    rng = np.random.default_rng(8)
    low, high = np.array([-3.0, 0.0], np.float32), np.array([3.0, 1.0], np.float32)
    p_j, p_t = JaxBoxUniform(jnp.asarray(low), jnp.asarray(high)), BoxUniform(low, high, device="cpu")
    theta = rng.uniform(low - 0.5, high + 0.5, size=(40, 2)).astype(np.float32)
    np.testing.assert_array_equal(p_t.within_support(torch.as_tensor(theta)).numpy(),
                                  np.asarray(p_j.within_support(jnp.asarray(theta))))
    _close(p_t.log_prob(torch.as_tensor(theta)), p_j.log_prob(jnp.asarray(theta)))
    s = p_t.sample((500,), generator=torch.Generator().manual_seed(0))
    assert s.shape == (500, 2) and bool(p_t.within_support(s).all())

    t_j, t_t = jax_mcmc_transform(p_j), mcmc_transform(p_t)
    inside = rng.uniform(low, high, size=(20, 2)).astype(np.float32)
    u = (rng.normal(size=(20, 2)) * 5).astype(np.float32)
    u[0] = [40.0, -40.0]  # sigmoid saturates: the inverse stays in the open box
    for a, b in zip(t_t.forward_and_log_det(torch.as_tensor(inside)),
                    t_j.forward_and_log_det(jnp.asarray(inside))):
        _close(a, b)
    for a, b in zip(t_t.inverse_and_log_det(torch.as_tensor(u)),
                    t_j.inverse_and_log_det(jnp.asarray(u))):
        _close(a, b)
    back = t_t.inv(torch.as_tensor(u))
    assert bool(((back > torch.as_tensor(low)) & (back < torch.as_tensor(high))).all())


def test_multivariate_normal_and_transform_match_jax():
    rng = np.random.default_rng(9)
    loc = np.array([0.5, -1.0, 2.0], np.float32)
    a = rng.normal(size=(3, 3)).astype(np.float32)
    cov = (a @ a.T + 0.5 * np.eye(3)).astype(np.float32)
    d_j = JaxMVN(jnp.asarray(loc), covariance_matrix=jnp.asarray(cov))
    d_t = MultivariateNormal(loc, covariance_matrix=cov, device="cpu")
    theta = rng.normal(size=(2, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(d_t.log_prob(torch.as_tensor(theta)).numpy(),
                               np.asarray(d_j.log_prob(jnp.asarray(theta))), rtol=1e-5, atol=1e-4)
    _close(d_t.mean, d_j.mean)
    _close(d_t.stddev, d_j.stddev)
    t_j, t_t = jax_mcmc_transform(d_j), mcmc_transform(d_t)
    for a_, b_ in zip(t_t.forward_and_log_det(torch.as_tensor(theta)),
                      t_j.forward_and_log_det(jnp.asarray(theta))):
        _close(a_, b_)
    s = d_t.sample((20_000,), generator=torch.Generator().manual_seed(1))
    assert s.shape == (20_000, 3)
    np.testing.assert_allclose(np.cov(s.numpy().T), cov, atol=0.15 * np.abs(cov).max())


def test_global_generators_follow_the_seed():
    seed_all_backends(3)
    a = torch.rand(4, generator=next_generator(None, "cpu"))
    seed_all_backends(3)
    b = torch.rand(4, generator=next_generator(None, "cpu"))
    c = torch.rand(4, generator=next_generator(None, "cpu"))
    assert torch.equal(a, b) and not torch.equal(b, c)
    g = torch.Generator()
    assert next_generator(g, "cpu") is g


@pytest.mark.parametrize("task", ["two_moons", "slcp"])
def test_simulators_match_jax_in_distribution(task):
    n = 4000
    if task == "two_moons":
        theta = np.array([[0.3, -0.5]], np.float32)
        sim_j, sim_t = jax_two_moons, two_moons_simulator
    else:
        theta = np.array([[0.5, -1.0, 0.8, -0.6, 0.4]], np.float32)
        sim_j, sim_t = jax_slcp, slcp_simulator
    th = np.repeat(theta, n, axis=0)
    x_j = np.asarray(sim_j(jnp.asarray(th), key=jax.random.PRNGKey(0)))
    x_t = sim_t(torch.as_tensor(th), generator=torch.Generator().manual_seed(0)).numpy()
    assert x_t.shape == x_j.shape and np.isfinite(x_t).all()
    se = np.sqrt(x_j.var(0) / n + x_t.var(0) / n)
    assert (np.abs(x_t.mean(0) - x_j.mean(0)) <= 5 * se).all()
    np.testing.assert_allclose(x_t.std(0), x_j.std(0), rtol=0.1)
    t = get_task(task, device="cpu")
    assert (t.theta_dim, t.x_dim) == (theta.shape[1], x_t.shape[1])
