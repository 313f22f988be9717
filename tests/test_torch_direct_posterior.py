"""sbi_tpu_torch's DirectPosterior against sbi_tpu's, on the CPU: the NSF
serving slice as a whole, on bridged weights (see test_torch_flows.py).

- log_prob (norm_posterior=False) is deterministic: 1e-4 absolute, the
  flow's tolerance, and -inf at the same places.
- leakage_correction is a Monte-Carlo acceptance rate: the two frameworks'
  estimates agree within 4 binomial standard deviations.
- sample / sample_batched draw from generators that differ between the
  frameworks: shapes and prior support, and a C2ST against the JAX
  package's samples of the same weights <= 0.55 (n = 1000 per side, where
  the C2ST accuracy of two equal distributions has a standard deviation of
  about 0.011).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference.posteriors import DirectPosterior as JaxDirectPosterior
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu.utils.metrics import c2st
from sbi_tpu_torch.inference.posteriors import DirectPosterior
from sbi_tpu_torch.utils import BoxUniform

from .test_torch_flows import make_pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

LOW, HIGH = -2.0, 2.0  # about 60% of the flows' mass lands inside


def make_posteriors(dim, low=LOW, high=HIGH):
    je, te, theta, x = make_pair(dim)
    lo, hi = np.full(dim, low, np.float32), np.full(dim, high, np.float32)
    jpost = JaxDirectPosterior(je, JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)))
    tpost = DirectPosterior(te, BoxUniform(lo, hi, device="cpu"))
    return jpost, tpost, theta, x


@pytest.mark.parametrize("dim", [2, 5])
def test_log_prob_matches_jax(dim):
    jpost, tpost, _, x = make_posteriors(dim)
    th = np.random.default_rng(0).uniform(LOW, HIGH, size=(60, dim)).astype(np.float32)
    th[:3] = 5.0  # outside the prior box
    lp_j = np.asarray(jpost.log_prob(jnp.asarray(th), x=jnp.asarray(x[0]), norm_posterior=False))
    lp_t = tpost.log_prob(th, x=x[0], norm_posterior=False).detach().numpy()
    np.testing.assert_array_equal(np.isinf(lp_t), np.isinf(lp_j))
    assert np.isinf(lp_t[:3]).all() and np.isfinite(lp_t[3:]).all()
    np.testing.assert_allclose(lp_t[3:], lp_j[3:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dim", [2, 5])
def test_leakage_correction_within_binomial_noise(dim):
    jpost, tpost, _, x = make_posteriors(dim)
    n = 10_000
    a_j = float(jpost.leakage_correction(jnp.asarray(x[0]), num_rejection_samples=n,
                                         key=jax.random.PRNGKey(0)))
    a_t = float(tpost.leakage_correction(x[0], num_rejection_samples=n,
                                         generator=torch.Generator().manual_seed(0)))
    sigma = math.sqrt(2 * a_j * (1 - a_j) / n)  # std of the difference
    assert 0.05 < a_j < 0.95
    assert abs(a_t - a_j) <= 4 * sigma, (a_t, a_j, sigma)
    # normalized log_prob subtracts log(acceptance), cached per x
    th = np.zeros((4, dim), np.float32)
    lp = tpost.log_prob(th, x=x[0]).detach().numpy()
    lp_raw = tpost.log_prob(th, x=x[0], norm_posterior=False).detach().numpy()
    np.testing.assert_allclose(lp, lp_raw - math.log(a_t), atol=1e-5)


@pytest.mark.parametrize("dim", [2, 5])
def test_log_prob_batched_matches_jax(dim):
    """Each side subtracts its own leakage estimate; adding it back leaves
    the deterministic part, which must agree."""
    jpost, tpost, _, x = make_posteriors(dim)
    th = np.random.default_rng(1).uniform(-2.5, 2.5, size=(10, 3, dim)).astype(np.float32)
    xs = x[:3]
    out_j = np.asarray(jpost.log_prob_batched(jnp.asarray(th), jnp.asarray(xs)))
    out_j = out_j + np.log(np.asarray(jpost.leakage_correction(jnp.asarray(xs))))[None]
    out_t = tpost.log_prob_batched(th, xs).detach().numpy()
    out_t = out_t + np.log(tpost.leakage_correction(xs).numpy())[None]
    assert out_t.shape == (10, 3)
    np.testing.assert_array_equal(np.isinf(out_t), np.isinf(out_j))
    fin = np.isfinite(out_j)
    np.testing.assert_allclose(out_t[fin], out_j[fin], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dim", [2, 5])
def test_sample_matches_jax_c2st(dim):
    jpost, tpost, _, x = make_posteriors(dim)
    n = 1000
    s_j = np.asarray(jpost.sample((n,), x=jnp.asarray(x[0]), key=jax.random.PRNGKey(1)))
    s_t = tpost.sample((n,), x=x[0], generator=torch.Generator().manual_seed(1)).numpy()
    assert s_t.shape == (n, dim)
    assert ((s_t >= LOW) & (s_t <= HIGH)).all()
    assert float(c2st(s_t, s_j)) <= 0.55


def test_sample_batched_matches_jax_c2st():
    dim, n = 2, 1000
    jpost, tpost, _, x = make_posteriors(dim)
    xs = x[:2]
    s_j = np.asarray(jpost.sample_batched((n,), jnp.asarray(xs), key=jax.random.PRNGKey(2),
                                          starvation_policy="raise"))
    s_t = tpost.sample_batched((n,), xs, generator=torch.Generator().manual_seed(2),
                               starvation_policy="raise").numpy()
    assert s_t.shape == (n, 2, dim)
    assert ((s_t >= LOW) & (s_t <= HIGH)).all()
    assert float(c2st(s_t[:, 0], s_j[:, 0])) <= 0.55
    assert float(c2st(s_t[:, 1], s_j[:, 1])) <= 0.55


def test_starvation_policy():
    """A prior box the flow never reaches: "raise" raises as in JAX; the
    default "mcmc" fill samples the starved observations' truncated
    posteriors, which lie inside the box."""
    jpost, tpost, _, x = make_posteriors(2, low=20.0, high=21.0)
    with pytest.raises(RuntimeError, match="starved"):
        jpost.sample_batched((50,), jnp.asarray(x[:2]), key=jax.random.PRNGKey(3),
                             max_total_proposals=512, starvation_policy="raise")
    with pytest.raises(RuntimeError, match="starved"):
        tpost.sample_batched((50,), x[:2], max_total_proposals=512, starvation_policy="raise")
    filled = tpost.sample_batched((50,), x[:2], max_total_proposals=512,
                                  generator=torch.Generator().manual_seed(3)).numpy()
    assert filled.shape == (50, 2, 2)
    assert np.isfinite(filled).all()
    assert ((filled >= 20.0) & (filled <= 21.0)).all()
