"""sbi_tpu_torch's rejection and importance sampling against sbi_tpu's, on
the CPU.

Both packages draw their proposals from their own generators, so the
deterministic parts are compared on the same inputs: a proposal that
returns fixed numpy draws gives both packages the same theta, hence the
same log importance weights; ``gpdfit`` takes the same tail; the
rejection sampler's ascent starts from the same theta on the same bridged
ratio potential, against the JAX package's 100 ``optax.adam(0.01)`` steps
(``rejection.py``'s ``scan``, rebuilt here from its lines). Tolerances:

- log weights, SIR block probabilities and the ESS: 1e-5 relative plus
  1e-5 absolute (float32);
- ``gpdfit`` (k, sigma and the quadrature weights) and the PSIS k-hat:
  1e-4 absolute. The weights are 1 / sum_j exp(L_j - L_i) with L = N *
  (...) and N the tail size (1,000 here at most), so float32 rounding of
  the terms moves a weight by up to ~3e-5;
- the ascent's end point and log M: 1e-4 absolute. Adam divides each step
  by sqrt(v), so a gradient that rounds differently moves a step by up to
  a few ulp of lr over 100 steps;
- the samplers end to end: the draws' mean within 0.1 and standard
  deviation within 0.1 of the target's (4,000 draws of N(0.5, 0.6^2) from
  a N(0, 1.5^2) proposal, ~5 standard errors).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sbi_tpu.inference.potentials.ratio_based_potential import RatioBasedPotential as JaxPotential
from sbi_tpu.samplers.importance import importance_sampling as jis
from sbi_tpu.utils.distributions import MultivariateNormal as JaxMVN
from sbi_tpu_torch.inference import (
    NRE_B,
    ImportanceSamplingPosterior,
    ImportanceSamplingPosteriorParameters,
    MCMCPosterior,
    MCMCPosteriorParameters,
    RatioBasedPotential,
    RejectionPosterior,
    RejectionPosteriorParameters,
    VIPosterior,
    VIPosteriorParameters,
)
from sbi_tpu_torch.inference.posteriors.posterior_parameters import build_posterior_from_parameters
from sbi_tpu_torch.samplers.importance import importance_sampling as tis
from sbi_tpu_torch.samplers.rejection import ascend_log_ratio, rejection_sample
from sbi_tpu_torch.utils import BoxUniform, MultivariateNormal

from .test_torch_nre import THETA_DIM, pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

RTOL = ATOL = 1e-5
K_ATOL = 1e-4
ASCENT_ATOL = 1e-4
MEAN_ATOL = STD_ATOL = 0.1


def fixed_draws(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_t(3, size=(n, 2)) * 0.8).astype(np.float32)


class _JaxFixed:
    """A JAX-side proposal that draws the given rows, with an MVN log-prob."""

    def __init__(self, draws):
        self.draws = jnp.asarray(draws)
        self.mvn = JaxMVN(jnp.zeros(2), covariance_matrix=2.0 * jnp.eye(2))

    def sample(self, key, shape):
        return self.draws[: shape[0]]

    def log_prob(self, theta):
        return self.mvn.log_prob(theta)


class _TorchFixed:
    def __init__(self, draws):
        self.draws = torch.tensor(draws)
        self.mvn = MultivariateNormal(torch.zeros(2), covariance_matrix=2.0 * torch.eye(2),
                                      device="cpu")

    def sample(self, shape, generator=None):
        return self.draws[: shape[0]]

    def log_prob(self, theta):
        return self.mvn.log_prob(theta)


def _potentials():
    """A skewed, heavy-tailed target on both sides, NaN at one row."""
    def jax_pot(t):
        lp = -0.5 * ((t - 0.3) ** 2).sum(-1) / 0.4 + 0.8 * jnp.tanh(3.0 * t[:, 0])
        return jnp.where(t[:, 1] > 4.0, jnp.nan, lp)

    def torch_pot(t):
        lp = -0.5 * ((t - 0.3) ** 2).sum(-1) / 0.4 + 0.8 * torch.tanh(3.0 * t[:, 0])
        return torch.where(t[:, 1] > 4.0, torch.nan, lp)

    return jax_pot, torch_pot


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    def arr(a):
        return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    np.testing.assert_allclose(arr(got), arr(want), rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# Importance weights, SIR, gpdfit, PSIS
# ---------------------------------------------------------------------------


def test_importance_weights_and_sir_blocks_match_jax():
    draws = fixed_draws(1024)
    assert (draws[:, 1] > 4.0).any()  # a NaN weight becomes -inf
    jax_pot, torch_pot = _potentials()
    js, jw = jis.importance_sample(jax_pot, _JaxFixed(draws), num_samples=len(draws),
                                   key=jax.random.PRNGKey(0))
    ts, tw = tis.importance_sample(torch_pot, _TorchFixed(draws), num_samples=len(draws))
    close(ts, js)
    assert np.array_equal(np.isneginf(tw.numpy()), np.isneginf(np.asarray(jw)))
    finite = np.isfinite(np.asarray(jw))
    close(tw.numpy()[finite], np.asarray(jw)[finite])
    close(tis.importance_resampling_weights_ess(tw), jis.importance_resampling_weights_ess(jw))
    # SIR draws one winner per block of 32 with probability softmax(block).
    blocks_t, blocks_j = tw.reshape(-1, 32), jw.reshape(-1, 32)
    close(torch.softmax(blocks_t, dim=-1), jax.nn.softmax(blocks_j, axis=-1))
    g = torch.Generator().manual_seed(0)
    winners = tis.sampling_importance_resampling(torch_pot, _TorchFixed(draws), num_samples=32,
                                                 oversampling_factor=32, generator=g)
    rows = {tuple(r) for r in draws.tolist()}
    assert winners.shape == (32, 2) and all(tuple(w) in rows for w in winners.tolist())


def test_sir_takes_the_only_finite_weight_of_a_block():
    draws = np.arange(16, dtype=np.float32).reshape(8, 2)

    def potential(t):
        keep = (t[:, 0] % 8) == 2  # rows 1 and 5: one per block of 4
        return torch.where(keep, torch.zeros(len(t)), torch.full((len(t),), -math.inf))

    proposal = _TorchFixed(draws)
    proposal.log_prob = lambda t: torch.zeros(len(t))
    out = tis.sampling_importance_resampling(potential, proposal, num_samples=2,
                                             oversampling_factor=4)
    assert out.tolist() == [[2.0, 3.0], [10.0, 11.0]]


@pytest.mark.parametrize("n", [200, 1000, 5000])
def test_gpdfit_and_psis_match_jax(n):
    jax_pot, torch_pot = _potentials()
    draws = fixed_draws(n, seed=n)
    tail = np.sort(np.random.default_rng(n).pareto(2.0, size=n // 5).astype(np.float32))
    kj, sj, bj, wj = jis.gpdfit(jnp.asarray(tail), return_quadrature=True)
    kt, st, bt, wt = tis.gpdfit(torch.tensor(tail), return_quadrature=True)
    close(kt, kj, 0, K_ATOL)
    close(st, sj, 1e-4, K_ATOL)
    close(bt, bj, 1e-5, 1e-6)
    close(wt, wj, 0, K_ATOL)
    unsorted = np.random.default_rng(1).permutation(tail)
    close(tis.gpdfit(torch.tensor(unsorted), sorted=False)[0], kt, 0, 1e-6)
    k_jax = jis.psis_diagnostics(jax_pot, _JaxFixed(draws), key=jax.random.PRNGKey(0), N=n)
    k_torch = tis.psis_diagnostics(torch_pot, _TorchFixed(draws), N=n)
    assert isinstance(k_torch, float) and abs(k_torch - k_jax) <= K_ATOL


# ---------------------------------------------------------------------------
# The rejection sampler's ascent
# ---------------------------------------------------------------------------


def _jax_ascent(potential_fn, proposal, theta0, num_iter=100):
    """``sbi_tpu/samplers/rejection/rejection.py``'s ascent from theta0."""
    def neg_ratio(theta):
        t = theta[None]
        return -(potential_fn(t) - proposal.log_prob(t)).sum()

    opt = optax.adam(0.01)
    grad_fn = jax.grad(neg_ratio)

    def step(carry, _):
        theta, state = carry
        updates, state = opt.update(grad_fn(theta), state)
        return (optax.apply_updates(theta, updates), state), None

    (theta, _), _ = jax.lax.scan(step, (theta0, opt.init(theta0)), None, length=num_iter)
    return theta


def test_rejection_ascent_matches_jax():
    je, te, theta, x = pair("resnet", embedding=True)
    jprior = JaxMVN(jnp.zeros(THETA_DIM), covariance_matrix=2.0 * jnp.eye(THETA_DIM))
    tprior = MultivariateNormal(torch.zeros(THETA_DIM), covariance_matrix=2.0 * torch.eye(THETA_DIM),
                                device="cpu")
    jpot = JaxPotential(je, jprior, jnp.asarray(x[:1]))
    tpot = RatioBasedPotential(te, tprior, x[:1])
    theta0 = theta[3]
    end_j = np.asarray(_jax_ascent(jpot, jprior, jnp.asarray(theta0)))
    end_t = ascend_log_ratio(tpot, tprior, torch.tensor(theta0[None]))
    close(end_t[0], end_j, 0, ASCENT_ATOL)
    assert float(np.abs(end_j - theta0).max()) > 0.3  # the ascent moved

    def log_m(pot, prior, points, m=1.2):
        return max(float((pot(p[None]) - prior.log_prob(p[None]))[0]) for p in points) + math.log(m)

    with torch.no_grad():
        got = log_m(tpot, tprior, [torch.tensor(theta0), end_t[0]])
    want = log_m(jpot, jprior, [jnp.asarray(theta0), jnp.asarray(end_j)])
    assert abs(got - want) <= ASCENT_ATOL


# ---------------------------------------------------------------------------
# The samplers and the two posteriors
# ---------------------------------------------------------------------------

TARGET_MEAN, TARGET_STD = 0.5, 0.6


def target_potential(t, x_o=0.0):
    """N(0.5 + x_o, 0.6^2 I), unnormalized."""
    return -0.5 * (((t - TARGET_MEAN - x_o) / TARGET_STD) ** 2).sum(-1)


def wide_proposal():
    return MultivariateNormal(torch.zeros(2), covariance_matrix=1.5**2 * torch.eye(2), device="cpu")


def _assert_target(samples):
    assert bool(torch.isfinite(samples).all())
    assert float((samples.mean(0) - TARGET_MEAN).abs().max()) < MEAN_ATOL
    assert float((samples.std(0) - TARGET_STD).abs().max()) < STD_ATOL


def test_rejection_sample_draws_the_target():
    g = torch.Generator().manual_seed(0)
    samples, rate = rejection_sample(target_potential, wide_proposal(), generator=g, num_samples=4000,
                                     sample_batch_size=2000, num_samples_to_find_max=2000)
    assert samples.shape == (4000, 2) and 0.0 < float(rate) < 1.0
    _assert_target(samples)


def test_rejection_ascent_may_leave_a_box_support():
    """A ratio that grows towards the edge of a box prior: the ascent ends
    outside the box, where the ratio is NaN, and log M comes from the
    best proposal draw (the JAX package's max would be NaN and accept
    nothing)."""
    prior = BoxUniform(-torch.ones(2), torch.ones(2), device="cpu")

    def potential(t):
        return 3.0 * t[:, 0] + prior.log_prob(t)

    end = ascend_log_ratio(potential, prior, torch.tensor([[0.9, 0.0]]))
    assert float(end[0, 0]) > 1.0
    g = torch.Generator().manual_seed(3)
    samples, rate = rejection_sample(potential, prior, generator=g, num_samples=2000,
                                     sample_batch_size=2000, num_samples_to_find_max=500)
    assert samples.shape == (2000, 2) and bool(prior.within_support(samples).all())
    # theta_0 has density prop. to exp(3 t) on [-1, 1]: mean 1/tanh(3) - 1/3.
    assert abs(float(samples[:, 0].mean()) - (1 / math.tanh(3.0) - 1 / 3)) < MEAN_ATOL
    # The acceptance rate is E[exp(3 t)] / (1.2 exp(3 max t)) = sinh(3) / (3.6 e^3) = 0.139.
    assert abs(float(rate) - math.sinh(3.0) / (3.6 * math.exp(3.0))) < 0.02


@pytest.mark.parametrize("method", ["sir", "importance"])
def test_importance_posterior_draws_the_target(method):
    post = ImportanceSamplingPosterior(target_potential, proposal=wide_proposal(), method=method,
                                       device="cpu")
    g = torch.Generator().manual_seed(1)
    x0 = torch.zeros(1, 2)
    samples = post.sample((4000,), x=x0, generator=g)
    assert samples.shape == (4000, 2)
    if method == "sir":
        _assert_target(samples)
    draws, log_w = post.sample_with_weights(4000, x=x0, generator=g)
    w = torch.softmax(log_w, 0)
    assert float(((w[:, None] * draws).sum(0) - TARGET_MEAN).abs().max()) < MEAN_ATOL
    ess = float(tis.importance_resampling_weights_ess(log_w))
    assert 100 < ess < 4000
    assert isinstance(post.evaluate(x=x0, num_samples=1000, generator=g), float)
    batched = post.sample_batched((30,), x=torch.tensor([[0.0, 0.0], [3.0, 3.0]]), generator=g)
    assert batched.shape == (30, 2, 2)
    if method == "sir":
        assert float(batched[:, 1].mean()) > float(batched[:, 0].mean()) + 1.0
    close(post.log_prob(draws[:5], x=x0), target_potential(draws[:5], x0))


def test_rejection_posterior_shapes_and_log_prob():
    post = RejectionPosterior(target_potential, proposal=wide_proposal(), max_sampling_batch_size=1000,
                              num_samples_to_find_max=500, num_iter_to_find_max=20, device="cpu")
    g = torch.Generator().manual_seed(2)
    assert post.sample((3, 4), x=torch.zeros(2), generator=g).shape == (3, 4, 2)
    batched = post.sample_batched((25,), x=torch.tensor([[0.0, 0.0], [2.0, 2.0]]), generator=g)
    assert batched.shape == (25, 2, 2)
    assert float(batched[:, 1].mean()) > float(batched[:, 0].mean()) + 1.0
    theta = torch.randn(6, 2, generator=g)
    close(post.log_prob(theta, x=torch.zeros(2)), target_potential(theta))


def test_nre_posterior_routes():
    """``build_posterior(sample_with=...)`` and the typed parameters of
    kind "nre": MCMC, rejection and importance over the ratio potential;
    VI raises."""
    _, te, theta, x = pair("mlp")
    prior = MultivariateNormal(torch.zeros(THETA_DIM), covariance_matrix=torch.eye(THETA_DIM),
                               device="cpu")
    trainer = NRE_B(prior=prior, device="cpu")
    trainer._neural_net = te
    routes = ((dict(), MCMCPosterior),
              (dict(sample_with="rejection", rejection_sampling_parameters=dict(m=1.5)),
               RejectionPosterior),
              (dict(sample_with="importance", importance_sampling_parameters=dict(method="importance")),
               ImportanceSamplingPosterior),
              (dict(posterior_parameters=MCMCPosteriorParameters(num_chains=3)), MCMCPosterior),
              (dict(posterior_parameters=RejectionPosteriorParameters(m=1.5)), RejectionPosterior),
              (dict(posterior_parameters=ImportanceSamplingPosteriorParameters(method="importance")),
               ImportanceSamplingPosterior))
    for kwargs, cls in routes:
        post = trainer.build_posterior(**kwargs)
        assert isinstance(post, cls), kwargs
        assert isinstance(post.potential_fn, RatioBasedPotential) and post.proposal is prior
        assert post.potential_fn.ratio_estimator is not te  # a frozen copy
        if cls is RejectionPosterior:
            assert post.m == 1.5
        if cls is ImportanceSamplingPosterior:
            assert post.method == "importance"
        with torch.no_grad():
            close(post.log_prob(theta[:4], x=x[:1]),
                  te.log_ratio(torch.tensor(theta[:4]), torch.tensor(x[:1]).expand(4, -1))
                  + prior.log_prob(torch.tensor(theta[:4])))
    assert trainer.build_posterior(posterior_parameters=MCMCPosteriorParameters(num_chains=3)
                                   ).num_chains == 3
    direct = build_posterior_from_parameters(MCMCPosteriorParameters(), te, prior, kind="nre")
    assert isinstance(direct.potential_fn, RatioBasedPotential)
    for kwargs in (dict(sample_with="vi"), dict(posterior_parameters=VIPosteriorParameters())):
        vi = trainer.build_posterior(**kwargs)
        assert isinstance(vi, VIPosterior) and isinstance(vi.potential_fn, RatioBasedPotential)
    with pytest.raises(ValueError, match="Cannot combine"):
        trainer.build_posterior(posterior_parameters=MCMCPosteriorParameters(),
                                mcmc_parameters=dict(num_chains=2))
    samples = trainer.build_posterior(sample_with="importance").sample(
        (20,), x=x[:1], generator=torch.Generator().manual_seed(0))
    assert samples.shape == (20, THETA_DIM) and bool(torch.isfinite(samples).all())
