"""sbi_tpu_torch's ODE and SDE samplers, the vector-field potential and
``VectorFieldPosterior.log_prob`` against sbi_tpu's, on the CPU.

Tolerances:

- ``odeint_rk4`` samples from the same z0 (64 RK4 steps through an FMPE
  and an NPSE-VP estimator on the JAX package's weights): 1e-4 absolute
  plus 5e-4 relative, float32 rounding compounded over 256 net
  evaluations. FMPE's samples are of order 1 and agree within 2e-6; the
  random VP net's reverse flow grows the noise to order 1,000 (its score
  does not cancel the drift -beta z / 2), where the two read 1.4e-4
  apart relatively.
- ``log_prob`` (64 RK4 steps of the state and the exact divergence): 1e-3
  absolute plus 1e-4 relative.
- one Euler-Maruyama step on the same noise: 1e-5 relative plus 1e-5
  absolute (the score at small t is O(100)).
- the Hutchinson divergence: its mean over 600 probes within 4 standard
  errors of the exact one.
- the reverse SDE on an analytic Gaussian score (no net), the grid of
  ``tests/test_score_samplers_deep.py``: moments within its 0.1 (0.12 for
  the target grid's standard deviations), 4,000 draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sbi_tpu.inference.posteriors.vector_field_posterior import (
    VectorFieldPosterior as JaxVectorFieldPosterior,
)
from sbi_tpu.samplers.ode.ode_solvers import build_neural_ode as jax_build_neural_ode
from sbi_tpu.samplers.ode.ode_solvers import odeint_rk4 as jax_odeint_rk4
from sbi_tpu.samplers.score.diffuser import euler_maruyama_predictor as jax_em
from sbi_tpu.utils.distributions import MultivariateNormal as JaxMVN
from sbi_tpu_torch.inference import VectorFieldPosterior, vector_field_estimator_based_potential
from sbi_tpu_torch.neural_nets.estimators.score_estimator import (
    SubVPScoreEstimator,
    VEScoreEstimator,
    VPScoreEstimator,
)
from sbi_tpu_torch.samplers.ode import build_neural_ode, odeint_rk4, odeint_with_logdet
from sbi_tpu_torch.samplers.score import CORRECTORS, Diffuser, euler_maruyama_predictor
from sbi_tpu_torch.utils import MultivariateNormal

from .test_torch_vf_nets import close, vf_pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

SAMPLE_ATOL, SAMPLE_RTOL = 1e-4, 5e-4
LP_ATOL, LP_RTOL = 1e-3, 1e-4
STEP_RTOL, STEP_ATOL = 1e-5, 1e-5
N = 4000


@pytest.fixture(scope="module", params=["fm", "vp"])
def pair(request):
    return vf_pair(request.param, net="mlp", hidden=16, seed=3)


def test_odeint_rk4_samples(pair):
    """The same z0 through 64 RK4 steps of the probability-flow ODE, noise
    to data, then the inverse z-scoring."""
    je, te, theta, x = pair
    x_o = x[:1]
    z0 = (np.random.default_rng(0).standard_normal((50, 2)) * 1.2).astype(np.float32)
    jnode = jax_build_neural_ode(je, jnp.asarray(x_o), num_steps=64)
    want = je.input_transform.inverse(
        jax_odeint_rk4(jnode.ode_fn, jnp.asarray(z0), jnode.t_noise, jnode.t_data, 64))
    node = build_neural_ode(te, torch.tensor(x_o), num_steps=64)
    assert (node.t_noise, node.t_data) == (jnode.t_noise, jnode.t_data)
    assert node.noise_std == pytest.approx(float(jnode.noise_std), rel=1e-6)
    with torch.no_grad():
        got = te.input_transform.inverse(
            odeint_rk4(node.ode_fn, torch.tensor(z0), node.t_noise, node.t_data, 64))
    close(got, want, SAMPLE_RTOL, SAMPLE_ATOL)


def test_log_prob(pair):
    """``VectorFieldPosterior.log_prob`` (64 RK4 steps, exact divergence)
    on the same theta and x, -inf outside the prior's support (none here:
    a Gaussian prior)."""
    je, te, theta, x = pair
    jprior = JaxMVN(jnp.zeros(2), covariance_matrix=jnp.eye(2) * 4.0)
    prior = MultivariateNormal(torch.zeros(2), covariance_matrix=torch.eye(2) * 4.0, device="cpu")
    thetas = theta[:12]
    want = JaxVectorFieldPosterior(je, jprior).log_prob(jnp.asarray(thetas), x=jnp.asarray(x[:1]))
    post = VectorFieldPosterior(te, prior)
    got = post.log_prob(torch.tensor(thetas), x=torch.tensor(x[:1]))
    close(got, want, LP_RTOL, LP_ATOL)
    # the potential gives the same, with gradients on request
    potential, _ = vector_field_estimator_based_potential(te, prior, torch.tensor(x[:1]))
    close(potential(torch.tensor(thetas), track_gradients=False), got, 1e-6, 1e-6)


def test_hutchinson_divergence(pair):
    """The Hutchinson estimate (a probe per row) averages to the exact
    divergence."""
    _, te, theta, x = pair
    node = build_neural_ode(te, torch.tensor(x[:1]), num_steps=8)
    z1 = te.input_transform.forward(torch.tensor(theta[:1])).expand(600, 2)
    with torch.no_grad():
        _, exact = odeint_with_logdet(node.ode_fn, z1[:1], node.t_data, node.t_noise, 8)
        _, hutch = odeint_with_logdet(node.ode_fn, z1, node.t_data, node.t_noise, 8, exact=False,
                                      generator=torch.Generator().manual_seed(0))
    se = float(hutch.std()) / math.sqrt(len(hutch))
    assert abs(float(hutch.mean()) - float(exact[0])) < 4 * se + 1e-4


@pytest.mark.parametrize("sde", ["vp", "subvp", "ve"])
def test_euler_maruyama_step(sde):
    """One reverse-SDE step on the same noise: the port's step less its
    noise term equals the JAX package's less its own."""
    je, te, theta, x = vf_pair(sde, seed=4)
    n, t0, t1 = 20, 0.6, 0.55
    z = np.random.default_rng(8).standard_normal((n, 2)).astype(np.float32)
    cz = je.condition_transform.forward(jnp.asarray(x[:n]))
    key = jax.random.PRNGKey(5)
    want = jax_em(je, je.params, jnp.asarray(z), cz, jnp.float32(t0), jnp.float32(t1), key)
    want = want - je.diffusion_fn(None, jnp.full((n,), t0)) * math.sqrt(t0 - t1) * \
        jax.random.normal(key, (n, 2))
    g = torch.Generator().manual_seed(3)
    eps = torch.randn(n, 2, generator=torch.Generator().manual_seed(3))
    c = te.embed_condition(te._embed_condition(torch.tensor(x[:n])))
    with torch.no_grad():
        got = euler_maruyama_predictor(te, torch.tensor(z), c, t0, t1, g)
        got = got - te.diffusion_fn(None, torch.full((n,), t0)) * math.sqrt(t0 - t1) * eps
    close(got, want, STEP_RTOL, STEP_ATOL)


# ---------------------------------------------------------------------------
# The samplers on an analytic score
# ---------------------------------------------------------------------------


class AnalyticGaussianNet(nn.Module):
    """eps_hat for the diffused marginal of a target N(mu, std^2 I): under
    each SDE the marginal is N(m_t mu, m_t^2 std^2 + s_t^2), so the score is
    -(z - m_t mu) / var and eps_hat = -score s_t. With ``mu=None`` the
    target's mean is the condition's first entry, row by row."""

    def __init__(self, holder, mu, std):
        super().__init__()
        self.holder, self.mu, self.std = holder, mu, std
        self.dummy = nn.Parameter(torch.zeros(1))  # places the estimator on the CPU

    def embed(self, condition):
        return condition.reshape(condition.shape[0], -1)

    def field(self, z, c, t):
        est = self.holder[0]
        m_t, s_t = est.mean_t_fn(t)[:, None], est.std_fn(t)[:, None]
        mu = c[:, :1].expand(z.shape[0], 1) if self.mu is None else self.mu
        var = m_t**2 * self.std**2 + s_t**2
        return (z - m_t * mu) / var * s_t

    def forward(self, z, condition, t):
        return self.field(z, self.embed(condition), t)


SDES = {"vp": VPScoreEstimator, "subvp": SubVPScoreEstimator, "ve": VEScoreEstimator}


def analytic_estimator(sde, mu, std, dim=2):
    holder = []
    est = SDES[sde](AnalyticGaussianNet(holder, mu, std), input_shape=(dim,), condition_shape=(1,))
    holder.append(est)
    return est


@pytest.mark.parametrize("sde", ["vp", "subvp", "ve"])
@pytest.mark.parametrize("corrector", [None, "langevin", "gibbs"])
def test_gaussian_score_sampling_grid(sde, corrector):
    mu, std = 1.0, 0.5
    diffuser = Diffuser(analytic_estimator(sde, mu, std), corrector=corrector)
    s = diffuser.run(N, torch.zeros(1, 1), steps=400, generator=torch.Generator().manual_seed(0))
    assert s.shape == (N, 1, 2)
    s = s[:, 0]
    assert bool(torch.isfinite(s).all())
    np.testing.assert_allclose(s.mean(0).numpy(), mu, atol=0.1, err_msg=f"{sde} {corrector}")
    np.testing.assert_allclose(s.std(0).numpy(), std, atol=0.1, err_msg=f"{sde} {corrector}")


@pytest.mark.parametrize("mu,std", [(-1.0, 1.0), (0.0, 0.1), (2.0, 0.3)])
def test_gaussian_score_sampling_target_moments(mu, std):
    diffuser = Diffuser(analytic_estimator("vp", mu, std), corrector="langevin")
    s = diffuser.run(N, torch.zeros(1, 1), steps=400, generator=torch.Generator().manual_seed(1))
    s = s[:, 0]
    np.testing.assert_allclose(s.mean(0).numpy(), mu, atol=max(0.1, 0.1 * abs(mu)))
    np.testing.assert_allclose(s.std(0).numpy(), std, atol=0.12)


def test_batched_observations_order():
    """B observations in one run: column b of the (S, B, D) output follows
    observation b (the condition is repeated observation-major)."""
    est = analytic_estimator("vp", None, 0.2)
    xs = torch.tensor([[-2.0], [0.5], [3.0]])
    s = Diffuser(est).run(1000, xs, steps=200, generator=torch.Generator().manual_seed(2))
    assert s.shape == (1000, 3, 2)
    np.testing.assert_allclose(s.mean(0).numpy(), xs.expand(3, 2).numpy(), atol=0.05)


def test_corrector_signatures_and_schedule():
    """A corrector that declares ``t_prev`` or ``**kwargs`` gets the
    predictor's start time; one with neither keeps working; a custom
    ``ts`` is followed; ``score_fn`` comes with a later slice."""
    est = analytic_estimator("ve", 0.0, 1.0)
    seen = []

    def old_style(estimator, z, condition, t, generator):
        seen.append(("old", t))
        return z

    def new_style(estimator, z, condition, t, generator, **kwargs):
        seen.append(("new", t, kwargs.get("t_prev")))
        return z

    ts = [1.0, 0.5, 0.01]
    Diffuser(est, corrector=old_style).run(4, torch.zeros(1, 1), ts=ts)
    Diffuser(est, corrector=new_style).run(4, torch.zeros(1, 1), ts=ts)
    assert seen == [("old", 0.5), ("old", 0.009999999776482582),
                    ("new", 0.5, 1.0), ("new", 0.009999999776482582, 0.5)]
    assert set(CORRECTORS) >= {"langevin", "gibbs"}
    with pytest.raises(NotImplementedError, match="later slice"):
        Diffuser(est).run(4, torch.zeros(1, 1), score_fn=lambda z, t: z)
