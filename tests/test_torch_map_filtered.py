"""sbi_tpu_torch's MAP (gradient ascent) and FilteredDirectPosterior against
sbi_tpu's, on the CPU.

- ``gradient_ascent`` from the same inits as the JAX package's, 200
  iterations: on tests/test_mcmc.py's analytic Gaussian, and on the
  posterior potential of a bridged NSF (3-D theta, its box prior's logit
  transform), the argmax within 1e-4 absolute and the max within 1e-4
  absolute plus 1e-5 relative. Adam is optax's (betas 0.9 / 0.999, eps
  1e-8 outside the square root, bias-corrected) in both.
- ``map`` on a direct posterior (the potential at its MAP at least that
  of every init), an MCMC posterior and a VI posterior (the mode within
  0.05 and 0.25: tests/test_vi_deep.py::test_vi_map's bar), and its cache.
- ``FilteredDirectPosterior``'s filter against the JAX package's on the
  same raw draws and log-probs (both estimators' draws and log-probs
  replaced by fixed arrays): the same rows kept, in order. End to end on
  a bridged NSF: the count, the support, and a quantile of 0 sampling as
  ``DirectPosterior``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference.posteriors.filtered_direct_posterior import (
    FilteredDirectPosterior as JaxFilteredDirectPosterior,
)
from sbi_tpu.inference.potentials.posterior_based_potential import (
    PosteriorBasedPotential as JaxPosteriorBasedPotential,
)
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu.utils.sbiutils import gradient_ascent as jax_gradient_ascent
from sbi_tpu.utils.transforms import mcmc_transform as jax_mcmc_transform
from sbi_tpu_torch.inference import (
    DirectPosterior,
    FilteredDirectPosterior,
    MCMCPosterior,
    VIPosterior,
)
from sbi_tpu_torch.inference.potentials.base_potential import CustomPotentialWrapper
from sbi_tpu_torch.inference.potentials.posterior_based_potential import PosteriorBasedPotential
from sbi_tpu_torch.utils import (
    BoxUniform,
    MultivariateNormal,
    gradient_ascent,
    mcmc_transform,
    seed_all_backends,
)

from .test_torch_flows import make_pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
COV = np.array([[1.0, 0.5], [0.5, 2.0]], np.float32)
MEAN = np.array([1.0, -2.0], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)
BOX = 3.0


def _gauss(xp):
    prec, mean = xp.asarray(PREC), xp.asarray(MEAN)
    return lambda th: -0.5 * (((th - mean) @ prec) * (th - mean)).sum(-1)


def _nsf_posterior_potentials():
    """(JAX, port) posterior potentials of a bridged NSF over a 3-D theta
    at one x_o, with a box prior, and its logit transforms."""
    je, te, theta, x = make_pair(3, x_dim=3)
    lo, hi = -BOX * np.ones(3, np.float32), BOX * np.ones(3, np.float32)
    jprior, tprior = JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)), BoxUniform(lo, hi, device="cpu")
    jpot = JaxPosteriorBasedPotential(je, jprior, x_o=jnp.asarray(x[:1]))
    tpot = PosteriorBasedPotential(te, tprior, x_o=x[:1])
    return (jpot, jax_mcmc_transform(jprior)), (tpot, mcmc_transform(tprior)), theta


@pytest.mark.parametrize("target", ["gaussian", "nsf_posterior"])
def test_gradient_ascent_matches_jax(target):
    rng = np.random.default_rng(0)
    if target == "gaussian":
        (jpot, jtf), (tpot, ttf) = (_gauss(jnp), None), (_gauss(torch), None)
        inits = rng.normal(size=(40, 2)).astype(np.float32) * 2.0
    else:
        (jpot, jtf), (tpot, ttf), theta = _nsf_posterior_potentials()
        inits = np.clip(theta[:40], -BOX + 0.5, BOX - 0.5)
    kwargs = dict(num_iter=200, num_to_optimize=8, learning_rate=0.01)
    want_theta, want_val = jax_gradient_ascent(lambda t: jpot(t), jnp.asarray(inits), jtf, **kwargs)
    got_theta, got_val = gradient_ascent(tpot, torch.tensor(inits), ttf, **kwargs)
    np.testing.assert_allclose(got_theta.numpy(), np.asarray(want_theta), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(got_val), float(want_val), atol=ATOL, rtol=1e-5)
    start = float(tpot(torch.tensor(inits)).max())
    assert float(got_val) > start + 1e-3  # the ascent climbed


def test_map_of_direct_mcmc_and_vi_posteriors():
    _, te, _, x = make_pair(3, x_dim=3)
    prior = BoxUniform(-BOX * np.ones(3), BOX * np.ones(3), device="cpu")
    g = torch.Generator().manual_seed(0)
    direct = DirectPosterior(te, prior)
    theta_map = direct.map(x=x[:1], num_iter=100, num_init_samples=200, num_to_optimize=10,
                           generator=g)
    inits = direct.sample((200,), x=x[:1], generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        best_init = float(direct.potential(inits, x=x[:1]).max())
        assert float(direct.potential(theta_map, x=x[:1])) >= best_init - 1e-4
    assert direct._map is None  # a map at a given x is not cached

    gauss_prior = MultivariateNormal(torch.zeros(2), covariance_matrix=9.0 * torch.eye(2),
                                     device="cpu")
    pot = CustomPotentialWrapper(lambda theta: _gauss(torch)(theta), prior=gauss_prior,
                                 device="cpu")
    mcmc = MCMCPosterior(pot, proposal=gauss_prior, num_chains=4, warmup_steps=5, device="cpu")
    m = mcmc.map(num_iter=300, init_method="proposal", num_init_samples=100, learning_rate=0.05,
                 generator=g)
    np.testing.assert_allclose(m.numpy(), MEAN, atol=0.05)
    assert mcmc.map() is m  # cached without x
    assert mcmc.map(force_update=True, init_method=torch.tensor(MEAN)[None] + 0.5) is not m

    seed_all_backends(0)  # q's initial weights come from the global CPU generator
    vi = VIPosterior(pot, prior=gauss_prior, q="gaussian", device="cpu")
    vi.train(max_num_iters=200, learning_rate=2e-3, generator=torch.Generator().manual_seed(0))
    m = vi.map(num_iter=200, num_init_samples=200, generator=g)
    np.testing.assert_allclose(m.numpy(), MEAN, atol=0.25)
    with pytest.raises(ValueError, match="init_method"):
        vi.map(force_update=True, init_method="other")


def test_filter_matches_jax_on_the_same_draws():
    je, te, _, x = make_pair(2, x_dim=3)
    lo, hi = -2.5 * np.ones(2, np.float32), 2.5 * np.ones(2, np.float32)
    quantile, num = 0.3, 100
    n_raw = int(np.ceil(np.float32(num * (1.0 / (1.0 - quantile)) * 1.5)))
    rng = np.random.default_rng(1)
    raw = (1.2 * rng.normal(size=(n_raw, 2))).astype(np.float32)
    lp = rng.normal(size=n_raw).astype(np.float32)

    je = copy.copy(je)
    je.sample_fn = lambda params, key, shape, xx: jnp.asarray(raw)[:shape[0], None, :]
    je.log_prob_fn = lambda params, theta, xx: jnp.asarray(lp)[:, None]
    jpost = JaxFilteredDirectPosterior(je, JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)),
                                       filter_quantile=quantile)
    want = np.asarray(jpost.sample((num,), x=jnp.asarray(x[:1]), key=jax.random.PRNGKey(0)))

    te = copy.copy(te)
    te.sample = lambda shape, xx, generator=None: torch.tensor(raw)[:shape[0], None, :]
    te.log_prob = lambda theta, xx: torch.tensor(lp)[:, None]
    tpost = FilteredDirectPosterior(te, BoxUniform(lo, hi, device="cpu"), filter_quantile=quantile)
    got = tpost.sample((num,), x=x[:1]).numpy()
    kept = (lp >= np.quantile(lp, quantile)) & (np.abs(raw) < 2.5).all(1)
    assert kept.sum() >= num  # no shortfall: the filter alone decides
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, raw[kept][:num])


def test_filtered_posterior_end_to_end():
    _, te, _, x = make_pair(2, x_dim=3)
    prior = BoxUniform(-3 * np.ones(2), 3 * np.ones(2), device="cpu")
    post = FilteredDirectPosterior(te, prior, filter_quantile=0.2)
    samples = post.sample((7, 30), x=x[:1], generator=torch.Generator().manual_seed(0))
    assert samples.shape == (7, 30, 2) and bool(prior.within_support(samples.reshape(-1, 2)).all())
    plain = FilteredDirectPosterior(te, prior, filter_quantile=0.0)
    want = DirectPosterior(te, prior).sample((50,), x=x[:1], generator=torch.Generator().manual_seed(1))
    got = plain.sample((50,), x=x[:1], generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
