"""sbi_tpu_torch's NLE against sbi_tpu's, on the CPU.

The likelihood estimators are the small flows of test_torch_flows.py
(hidden 16, 2 transforms) with the JAX package's perturbed weights,
bridged: a 2-D x through autoregressive splines and a 5-D x through
couplings, each conditioned on a 3-D theta. Inputs are numpy arrays made
from a seed. Tolerances:

- the likelihood potential (one x, T = 3 iid trials, ``batched_over_x``,
  ``condition_on_theta``): 1e-4 absolute, the flows' log-prob tolerance,
  and -inf at the same places (theta outside the prior box).
- the NLE loss: 1e-4 absolute; its gradients 1e-4 absolute plus 1e-3
  relative per parameter element, as test_torch_npe.py holds NPE's (the
  reasons are stated there).
- SLCP's exact likelihood: 1e-4 relative. The port writes the 2 x 2
  Cholesky factor out; the log-likelihood reaches |lp| ~ 1e5 where a scale
  parameter is near 0, so the float32 results differ by ~1e-5 relative.
- the port's NLE end to end (a tiny likelihood, a few epochs, a few MCMC
  chains): shapes, finite losses and samples inside the prior.
"""

import copy
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference import NLE as JaxNLE
from sbi_tpu.inference.potentials.likelihood_based_potential import (
    LikelihoodBasedPotential as JaxLikelihoodBasedPotential,
)
from sbi_tpu.simulators.tasks import slcp_log_likelihood as jax_slcp_log_likelihood
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu_torch.inference import (
    NLE,
    ImportanceSamplingPosterior,
    NPE,
    SNL,
    LikelihoodBasedPotential,
    MCMCPosterior,
    RejectionPosterior,
    VIPosterior,
    VIPosteriorParameters,
    infer,
    likelihood_estimator_based_potential,
    simulate_for_sbi,
)
from sbi_tpu_torch.inference.potentials.likelihood_based_potential import (
    mixed_likelihood_estimator_based_potential,
)
from sbi_tpu_torch.neural_nets import likelihood_nn, posterior_nn
from sbi_tpu_torch.simulators import get_task, slcp_log_likelihood, two_moons_simulator
from sbi_tpu_torch.utils import BoxUniform

from .test_torch_flows import make_pair
from .test_torch_npe import _assert_grads_match, _maf_pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
LOSS_ATOL = 1e-4
THETA_DIM = 3
BOX = 4.0


def _x_dim(kind):
    return 3 if kind == "maf3" else int(kind[-1])


def _pair(kind):
    """(jax estimator, a private copy of the port's, x rows, theta rows) of
    a likelihood p(x | theta): the flows' input is x, their condition
    theta."""
    je, te, inputs, conditions = _maf_pair() if kind == "maf3" else make_pair(_x_dim(kind))
    return je, copy.deepcopy(te), inputs, conditions


@functools.lru_cache(maxsize=None)
def _jax_nle_loss_grad(kind):
    """The JAX NLE trainer's loss (its ``_ensemble_loss_fn``, the same
    closure as ``train``'s) as one jitted value_and_grad."""
    je = _maf_pair()[0] if kind == "maf3" else make_pair(_x_dim(kind))[0]
    jtr = JaxNLE(prior=None)
    jtr._neural_net = je
    loss = jtr._ensemble_loss_fn()
    return jax.jit(jax.value_and_grad(
        lambda p, theta_b, x_b, masks_b: loss(p, None, theta_b, x_b, masks_b).mean()))


def _priors():
    lo, hi = -BOX * np.ones(THETA_DIM, np.float32), BOX * np.ones(THETA_DIM, np.float32)
    return JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)), BoxUniform(lo, hi, device="cpu")


def _assert_potentials_match(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["nsf2", "nsf5"])
def test_likelihood_potential_matches_jax(kind):
    """The JAX package compiles its flow once per input shape, so the cases
    share two: one x and ``batched_over_x`` score 60 rows, the T = 3 iid
    trials and ``condition_on_theta`` 3 x 20."""
    je, te, x, _ = _pair(kind)
    jprior, prior = _priors()
    rng = np.random.default_rng(1)
    theta = rng.uniform(-3, 3, size=(60, THETA_DIM)).astype(np.float32)
    theta[:2] = 5.0  # outside the prior box
    potential = LikelihoodBasedPotential(te, prior)
    for x_o, th in ((x[:1], theta), (x[1:4], theta[:20])):  # one x, and T = 3 iid trials
        jpot = JaxLikelihoodBasedPotential(je, jprior, x_o=jnp.asarray(x_o))
        potential.set_x(x_o, x_is_iid=True)
        _assert_potentials_match(potential(torch.tensor(th)), jpot(jnp.asarray(th)))

    # batched_over_x: chain i of 12 x 5 against observation i // 5.
    xs = x[4:16]
    want = jpot.batched_over_x(jnp.asarray(xs), 5)(jnp.asarray(theta))
    _assert_potentials_match(potential.batched_over_x(xs, 5)(torch.tensor(theta)), want)

    # condition_on_theta: global dims 0 and 2, one local parameter per trial.
    local = rng.normal(size=(3, 1)).astype(np.float32)
    th = theta[:20, :2]
    want = jpot.condition_on_theta(jnp.asarray(local), [0, 2])(jnp.asarray(th))
    got = potential.condition_on_theta(local, [0, 2])(torch.tensor(th))
    assert got.shape == (20,)
    _assert_potentials_match(got, want)


def test_likelihood_potential_factory():
    _, te, x, _ = _pair("nsf2")
    _, prior = _priors()
    potential, transform = likelihood_estimator_based_potential(te, prior, x[:1])
    assert isinstance(potential, LikelihoodBasedPotential) and potential.allow_iid_x
    assert potential.device == torch.device("cpu")
    assert torch.equal(potential.x_o, torch.tensor(x[:1]))
    u = transform.forward(torch.zeros(2, THETA_DIM))
    np.testing.assert_allclose(u.numpy(), 0.0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="later slice"):
        mixed_likelihood_estimator_based_potential(te, prior, x[:1])


@pytest.mark.parametrize("kind", ["nsf2", "nsf5", "maf3"])
def test_nle_loss_and_gradients_match_jax(kind):
    je, te, x, theta = _pair(kind)
    th, xs, masks = theta[:64], x[:64], np.ones(64, np.float32)
    val, grads = _jax_nle_loss_grad(kind)(je.params, *map(jnp.asarray, (th, xs, masks)))
    trainer = NLE(prior=None, device="cpu")
    trainer._neural_net = te
    loss = trainer._loss_fn()(torch.tensor(th), torch.tensor(xs), torch.tensor(masks), None).mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(val)) <= LOSS_ATOL
    _assert_grads_match(te, grads)


def test_slcp_log_likelihood_matches_jax():
    rng = np.random.default_rng(0)
    theta = rng.uniform(-3, 3, size=(300, 5)).astype(np.float32)
    x_o = rng.normal(size=8).astype(np.float32)
    want = np.asarray(jax_slcp_log_likelihood(jnp.asarray(theta), jnp.asarray(x_o)))
    got = slcp_log_likelihood(torch.tensor(theta), x_o)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert slcp_log_likelihood(torch.tensor(theta).reshape(10, 30, 5), x_o).shape == (10, 30)
    assert get_task("slcp", device="cpu").log_likelihood is slcp_log_likelihood


@pytest.mark.parametrize("model", ["default_maf", "nsf"])
def test_tiny_nle_trains_and_samples(model):
    task = get_task("two_moons", device="cpu")
    g = torch.Generator().manual_seed(0)
    theta, x = simulate_for_sbi(task.simulator, task.prior, 1000, generator=g)
    if model == "default_maf":
        trainer = NLE(prior=task.prior, device="cpu")
    else:
        trainer = SNL(prior=task.prior, device="cpu", density_estimator=likelihood_nn(
            "nsf", hidden_features=8, num_transforms=2, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        trainer.append_simulations(theta, x).train(max_num_epochs=3, generator=g)
    first = type(trainer._neural_net.net.layers[0]).__name__
    assert first == ("MaskedAffineAutoregressive" if model == "default_maf" else "MaskedRQSAutoregressive")
    losses = trainer.summary["training_loss"] + trainer.summary["validation_loss"]
    assert len(losses) == 6 and np.isfinite(losses).all()
    posterior = trainer.build_posterior(mcmc_parameters=dict(num_chains=10, warmup_steps=20))
    assert isinstance(posterior, MCMCPosterior)
    samples = posterior.sample((40,), x=x[:1], generator=g)
    assert samples.shape == (40, 2) and bool(torch.isfinite(samples).all())
    assert bool(task.prior.within_support(samples).all())
    batched = posterior.sample_batched((15,), x=x[:3], generator=g)
    assert batched.shape == (15, 3, 2)
    assert bool(task.prior.within_support(batched.reshape(-1, 2)).all())
    for option in (dict(sample_with="vi"), dict(posterior_parameters=VIPosteriorParameters())):
        assert isinstance(trainer.build_posterior(**option), VIPosterior)
    for sample_with, cls in (("rejection", RejectionPosterior),
                             ("importance", ImportanceSamplingPosterior)):
        assert isinstance(trainer.build_posterior(sample_with=sample_with), cls)


def test_append_simulations_keeps_invalid_x():
    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    theta = torch.zeros(10, 2)
    x = torch.zeros(10, 2)
    x[3, 0] = float("nan")
    trainer = NLE(prior=prior, device="cpu")
    with pytest.warns(UserWarning, match="not exact for NLE"):
        trainer.append_simulations(theta, x)
    assert trainer.get_simulations()[1].shape == (10, 2)
    with pytest.warns(UserWarning):
        trainer.append_simulations(theta, x, exclude_invalid_x=True)
    assert trainer.get_simulations()[1].shape == (19, 2)


def test_infer_nle_and_npe_mcmc_on_cpu():
    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    small = likelihood_nn("nsf", hidden_features=8, num_transforms=1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        posterior = infer(two_moons_simulator, prior, "NLE", 200,
                          init_kwargs=dict(device="cpu", density_estimator=small),
                          train_kwargs=dict(max_num_epochs=1),
                          build_posterior_kwargs=dict(
                              mcmc_parameters=dict(num_chains=5, warmup_steps=5)))
    assert isinstance(posterior, MCMCPosterior)
    assert posterior.sample((10,), x=np.zeros(2, np.float32)).shape == (10, 2)

    theta, x = simulate_for_sbi(two_moons_simulator, prior, 200)
    npe = NPE(prior=prior, device="cpu", density_estimator=posterior_nn(
        "nsf", hidden_features=8, num_transforms=1, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        npe.append_simulations(theta, x).train(max_num_epochs=1)
    mcmc = npe.build_posterior(sample_with="mcmc", mcmc_method="slice_np_vectorized",
                               mcmc_parameters=dict(num_chains=5, warmup_steps=5))
    assert isinstance(mcmc, MCMCPosterior)
    samples = mcmc.sample((10,), x=x[0])
    assert samples.shape == (10, 2) and bool(prior.within_support(samples).all())
    assert isinstance(npe.build_posterior(sample_with="vi"), VIPosterior)
