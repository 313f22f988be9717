"""The port's NRE end to end on the CPU: a small NRE-B run scored by C2ST,
its MCMC, rejection and importance posteriors, two rounds, and vmapped
ensembles of all four NRE classes.

The task is the 2-D linear Gaussian of ``tests/test_nle_nre.py`` (shift
-1, covariance 0.3 I, prior N(0, I)) at 1,000 simulations, batch 100, at
most 60 epochs; 1,000 draws at x_o = 0 against 1,000 of the analytic
posterior. Bars:

- C2ST (``c2st_torch``) at most 0.65: three seeds read 0.49-0.58 on the
  CPU for MCMC (50 chains, warmup 50). The JAX package's slow test holds
  0.6 at 2,500 simulations;
- rejection and SIR draws from the same ratio: the same bar;
- ensembles (2 members, at most 10 epochs): finite losses, members that
  differ, finite mixture draws, and the stacked (one-vmap) potential
  equal to the member-by-member one within 1e-5.
"""

import warnings

import numpy as np
import pytest
import torch

from sbi_tpu_torch.inference import (
    BNRE,
    NRE_A,
    NRE_B,
    NRE_C,
    SNRE_B,
    ImportanceSamplingPosterior,
    MCMCPosterior,
    RejectionPosterior,
    infer,
)
from sbi_tpu_torch.inference.posteriors.ensemble_posterior import EnsemblePosterior
from sbi_tpu_torch.simulators.linear_gaussian import (
    linear_gaussian,
    true_posterior_linear_gaussian_mvn_prior,
)
from sbi_tpu_torch.utils import MultivariateNormal, c2st_torch

from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

C2ST_MAX = 0.65
NUM_SIMS, BATCH, MAX_EPOCHS, DRAWS = 1_000, 100, 60, 1_000
SHIFT, LIK_VAR = -1.0, 0.3


def _simulator(theta, generator=None):
    return linear_gaussian(theta, SHIFT * torch.ones(2), LIK_VAR * torch.eye(2), generator=generator)


@pytest.fixture(scope="module")
def lg():
    g = torch.Generator().manual_seed(0)
    prior = MultivariateNormal(torch.zeros(2), covariance_matrix=torch.eye(2), device="cpu")
    theta = prior.sample((NUM_SIMS,), generator=g)
    x_o = torch.zeros(1, 2)
    truth = true_posterior_linear_gaussian_mvn_prior(
        x_o, SHIFT * torch.ones(2), LIK_VAR * torch.eye(2), torch.zeros(2), torch.eye(2))
    return prior, theta, _simulator(theta, g), x_o, truth.sample((DRAWS,), generator=g)


@pytest.fixture(scope="module")
def trained(lg):
    prior, theta, x, _, _ = lg
    inference = NRE_B(prior=prior, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        inference.append_simulations(theta, x).train(
            training_batch_size=BATCH, max_num_epochs=MAX_EPOCHS,
            generator=torch.Generator().manual_seed(0))
    return inference


def test_nre_b_trains_and_mcmc_matches_the_posterior(lg, trained):
    _, _, _, x_o, ref = lg
    losses = trained.summary["training_loss"] + trained.summary["validation_loss"]
    assert np.isfinite(losses).all()
    assert trained.summary["validation_loss"][-1] < trained.summary["validation_loss"][0]
    posterior = trained.build_posterior(mcmc_parameters=dict(num_chains=50, warmup_steps=50))
    assert isinstance(posterior, MCMCPosterior)
    g = torch.Generator().manual_seed(1)
    samples = posterior.sample((DRAWS,), x=x_o, generator=g)
    assert samples.shape == (DRAWS, 2) and bool(torch.isfinite(samples).all())
    assert float(c2st_torch(samples, ref, generator=g)) <= C2ST_MAX
    # sample_batched runs both observations' chains through batched_over_x.
    xs = torch.tensor([[0.0, 0.0], [1.5, 1.5]])
    batched = posterior.sample_batched((200,), x=xs, generator=g, num_chains=50)
    assert batched.shape == (200, 2, 2) and bool(torch.isfinite(batched).all())
    assert float((batched[:, 1].mean(0) - batched[:, 0].mean(0)).min()) > 0.6  # mean 1.5 / 1.3


@pytest.mark.parametrize("sample_with, cls", [("rejection", RejectionPosterior),
                                              ("importance", ImportanceSamplingPosterior)])
def test_rejection_and_importance_match_the_posterior(lg, trained, sample_with, cls):
    _, _, _, x_o, ref = lg
    posterior = trained.build_posterior(sample_with=sample_with)
    assert isinstance(posterior, cls)
    g = torch.Generator().manual_seed(2)
    samples = posterior.sample((DRAWS,), x=x_o, generator=g)
    assert samples.shape == (DRAWS, 2) and bool(torch.isfinite(samples).all())
    assert float(c2st_torch(samples, ref, generator=g)) <= C2ST_MAX


def test_two_rounds_and_infer(lg, trained):
    """A second round whose proposal is the first posterior at x_o, and
    infer(..., "SNRE_B")."""
    prior, _, _, x_o, _ = lg
    g = torch.Generator().manual_seed(3)
    inference = SNRE_B(prior=prior, classifier="mlp", device="cpu")
    proposal = prior
    for _ in range(2):
        theta = proposal.sample((300,), generator=g)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            inference.append_simulations(theta, _simulator(theta, g), proposal=proposal).train(
                training_batch_size=50, max_num_epochs=5, generator=g)
        proposal = inference.build_posterior(
            mcmc_parameters=dict(num_chains=10, warmup_steps=20)).set_default_x(x_o)
    assert inference._data_round_index == [0, 1] and inference._round == 1
    assert inference._prior_masks[1].sum() == 0
    samples = proposal.sample((50,), generator=g)
    assert samples.shape == (50, 2) and bool(torch.isfinite(samples).all())
    posterior = infer(_simulator, prior, "NRE", 200, init_kwargs=dict(device="cpu"),
                      train_kwargs=dict(max_num_epochs=2), generator=g)
    assert posterior.sample((10,), x=x_o, generator=g, num_chains=5, warmup_steps=5).shape == (10, 2)


@pytest.mark.parametrize("cls", [NRE_A, NRE_B, NRE_C, BNRE])
def test_train_ensemble_nre_family(lg, cls):
    """As tests/test_train_ensemble.py's: members are different functions
    of (theta, x); the mixture posterior samples finite draws through the
    stacked potential, which equals the member-by-member one."""
    prior, theta, x, x_o, _ = lg
    inference = cls(prior=prior, device="cpu")
    inference.append_simulations(theta[:800], x[:800])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        members = inference.train_ensemble(num_members=2, max_num_epochs=10, stop_after_epochs=6,
                                           epoch_chunk=5, generator=torch.Generator().manual_seed(4))
    assert len(members) == 2
    assert np.isfinite(inference.summary["best_validation_loss"][-1])
    with torch.no_grad():
        lr = [m.log_ratio(theta[:8], x[:8]) for m in members]
    assert not torch.allclose(lr[0], lr[1])
    posterior = inference.build_ensemble_posterior(
        mcmc_parameters=dict(num_chains=10, warmup_steps=20))
    assert isinstance(posterior, EnsemblePosterior) and posterior.potential_fn.vmapped
    potential = posterior.potential_fn.set_x(x_o)
    with torch.no_grad():
        stacked = potential.member_potentials(theta[:16])
        one_by_one = torch.stack([p.potential_fn(theta[:16]) for p in posterior.posteriors])
    np.testing.assert_allclose(stacked.numpy(), one_by_one.numpy(), rtol=1e-5, atol=1e-5)
    samples = posterior.sample((50,), x=x_o, generator=torch.Generator().manual_seed(5))
    assert samples.shape == (50, 2) and bool(torch.isfinite(samples).all())


@pytest.mark.parametrize("cls", [NRE_B, NRE_C])
def test_ensemble_members_draw_their_own_atoms(lg, cls, monkeypatch):
    """Every ensemble step and validation draws each member's atoms outside
    the vmapped step: (K, B, M) index tensors whose members differ."""
    prior, theta, x, _, _ = lg
    inference = cls(prior=prior, device="cpu")
    inference.append_simulations(theta[:400], x[:400])
    drawn = []
    draw = inference._ensemble_extra_inputs

    def recording(theta_b, generator, validation):
        atoms = draw(theta_b, generator, validation)
        drawn.append((theta_b.shape[:2], validation, atoms))
        return atoms

    monkeypatch.setattr(inference, "_ensemble_extra_inputs", recording)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inference.train_ensemble(num_members=3, max_num_epochs=1, training_batch_size=90)
    assert [v for _, v, _ in drawn] == [False] * 4 + [True]
    for (K, B), _, atoms in drawn:
        assert len(atoms) == (3 if cls is NRE_C else 1)
        for a in atoms:
            assert a.shape[:2] == (K, B) == (3, a.shape[1])
            assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
        assert atoms[0].shape[-1] == (6 if cls is NRE_C else 10)
