"""sbi_tpu_torch's MDN trainers and posteriors against sbi_tpu's, on the
CPU: the first-round NPE loss on an MDN, NPE-C's non-atomic MoG loss,
NPE-A (the head expansion, the proposal corrections, ``NPE_A_Posterior``),
NPE-B's importance-weighted loss, ``posterior_parameters``, and small
trainings end to end.

The estimators are small MDNs (D = 2, hidden 16, K <= 3) with the JAX
package's weights, perturbed and bridged (``test_torch_mdn.mdn_pair``).
Tolerances:

- losses: 1e-5 relative plus 1e-5 absolute; gradients: 1e-4 absolute plus
  1e-3 relative per parameter element, the NSF trainer's gradient
  tolerance (``test_torch_npe.py``): a mean over the batch of products
  through the MLP, accumulated in another order by XLA and torch.
- the NPE-A corrections (``correct_mog_for_proposal``,
  ``divide_mog_by_proposal_mog``), ``_moment_match`` and
  ``NPE_A_Posterior.log_prob``: 1e-5
  relative plus 5e-5 absolute; both packages call ``solve``, ``slogdet``,
  ``eigvalsh`` and ``cholesky`` on float32 matrices of eigenvalues in about
  [0.5, 5], and the log-partition differences lose a few ulps of terms of
  order 10.
- the head expansion with no jitter: exact.
- end to end, 2-D linear Gaussian with a Gaussian prior: NPE-MDN's C2ST
  against the analytic posterior within 0.5 +/- 0.1, the JAX package's bar
  for this configuration (``tests/test_linear_gaussian_npe.py:26``), scored
  by the port's ``c2st_torch``; a second, non-atomic NPE-C round on the
  same trainer within ``test_npe_c_non_atomic_mog_path``'s 0.5 +/- 0.15.
"""

import copy
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference import NPE_A as JaxNPE_A
from sbi_tpu.inference import NPE_B as JaxNPE_B
from sbi_tpu.inference import NPE_C as JaxNPE_C
from sbi_tpu.inference.posteriors import DirectPosterior as JaxDirectPosterior
from sbi_tpu.inference.posteriors import posterior_parameters as jax_pp
from sbi_tpu.inference.posteriors.npe_a_posterior import NPE_A_Posterior as JaxNPE_A_Posterior
from sbi_tpu.inference.posteriors.npe_a_posterior import correct_mog_for_proposal as jax_correct
from sbi_tpu.inference.posteriors.npe_a_posterior import _moment_match as jax_moment_match
from sbi_tpu.inference.posteriors.npe_a_posterior import divide_mog_by_proposal_mog as jax_divide
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu.utils.distributions import MultivariateNormal as JaxMVN
from sbi_tpu_torch.inference import (
    NLE,
    NPE,
    NPE_A,
    NPE_B,
    NPE_C,
    DirectPosterior,
    DirectPosteriorParameters,
    ImportanceSamplingPosterior,
    MCMCPosterior,
    MCMCPosteriorParameters,
    NPE_A_Posterior,
    RejectionPosterior,
    VectorFieldPosteriorParameters,
    VIPosteriorParameters,
    infer,
)
from sbi_tpu_torch.inference.posteriors import posterior_parameters as torch_pp
from sbi_tpu_torch.inference.posteriors.npe_a_posterior import (
    _GaussSpec,
    _moment_match,
    correct_mog_for_proposal,
    divide_mog_by_proposal_mog,
)
from sbi_tpu_torch.neural_nets import likelihood_nn, posterior_nn
from sbi_tpu_torch.neural_nets.estimators.mdn import MoG
from sbi_tpu_torch.simulators.linear_gaussian import (
    linear_gaussian,
    true_posterior_linear_gaussian_mvn_prior,
)
from sbi_tpu_torch.utils import BoxUniform, MultivariateNormal, c2st_torch
from sbi_tpu_torch.utils.params_bridge import load_flax_params

from .test_torch_mdn import assert_mog_close, mdn_pair, mog_pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
CORR_RTOL, CORR_ATOL = 1e-5, 5e-5
KEY = jax.random.PRNGKey(0)


def _priors(kind, dim=2):
    if kind == "gaussian":
        loc = np.full(dim, 0.2, np.float32)
        cov = (np.eye(dim) * 2.0 + 0.3).astype(np.float32)
        return (JaxMVN(jnp.asarray(loc), covariance_matrix=jnp.asarray(cov)),
                MultivariateNormal(loc, covariance_matrix=cov, device="cpu"))
    lo, hi = np.full(dim, -4.0, np.float32), np.full(dim, 4.0, np.float32)
    return JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)), BoxUniform(lo, hi, device="cpu")


def _pair_copy(**kw):
    je, te, theta, x = mdn_pair(**kw)
    je = copy.copy(je)
    return je, copy.deepcopy(te), theta, x


def _check_loss_and_grads(jtr, ttr, jloss, tloss, theta, x):
    """The JAX loss and its gradients against the port's, on a batch."""
    je, te = jtr._neural_net, ttr._neural_net
    masks = np.ones(len(theta), np.float32)
    batch = tuple(map(jnp.asarray, (theta, x, masks)))
    want, grads = jax.jit(jax.value_and_grad(lambda p: jloss(p, KEY, *batch).mean()))(je.params)
    got = tloss(torch.tensor(theta), torch.tensor(x), torch.tensor(masks), None).mean()
    te.net.zero_grad(set_to_none=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    ref = load_flax_params(copy.deepcopy(te), jax.tree_util.tree_map(np.asarray, grads))
    for (name, p), (_, r) in zip(te.net.named_parameters(), ref.net.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), r.detach().numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def _broadened(je, te, shift=-3.0):
    """Copies of an MDN pair whose precision factors' diagonal head bias is
    lowered by ``-shift``: a broader density, as a proposal is broader than
    the posterior estimated from its draws."""
    nl = te.net.num_layers
    params = jax.tree_util.tree_map(np.asarray, je.params)
    params["params"][f"Dense_{nl + 2}"]["bias"] = params["params"][f"Dense_{nl + 2}"]["bias"] + shift
    jb = copy.copy(je)
    jb.params = jax.tree_util.tree_map(jnp.asarray, params)
    tb = copy.deepcopy(te)
    with torch.no_grad():
        tb.net.diag.bias += shift
    return jb, tb


def _trainers(jcls, tcls, jprior, tprior, je, te):
    jtr = jcls(prior=jprior)
    jtr._neural_net = je
    ttr = tcls(prior=tprior, device="cpu")
    ttr._neural_net = te
    return jtr, ttr


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_first_round_loss_and_gradients_match_jax():
    je, te, theta, x = _pair_copy(dim=2)
    jtr, ttr = _trainers(JaxNPE_C, NPE_C, None, None, je, te)
    _check_loss_and_grads(jtr, ttr, jtr._make_loss_fn(None, None, True),
                          ttr._make_loss_fn(None, None, True), theta[:64], x[:64])


@pytest.mark.parametrize("prior_kind", ["gaussian", "box"])
def test_non_atomic_mog_loss_and_gradients_match_jax(prior_kind):
    """NPE-C's closed form: the net's MoG times the proposal's MoG, the
    Gaussian prior divided out, in z-space, plus the z-scoring's log-det."""
    jprior, tprior = _priors(prior_kind)
    je, te, theta, x = _pair_copy(dim=2)
    jp, tp, _, _ = mdn_pair(dim=2, seed=1)
    x_o = x[:1]
    jprop = JaxDirectPosterior(jp, jprior).set_default_x(jnp.asarray(x_o))
    tprop = DirectPosterior(tp, tprior).set_default_x(x_o)
    jtr, ttr = _trainers(JaxNPE_C, NPE_C, jprior, tprior, je, te)
    assert jtr._is_mog_case(jprop) and ttr._is_mog_case(tprop)
    _check_loss_and_grads(jtr, ttr, jtr._make_mog_loss_fn(jprop), ttr._make_mog_loss_fn(tprop),
                          theta[:64], x[:64])


def test_mog_case_gating_matches_jax():
    """The closed form needs an MDN net, a DirectPosterior over an MDN, and
    a Gaussian or uniform prior; an unbuilt net means the atomic loss."""
    jprior, tprior = _priors("gaussian")
    je, te, _, x = mdn_pair(dim=2)
    jtr, ttr = _trainers(JaxNPE_C, NPE_C, jprior, tprior, je, te)
    jprop = JaxDirectPosterior(je, jprior).set_default_x(jnp.asarray(x[:1]))
    tprop = DirectPosterior(te, tprior).set_default_x(x[:1])
    assert jtr._is_mog_case(jprop) and ttr._is_mog_case(tprop)
    assert not jtr._is_mog_case(jprior) and not ttr._is_mog_case(tprior)
    ttr._neural_net = jtr._neural_net = None
    assert not jtr._is_mog_case(jprop) and not ttr._is_mog_case(tprop)


def test_npe_b_loss_and_gradients_match_jax():
    """The importance weight prior / proposal is detached and its log
    clipped to [-10, 10]; the Gaussian prior makes the clip bite on some
    rows."""
    jprior, tprior = _priors("gaussian")
    je, te, theta, x = _pair_copy(dim=2)
    jp, tp, _, _ = mdn_pair(dim=2, seed=1)
    jprop = JaxDirectPosterior(jp, jprior).set_default_x(jnp.asarray(x[:1]))
    tprop = DirectPosterior(tp, tprior).set_default_x(x[:1])
    jtr, ttr = _trainers(JaxNPE_B, NPE_B, jprior, tprior, je, te)
    _check_loss_and_grads(jtr, ttr, jtr._make_proposal_loss_fn(jprop, None),
                          ttr._make_proposal_loss_fn(tprop, None), theta[:64], x[:64])


# ---------------------------------------------------------------------------
# NPE-A
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prior_kind", ["gaussian", "box"])
def test_correct_mog_for_proposal_matches_jax(prior_kind):
    rng = np.random.default_rng(1)
    jm, tm = mog_pair(rng, 2, 3, 2, shift=2.0)
    jprior, tprior = _priors(prior_kind)
    Pp = np.array([[0.6, 0.1], [0.1, 0.4]], np.float32)
    etap = np.array([0.3, -0.2], np.float32)
    got = correct_mog_for_proposal(tm, tprior, (torch.tensor(Pp), torch.tensor(etap)), 2)
    want = jax_correct(jm, jprior, (jnp.asarray(Pp), jnp.asarray(etap)), 2)
    assert_mog_close(got, want, rtol=CORR_RTOL, atol=CORR_ATOL)
    # A proposal equal to the prior: the correction cancels (weights normalized).
    spec = _GaussSpec(torch.tensor(Pp), torch.tensor(etap))
    same = MoG(torch.log_softmax(tm.logits, -1), tm.means, tm.precision_chols)
    assert_mog_close(correct_mog_for_proposal(tm, spec, None, 2), same, rtol=CORR_RTOL, atol=CORR_ATOL)


@pytest.mark.parametrize("prior_natural", [False, True])
def test_divide_mog_by_proposal_mog_matches_jax(prior_natural):
    """K * L pairs; the proposal's last component is sharper than every
    density component, so its pairs are not positive definite and are
    dropped (-inf weight) in both packages."""
    rng = np.random.default_rng(2)
    jd, td = mog_pair(rng, 2, 2, 2, shift=3.0)
    jp, tp = mog_pair(rng, 2, 2, 2, shift=0.5)
    for m in (jp, tp):
        chols = np.asarray(m.precision_chols).copy()
        chols[:, 1] = np.sqrt(8.0) * np.eye(2)
        m.precision_chols = (jnp.asarray(chols) if m is jp else torch.tensor(chols))
    nat_j = nat_t = None
    if prior_natural:
        P0 = np.array([[0.5, 0.0], [0.0, 0.5]], np.float32)
        eta0 = np.array([0.1, 0.2], np.float32)
        nat_j, nat_t = (jnp.asarray(P0), jnp.asarray(eta0)), (torch.tensor(P0), torch.tensor(eta0))
    got = divide_mog_by_proposal_mog(td, tp, nat_t, 2)
    want = jax_divide(jd, jp, nat_j, 2)
    assert np.isneginf(got.logits.numpy()[:, 1::2]).all()
    assert_mog_close(got, want, rtol=CORR_RTOL, atol=CORR_ATOL)


def test_moment_match_matches_jax():
    rng = np.random.default_rng(4)
    jm, tm = mog_pair(rng, 2, 3, 2)
    for got, want in zip(_moment_match(tm), jax_moment_match(jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CORR_RTOL, atol=CORR_ATOL)


@pytest.mark.parametrize("prior_kind", ["gaussian", "box"])
def test_npe_a_posterior_log_prob_matches_jax(prior_kind):
    """The corrected MoG of an estimator trained on prior samples (the
    proposal is the prior), and of one whose proposal is another NPE-A
    posterior (the pairwise division), carried through the z-scoring."""
    jprior, tprior = _priors(prior_kind)
    je, te, theta, x = mdn_pair(dim=2, num_components=1)
    jp, tp = _broadened(je, te)
    x_o = x[:1]
    jprop = JaxNPE_A_Posterior(jp, jprior).set_default_x(jnp.asarray(x_o))
    tprop = NPE_A_Posterior(tp, tprior).set_default_x(x_o)
    th = theta[:40]
    for jprop_, tprop_ in ((None, None), (jprop, tprop)):
        jpost = JaxNPE_A_Posterior(je, jprior, proposal=jprop_)
        want = np.asarray(jax.jit(lambda t: jpost.log_prob(t, x=jnp.asarray(x_o)))(jnp.asarray(th)))
        got = NPE_A_Posterior(te, tprior, proposal=tprop_).log_prob(th, x=x_o).numpy()
        assert np.isfinite(want).any()
        np.testing.assert_allclose(got, want, rtol=CORR_RTOL, atol=CORR_ATOL)


def test_expand_mog_tiles_the_head_as_jax():
    """With no jitter, the expanded head's weights are JAX's exactly, and
    the expanded K-component MDN has the one-component density."""
    je, te, theta, x = _pair_copy(dim=2, num_components=1)
    jtr, ttr = _trainers(lambda prior: JaxNPE_A(prior=prior, num_components=3),
                         lambda prior, device: NPE_A(prior=prior, num_components=3, device=device),
                         None, None, je, te)
    with torch.no_grad():
        before = te.log_prob(torch.tensor(theta[None, :20]), torch.tensor(x[:20]))
    ttr._optimizer = object()
    jtr._maybe_expand_mog(eps=0.0)
    ttr._maybe_expand_mog(eps=0.0)
    assert ttr._optimizer is None and te.net.num_components == 3
    ref = copy.deepcopy(te)
    load_flax_params(ref, jax.tree_util.tree_map(np.asarray, jtr._neural_net.params))
    for (name, p), (_, r) in zip(te.net.named_parameters(), ref.net.named_parameters()):
        assert torch.equal(p, r), name
    with torch.no_grad():
        after = te.log_prob(torch.tensor(theta[None, :20]), torch.tensor(x[:20]))
    torch.testing.assert_close(after, before, rtol=0, atol=1e-5)
    ttr._maybe_expand_mog(eps=0.0)  # a second call leaves a K-component head alone
    assert te.net.logits.out_features == 3


# ---------------------------------------------------------------------------
# posterior_parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls, bad", [
    ("DirectPosteriorParameters", dict(max_sampling_batch_size=0)),
    ("FilteredDirectPosteriorParameters", dict(filter_quantile=1.0)),
    ("MCMCPosteriorParameters", dict(warmup_steps=-1)),
    ("MCMCPosteriorParameters", dict(num_chains=0)),
    ("MCMCPosteriorParameters", dict(thin=0)),
    ("RejectionPosteriorParameters", dict(m=0.5)),
    ("ImportanceSamplingPosteriorParameters", dict(method="other")),
    ("ImportanceSamplingPosteriorParameters", dict(oversampling_factor=0)),
    ("VIPosteriorParameters", dict(vi_method="other")),
    ("VectorFieldPosteriorParameters", dict(sample_with="other")),
])
def test_posterior_parameters_validate_as_jax(cls, bad):
    with pytest.raises(Exception) as jerr:
        getattr(jax_pp, cls)(**bad)
    with pytest.raises(type(jerr.value)):
        getattr(torch_pp, cls)(**bad)
    assert torch_pp.asdict(getattr(torch_pp, cls)()) == jax_pp.asdict(getattr(jax_pp, cls)())


def test_build_posterior_from_parameters_dispatch():
    _, te, _, x = mdn_pair(dim=2)
    _, tprior = _priors("box")
    build = torch_pp.build_posterior_from_parameters
    assert isinstance(build(DirectPosteriorParameters(), te, tprior, kind="npe"), DirectPosterior)
    for kind in ("npe", "nle"):
        post = build(MCMCPosteriorParameters(num_chains=3, warmup_steps=7), te, tprior, kind=kind)
        assert isinstance(post, MCMCPosterior) and (post.num_chains, post.warmup_steps) == (3, 7)
    with pytest.raises(TypeError, match="requires a posterior estimator"):
        build(DirectPosteriorParameters(), te, tprior, kind="nle")
    with pytest.raises(TypeError, match="vector-field"):
        build(VectorFieldPosteriorParameters(), te, tprior, kind="npe")
    with pytest.raises(TypeError):
        build(object(), te, tprior, kind="npe")
    for params, cls in ((torch_pp.RejectionPosteriorParameters(m=2.0), RejectionPosterior),
                        (torch_pp.ImportanceSamplingPosteriorParameters(oversampling_factor=4),
                         ImportanceSamplingPosterior)):
        for kind in ("npe", "nle"):
            post = build(params, te, tprior, kind=kind)
            assert isinstance(post, cls) and post.proposal is tprior
    assert build(params, te, tprior, kind="npe").oversampling_factor == 4
    for params, kind in ((MCMCPosteriorParameters(), "vf"), (VIPosteriorParameters(), "npe"),
                         (torch_pp.FilteredDirectPosteriorParameters(), "npe")):
        with pytest.raises(NotImplementedError, match="later slice"):
            build(params, te, tprior, kind=kind)
    with pytest.warns(UserWarning, match="takes precedence"):
        torch_pp.check_legacy_sampler_args({"mcmc_parameters": None}, {"sample_with": ("vi", "mcmc")})
    with pytest.raises(ValueError, match="Cannot combine"):
        torch_pp.check_legacy_sampler_args({"mcmc_parameters": {}}, {})


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

SHIFT, LIK_COV = -1.0, 0.3


def _lg(prior, n, seed):
    g = torch.Generator().manual_seed(seed)
    theta = prior.sample((n,), generator=g)
    return theta, linear_gaussian(theta, SHIFT * torch.ones(2), LIK_COV * torch.eye(2), generator=g)


@pytest.fixture(scope="module")
def npe_mdn_round0():
    """2-D linear Gaussian, Gaussian prior, 2,500 simulations, the default
    MDN (hidden 50, 10 components), batch 100, trained to patience: the
    JAX test's configuration (``tests/test_linear_gaussian_npe.py:26``)."""
    prior = MultivariateNormal(torch.zeros(2), covariance_matrix=torch.eye(2), device="cpu")
    theta, x = _lg(prior, 2_500, 0)
    torch.manual_seed(0)
    trainer = NPE(prior=prior, density_estimator="mdn", device="cpu")
    trainer.append_simulations(theta, x).train(training_batch_size=100,
                                               generator=torch.Generator().manual_seed(1))
    return prior, trainer


def _truth(n, seed):
    gt = true_posterior_linear_gaussian_mvn_prior(
        torch.zeros(1, 2), SHIFT * torch.ones(2), LIK_COV * torch.eye(2), torch.zeros(2), torch.eye(2))
    return gt.sample((n,), generator=torch.Generator().manual_seed(seed))


def test_npe_mdn_linear_gaussian_end_to_end(npe_mdn_round0):
    prior, trainer = npe_mdn_round0
    posterior = trainer.build_posterior().set_default_x(torch.zeros(1, 2))
    samples = posterior.sample((1_000,), generator=torch.Generator().manual_seed(2))
    assert samples.shape == (1_000, 2) and bool(torch.isfinite(samples).all())
    assert bool(torch.isfinite(posterior.log_prob(samples[:10])).all())
    score = float(c2st_torch(samples, _truth(1_000, 3), generator=torch.Generator().manual_seed(0)))
    assert 0.4 <= score <= 0.6, score


def test_snpe_c_non_atomic_second_round(npe_mdn_round0):
    """A second round proposed by the round-0 posterior (an MDN) takes the
    non-atomic MoG loss, trains on that round's data only, and stays a
    sound posterior."""
    prior, trainer = npe_mdn_round0
    trainer = copy.deepcopy(trainer)
    proposal = trainer.build_posterior().set_default_x(torch.zeros(1, 2))
    theta = proposal.sample((1_200,), generator=torch.Generator().manual_seed(4))
    x = linear_gaussian(theta, SHIFT * torch.ones(2), LIK_COV * torch.eye(2),
                        generator=torch.Generator().manual_seed(5))
    trainer.append_simulations(theta, x, proposal=proposal)
    trainer.train(training_batch_size=100, max_num_epochs=30,
                  generator=torch.Generator().manual_seed(6))
    assert trainer.use_non_atomic_loss and trainer._get_start_index(False, False) == 1
    samples = trainer.build_posterior().sample((1_000,), x=torch.zeros(1, 2),
                                               generator=torch.Generator().manual_seed(7))
    score = float(c2st_torch(samples, _truth(1_000, 8), generator=torch.Generator().manual_seed(0)))
    assert 0.35 <= score <= 0.65, score


def test_npe_a_and_npe_b_two_rounds_on_the_cpu():
    """NPE-A: one Gaussian component in round 0, ten after the final
    round's expansion, finite corrected samples and log-probs; NPE-B: a
    second round with the importance-weighted loss."""
    prior = MultivariateNormal(torch.zeros(2), covariance_matrix=torch.eye(2), device="cpu")
    x_o = torch.zeros(1, 2)
    g = torch.Generator().manual_seed(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        npe_a = NPE_A(prior=prior, num_components=4, device="cpu")
        theta, x = _lg(prior, 400, 10)
        npe_a.append_simulations(theta, x).train(max_num_epochs=5, generator=g)
        assert npe_a._neural_net.net.num_components == 1
        proposal = npe_a.build_posterior().set_default_x(x_o)
        theta = proposal.sample((400,), generator=g)
        x = linear_gaussian(theta, SHIFT * torch.ones(2), LIK_COV * torch.eye(2), generator=g)
        npe_a.append_simulations(theta, x, proposal=proposal)
        npe_a.train(final_round=True, max_num_epochs=5, generator=g)
        assert npe_a._neural_net.net.num_components == 4
        posterior = npe_a.build_posterior().set_default_x(x_o)
        assert isinstance(posterior, NPE_A_Posterior) and isinstance(posterior.proposal, NPE_A_Posterior)
        s = posterior.sample((200,), generator=g)
        assert s.shape == (200, 2) and bool(torch.isfinite(s).all())
        assert bool(torch.isfinite(posterior.log_prob(s)).all())
        with pytest.raises(AssertionError, match="from scratch"):
            npe_a.train(retrain_from_scratch=True)

        npe_b = NPE_B(prior=prior, density_estimator=posterior_nn("mdn", hidden_features=16,
                                                                   num_components=2, device="cpu"),
                      device="cpu")
        theta, x = _lg(prior, 400, 20)
        npe_b.append_simulations(theta, x).train(max_num_epochs=3, generator=g)
        proposal = npe_b.build_posterior().set_default_x(x_o)
        theta = proposal.sample((400,), generator=g)
        x = linear_gaussian(theta, SHIFT * torch.ones(2), LIK_COV * torch.eye(2), generator=g)
        npe_b.append_simulations(theta, x, proposal=proposal).train(max_num_epochs=3, generator=g)
        assert all(math.isfinite(v) for v in npe_b.summary["validation_loss"])
        s = npe_b.build_posterior().sample((50,), x=x_o, generator=g)
        assert bool(torch.isfinite(s).all())


def test_trainers_build_posteriors_from_parameters():
    """build_posterior(posterior_parameters=...) through the trainers, and
    infer(..., "NPE_A") by name."""
    prior = BoxUniform(-2 * np.ones(2), 2 * np.ones(2), device="cpu")
    theta, x = _lg(prior, 200, 30)
    small = dict(hidden_features=8, num_components=2, device="cpu")
    npe = NPE(prior=prior, density_estimator=posterior_nn("mdn", **small), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        npe.append_simulations(theta, x).train(max_num_epochs=1)
    assert isinstance(npe.build_posterior(posterior_parameters=DirectPosteriorParameters()),
                      DirectPosterior)
    nle = NLE(prior=prior, density_estimator=likelihood_nn("mdn", **small), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        nle.append_simulations(theta, x).train(max_num_epochs=1)
    post = nle.build_posterior(posterior_parameters=MCMCPosteriorParameters(num_chains=4, warmup_steps=5))
    assert isinstance(post, MCMCPosterior)
    assert post.sample((8,), x=x[:1]).shape == (8, 2)
    with pytest.raises(ValueError, match="Cannot combine"):
        nle.build_posterior(posterior_parameters=MCMCPosteriorParameters(), mcmc_parameters={})
    with pytest.raises(TypeError):
        nle.build_posterior(posterior_parameters=DirectPosteriorParameters())

    def simulator(t):
        return linear_gaussian(t, SHIFT * torch.ones(2), LIK_COV * torch.eye(2))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        posterior = infer(simulator, prior, "NPE_A", 200, init_kwargs=dict(device="cpu"),
                          train_kwargs=dict(max_num_epochs=2))
    assert isinstance(posterior, NPE_A_Posterior)
    assert posterior.sample((5,), x=x[:1]).shape == (5, 2)
