"""sbi_tpu_torch's vmapped ensembles against sbi_tpu's, on the CPU.

Members are small NSFs of npe-nsf-ens8's architecture (couplings with
interleaved MAF layers, hidden 16, 2 transforms) built by the JAX package
with their own keys, their parameters perturbed with numpy noise and
bridged into the port (``load_stacked_flax_params``): a 10-D theta
conditioned on a 10-D x (an NPE posterior), or the same flow as a
likelihood of x given theta (NLE). Inputs are numpy arrays made
from a seed. Tolerances:

- log-probs and potentials (members, the mixture and the product): 1e-4
  absolute, the flows' tolerance (test_torch_flows.py), -inf at the same
  places. The port's two routes, one vmapped call over the stacked members
  and member by member, run the same float32 arithmetic in another
  grouping: within 1e-5.
- one vmapped training step against JAX's vmapped ``member_step``: losses
  1e-4 absolute; gradients 1e-4 absolute plus 1e-3 relative per element
  (test_torch_npe.py states why); parameters after the clipped Adam step
  within 2 lr absolute and all but 1% of the elements within 1e-5 (Adam's
  first step moves an element by ~lr sign(g), and an element whose
  gradient is at the rounding noise may move either way).
- the per-member clip against optax's clip under ``jax.vmap``: 1e-6
  relative.
- linear Gaussian: the analytic posterior's mean and covariance 1e-6
  absolute (closed form in float32); the simulator's noise covariance
  within 0.01 of 0.1 I at 20,000 draws (its sampling error is ~0.001).
- end to end: a 2-D linear Gaussian trained as a 2-member ensemble, its
  mixture posterior 0.4 < C2ST < 0.62 against the analytic posterior, the
  bar of tests/test_train_ensemble.py:58, scored by the port's
  ``c2st_torch`` (one 80/20 holdout of 2,000 draws; its standard error at
  0.5 is ~0.025).
- ``weight_by_evidence``: the weights equal the softmax of the returned
  log-evidences to 1e-6; both routes give the same log-evidences to 1e-5.
"""

import copy
import functools
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sbi_tpu.inference import NLE as JaxNLE
from sbi_tpu.inference import NPE as JaxNPE
from sbi_tpu.inference.posteriors.direct_posterior import DirectPosterior as JaxDirectPosterior
from sbi_tpu.inference.posteriors.ensemble_posterior import EnsemblePosterior as JaxEnsemblePosterior
from sbi_tpu.inference.posteriors.ensemble_posterior import EnsemblePotential as JaxEnsemblePotential
from sbi_tpu.inference.potentials.likelihood_based_potential import (
    LikelihoodBasedPotential as JaxLikelihoodBasedPotential,
)
from sbi_tpu.inference.trainers._contracts import TrainConfig as JaxTrainConfig
from sbi_tpu.neural_nets.net_builders.flow import build_nsf as jax_build_nsf
from sbi_tpu.simulators.linear_gaussian import (
    true_posterior_linear_gaussian_mvn_prior as jax_true_posterior,
)
from sbi_tpu.simulators.tasks import get_task as jax_get_task
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu_torch.inference import NLE, NPE, DirectPosterior, EnsemblePosterior
from sbi_tpu_torch.inference.posteriors.ensemble_posterior import EnsemblePotential
from sbi_tpu_torch.inference.potentials.likelihood_based_potential import LikelihoodBasedPotential
from sbi_tpu_torch.inference.trainers import base as trainer_base
from sbi_tpu_torch.inference.trainers._contracts import TrainConfig
from sbi_tpu_torch.inference.trainers.base import (
    clip_by_global_norm_per_member_,
    ensemble_grad_and_loss,
    ensemble_step,
)
from sbi_tpu_torch.neural_nets import likelihood_nn, posterior_nn
from sbi_tpu_torch.neural_nets.estimators.flows import MaskedAffineAutoregressive
from sbi_tpu_torch.neural_nets.net_builders.flow import build_nsf
from sbi_tpu_torch.ops import rqs
from sbi_tpu_torch.simulators import (
    diagonal_linear_gaussian,
    get_task,
    linear_gaussian,
    true_posterior_linear_gaussian_mvn_prior,
)
from sbi_tpu_torch.utils import BoxUniform, MultivariateNormal, c2st_torch
from sbi_tpu_torch.utils.params_bridge import load_flax_params, load_stacked_flax_params
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
ROUTE_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
LR = 5e-4
SMALL = dict(hidden_features=16, num_transforms=2)
K = 2
DIM, COND = 10, 10
BOX = 4.0


@functools.lru_cache(maxsize=None)
def _members(dim=DIM, cond=COND, interleave=True, seed=0, n=300, members=K):
    """``members`` JAX NSFs (own keys, perturbed weights) and the port's, bridged.
    Returns (jax members, port members, the port's stacked state, inputs,
    conditions). Cached: callers copy what they modify."""
    rng = np.random.default_rng(seed)
    inputs = (rng.normal(size=(n, dim)) * 1.5 + 0.3).astype(np.float32)
    conds = (inputs[:, :1] + rng.normal(size=(n, cond))).astype(np.float32)
    jes, params = [], []
    for k in range(members):
        je = jax_build_nsf(jnp.asarray(inputs), jnp.asarray(conds), key=jax.random.PRNGKey(seed + k),
                           interleave_affine=interleave, **SMALL)
        p = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), je.params)
        je.params = jax.tree_util.tree_map(jnp.asarray, p)
        jes.append(je)
        params.append(p)
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *params)
    tes = [build_nsf(inputs, conds, device="cpu", interleave_affine=interleave, **SMALL)
           for _ in range(members)]
    t0 = jes[0]
    state = load_stacked_flax_params(
        tes, stacked,
        np.asarray(t0.input_transform.loc), np.asarray(t0.input_transform.scale),
        np.asarray(t0.condition_transform.loc), np.asarray(t0.condition_transform.scale))
    return jes, tes, state, inputs, conds


def _jax_log_probs(jes, inputs, conds):
    """Each JAX member's log-prob, through one jitted ``log_prob_fn``."""
    fn = jax.jit(jes[0].log_prob_fn)
    return [np.asarray(fn(je.params, jnp.asarray(inputs[None]), jnp.asarray(conds))) for je in jes]


def _assert_potentials_match(got, want, atol=ATOL):
    got, want = np.asarray(got.detach()), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0)


def _priors(dim):
    lo, hi = -BOX * np.ones(dim, np.float32), BOX * np.ones(dim, np.float32)
    return JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)), BoxUniform(lo, hi, device="cpu")


def _by_hand(tes):
    """Copies of the members with z-scorings of their own: posteriors built
    from them are evaluated member by member."""
    return [copy.deepcopy(te) for te in tes]



# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def test_stacked_bridge():
    jes, tes, state, inputs, conds = _members()
    for name, p in tes[0].net.named_parameters():
        assert state[name].shape == (K,) + tuple(p.shape)
        for k in range(K):
            assert torch.equal(state[name][k], dict(tes[k].net.named_parameters())[name])
    assert tes[1].input_transform is tes[0].input_transform
    for lp_j, te in zip(_jax_log_probs(jes, inputs[:40], conds[:40]), tes):
        with torch.no_grad():
            lp_t = te.log_prob(torch.tensor(inputs[None, :40]), torch.tensor(conds[:40]))
        np.testing.assert_allclose(lp_t.numpy(), lp_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dim", [2, 10])
def test_build_nsf_interleave_affine_matches_jax(dim):
    """A MAF layer before each spline, in both branches (autoregressive
    splines for dim <= 2, couplings above)."""
    jes, tes, _, inputs, conds = _members(dim=dim, members=1 if dim == 2 else K)
    layers = list(tes[0].net.layers)
    # maf, spline, then permutation (dim 2) or lu_linear (dim 10)
    assert all(isinstance(layers[i], MaskedAffineAutoregressive) for i in range(0, len(layers), 3))
    assert sum(isinstance(l, MaskedAffineAutoregressive) for l in layers) == SMALL["num_transforms"]
    for lp_j, te in zip(_jax_log_probs(jes, inputs[:40], conds[:40]), tes):
        with torch.no_grad():
            lp_t = te.log_prob(torch.tensor(inputs[None, :40]), torch.tensor(conds[:40]))
        np.testing.assert_allclose(lp_t.numpy(), lp_j, atol=ATOL, rtol=0)


def test_linear_gaussian_matches_jax():
    """gaussian_linear's prior, its analytic posterior and the simulators:
    the closed forms against JAX's, the noise by its covariance."""
    jtask, task = jax_get_task("gaussian_linear"), get_task("gaussian_linear", device="cpu")
    np.testing.assert_allclose(task.prior.loc.numpy(), np.asarray(jtask.prior.loc), atol=1e-6)
    np.testing.assert_allclose(task.prior.covariance_matrix.numpy(), 0.1 * np.eye(10), atol=1e-6)
    rng = np.random.default_rng(0)
    x_o = rng.normal(size=(3, 10)).astype(np.float32)
    shift = rng.normal(size=10).astype(np.float32)
    lik_cov = (0.2 * np.eye(10) + 0.05).astype(np.float32)
    prior_mean = rng.normal(size=10).astype(np.float32)
    want = jax_true_posterior(jnp.asarray(x_o), shift, lik_cov, prior_mean, 0.3 * np.eye(10))
    got = true_posterior_linear_gaussian_mvn_prior(torch.tensor(x_o), shift, lik_cov, prior_mean,
                                                   0.3 * np.eye(10))
    np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc), atol=1e-6)
    want_cov = np.asarray(want.scale_tril) @ np.asarray(want.scale_tril).T
    np.testing.assert_allclose(got.covariance_matrix.numpy(), want_cov, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    theta = task.prior.sample((20_000,), generator=g)
    for noise, cov in ((task.simulator(theta, generator=g) - theta, 0.1 * np.eye(10)),
                       (linear_gaussian(theta, shift, lik_cov, generator=g) - theta - torch.tensor(shift),
                        lik_cov),
                       (diagonal_linear_gaussian(theta, std=0.5, generator=g) - theta,
                        0.25 * np.eye(10))):
        np.testing.assert_allclose(torch.cov(noise.T).numpy(), cov, atol=0.01)
        assert float(noise.mean(0).abs().max()) < 0.02
    ref = task.reference_sampler(torch.tensor(x_o[0]), 20_000, generator=g)
    want = jax_true_posterior(jnp.asarray(x_o[0]), np.zeros(10), 0.1 * np.eye(10), np.zeros(10),
                              0.1 * np.eye(10))
    np.testing.assert_allclose(ref.mean(0).numpy(), np.asarray(want.loc), atol=0.01)


def test_per_member_clip_matches_optax_under_vmap():
    """Member 0 below max_norm 5, member 1 above: each scaled by its own
    norm."""
    rng = np.random.default_rng(1)
    shapes = ((3, 4), (7,), (2, 2, 2))
    tree = [rng.normal(size=(K,) + s).astype(np.float32) for s in shapes]
    norms = np.sqrt(sum((a.reshape(K, -1) ** 2).sum(1) for a in tree))
    target = np.array([1.0, 20.0], np.float32)
    tree = [a * (target / norms).reshape((K,) + (1,) * (a.ndim - 1)).astype(np.float32) for a in tree]
    want = jax.vmap(lambda t: optax.clip_by_global_norm(5.0).update(t, None)[0])(
        [jnp.asarray(a) for a in tree])
    got = [torch.tensor(a) for a in tree]
    clip_by_global_norm_per_member_(got, 5.0)
    for g, w, a in zip(got, want, tree):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g[0].numpy(), a[0])  # member 0 untouched


@functools.lru_cache(maxsize=None)
def _jax_member_step(clip):
    """JAX's vmapped member_step of ``train_ensemble`` (sbi_tpu base.py
    :581-598), with its loss and optimizer."""
    jes = _members()[0]
    jtr = JaxNPE(prior=None)
    jtr._neural_net = jes[0]
    loss_fn = jtr._ensemble_loss_fn()
    tx = jtr._make_optimizer(JaxTrainConfig(learning_rate=LR, clip_max_norm=clip), steps_per_epoch=1)

    def member_step(pm, sm, theta_b, x_b, masks_b):
        loss, g = jax.value_and_grad(lambda q: loss_fn(q, None, theta_b, x_b, masks_b).mean())(pm)
        updates, sm = tx.update(g, sm, pm)
        return optax.apply_updates(pm, updates), sm, loss, g

    return tx, jax.jit(jax.vmap(member_step))


def test_vmapped_member_step_matches_jax():
    jes, tes, state, theta, x = _members()
    tes = [copy.deepcopy(te) for te in tes]
    for te in tes[1:]:
        te.input_transform, te.condition_transform = tes[0].input_transform, tes[0].condition_transform
    params = {k: v.clone() for k, v in state.items()}
    rng = np.random.default_rng(5)
    idx = np.stack([rng.choice(len(theta), 48, replace=False) for _ in range(K)])
    batch = (theta[idx], x[idx], np.ones(idx.shape, np.float32))
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[je.params for je in jes])

    # The clip between the two members' gradient norms: it scales one only.
    ttr = NPE(prior=None, device="cpu")
    grad_and_loss = ensemble_grad_and_loss(tes[0].net, ttr._ensemble_loss_fn(tes[0]))
    with torch.no_grad():
        grads, losses = grad_and_loss(params, *map(torch.tensor, batch))
    norms = torch.linalg.vector_norm(torch.cat([g.reshape(K, -1) for g in grads.values()], 1), dim=1)
    clip = float(norms.prod().sqrt())
    assert float(norms.min()) < clip < float(norms.max())

    tx, step = _jax_member_step(clip)
    new_p, _, j_loss, j_grads = step(stacked, jax.vmap(tx.init)(stacked), *map(jnp.asarray, batch))
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_loss), atol=ATOL, rtol=0)
    for k, te in enumerate(tes):
        ref = load_flax_params(copy.deepcopy(te), jax.tree_util.tree_map(lambda a: np.asarray(a)[k], j_grads))
        for name, r in ref.net.named_parameters():
            np.testing.assert_allclose(grads[name][k].numpy(), r.detach().numpy(), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=name)

    opt = ttr._make_optimizer(TrainConfig(learning_rate=LR), list(params.values()))
    ensemble_step(grad_and_loss, params, opt, tuple(map(torch.tensor, batch)), clip)
    diffs = []
    for k, te in enumerate(tes):
        ref = load_flax_params(copy.deepcopy(te), jax.tree_util.tree_map(lambda a: np.asarray(a)[k], new_p))
        diffs += [(params[name][k] - r.detach()).abs().numpy().ravel()
                  for name, r in ref.net.named_parameters()]
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR
    assert np.mean(diffs > 1e-5) <= 0.01


# ---------------------------------------------------------------------------
# Potentials and the posterior
# ---------------------------------------------------------------------------


def _npe_posteriors(combination):
    jes, tes, _, theta, x = _members()
    jprior, tprior = _priors(DIM)
    jpost = JaxEnsemblePosterior([JaxDirectPosterior(je, jprior) for je in jes],
                                 potential_combination=combination)
    stacked = EnsemblePosterior([DirectPosterior(te, tprior) for te in tes],
                                potential_combination=combination)
    by_hand = EnsemblePosterior([DirectPosterior(te, tprior) for te in _by_hand(tes)],
                                potential_combination=combination)
    return jpost, stacked, by_hand, theta, x


def _thetas(theta, n=40, seed=9):
    rng = np.random.default_rng(seed)
    th = (theta[:n] + 0.5 * rng.normal(size=theta[:n].shape)).astype(np.float32)
    th[:3] = BOX + 1.0  # outside the prior box: -inf
    return th


@pytest.mark.parametrize("combination", ["mixture", "product"])
def test_ensemble_potential_matches_jax(combination, monkeypatch):
    jpost, stacked, by_hand, theta, x = _npe_posteriors(combination)
    assert stacked.potential_fn.vmapped and not by_hand.potential_fn.vmapped
    th, x_o = _thetas(theta), x[:1]
    jpot = jpost.potential_fn
    jpot.set_x(jnp.asarray(x_o))
    want = jpot(jnp.asarray(th))
    calls = [0]
    plain = rqs.rational_quadratic_spline_plain

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(rqs, "rational_quadratic_spline_plain", counted)
    got = {}
    for name, post in (("stacked", stacked), ("by_hand", by_hand)):
        calls[0] = 0
        post.potential_fn.set_x(torch.tensor(x_o))
        with torch.no_grad():
            got[name] = post.potential_fn(torch.tensor(th))
        # One spline call per coupling for all members, or one per member.
        assert calls[0] == SMALL["num_transforms"] * (1 if name == "stacked" else K)
        _assert_potentials_match(got[name], want)
    _assert_potentials_match(got["stacked"], got["by_hand"].numpy(), atol=ROUTE_ATOL)


@pytest.mark.parametrize("combination", ["mixture", "product"])
def test_ensemble_log_prob_matches_jax(combination):
    jpost, stacked, by_hand, theta, x = _npe_posteriors(combination)
    th, x_o = _thetas(theta, seed=10), x[1:2]
    want = jpost.log_prob(jnp.asarray(th), x=jnp.asarray(x_o), norm_posterior=False)
    want_each = jpost.log_prob(jnp.asarray(th), x=jnp.asarray(x_o), norm_posterior=False,
                               individually=True)
    for post in (stacked, by_hand):
        with torch.no_grad():
            got = post.log_prob(torch.tensor(th), x=torch.tensor(x_o), norm_posterior=False)
            each = post.log_prob(torch.tensor(th), x=torch.tensor(x_o), norm_posterior=False,
                                 individually=True)
        assert each.shape == (K, len(th))
        _assert_potentials_match(got, want)
        _assert_potentials_match(each, want_each)


@pytest.mark.parametrize("combination", ["mixture", "product"])
def test_nle_ensemble_potential_and_batched_over_x_match_jax(combination):
    """Likelihood members (the product-of-experts NLE path): the combined
    potential with T = 2 iid trials, and ``batched_over_x``."""
    jes, tes, _, inputs, conds = _members()
    jprior, tprior = _priors(COND)
    weights = np.array([0.3, 0.7], np.float32)
    jpot = JaxEnsemblePotential([JaxLikelihoodBasedPotential(je, jprior) for je in jes], weights,
                                jprior, combination=combination)
    tpot = EnsemblePotential([LikelihoodBasedPotential(te, tprior) for te in tes], weights, tprior,
                             combination=combination)
    hand = EnsemblePotential([LikelihoodBasedPotential(te, tprior) for te in _by_hand(tes)],
                             weights, tprior, combination=combination)
    assert tpot.vmapped and not hand.vmapped
    th = _thetas(conds, n=24, seed=11)
    jpot.set_x(jnp.asarray(inputs[:2]), x_is_iid=True)
    want = jax.jit(jpot)(jnp.asarray(th))
    for pot in (tpot, hand):
        pot.set_x(torch.tensor(inputs[:2]), x_is_iid=True)
        with torch.no_grad():
            _assert_potentials_match(pot(torch.tensor(th)), want)
    xs, reps = inputs[2:5], 8
    want_b = jax.jit(jpot.batched_over_x(jnp.asarray(xs), reps))(jnp.asarray(th))
    for pot in (tpot, hand):
        with torch.no_grad():
            _assert_potentials_match(pot.batched_over_x(torch.tensor(xs), reps)(torch.tensor(th)), want_b)


def test_weight_by_evidence_is_the_softmax_of_log_z():
    _, stacked, by_hand, _, x = _npe_posteriors("mixture")
    logz = {}
    for name, post in (("stacked", stacked), ("by_hand", by_hand)):
        logz[name] = post.weight_by_evidence(x=torch.tensor(x[:1]), num_samples=3_000,
                                             generator=torch.Generator().manual_seed(0),
                                             chunk_size=1_000)
        assert logz[name].shape == (K,) and bool(torch.isfinite(logz[name]).all())
        np.testing.assert_allclose(post.weights.numpy(), torch.softmax(logz[name], 0).numpy(), atol=1e-6)
        np.testing.assert_allclose(post.potential_fn._weights.numpy(), post.weights.numpy(), atol=1e-6)
    np.testing.assert_allclose(logz["stacked"].numpy(), logz["by_hand"].numpy(), atol=ROUTE_ATOL)


# ---------------------------------------------------------------------------
# train_ensemble end to end
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lg_data():
    prior = MultivariateNormal(torch.zeros(2), covariance_matrix=torch.eye(2), device="cpu")
    g = torch.Generator().manual_seed(0)
    theta = prior.sample((2_500,), generator=g)
    return prior, theta, diagonal_linear_gaussian(theta, generator=g)


def test_train_ensemble_mixture_recovers_the_analytic_posterior():
    prior, theta, x = _lg_data()
    builder = posterior_nn("nsf", hidden_features=16, num_transforms=2, device="cpu")
    inf = NPE(prior=prior, density_estimator=builder, device="cpu")
    inf.append_simulations(theta, x)
    g = torch.Generator().manual_seed(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        members = inf.train_ensemble(num_members=2, max_num_epochs=20, stop_after_epochs=10,
                                     generator=g)
    assert len(members) == 2
    state = inf._ensemble_stacked_state
    assert all(v.shape[0] == 2 for v in state.values())
    for name, p in members[1].net.named_parameters():
        assert torch.equal(p, state[name][1])
    x_o = torch.ones(1, 2)
    with torch.no_grad():
        lps = [m.log_prob(theta[None, :16], x[:16])[0] for m in members]
    assert not torch.allclose(lps[0], lps[1])
    assert inf.summary["epochs_trained"][-1] <= 20
    # One summary entry a chunk of epoch_chunk (default 10) epochs, as in JAX.
    assert len(inf.summary["validation_loss"]) == -(-inf.summary["epochs_trained"][-1] // 10)
    posterior = inf.build_ensemble_posterior()
    assert posterior.potential_fn.vmapped
    samples = posterior.sample((1_000,), x=x_o, generator=g)
    batched = posterior.sample_batched((50,), x=torch.cat([x_o, -x_o]), generator=g)
    assert batched.shape == (50, 2, 2) and bool(torch.isfinite(batched).all())
    ref = true_posterior_linear_gaussian_mvn_prior(x_o[0], torch.zeros(2), torch.eye(2),
                                                   torch.zeros(2), torch.eye(2))
    score = float(c2st_torch(samples, ref.sample((1_000,), generator=g), generator=g))
    assert 0.5 - 0.1 < score < 0.5 + 0.12, score


def test_nle_bootstrap_and_member_train_indices(monkeypatch):
    """Bootstrap: each member's batches come from its own resample of the
    shared training rows. member_train_indices: from its own block only."""
    prior = BoxUniform(-2 * np.ones(2), 2 * np.ones(2), device="cpu")
    n = 600
    theta = prior.sample((n,), generator=torch.Generator().manual_seed(0))
    x = theta + 0.3 * torch.randn(n, 2, generator=torch.Generator().manual_seed(1))
    builder = likelihood_nn("nsf", hidden_features=8, num_transforms=1, device="cpu")
    seen = []
    step = trainer_base.ensemble_step

    def recording(grad_and_loss, params, optimizer, batch, *rest):
        seen.append(batch[0].clone())
        return step(grad_and_loss, params, optimizer, batch, *rest)

    monkeypatch.setattr(trainer_base, "ensemble_step", recording)
    row_of = {tuple(t.tolist()): i for i, t in enumerate(theta)}

    def rows(batch):  # (K, B, D) -> per member, the set of row indices
        return [{row_of[tuple(t.tolist())] for t in member} for member in batch]

    inf = NLE(prior=prior, density_estimator=builder, device="cpu").append_simulations(theta, x)
    members = inf.train_ensemble(num_members=2, bootstrap=True, max_num_epochs=3,
                                 stop_after_epochs=8, generator=torch.Generator().manual_seed(2))
    assert len(members) == 2 and len(seen) == 3 * ((n - n // 10) // 200)
    train_rows = set(inf._train_indices.tolist())
    drawn = [set().union(*(rows(b)[k] for b in seen)) for k in range(2)]
    assert drawn[0] <= train_rows and drawn[1] <= train_rows and drawn[0] != drawn[1]
    assert inf.summary["epochs_trained"][-1] == 3
    assert np.isfinite(inf.summary["best_validation_loss"][-1])

    seen.clear()
    blocks = [np.arange(0, 300), np.arange(300, 600)]
    inf = NLE(prior=prior, density_estimator=builder, device="cpu").append_simulations(theta, x)
    inf.train_ensemble(num_members=2, member_train_indices=blocks, max_num_epochs=2,
                       generator=torch.Generator().manual_seed(3))
    n_val = int(0.1 * 300)
    for b in seen:
        for k, r in enumerate(rows(b)):
            assert r <= set(blocks[k][: 300 - n_val].tolist())  # own rows, validation carved off
    assert len(seen) == 2 * ((300 - n_val) // 200)


def test_product_of_experts_samples_by_mcmc(monkeypatch):
    """A 2-member NLE product of experts, a few slice chains: each potential
    evaluation is one spline call per layer for both members."""
    prior = BoxUniform(-2 * np.ones(2), 2 * np.ones(2), device="cpu")
    g = torch.Generator().manual_seed(4)
    theta = prior.sample((400,), generator=g)
    x = theta + 0.3 * torch.randn(400, 2, generator=g)
    builder = likelihood_nn("nsf", hidden_features=8, num_transforms=2, device="cpu")
    inf = NLE(prior=prior, density_estimator=builder, device="cpu").append_simulations(theta, x)
    inf.train_ensemble(num_members=2, max_num_epochs=1, generator=g)
    posterior = inf.build_ensemble_posterior("product")
    assert posterior.potential_fn.vmapped
    net = posterior.posteriors[0].potential_fn.likelihood_estimator.net
    evaluations, calls = [0], [0]
    log_prob, plain = net.log_prob, rqs.rational_quadratic_spline_plain

    def counted_eval(*args, **kwargs):
        evaluations[0] += 1
        return log_prob(*args, **kwargs)

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(net, "log_prob", counted_eval)
    monkeypatch.setattr(rqs, "rational_quadratic_spline_plain", counted)
    samples = posterior.sample((8,), x=torch.zeros(1, 2), generator=g, num_chains=4,
                               warmup_steps=2)
    assert samples.shape == (8, 2) and bool(torch.isfinite(samples).all())
    assert bool(prior.within_support(samples).all())
    assert evaluations[0] > 0 and calls[0] == 2 * evaluations[0]  # 2 autoregressive splines
    posterior._mcmc().warmup_steps = 2  # the product's sampler, as sample_batched runs it
    batched = posterior.sample_batched((2,), x=torch.zeros(2, 2), generator=g, num_chains=2)
    assert batched.shape == (2, 2, 2) and bool(torch.isfinite(batched).all())


def test_train_ensemble_mesh_and_ema_are_later_slices():
    prior, theta, x = _lg_data()
    inf = NPE(prior=prior, density_estimator=posterior_nn("nsf", hidden_features=8,
                                                          num_transforms=1, device="cpu"),
              device="cpu").append_simulations(theta[:100], x[:100])
    with pytest.raises(NotImplementedError, match="later slice"):
        inf.train_ensemble(num_members=2, max_num_epochs=1, mesh="auto")
    with pytest.raises(TypeError, match="ema_params_decay"):  # as JAX's signature
        inf.train_ensemble(num_members=2, max_num_epochs=1, ema_params_decay=0.99)
    with pytest.raises(RuntimeError, match="train_ensemble"):
        inf.build_ensemble_posterior()
