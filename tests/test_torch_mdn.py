"""sbi_tpu_torch's MDN family against sbi_tpu's, on the CPU: the ``MoG``
container, ``mog_log_prob``, ``MDNModule`` / ``MixtureDensityEstimator``
on bridged weights, ``build_mdn``, MDN ensembles, and two ``train_ensemble``
checks that hold for any member.

Inputs are numpy arrays made from a seed; the estimators are small (D <= 3,
hidden 16, K <= 3) with the JAX package's weights, perturbed and bridged
(``params_bridge``). Tolerances:

- ``MoG`` algebra (``log_prob``, ``condition``, ``product``,
  ``from_gaussian``, ``precisions``, ``mog_log_prob``): 1e-5 relative plus
  2e-5 absolute. The port takes its solves and log-determinants from
  Cholesky factors where the JAX package calls ``inv``, ``solve`` and
  ``slogdet``; on these well-conditioned float32 matrices (eigenvalues in
  about [1, 5]) the two orders of operations agree to a few float32 ulps
  of the largest term, which the absolute part covers where a value is
  near 0.
- the MDN's log-prob on bridged weights: 1e-5 absolute (one MLP and one
  small MoG; measured ~1e-6).
- ``MoG.sample``: the sample mean within 5 standard errors of the mixture
  mean in every coordinate, the sample covariance within 0.05 absolute at
  n = 40,000 (the JAX test's check, ``tests/test_mog.py:59``).
"""

import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference import NPE as JaxNPE
from sbi_tpu.neural_nets.estimators.mdn import MoG as JaxMoG
from sbi_tpu.neural_nets.net_builders.flow import build_nsf as jax_build_nsf
from sbi_tpu.neural_nets.net_builders.mdn import build_mdn as jax_build_mdn
from sbi_tpu.utils.sbiutils import mog_log_prob as jax_mog_log_prob
from sbi_tpu_torch.inference import NLE, NPE
from sbi_tpu_torch.inference.trainers import base as torch_base
from sbi_tpu_torch.neural_nets import likelihood_nn, posterior_nn
from sbi_tpu_torch.neural_nets.estimators.base import functional
from sbi_tpu_torch.neural_nets.estimators.mdn import MDNModule, MixtureDensityEstimator, MoG
from sbi_tpu_torch.neural_nets.net_builders.flow import build_nsf
from sbi_tpu_torch.neural_nets.net_builders.mdn import build_mdn
from sbi_tpu_torch.utils import MultivariateNormal, mog_log_prob
from sbi_tpu_torch.utils.params_bridge import load_flax_params, load_stacked_flax_params
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 2e-5
SMALL_MDN = dict(hidden_features=16, num_components=3)


def random_mog_arrays(rng, B, K, D, shift=2.0):
    """logits (B, K), means (B, K, D) and lower precision factors
    (B, K, D, D) of a well-conditioned mixture, as float32 numpy."""
    logits = rng.normal(size=(B, K)).astype(np.float32)
    means = rng.normal(size=(B, K, D)).astype(np.float32)
    A = 0.3 * rng.normal(size=(B, K, D, D))
    P = np.einsum("bkij,bklj->bkil", A, A) + shift * np.eye(D)
    return logits, means, np.linalg.cholesky(P).astype(np.float32)


def mog_pair(rng, B, K, D, shift=2.0):
    arrays = random_mog_arrays(rng, B, K, D, shift)
    return JaxMoG(*map(jnp.asarray, arrays)), MoG(*map(torch.tensor, arrays))


def assert_mog_close(got: MoG, want: JaxMoG, rtol=RTOL, atol=ATOL):
    for name in ("logits", "means", "precision_chols"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@functools.lru_cache(maxsize=None)
def mdn_pair(dim=2, x_dim=3, scale="softplus", seed=0, noise=0.1, n=200, **kw):
    """A JAX MDN and the port's MDN with the same perturbed weights and
    z-scoring. Cached: callers must not modify what it returns."""
    kw = {**SMALL_MDN, **kw}
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(n, dim)) * 1.5 + 0.3).astype(np.float32)
    x = (theta.sum(1, keepdims=True) + rng.normal(size=(n, x_dim))).astype(np.float32)
    je = jax_build_mdn(jnp.asarray(theta), jnp.asarray(x), scale_parameterization=scale,
                       key=jax.random.PRNGKey(seed), **kw)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + noise * rng.normal(size=a.shape).astype(np.float32), je.params)
    je.params = jax.tree_util.tree_map(jnp.asarray, params)
    te = build_mdn(theta, x, scale_parameterization=scale, device="cpu", **kw)
    load_flax_params(
        te, params,
        np.asarray(je.input_transform.loc), np.asarray(je.input_transform.scale),
        np.asarray(je.condition_transform.loc), np.asarray(je.condition_transform.scale),
    )
    return je, te, theta, x


# ---------------------------------------------------------------------------
# MoG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1, 3])
def test_mog_log_prob_weights_and_precisions_match_jax(D):
    rng = np.random.default_rng(D)
    jm, tm = mog_pair(rng, 4, 3, D)
    theta = rng.normal(size=(4, D)).astype(np.float32)
    np.testing.assert_allclose(tm.log_prob(torch.tensor(theta)).numpy(),
                               np.asarray(jm.log_prob(jnp.asarray(theta))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.precisions.numpy(), np.asarray(jm.precisions), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights), rtol=RTOL, atol=ATOL)
    assert (tm.dim, tm.num_components, tm.batch_shape) == (jm.dim, jm.num_components, jm.batch_shape)


def test_mog_log_prob_function_matches_jax():
    rng = np.random.default_rng(7)
    logits, means, chols = random_mog_arrays(rng, 5, 3, 3)
    precisions = np.einsum("bkij,bklj->bkil", chols, chols).astype(np.float32)
    theta = rng.normal(size=(5, 3)).astype(np.float32)
    want = jax_mog_log_prob(*map(jnp.asarray, (theta, logits, means, precisions)))
    got = mog_log_prob(*map(torch.tensor, (theta, logits, means, precisions)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_from_gaussian_matches_jax(batched):
    rng = np.random.default_rng(11)
    A = rng.normal(size=(2, 3, 3))
    cov = (np.einsum("bij,bkj->bik", A, A) + np.eye(3)).astype(np.float32)
    mean = rng.normal(size=(2, 3)).astype(np.float32)
    if not batched:
        mean, cov = mean[0], cov[0]
    assert_mog_close(MoG.from_gaussian(torch.tensor(mean), torch.tensor(cov)),
                     JaxMoG.from_gaussian(jnp.asarray(mean), jnp.asarray(cov)))


@pytest.mark.parametrize("dims_to_sample", [[0, 2], [1]])
def test_condition_matches_jax(dims_to_sample):
    """Conditional means and factors, and the weights reweighted by the
    exact marginal of the fixed dims."""
    rng = np.random.default_rng(3)
    jm, tm = mog_pair(rng, 2, 3, 3)
    condition = rng.normal(size=(2, 3)).astype(np.float32)
    got = tm.condition(torch.tensor(condition), dims_to_sample)
    want = jm.condition(jnp.asarray(condition), dims_to_sample)
    assert_mog_close(got, want)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("subtract", [False, True])
def test_product_matches_jax(subtract):
    """The pairwise product, with and without a Gaussian divided out."""
    rng = np.random.default_rng(5 + subtract)
    D = 3
    ja, ta = mog_pair(rng, 3, 2, D)
    jb, tb = mog_pair(rng, 3, 3, D)
    nat_j = nat_t = None
    if subtract:
        P0 = (0.3 * np.eye(D)).astype(np.float32)
        eta0 = (P0 @ np.array([0.2, -0.1, 0.4])).astype(np.float32)
        nat_j, nat_t = (jnp.asarray(P0), jnp.asarray(eta0)), (torch.tensor(P0), torch.tensor(eta0))
    got = MoG.product(ta, tb, subtract_natural=nat_t)
    want = JaxMoG.product(ja, jb, subtract_natural=nat_j)
    assert_mog_close(got, want)
    theta = rng.normal(size=(3, D)).astype(np.float32)
    np.testing.assert_allclose(got.log_prob(torch.tensor(theta)).numpy(),
                               np.asarray(want.log_prob(jnp.asarray(theta))), rtol=RTOL, atol=ATOL)


def test_detach_and_non_positive_definite_products_are_nan():
    """detach stops gradients; a product whose precision is not positive
    definite gives NaN, not finite garbage (no host check on the card)."""
    rng = np.random.default_rng(9)
    _, ta = mog_pair(rng, 1, 1, 2)
    _, tb = mog_pair(rng, 1, 1, 2)
    ta.means.requires_grad_(True)
    assert not ta.detach().means.requires_grad
    big = torch.eye(2) * 100.0
    pp = MoG.product(ta, tb, subtract_natural=(big, torch.zeros(2)))
    assert torch.isnan(pp.precision_chols).all() and torch.isnan(pp.means).all()


@pytest.mark.parametrize("corrupt", ["nan_logits", "inf_means", "nan_chol", "neg_diag"])
def test_validate_rejects_what_jax_rejects(corrupt):
    rng = np.random.default_rng(1)
    arrays = [a.copy() for a in random_mog_arrays(rng, 2, 2, 2)]
    if corrupt == "nan_logits":
        arrays[0][0, 0] = np.nan
    elif corrupt == "inf_means":
        arrays[1][1, 0, 1] = np.inf
    elif corrupt == "nan_chol":
        arrays[2][0, 1, 1, 0] = np.nan
    else:
        arrays[2][1, 1, 0, 0] = -0.5
    with pytest.raises(ValueError) as jerr:
        JaxMoG(*map(jnp.asarray, arrays)).validate()
    with pytest.raises(ValueError) as terr:
        MoG(*map(torch.tensor, arrays)).validate()
    assert str(terr.value) == str(jerr.value)
    MoG(*map(torch.tensor, random_mog_arrays(rng, 2, 2, 2))).validate()


def test_sample_moments():
    """Mean within 5 standard errors, covariance within 0.05 at n = 40,000
    (per-component covariance 0.25 I, weights 1/4 and 3/4)."""
    D, n = 2, 40_000
    means = torch.tensor([[[2.0, 0.0], [-2.0, 1.0]]])
    logits = torch.log(torch.tensor([[0.25, 0.75]]))
    chols = (2.0 * torch.eye(D)).expand(1, 2, D, D)
    s = MoG(logits, means, chols).sample(n, torch.Generator().manual_seed(0))[:, 0].numpy()
    assert s.shape == (n, D)
    w = np.array([0.25, 0.75])
    mu = w @ means[0].numpy()
    mdiff = means[0].numpy() - mu
    cov = 0.25 * np.eye(D) + (w[:, None, None] * mdiff[:, :, None] * mdiff[:, None, :]).sum(0)
    se = np.sqrt(np.diag(cov) / n)
    assert (np.abs(s.mean(0) - mu) <= 5 * se).all(), (s.mean(0), mu)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.05)


# ---------------------------------------------------------------------------
# MDNModule / MixtureDensityEstimator / build_mdn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim, scale", [(1, "softplus"), (3, "softplus"), (3, "log")])
def test_mdn_outputs_and_log_prob_match_jax_on_bridged_weights(dim, scale):
    je, te, theta, x = mdn_pair(dim=dim, scale=scale)
    zc = je._embed_condition(jnp.asarray(x[:20]))
    j_out = je.net.apply(je.params, zc)
    with torch.no_grad():
        t_out = te.net(te._embed_condition(torch.tensor(x[:20])))
    for name, j, t in zip(("logits", "means", "chols"), j_out, t_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, err_msg=name)
    want = np.asarray(je.log_prob(jnp.asarray(theta[None]), jnp.asarray(x)))
    with torch.no_grad():
        got = te.log_prob(torch.tensor(theta[None]), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert_mog_close(te.get_uncorrected_mog(x[:4]), je.get_uncorrected_mog(jnp.asarray(x[:4])))


def test_tril_order_and_initialisation():
    """The off-diagonal entries fill the strict lower triangle in
    tril_indices order on both sides; the off-diagonal head starts at zero
    weight and the diagonal head at zero bias."""
    D = 3
    net = MDNModule(theta_dim=D, condition_features=2, num_components=1, hidden_features=4)
    h = torch.zeros(1, 2)
    with torch.no_grad():
        net.off.weight.zero_()
        net.off.bias.copy_(torch.arange(1.0, 4.0))
        _, _, chol = net(h)
    rows, cols = np.tril_indices(D, -1)
    np.testing.assert_array_equal(chol[0, 0].numpy()[rows, cols], [1.0, 2.0, 3.0])
    jrows, jcols = jnp.tril_indices(D, -1)
    np.testing.assert_array_equal(rows, np.asarray(jrows))
    np.testing.assert_array_equal(cols, np.asarray(jcols))
    est = build_mdn(np.zeros((10, D), np.float32), np.ones((10, 2), np.float32), device="cpu")
    assert est.net.off.weight.abs().max() == 0 and est.net.diag.bias.abs().max() == 0
    assert (est.net.hidden_features, est.net.num_components, len(est.net.hidden)) == (50, 10, 2)
    assert isinstance(est, MixtureDensityEstimator)


def test_posterior_and_likelihood_nn_build_mdns():
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(30, 2)).astype(np.float32)
    x = rng.normal(size=(30, 4)).astype(np.float32)
    post = posterior_nn("mdn", num_components=2, hidden_features=8, device="cpu")(theta, x)
    lik = likelihood_nn("mdn", num_components=2, hidden_features=8, device="cpu")(theta, x)
    assert (post.input_shape, post.condition_shape, post.net.num_components) == ((2,), (4,), 2)
    assert (lik.input_shape, lik.condition_shape) == ((4,), (2,))
    s = post.sample((5,), torch.tensor(x[:3]))
    assert s.shape == (5, 3, 2) and bool(torch.isfinite(s).all())


def test_stacked_bridge_of_mdn_members():
    """The stacked bridge loads an MDN ensemble; the vmapped log-prob over
    the stacked state equals each member's JAX log-prob."""
    je, _, theta, x = mdn_pair(dim=2)
    rng = np.random.default_rng(4)
    stacked = jax.tree_util.tree_map(
        lambda a: np.stack([np.asarray(a) + 0.05 * k * rng.normal(size=a.shape).astype(np.float32)
                            for k in range(3)]), je.params)
    tes = [build_mdn(theta, x, device="cpu", **SMALL_MDN) for _ in range(3)]
    state = load_stacked_flax_params(
        tes, stacked, np.asarray(je.input_transform.loc), np.asarray(je.input_transform.scale),
        np.asarray(je.condition_transform.loc), np.asarray(je.condition_transform.scale))
    f = functional(tes[0].net, lambda t, c: tes[0].log_prob(t, c))
    with torch.no_grad():
        got = torch.func.vmap(f, in_dims=(0, None, None))(state, torch.tensor(theta[None]), torch.tensor(x))
    for k in range(3):
        jk = copy.copy(je)
        jk.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a[k]), stacked)
        want = np.asarray(jk.log_prob(jnp.asarray(theta[None]), jnp.asarray(x)))
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# train_ensemble
# ---------------------------------------------------------------------------


def test_mdn_ensemble_trains_as_one_vmapped_program():
    """MDN members train through the vmapped step; the mixture samples and
    scores finite values (its members' potentials in one vmap)."""
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(300, 2)).astype(np.float32)
    x = (theta + 0.3 * rng.normal(size=theta.shape)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    prior = MultivariateNormal(torch.zeros(2), covariance_matrix=torch.eye(2), device="cpu")
    inf = NPE(prior=prior, density_estimator=posterior_nn("mdn", device="cpu", **SMALL_MDN),
              device="cpu").append_simulations(theta, x)
    members = inf.train_ensemble(num_members=3, max_num_epochs=3, epoch_chunk=1, generator=g)
    assert len(members) == 3 and all(isinstance(m, MixtureDensityEstimator) for m in members)
    assert inf.summary["epochs_trained"][-1] == 3 and len(inf.summary["validation_loss"]) == 3
    assert all(math.isfinite(v) for v in inf.summary["validation_loss"])
    for k, m in enumerate(members):
        for name, p in m.net.named_parameters():
            assert torch.equal(p, inf._ensemble_stacked_state[name][k])
    posterior = inf.build_ensemble_posterior()
    s = posterior.sample((20,), x=x[:1], generator=g)
    assert s.shape == (20, 2) and bool(torch.isfinite(s).all())
    assert bool(torch.isfinite(posterior.log_prob(s, x=x[:1])).all())


def test_nle_mdn_ensemble_trains_and_scores():
    """An NLE ensemble of MDN likelihoods trains through the vmapped step
    (the NLE loss, -log p(x | theta)); its product-of-experts potential is
    finite."""
    rng = np.random.default_rng(1)
    theta = rng.normal(size=(300, 2)).astype(np.float32)
    x = (theta + 0.3 * rng.normal(size=theta.shape)).astype(np.float32)
    prior = MultivariateNormal(torch.zeros(2), covariance_matrix=torch.eye(2), device="cpu")
    inf = NLE(prior=prior, density_estimator=likelihood_nn("mdn", device="cpu", **SMALL_MDN),
              device="cpu").append_simulations(theta, x)
    members = inf.train_ensemble(num_members=2, max_num_epochs=2,
                                 generator=torch.Generator().manual_seed(0))
    assert all(isinstance(m, MixtureDensityEstimator) for m in members)
    assert all(math.isfinite(v) for v in inf.summary["validation_loss"])
    posterior = inf.build_ensemble_posterior("product")
    lp = posterior.log_prob(torch.tensor(theta[:10]), x=torch.tensor(x[:1]))
    assert lp.shape == (10,) and bool(torch.isfinite(lp).all())


def _record_member_val(monkeypatch):
    """Record, after every epoch of the port's train_ensemble, the
    members' validation losses and their parameters: the vmapped
    validation call is the one whose output is a plain (K,) tensor."""
    records = []
    real_vmap = torch.func.vmap

    def vmap(fn, *args, **kwargs):
        mapped = real_vmap(fn, *args, **kwargs)

        def call(params, *rest):
            out = mapped(params, *rest)
            if isinstance(out, torch.Tensor) and out.dim() == 1:
                records.append((out.clone(), {k: v.clone() for k, v in params.items()}))
            return out

        return call

    monkeypatch.setattr(torch_base.torch.func, "vmap", vmap)
    return records


def _record_jax_chunk_losses(monkeypatch):
    """Record the (K, n) validation losses JAX's train_ensemble reads back
    after every chunk (the second of its two np.asarray reads a chunk)."""
    from sbi_tpu.inference.trainers import base as jax_base

    reads = []

    class _NP:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def asarray(a, *args, **kwargs):
            out = np.asarray(a, *args, **kwargs)
            reads.append(out)
            return out

    monkeypatch.setattr(jax_base, "np", _NP())
    return reads


def test_train_ensemble_stops_and_summarises_at_chunk_ends_as_jax(monkeypatch):
    """Patience runs out in mid-chunk (stop_after_epochs=2: after epoch 3
    of chunks of 2): both packages train on to the chunk's end (4 epochs),
    write one summary entry a chunk (its last epoch's mean losses), and keep
    each member's snapshot of its lowest validation loss over every epoch
    trained. A learning rate of 1e-7 keeps every improvement below the
    1e-4 that patience needs, so the stopping epoch does not depend on the
    draws, which differ between the packages; the snapshots are compared
    as epochs."""
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(200, 2)).astype(np.float32)
    x = (theta + 0.3 * rng.normal(size=theta.shape)).astype(np.float32)
    tiny = dict(hidden_features=8, num_transforms=1)
    run = dict(num_members=2, training_batch_size=50, learning_rate=1e-7, stop_after_epochs=2,
               epoch_chunk=2, max_num_epochs=10)

    jax_reads = _record_jax_chunk_losses(monkeypatch)
    jinf = JaxNPE(prior=None, density_estimator=lambda t, c: jax_build_nsf(t, c, **tiny))
    jinf.append_simulations(jnp.asarray(theta), jnp.asarray(x))
    jinf.train_ensemble(key=jax.random.PRNGKey(0), **run)
    j_val = np.concatenate([r for r in jax_reads if r.ndim == 2][1::2], axis=1)  # (K, epochs)

    records = _record_member_val(monkeypatch)
    tinf = NPE(prior=None, density_estimator=lambda t, c: build_nsf(t, c, device="cpu", **tiny),
               device="cpu")
    tinf.append_simulations(theta, x)
    members = tinf.train_ensemble(generator=torch.Generator().manual_seed(0), **run)
    t_val = torch.stack([r[0] for r in records], dim=1).numpy()  # (K, epochs)

    assert jinf.summary["epochs_trained"] == tinf.summary["epochs_trained"] == [4]
    assert j_val.shape == t_val.shape == (2, 4)
    for key in ("training_loss", "validation_loss"):
        assert len(jinf.summary[key]) == len(tinf.summary[key]) == 2
    np.testing.assert_allclose(tinf.summary["validation_loss"], t_val[:, [1, 3]].mean(0), rtol=1e-6)
    np.testing.assert_allclose(jinf.summary["validation_loss"], j_val[:, [1, 3]].mean(0), rtol=1e-6)
    j_best, t_best = j_val.argmin(axis=1), t_val.argmin(axis=1)
    np.testing.assert_array_equal(t_best, j_best)
    for k, member in enumerate(members):
        snapshot = records[t_best[k]][1]
        for name, p in member.net.named_parameters():
            assert torch.equal(p, snapshot[name][k]), (k, name)


def test_ensemble_loss_runs_through_the_template_member_not_the_trained_net(monkeypatch):
    """A known divergence from the JAX package: its ``_ensemble_loss_fn``
    reads ``self._neural_net`` (``sbi_tpu/inference/trainers/npe/npe_base.py:180``,
    ``nle/nle_base.py:123``), so after an earlier ``train()`` with another
    z-scoring the ensemble's loss would run through that older net's
    z-scoring. The port evaluates the loss through the ensemble's template
    member, member 0, whose z-scoring every member shares."""
    rng = np.random.default_rng(2)
    theta = rng.normal(size=(200, 2)).astype(np.float32)
    x = (theta + 0.3 * rng.normal(size=theta.shape)).astype(np.float32)
    build = posterior_nn("mdn", device="cpu", **SMALL_MDN)
    inf = NPE(prior=None, density_estimator=build, device="cpu").append_simulations(theta, x)
    inf.train(max_num_epochs=1)
    trained = inf._neural_net
    trained.input_transform = copy.copy(trained.input_transform)
    trained.input_transform.loc = trained.input_transform.loc + 5.0  # another z-scoring
    seen = []
    real = NPE._ensemble_loss_fn

    def spy(self, est):
        seen.append(est)
        return real(self, est)

    monkeypatch.setattr(NPE, "_ensemble_loss_fn", spy)
    members = inf.train_ensemble(num_members=2, max_num_epochs=1,
                                 generator=torch.Generator().manual_seed(0))
    assert seen and all(est is members[0] for est in seen)
    assert inf._neural_net is trained and members[0] is not trained
    assert members[0].input_transform is not trained.input_transform
    assert not torch.equal(members[0].input_transform.loc, trained.input_transform.loc)
