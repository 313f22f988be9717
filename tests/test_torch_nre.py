"""sbi_tpu_torch's NRE against sbi_tpu's, on the CPU.

The ratio classifiers (linear, MLP and ResNet; hidden 16; with and without
an FC embedding of x) carry the JAX package's weights, perturbed so that
the zero biases matter, loaded through ``params_bridge``. theta is 3-D, x
4-D (7-D before the embedding). Inputs are numpy arrays made from a seed.

JAX threefry keys and torch generators never draw the same contrastive
atoms, so the losses are compared at the same atoms: the test rebuilds
the JAX package's index matrix from its key exactly as
``nre_base.classifier_logits`` draws it (for NRE-C also the split into
three keys and the permutation) and hands it to the port's pure losses.

Tolerances:

- logits, ``classifier_logits``, per-row losses and potentials: 1e-5
  absolute plus 1e-5 relative (float32 sums of a few hundred products in
  another order), and -inf at the same places (theta outside the prior
  box);
- gradients of the mean loss: 1e-4 absolute plus 1e-4 relative per
  parameter element;
- z-scoring: 1e-6 relative (the same float32 mean and population std).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference import BNRE as JaxBNRE
from sbi_tpu.inference import NRE_A as JaxNRE_A
from sbi_tpu.inference import NRE_B as JaxNRE_B
from sbi_tpu.inference import NRE_C as JaxNRE_C
from sbi_tpu.inference.potentials.ratio_based_potential import RatioBasedPotential as JaxPotential
from sbi_tpu.inference.trainers.nre.nre_base import classifier_logits as jax_classifier_logits
from sbi_tpu.neural_nets.embedding_nets import FCEmbedding as JaxFC
from sbi_tpu.neural_nets.factory import classifier_nn as jax_classifier_nn
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu_torch.inference import (
    AALR,
    BNRE,
    CNRE,
    NRE,
    NRE_A,
    NRE_B,
    NRE_C,
    SNRE_A,
    SNRE_B,
    SNRE_C,
    SRE,
    RatioBasedPotential,
    ratio_estimator_based_potential,
)
from sbi_tpu_torch.inference.trainers.base import contrast_indices
from sbi_tpu_torch.inference.trainers.nre.nre_base import classifier_logits
from sbi_tpu_torch.neural_nets import classifier_nn
from sbi_tpu_torch.neural_nets.embedding_nets import FCEmbedding
from sbi_tpu_torch.neural_nets.estimators import RatioEstimator
from sbi_tpu_torch.utils import BoxUniform
from sbi_tpu_torch.utils.params_bridge import load_flax_params, load_stacked_flax_params

from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ATOL = RTOL = 1e-5
GRAD_ATOL = GRAD_RTOL = 1e-4
THETA_DIM, X_DIM, EMB_X_DIM, HIDDEN = 3, 4, 7, 16
BOX = 2.5


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def perturbed(params, seed=0, std=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + std * rng.standard_normal(a.shape).astype(np.float32)),
        params)


def data(n=64, x_dim=X_DIM, seed=0):
    rng = np.random.default_rng(seed)
    theta = (rng.standard_normal((n, THETA_DIM)) * 1.2 + 0.2).astype(np.float32)
    x = (theta.sum(1, keepdims=True) * 0.5 + rng.standard_normal((n, x_dim)) * 0.7 - 1.0
         ).astype(np.float32)
    return theta, x


def pair(model="resnet", embedding=False, seed=0, z_score="independent"):
    """(JAX ratio estimator, port ratio estimator with its weights, theta,
    x)."""
    theta, x = data(x_dim=EMB_X_DIM if embedding else X_DIM, seed=seed)
    jemb, temb = ((JaxFC(output_dim=5, num_hiddens=12), FCEmbedding(output_dim=5, num_hiddens=12))
                  if embedding else (None, None))
    je = jax_classifier_nn(model, z_score_theta=z_score, z_score_x=z_score, hidden_features=HIDDEN,
                           embedding_net_x=jemb, key=jax.random.PRNGKey(seed))(theta, x)
    te = classifier_nn(model, z_score_theta=z_score, z_score_x=z_score, hidden_features=HIDDEN,
                       embedding_net_x=temb, device="cpu")(theta, x)
    je.params = perturbed(je.params, seed)
    tt, xt = je.theta_transform, je.x_transform
    locs = (tt.loc, tt.scale, xt.loc, xt.scale) if z_score != "none" else ()
    load_flax_params(te, np_tree(je.params), *locs)
    return je, te, theta, x


def jax_atoms(key, B, M):
    """The (B, M) index matrix the JAX package's ``classifier_logits``
    draws from ``key``."""
    perms = jax.vmap(lambda k: jax.random.permutation(k, B - 1))(jax.random.split(key, B))
    picks = perms[:, : M - 1]
    rows = jnp.arange(B)[:, None]
    return np.asarray(jnp.concatenate([rows, picks + (picks >= rows)], axis=1))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    def arr(a):
        return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    np.testing.assert_allclose(arr(got), arr(want), rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# Classifiers and their builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model, embedding", [
    ("linear", False), ("mlp", False), ("mlp", True), ("resnet", False), ("resnet", True)])
def test_classifier_modules_match_jax(model, embedding):
    je, te, theta, x = pair(model, embedding)
    assert isinstance(te, RatioEstimator) and te.device == torch.device("cpu")
    assert te.theta_shape == (THETA_DIM,) and te.x_shape == x.shape[1:]
    want = je.log_ratio(jnp.asarray(theta), jnp.asarray(x))
    with torch.no_grad():
        got = te.log_ratio(torch.tensor(theta), torch.tensor(x))
        close(got, want, msg=model)
        close(te(torch.tensor(theta), torch.tensor(x)), want)
        params = dict(te.net.named_parameters())
        close(te.log_ratio_fn(params, torch.tensor(theta), torch.tensor(x)), want)
    assert float(np.abs(np.asarray(want)).max()) > 0.1  # the perturbed weights matter


def test_stacked_classifiers_match_jax():
    """Two members' stacked flax parameters through
    ``load_stacked_flax_params``: each member's logits as the JAX
    package's ``log_ratio_fn`` under its slice."""
    je, te, theta, x = pair("resnet", embedding=True)
    params = [perturbed(je.params, seed) for seed in (1, 2)]
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *map(np_tree, params))
    members = [te, copy.deepcopy(te)]
    tt, xt = je.theta_transform, je.x_transform
    state = load_stacked_flax_params(members, stacked, tt.loc, tt.scale, xt.loc, xt.scale)
    assert members[1].theta_transform is members[0].theta_transform
    for k, (p, member) in enumerate(zip(params, members)):
        want = je.log_ratio_fn(p, jnp.asarray(theta), jnp.asarray(x))
        with torch.no_grad():
            close(member.log_ratio(torch.tensor(theta), torch.tensor(x)), want, msg=f"member {k}")
            close(te.log_ratio_fn({n: v[k] for n, v in state.items()}, torch.tensor(theta),
                                  torch.tensor(x)), want)


@pytest.mark.parametrize("z_score", ["independent", "structured", "none"])
def test_z_scoring_matches_jax(z_score):
    je, te, theta, x = pair("mlp", z_score=z_score)
    fresh = classifier_nn("mlp", z_score_theta=z_score, z_score_x=z_score, hidden_features=HIDDEN,
                          device="cpu")(theta, x)
    for name in ("theta_transform", "x_transform"):
        jt, tt = getattr(je, name), getattr(fresh, name)
        if z_score == "none":
            assert type(tt).__name__ == type(jt).__name__ == "IdentityTransform"
            continue
        close(tt.loc, jt.loc, rtol=1e-6, atol=1e-7)
        close(tt.scale, jt.scale, rtol=1e-6, atol=1e-7)
        z = tt.forward(torch.tensor(theta if name == "theta_transform" else x))
        close(z, jt.forward(jnp.asarray(theta if name == "theta_transform" else x)), 1e-6, 1e-6)


def test_classifier_nn_errors_match_jax():
    theta, x = data()
    for factory, kw in ((jax_classifier_nn, {}), (classifier_nn, dict(device="cpu"))):
        with pytest.raises(NotImplementedError, match="Unknown classifier model"):
            factory("transformer", **kw)(theta, x)
        with pytest.raises(ValueError, match="transform_to_unconstrained"):
            factory("mlp", z_score_x="transform_to_unconstrained", **kw)(theta, x)


# ---------------------------------------------------------------------------
# classifier_logits and the losses, at the JAX package's atoms
# ---------------------------------------------------------------------------


def test_classifier_logits_match_jax():
    je, te, theta, x = pair("resnet", embedding=True)
    key = jax.random.PRNGKey(7)
    B, M = 40, 6
    want = jax_classifier_logits(je, je.params, key, jnp.asarray(theta[:B]), jnp.asarray(x[:B]), M)
    idx = jax_atoms(key, B, M)
    assert (idx[:, 0] == np.arange(B)).all()
    assert all(len(set(row)) == M for row in idx.tolist())
    with torch.no_grad():
        got = classifier_logits(te, torch.tensor(theta[:B]), torch.tensor(x[:B]), torch.tensor(idx))
    close(got, want)


def test_contrast_indices_are_distinct_other_rows():
    g = torch.Generator().manual_seed(0)
    idx = contrast_indices(12, 5, g, "cpu", batch_shape=(3,))
    assert idx.shape == (3, 12, 5)
    assert bool((idx[..., 0] == torch.arange(12)).all())
    assert all(len(set(row)) == 5 for row in idx.reshape(-1, 5).tolist())
    assert not torch.equal(idx[0], idx[1])


# (JAX class, port class, loss kwargs, num_atoms). The atoms are rebuilt
# from the key as each JAX loss draws them.
LOSSES = {
    "NRE_A": (JaxNRE_A, NRE_A, {}, 2),
    "NRE_B": (JaxNRE_B, NRE_B, {}, 10),
    "NRE_B_short": (JaxNRE_B, NRE_B, {}, 80),
    "NRE_C": (JaxNRE_C, NRE_C, dict(num_classes=4, gamma=0.7), 4),
    "BNRE": (JaxBNRE, BNRE, dict(regularization_strength=30.0), 2),
}


def _atoms_from_key(name, key, B, num_atoms, loss_kwargs):
    if name.startswith("NRE_C"):
        k1, k2, k3 = jax.random.split(key, 3)
        M = min(loss_kwargs["num_classes"], B - 1) + 1
        return (jax_atoms(k1, B, M), np.asarray(jax.random.permutation(k2, B)), jax_atoms(k3, B, M))
    M = 2 if name in ("NRE_A", "BNRE") else min(num_atoms, B)
    return (jax_atoms(key, B, M),)


@pytest.mark.parametrize("name", list(LOSSES))
def test_nre_losses_and_gradients_match_jax(name):
    jcls, tcls, loss_kwargs, num_atoms = LOSSES[name]
    je, te, theta, x = pair("resnet", embedding=True)
    B = 48
    th, xs, masks = theta[:B], x[:B], np.ones(B, np.float32)
    jtr = jcls(prior=None)
    jtr._neural_net = je
    jax_loss = jtr._make_loss_fn(num_atoms, **loss_kwargs)
    key = jax.random.PRNGKey(11)

    def mean_loss(p):
        rows = jax_loss(p, key, jnp.asarray(th), jnp.asarray(xs), jnp.asarray(masks))
        return rows.mean(), rows

    (_, rows_j), grads = jax.value_and_grad(mean_loss, has_aux=True)(je.params)
    ttr = tcls(prior=None, device="cpu")
    atoms = [torch.tensor(a) for a in _atoms_from_key(name, key, B, num_atoms, loss_kwargs)]
    rows_t = ttr._loss(te, torch.tensor(th), torch.tensor(xs), *atoms, **loss_kwargs)
    close(rows_t, rows_j, msg=name)
    rows_t.mean().backward()
    ref = load_flax_params(copy.deepcopy(te), np_tree(grads))
    for (pname, p), (_, r) in zip(te.net.named_parameters(), ref.net.named_parameters()):
        close(p.grad, r, GRAD_RTOL, GRAD_ATOL, msg=f"{name} {pname}")
    if name == "BNRE":  # the balancing term is one batch scalar on every row
        with torch.no_grad():
            logits = classifier_logits(te, torch.tensor(th), torch.tensor(xs), atoms[0])
            plain = NRE_A(prior=None, device="cpu")._loss(te, torch.tensor(th), torch.tensor(xs),
                                                          atoms[0])
        balance = float((torch.sigmoid(logits).sum(1) - 1.0).mean() ** 2)
        close(rows_t.detach() - plain, np.full(B, 30.0 * balance, np.float32))


def test_nre_names_and_defaults():
    assert AALR is SNRE_A is NRE_A and SRE is NRE is SNRE_B is NRE_B and CNRE is SNRE_C is NRE_C
    assert (NRE_A._ensemble_num_atoms, BNRE._ensemble_num_atoms, NRE_B._ensemble_num_atoms,
            NRE_C._ensemble_num_atoms) == (2, 2, 10, 10)
    trainer = NRE_A(prior=None, device="cpu")
    with pytest.raises(ValueError, match="exactly 2 atoms"):
        trainer.train(num_atoms=3)


# ---------------------------------------------------------------------------
# The ratio potential
# ---------------------------------------------------------------------------


def _priors():
    return (JaxBoxUniform(-BOX * jnp.ones(THETA_DIM), BOX * jnp.ones(THETA_DIM)),
            BoxUniform(-BOX * np.ones(THETA_DIM), BOX * np.ones(THETA_DIM), device="cpu"))


@pytest.mark.parametrize("trials", [1, 3])
def test_ratio_potential_matches_jax(trials):
    je, te, theta, x = pair("mlp", embedding=True)
    jprior, tprior = _priors()
    x_o = x[:trials]
    want = np.asarray(JaxPotential(je, jprior, jnp.asarray(x_o))(jnp.asarray(theta)))
    potential, transform = ratio_estimator_based_potential(te, tprior, x_o)
    assert isinstance(potential, RatioBasedPotential) and potential.allow_iid_x
    assert potential.device == torch.device("cpu")
    with torch.no_grad():
        got = potential(torch.tensor(theta)).numpy()
    outside = np.abs(theta).max(1) > BOX
    assert outside.any() and not outside.all()
    assert np.isneginf(got[outside]).all() and np.isneginf(want[outside]).all()
    close(got[~outside], want[~outside])
    np.testing.assert_allclose(transform.forward(torch.zeros(2, THETA_DIM)).numpy(), 0.0, atol=1e-6)


def test_ratio_potential_batched_over_x_matches_jax():
    je, te, theta, x = pair("resnet")
    jprior, tprior = _priors()
    reps, xs = 5, x[:4]
    th = np.clip(theta[: 4 * reps], -BOX + 0.1, BOX - 0.1)
    jpot = JaxPotential(je, jprior, jnp.asarray(x[:1])).batched_over_x(jnp.asarray(xs), reps)
    tpot = RatioBasedPotential(te, tprior, x[:1]).batched_over_x(torch.tensor(xs), reps)
    with torch.no_grad():
        got = tpot(torch.tensor(th))
        close(got, jpot(jnp.asarray(th)))
        # Chain i is scored against observation i // reps.
        one = RatioBasedPotential(te, tprior, x[2:3])(torch.tensor(th[2 * reps: 3 * reps]))
        close(got[2 * reps: 3 * reps], one)
