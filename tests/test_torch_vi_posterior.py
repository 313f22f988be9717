"""sbi_tpu_torch's VIPosterior entry points, on the CPU.

- The optimizer of ``train`` (``optax.chain(clip_by_global_norm,
  adam(exponential_decay(lr, 100, gamma)))``, with gamma 1 that of
  ``train_amortized``) over 300 steps of a fixed gradient sequence whose
  global norm exceeds the clip at about a third of them: parameters within
  1e-5 of optax's.
- The amortized loss on a bridged conditional NSF (the JAX package's
  ``train_amortized`` loss, each observation's particles drawn from its own
  key), with a bridged NLE likelihood potential (a 2-D x given a 3-D theta)
  and a box prior's link transform: the loss within 1e-5 absolute plus
  1e-5 relative and its gradient in every parameter within 1e-4 absolute
  plus 1e-3 relative to the parameter's largest, as test_torch_vi.py holds
  the divergences. The port scores all observations in one flow pass
  (each condition tiled into rows), the JAX package vmaps over them.
- ``train_amortized`` end to end: ``sample(x=...)`` for each observation.
- ``sample_with="vi"`` (and ``VIPosteriorParameters``) from NPE, NLE and
  NRE builds a ``VIPosterior`` that trains and samples; ``q="naf"`` and
  ``"unaf"`` raise ``NotImplementedError``.
- tests/test_vi.py::test_vi_evaluate_psis at its sizes (rKL, 1,500
  iterations at lr 1e-3, N = 2,000): PSIS k-hat < 0.7; the quality checks
  of ``samplers/vi`` agree, and SIR sampling recovers the mean.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sbi_tpu.inference.posteriors import vi_posterior as jvi
from sbi_tpu.inference.potentials.likelihood_based_potential import (
    LikelihoodBasedPotential as JaxLikelihoodBasedPotential,
)
from sbi_tpu.neural_nets.net_builders.flow import build_nsf as jax_build_nsf
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu.utils.transforms import mcmc_transform as jax_mcmc_transform
from sbi_tpu_torch.inference import (
    NLE,
    NPE,
    NRE_B,
    LikelihoodBasedPotential,
    VIPosterior,
    VIPosteriorParameters,
)
from sbi_tpu_torch.inference.posteriors import vi_posterior as tvi
from sbi_tpu_torch.samplers.vi import proportional_to_joint_diagnostics, psis_diagnostics
from sbi_tpu_torch.utils import BoxUniform, mcmc_transform, seed_all_backends
from sbi_tpu_torch.utils.params_bridge import load_flax_params

from .test_torch_flows import make_pair
from .test_torch_nre import pair as nre_pair
from .test_torch_vi import ATOL, RTOL, _assert_grads_close, _perturbed
from .test_torch_vi_fit import MEAN, trained_vi
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)


def _posteriors():
    je, te, x, _ = make_pair(2, x_dim=3)  # a likelihood of a 2-D x given a 3-D theta
    lo, hi = -3 * np.ones(3, np.float32), 3 * np.ones(3, np.float32)
    jprior, tprior = JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)), BoxUniform(lo, hi, device="cpu")
    jpost = jvi.VIPosterior(JaxLikelihoodBasedPotential(je, jprior), prior=jprior,
                            theta_transform=jax_mcmc_transform(jprior))
    tpost = VIPosterior(LikelihoodBasedPotential(te, tprior), prior=tprior,
                        theta_transform=mcmc_transform(tprior), device="cpu")
    return jpost, tpost, x, tprior


def test_amortized_loss_matches_jax():
    jpost, tpost, x, _ = _posteriors()
    xs = x[:3]
    X, n = xs.shape[0], 32
    tile = np.arange(8) % X
    jest = jax_build_nsf(jnp.zeros((8, 3)), jnp.asarray(xs[tile]), z_score_theta="none",
                         hidden_features=32, num_transforms=3, key=jax.random.PRNGKey(0))
    params = _perturbed(jest.params, 1)
    ct = jest.condition_transform
    test_ = tpost._amortized_estimator(torch.tensor(xs))
    load_flax_params(test_, params, condition_loc=np.asarray(ct.loc), condition_scale=np.asarray(ct.scale))
    jxfn, tt = jpost._pure_potential_xfn(), jpost.theta_transform
    key = jax.random.PRNGKey(5)

    def jloss(p):  # the JAX package's train_amortized loss
        def per_x(k_i, x_i):
            u, log_q = jest.net.apply(p, k_i, n, jest._embed_condition(x_i[None]),
                                      method="sample_and_log_prob")
            theta, ldj = tt.inverse_and_log_det(u[:, 0, :])
            return jnp.mean(log_q[:, 0] - (jxfn(theta, x_i) + ldj))

        return jnp.mean(jax.vmap(per_x)(jax.random.split(key, X), jnp.asarray(xs)))

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jax.tree_util.tree_map(jnp.asarray, params))
    # Observation i's particles from its own key, in sample-major rows.
    z = np.stack([np.asarray(jax.random.normal(k, (n, 3))) for k in jax.random.split(key, X)], axis=1)
    loss = tvi._amortized_loss(test_, tpost._pure_potential_xfn(), tpost.theta_transform,
                               torch.tensor(xs), torch.tensor(z.reshape(n * X, 3)))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), atol=ATOL, rtol=RTOL)
    holder = tpost._amortized_estimator(torch.tensor(xs))
    load_flax_params(holder, jax.tree_util.tree_map(np.asarray, jgrads))
    _assert_grads_close({k: v.grad for k, v in test_.net.named_parameters()},
                        dict(holder.net.named_parameters()))


@pytest.mark.parametrize("gamma", [0.9, 1.0])
def test_optimizer_schedule_and_clip_match_optax(gamma):
    rng = np.random.default_rng(4)
    init = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    # Global norms from 0 to ~8.7: the clip at 5 acts on about a third of the steps.
    grad = lambda xp, p, i: (1.5 + 1.5 * math.sin(0.05 * i)) * xp.sin(3.0 * p + 0.1 * i)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(optax.exponential_decay(1e-2, 100, gamma)))
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    opt = tvi._ScheduledAdam(tp.values(), 1e-2, gamma, 5.0)
    clipped = 0
    for i in range(300):
        g = jax.tree_util.tree_map(lambda p: grad(jnp, p, i), jp)
        clipped += float(optax.global_norm(g)) > 5.0
        updates, state = update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p in tp.values():
            p.grad = grad(torch, p.detach(), i)
        opt.step()
    assert 30 < clipped < 270
    for k in init:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=ATOL, rtol=0)


def test_train_amortized_samples_every_observation():
    seed_all_backends(0)  # the conditional q's initial weights
    _, tpost, x, prior = _posteriors()
    g = torch.Generator().manual_seed(0)
    tpost.train_amortized(x[:2], n_particles=16, max_num_iters=30, generator=g)
    for x_i in x[:2]:
        samples = tpost.sample((40,), x=x_i[None], generator=g)
        assert samples.shape == (40, 3) and bool(prior.within_support(samples).all())


def test_sample_with_vi_from_npe_nle_and_nre():
    _, te, theta, x = make_pair(2, x_dim=2)
    prior = BoxUniform(-5 * np.ones(2), 5 * np.ones(2), device="cpu")
    npe = NPE(prior=prior, device="cpu").build_posterior(density_estimator=te, sample_with="vi",
                                                         vi_parameters=dict(q="nsf"))
    nle = NLE(prior=prior, device="cpu").build_posterior(
        density_estimator=te, posterior_parameters=VIPosteriorParameters(q="gaussian_diag"))
    _, re, _, _ = nre_pair()
    rprior = BoxUniform(-3 * np.ones(re.input_shape[0]), 3 * np.ones(re.input_shape[0]),
                        device="cpu")
    nre = NRE_B(prior=rprior, device="cpu").build_posterior(ratio_estimator=re, sample_with="vi",
                                                            vi_parameters=dict(vi_method="IW"))
    for post, q in ((npe, "nsf"), (nle, "gaussian_diag"), (nre, "maf")):
        assert isinstance(post, VIPosterior) and post._q_name == q
    g = torch.Generator().manual_seed(0)
    npe.set_default_x(x[:1]).train(max_num_iters=20, n_particles=32, generator=g)
    samples = npe.sample((50,), generator=g)
    assert samples.shape == (50, 2) and bool(prior.within_support(samples).all())
    assert npe.log_prob(samples).shape == (50,)
    with pytest.raises(NotImplementedError):
        npe.sample_batched((5,), x=x[:2])


@pytest.mark.parametrize("q", ["naf", "unaf"])
def test_monotone_q_is_a_later_slice(q):
    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        VIPosterior(lambda theta: prior.log_prob(theta), prior=prior, q=q, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tvi._make_q_flow(2, q)
    with pytest.raises(NotImplementedError, match="Unknown q"):
        tvi._make_q_flow(2, "other")


def test_psis_k_hat_of_a_well_fit_q():
    """tests/test_vi.py::test_vi_evaluate_psis: 1,500 iterations, N = 2,000."""
    vi = trained_vi("rKL", iters=1500, lr=1e-3)
    k_hat = vi.evaluate(N=2000, generator=torch.Generator().manual_seed(1))
    assert k_hat < 0.7, k_hat
    g = torch.Generator().manual_seed(2)
    q_sample = lambda gen, N: vi.sample((N,), generator=gen)
    assert psis_diagnostics(vi.potential_fn, q_sample, vi.log_prob, N=2000, generator=g) < 0.7
    assert proportional_to_joint_diagnostics(vi.potential_fn, q_sample, vi.log_prob, generator=g) > 0.9
    sir = vi.sample((2000,), generator=g, method="sir", oversampling_factor=8).numpy()
    assert np.allclose(sir.mean(0), MEAN, atol=0.2)


