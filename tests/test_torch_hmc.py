"""sbi_tpu_torch's HMC and NUTS against sbi_tpu's, on the CPU.

Deterministic parity (the same inputs, numpy arrays from a seed, given to
both packages):

- ``_leapfrog`` on the analytic Gaussian of tests/test_mcmc.py and on a
  bridged NLE-NSF likelihood potential (x 2-D through autoregressive
  splines, conditioned on a 2-D theta, as two_moons'): theta, momentum,
  potential and gradient within 1e-5 absolute (1e-4 through the flow,
  whose log-prob tolerance it is).
- ``_is_uturn`` on random inputs: the same booleans.
- one HMC step and one NUTS step of the port, on the JAX package's draws
  replayed from its keys (the momenta, the acceptance uniform, the
  trajectory length; NUTS's directions, leaf and merge uniforms): the same
  proposal within 1e-5 and the same acceptance statistic within 1e-5.
  So the lockstep NUTS builds each chain's tree as the JAX package's
  per-chain loop does.
- the warmup with one deterministic step function given to both packages:
  the same step size and inverse mass within 1e-5 relative, with and
  without ``max_sweeps_per_program``.

Statistical: HMC, NUTS and jittered NUTS on tests/test_mcmc.py's Gaussian
and banana at its sizes and tolerances; ``MCMCPosterior(method="nuts")``
end to end on a tiny NLE; every ``hmc`` / ``nuts`` alias.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference.potentials.likelihood_based_potential import (
    LikelihoodBasedPotential as JaxLikelihoodBasedPotential,
)
from sbi_tpu.samplers.mcmc import hmc as jhmc
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu_torch.inference import NLE, LikelihoodBasedPotential, MCMCPosterior
from sbi_tpu_torch.inference.posteriors.mcmc_posterior import _METHOD_ALIASES
from sbi_tpu_torch.neural_nets import likelihood_nn
from sbi_tpu_torch.samplers.mcmc import hmc, run_hmc, run_nuts, run_nuts_jittered
from sbi_tpu_torch.simulators import two_moons_simulator
from sbi_tpu_torch.utils import BoxUniform

from .test_torch_flows import make_pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
FLOW_ATOL = 1e-4
COV = np.array([[1.0, 0.5], [0.5, 2.0]], np.float32)
MEAN = np.array([1.0, -2.0], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def _gauss(xp):
    prec, mean = xp.asarray(PREC), xp.asarray(MEAN)

    def logp(th):
        d = th - mean
        return -0.5 * ((d @ prec) * d).sum(-1)

    return logp


def _banana(th):
    x, y = th[:, 0], th[:, 1]
    return -0.5 * x**2 - 0.5 * (y - x**2) ** 2 / 0.1


_FLOW_POTENTIALS = {}


def _flow_potentials():
    """(JAX potential, the port's) of a bridged NLE-NSF at one x_o, a box
    prior of half-width 4 on the 2-D theta."""
    if not _FLOW_POTENTIALS:
        je, te, x, _ = make_pair(2, x_dim=2)
        lo, hi = -4 * np.ones(2, np.float32), 4 * np.ones(2, np.float32)
        jpot = JaxLikelihoodBasedPotential(je, JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)),
                                           x_o=jnp.asarray(x[:1]))
        tpot = LikelihoodBasedPotential(te, BoxUniform(lo, hi, device="cpu"), x_o=x[:1])
        _FLOW_POTENTIALS.update(jax=jpot, torch=tpot)
    return _FLOW_POTENTIALS["jax"], _FLOW_POTENTIALS["torch"]


def _inputs(C, D, seed):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-1.5, 1.5, (C, D)).astype(np.float32)
    mom = rng.normal(size=(C, D)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, D).astype(np.float32)
    return theta, mom, inv_mass


@pytest.mark.parametrize("target", ["gaussian", "nle_nsf"])
def test_leapfrog_matches_jax(target):
    if target == "gaussian":
        jlogp, tlogp, atol = _gauss(jnp), _gauss(torch), ATOL
    else:
        jpot, tpot = _flow_potentials()
        jlogp, tlogp, atol = (lambda t: jpot(t)), tpot, FLOW_ATOL
    theta, mom, inv_mass = _inputs(6, 2, 0)
    step_size, num_steps = 0.15, 5
    jgrad = jax.value_and_grad(lambda th: jlogp(th[None])[0])
    jfn = jax.jit(jax.vmap(lambda th, m: jhmc._leapfrog(
        th, m, jgrad(th)[1], step_size, jnp.asarray(inv_mass), jgrad, num_steps)))
    want = jfn(jnp.asarray(theta), jnp.asarray(mom))
    lg = hmc._value_and_grad(tlogp)
    th0 = torch.tensor(theta)
    got = hmc._leapfrog(th0, torch.tensor(mom), lg(th0)[1], step_size, torch.tensor(inv_mass),
                        lg, num_steps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def test_is_uturn_matches_jax():
    rng = np.random.default_rng(3)
    args = [rng.normal(size=(500, 3)).astype(np.float32) for _ in range(4)]
    inv_mass = rng.uniform(0.2, 2.0, 3).astype(np.float32)
    want = jax.vmap(jhmc._is_uturn, in_axes=(0, 0, 0, 0, None))(
        *map(jnp.asarray, args), jnp.asarray(inv_mass))
    got = hmc._is_uturn(*map(torch.tensor, args), torch.tensor(inv_mass))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 500


class _Replay:
    """The draws of one step per chain, replayed from the JAX package's
    keys exactly as its per-chain steps consume them."""

    def __init__(self, keys, D, num_leapfrog=None, max_depth=None):
        per_chain = [self._chain(k, D, num_leapfrog, max_depth) for k in keys]
        self.d = {name: torch.tensor(np.stack([c[name] for c in per_chain], axis=-1))
                  for name in per_chain[0]}

    @staticmethod
    def _chain(key, D, num_leapfrog, max_depth):
        u = lambda k: float(jax.random.uniform(k))
        if num_leapfrog is not None:  # _make_hmc_step
            k_mom, k_acc, k_jit = jax.random.split(key, 3)
            return {"momentum": np.asarray(jax.random.normal(k_mom, (D,))), "accept": u(k_acc),
                    "num_steps": int(jax.random.randint(k_jit, (), 1, num_leapfrog + 1))}
        k_mom, kk = jax.random.split(key)  # _make_nuts_step
        out = {"momentum": np.asarray(jax.random.normal(k_mom, (D,)))}
        for depth in range(max_depth):
            kk, k_dir, k_sub, k_merge = jax.random.split(kk, 4)
            assert bool(jax.random.bernoulli(k_dir)) == (u(k_dir) < 0.5)
            out[f"direction{depth}"], out[f"merge{depth}"] = u(k_dir) < 0.5, u(k_merge)
            leaves = []
            for _ in range(1 << depth):
                k_sub, k_sel = jax.random.split(k_sub)
                leaves.append(u(k_sel))
            out[f"leaves{depth}"] = np.asarray(leaves, np.float32)
        return out

    def momentum(self):
        return self.d["momentum"].T.float()

    def accept(self):
        return self.d["accept"].float()

    def num_steps(self, high):
        return self.d["num_steps"]

    def direction(self, depth):
        return self.d[f"direction{depth}"]

    def leaves(self, depth):
        return self.d[f"leaves{depth}"].float()

    def merge(self, depth):
        return self.d[f"merge{depth}"].float()


@pytest.mark.parametrize("kind", ["hmc", "hmc_jitter", "nuts"])
def test_step_on_replayed_draws_matches_jax(kind):
    C, D = 8, 2
    theta, _, inv_mass = _inputs(C, D, 4)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jlogp, tlogp = _gauss(jnp), _gauss(torch)
    lg = hmc._value_and_grad(tlogp)
    th = torch.tensor(theta)
    state = (th, *lg(th))
    for step_size in (0.3, 0.9):
        if kind == "nuts":
            jstep = jhmc._make_nuts_step(jlogp, D, 6)
            step, draws = hmc._make_nuts_step(lg, 6), _Replay(keys, D, max_depth=6)
        else:
            jitter = kind == "hmc_jitter"
            jstep = jhmc._make_hmc_step(jlogp, D, 8, jitter)
            step, draws = hmc._make_hmc_step(lg, 8, jitter), _Replay(keys, D, num_leapfrog=8)
        want_th, want_alpha = jax.jit(jax.vmap(jstep, in_axes=(0, 0, None, None)))(
            jnp.asarray(theta), keys, step_size, jnp.asarray(inv_mass))
        (got_th, got_lp, got_g), got_alpha = step(
            state, torch.tensor(step_size), torch.tensor(inv_mass), draws)
        np.testing.assert_allclose(got_th.numpy(), np.asarray(want_th), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha), atol=ATOL, rtol=0)
        lp, g = lg(got_th)
        np.testing.assert_allclose(got_lp.numpy(), lp.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got_g.numpy(), g.numpy(), atol=ATOL, rtol=0)
        assert not np.allclose(np.asarray(want_th), theta)  # the chains moved


def _jax_det_step(th, k, step_size, inv_mass):
    """A deterministic step for the JAX package's warmup: it ignores its key."""
    return (0.8 * th + 0.1 * step_size * jnp.sqrt(inv_mass),
            jax.nn.sigmoid(2.0 - 4.0 * step_size + 0.1 * jnp.sum(th)))


def _torch_det_step(state, step_size, inv_mass, draws):
    th = state[0]
    return ((0.8 * th + 0.1 * step_size * torch.sqrt(inv_mass),),
            torch.sigmoid(2.0 - 4.0 * step_size + 0.1 * th.sum(-1)))


@pytest.mark.parametrize("max_sweeps", [None, 10])
def test_warmup_adaptation_matches_jax(max_sweeps):
    theta = np.random.default_rng(6).normal(size=(16, 3)).astype(np.float32) * 2.0
    want = jhmc._adaptive_warmup(jnp.asarray(theta), jax.random.PRNGKey(0), 0.8,
                                 step_fn=_jax_det_step, warmup_steps=25,
                                 max_sweeps_per_program=max_sweeps)
    state, step_size, inv_mass = hmc._adaptive_warmup(
        (torch.tensor(theta),), 0.8, _torch_det_step, 25, None, max_sweeps)
    for g, w in zip((state[0], step_size, inv_mass), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert abs(float(step_size) - 0.1) > 0.03  # adapted away from its 0.1 start


RUNNERS = {"hmc": run_hmc, "nuts": run_nuts, "nuts_jittered": run_nuts_jittered}


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_exactness_on_the_gaussian(runner):
    """tests/test_mcmc.py::test_mcmc_exactness: 50 chains, 300 draws each
    after 100 warmup steps."""
    inits = torch.randn(50, 2, generator=torch.Generator().manual_seed(0))
    draws = RUNNERS[runner](_gauss(torch), inits, num_samples=300, warmup_steps=100,
                            generator=torch.Generator().manual_seed(1))
    assert draws.shape == (300, 50, 2)
    flat = draws.reshape(-1, 2).numpy()
    assert np.allclose(flat.mean(0), MEAN, atol=0.15), flat.mean(0)
    assert np.allclose(np.cov(flat.T), COV, atol=0.3)


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_banana_moments(runner):
    """tests/test_mcmc.py::test_mcmc_banana_moments: 100 chains, 400 draws
    each after 300 warmup steps; E[x] = 0, Var[x] = 1, E[y] = 1."""
    inits = torch.randn(100, 2, generator=torch.Generator().manual_seed(2))
    draws = RUNNERS[runner](_banana, inits, num_samples=400, warmup_steps=300,
                            generator=torch.Generator().manual_seed(3))
    flat = draws.reshape(-1, 2).numpy()
    assert abs(flat[:, 0].mean()) < 0.15
    assert abs(flat[:, 0].var() - 1.0) < 0.25
    assert abs(flat[:, 1].mean() - 1.0) < 0.25


def test_nuts_syncs_once_per_doubling_and_thins(monkeypatch):
    """At most max_tree_depth - 1 host reads a NUTS step, 2^depth
    leapfrogs a doubling; ``thin`` keeps every thin-th step and
    ``max_sweeps_per_program`` rounds warmup up to whole blocks without
    changing sampling's length."""
    counts = {"syncs": 0, "leapfrogs": 0}
    all_done, leapfrog1 = hmc._all_done, hmc._leapfrog1

    def counted_sync(done):
        counts["syncs"] += 1
        return all_done(done)

    def counted_leapfrog(*args):
        counts["leapfrogs"] += 1
        return leapfrog1(*args)

    monkeypatch.setattr(hmc, "_all_done", counted_sync)
    monkeypatch.setattr(hmc, "_leapfrog1", counted_leapfrog)
    inits = torch.randn(10, 2, generator=torch.Generator().manual_seed(0))
    draws = run_nuts(_gauss(torch), inits, num_samples=4, thin=3, warmup_steps=5,
                     max_tree_depth=4, generator=torch.Generator().manual_seed(1),
                     max_sweeps_per_program=4)
    steps = 8 + 12  # warmup in two blocks of 4, then 4 x 3 recorded steps
    assert draws.shape == (4, 10, 2)
    assert counts["syncs"] <= 3 * steps
    assert steps <= counts["leapfrogs"] <= (1 + 2 + 4 + 8) * steps


def test_mcmc_posterior_nuts_end_to_end_on_a_tiny_nle():
    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    g = torch.Generator().manual_seed(0)
    theta = prior.sample((300,), generator=g)
    x = two_moons_simulator(theta, generator=g)
    small = likelihood_nn("nsf", hidden_features=8, num_transforms=1, device="cpu")
    trainer = NLE(prior=prior, density_estimator=small, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer.append_simulations(theta, x).train(max_num_epochs=3)
    posterior = trainer.build_posterior(mcmc_method="nuts",
                                        mcmc_parameters=dict(num_chains=6, warmup_steps=10))
    assert posterior.method == "nuts"
    samples = posterior.sample((24,), x=x[:1], generator=g, max_tree_depth=4)
    assert samples.shape == (24, 2) and bool(torch.isfinite(samples).all())
    assert bool(prior.within_support(samples).all())
    draws = posterior.sample((12,), x=x[:1], generator=g, method="hmc_pyro", num_leapfrog=3)
    assert draws.shape == (12, 2) and bool(prior.within_support(draws).all())
    assert posterior._last_chain_draws.shape == (2, 6, 2)


def test_every_alias_resolves():
    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    pot = lambda theta: prior.log_prob(theta)
    for name in ("hmc", "hmc_pyro", "hmc_pymc", "nuts", "nuts_pyro", "nuts_pymc"):
        post = MCMCPosterior(pot, proposal=prior, method=name, num_chains=4, warmup_steps=3,
                             device="cpu")
        assert post.method == _METHOD_ALIASES[name] == name.split("_")[0]
        assert post.sample((8,), generator=torch.Generator().manual_seed(0)).shape == (8, 2)
