"""sbi_tpu_torch's vectorized slice sampler and MCMCPosterior, on the CPU,
against sbi_tpu's where the JAX package has the same function.

Tolerances:

- ``transformed_potential``: 1e-5 absolute plus 1e-6 relative. Both compute
  a scaled logit and log-sigmoids in float32; the potentials are of order
  10 here.
- the sampler against JAX's ``run_slice_vectorized_fsm`` on the same
  analytic 2-D Gaussian (draws are not comparable across frameworks, so
  the check is statistical): the moments within 0.1 (mean) and 0.15
  (covariance), as ``tests/test_slice_equivalence.py`` holds JAX's, and
  the C2ST between the two packages' 4,000 draws within 0.5 +- 0.06, the
  bar of that test. The C2ST is the port's ``c2st_torch`` (one 80/20
  holdout: 1,600 test points, a standard deviation of ~0.0125 at 0.5).
- the bookkeeping (thinning, the population std of the width tuning, the
  iterations past the target, ``max_total``) is deterministic and exact:
  runs on the same generator seed consume the same draws.
- the resumable state and the chunked mode: shapes, finiteness, and the
  moments within 0.15 (mean) and 0.3 (covariance), as
  ``tests/test_mcmc.py`` holds JAX's.
- init strategies: exact (a single candidate with finite weight; all -inf
  weights give index 0, as ``jax.random.categorical``); the categorical's
  frequencies within 0.015 of the probabilities over 20,000 draws (about
  4 standard deviations).
- ``sample_batched`` against a loop over the observations: each
  observation's draws lie around its own x (posterior std 0.3) and their
  means agree with the loop's within 0.15.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.samplers.mcmc.slice_fsm import run_slice_vectorized_fsm as jax_run_fsm
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu.utils.transforms import mcmc_transform as jax_mcmc_transform
from sbi_tpu.utils.transforms import transformed_potential as jax_transformed_potential
from sbi_tpu_torch.inference import LikelihoodBasedPotential, MCMCPosterior
from sbi_tpu_torch.samplers.mcmc import (
    SliceSampler,
    SliceSamplerSerial,
    SliceSamplerVectorized,
    resample_given_potential_fn,
    run_slice_vectorized_fsm,
    sir_init,
    slice_fsm,
    slice_fsm_advance,
    slice_fsm_warmup,
)
from sbi_tpu_torch.samplers.mcmc.init_strategy import categorical
from sbi_tpu_torch.utils import BoxUniform, c2st_torch, mcmc_transform, transformed_potential
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

# The correlated Gaussian of tests/test_slice_equivalence.py.
MEAN = np.array([0.8, -0.5], np.float32)
COV = np.array([[1.0, 0.6], [0.6, 0.7]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)
# The one of tests/test_mcmc.py.
MEAN2 = np.array([1.0, -2.0], np.float32)
COV2 = np.array([[1.0, 0.5], [0.5, 2.0]], np.float32)
PREC2 = np.linalg.inv(COV2).astype(np.float32)


def gaussian(mean, prec):
    m, p = torch.tensor(mean), torch.tensor(prec)

    def log_prob(theta):
        d = theta - m
        return -0.5 * torch.einsum("...i,ij,...j->...", d, p, d)

    return log_prob


log_prob = gaussian(MEAN, PREC)
logp2 = gaussian(MEAN2, PREC2)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_transformed_potential_matches_jax():
    lo, hi = np.array([-2.0, -1.0, 0.0], np.float32), np.array([3.0, 1.0, 5.0], np.float32)
    rng = np.random.default_rng(0)
    u = (3.0 * rng.normal(size=(200, 3))).astype(np.float32)
    center = np.array([0.5, 0.2, 2.0], np.float32)

    def jpot(theta, prior=JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi))):
        return -0.5 * jnp.sum((theta - center) ** 2, -1) + prior.log_prob(theta)

    prior = BoxUniform(lo, hi, device="cpu")

    def tpot(theta):
        return -0.5 * ((theta - torch.tensor(center)) ** 2).sum(-1) + prior.log_prob(theta)

    want = np.asarray(jax_transformed_potential(
        jpot, jax_mcmc_transform(JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi))))(jnp.asarray(u)))
    got = transformed_potential(tpot, mcmc_transform(prior))(torch.tensor(u)).numpy()
    assert got.shape == (200,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_fsm_matches_jax_distribution():
    n_chains, per_chain = 200, 20
    inits = (0.1 * np.random.default_rng(99).normal(size=(n_chains, 2))).astype(np.float32)
    prec = jnp.asarray(PREC)

    def jlp(theta):
        d = theta - jnp.asarray(MEAN)
        return -0.5 * jnp.einsum("...i,ij,...j->...", d, prec, d)

    s_jax = np.asarray(jax_run_fsm(jlp, jnp.asarray(inits), per_chain, thin=3, warmup_steps=60,
                                   key=jax.random.PRNGKey(1))).reshape(-1, 2)
    draws = run_slice_vectorized_fsm(log_prob, torch.tensor(inits), per_chain, thin=3,
                                     warmup_steps=60, generator=gen(2))
    assert draws.shape == (per_chain, n_chains, 2)
    s_torch = draws.reshape(-1, 2).numpy()
    for s in (s_torch, s_jax):
        np.testing.assert_allclose(s.mean(0), MEAN, atol=0.1)
        np.testing.assert_allclose(np.cov(s.T), COV, atol=0.15)
    score = float(c2st_torch(s_torch, s_jax, generator=gen(3)))
    assert 0.5 - 0.06 < score < 0.5 + 0.06, score


def test_thin_takes_every_thin_th_recorded_sweep():
    inits = torch.randn(6, 2, generator=gen(0))
    full = run_slice_vectorized_fsm(logp2, inits, 15, thin=1, warmup_steps=10, generator=gen(1))
    thinned = run_slice_vectorized_fsm(logp2, inits, 5, thin=3, warmup_steps=10, generator=gen(1))
    assert full.shape == (15, 6, 2) and thinned.shape == (5, 6, 2)
    assert torch.equal(thinned, full[2::3])


def test_no_warmup_keeps_the_initial_widths_and_chains_move():
    inits = torch.tensor(MEAN2) + torch.randn(50, 2, generator=gen(0))
    state = slice_fsm_warmup(logp2, inits, warmup_steps=0, init_width=0.7, generator=gen(1))
    assert torch.equal(state.x, inits)
    np.testing.assert_allclose(state.widths.numpy(), [0.7, 0.7])
    draws = run_slice_vectorized_fsm(logp2, inits, 120, warmup_steps=0, generator=gen(2),
                                     max_sweeps_per_program=32)
    assert draws.shape == (120, 50, 2) and bool(torch.isfinite(draws).all())
    assert not torch.allclose(draws[-1], inits)
    np.testing.assert_allclose(draws[30:].reshape(-1, 2).mean(0).numpy(), MEAN2, atol=0.2)


def test_tuned_widths_are_twice_the_population_std(monkeypatch):
    """Few warmup draws (4 chains x 2 recorded sweeps), so ddof 0 and ddof
    1 differ by 7%."""
    recorded = []
    phase = slice_fsm._fsm_phase

    def spy(*args, **kwargs):
        out = phase(*args, **kwargs)
        recorded.append(out[0].clone())
        return out

    monkeypatch.setattr(slice_fsm, "_fsm_phase", spy)
    state = slice_fsm_warmup(logp2, torch.randn(4, 2, generator=gen(0)), warmup_steps=4,
                             generator=gen(1))
    assert len(recorded) == 1 and recorded[0].shape == (2, 4, 2)
    warm = recorded[0].reshape(-1, 2).double().numpy()
    widths = state.widths.numpy()
    np.testing.assert_allclose(widths, 2 * warm.std(0, ddof=0) + 1e-3, rtol=1e-5)
    assert not np.allclose(widths, 2 * warm.std(0, ddof=1) + 1e-3, rtol=1e-3)


def _count_iterations(monkeypatch):
    count = [0]
    step = slice_fsm._fsm_iteration

    def counted(*args, **kwargs):
        count[0] += 1
        return step(*args, **kwargs)

    monkeypatch.setattr(slice_fsm, "_fsm_iteration", counted)
    return count


def test_iterations_past_the_target_leave_the_draws_unchanged(monkeypatch):
    count = _count_iterations(monkeypatch)
    inits = torch.randn(8, 2, generator=gen(0))
    widths = torch.ones(2)
    runs = {}
    for block in (1, 64):
        monkeypatch.setattr(slice_fsm, "SYNC_EVERY", block)
        count[0] = 0
        draws, _ = slice_fsm._fsm_phase(logp2, gen(1), widths, inits, 5, 2, 50, 100, 10_000)
        runs[block] = (draws, count[0])
    (d1, n1), (d64, n64) = runs[1], runs[64]
    assert n64 > n1 and n64 % 64 == 0
    assert torch.equal(d1, d64)


def test_max_total_is_held_exactly(monkeypatch):
    count = _count_iterations(monkeypatch)
    monkeypatch.setattr(slice_fsm, "SYNC_EVERY", 4)
    draws, x = slice_fsm._fsm_phase(logp2, gen(1), torch.ones(2), torch.zeros(3, 2), 1000, 0,
                                    50, 100, 7)
    assert count[0] == 7
    assert draws.shape == (1000, 3, 2) and bool(torch.isfinite(x).all())


def test_resumable_state_and_chunked_runs():
    """As tests/test_mcmc.py::test_fsm_resumable_state_and_bounded_programs."""
    inits = torch.randn(50, 2, generator=gen(0))
    g = gen(1)
    state = slice_fsm_warmup(logp2, inits, warmup_steps=100, generator=g)
    assert state.x.shape == (50, 2) and state.widths.shape == (2,)
    parts = []
    for _ in range(3):
        draws, state2 = slice_fsm_advance(logp2, state, 40, generator=g)
        assert draws.shape == (40, 50, 2)
        assert bool(torch.isfinite(state2.x).all())
        assert not torch.allclose(state2.x, state.x)
        assert torch.equal(state2.widths, state.widths)
        parts.append(draws)
        state = state2
    flat = torch.cat(parts).reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), MEAN2, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV2, atol=0.3)

    draws = run_slice_vectorized_fsm(logp2, inits, 100, warmup_steps=80, generator=gen(2),
                                     max_sweeps_per_program=64)
    assert draws.shape == (100, 50, 2)
    flat = draws.reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), MEAN2, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV2, atol=0.3)

    thinned = run_slice_vectorized_fsm(logp2, inits, 20, thin=3, warmup_steps=20,
                                       generator=gen(3), max_sweeps_per_program=16)
    assert thinned.shape == (20, 50, 2)


class _Grid:
    """A proposal whose n candidates are the rows [i, i], i < n."""

    def sample(self, sample_shape, generator=None):
        return torch.arange(sample_shape[0], dtype=torch.float32)[:, None].repeat(1, 2)

    def log_prob(self, theta):
        return torch.zeros(theta.shape[0])


@pytest.mark.parametrize("init", ["resample", "sir"])
def test_init_strategies_pick_the_only_finite_candidate(init):
    def one_finite(theta):
        lp = torch.full((theta.shape[0],), -torch.inf)
        lp[theta[:, 0] == 7] = 0.0
        lp[theta[:, 0] == 3] = torch.nan  # NaN counts as -inf
        return lp

    def none_finite(theta):
        return torch.full((theta.shape[0],), -torch.inf)

    if init == "resample":
        run = lambda pot: resample_given_potential_fn(_Grid(), pot, 25, 100, generator=gen(0))
    else:
        run = lambda pot: sir_init(_Grid(), pot, 25, 4, 25, generator=gen(0))
    assert torch.equal(run(one_finite), torch.full((25, 2), 7.0))
    assert torch.equal(run(none_finite), torch.zeros(25, 2))
    # jax.random.categorical gives index 0 for a row of -inf too.
    jax_idx = jax.random.categorical(jax.random.PRNGKey(0), jnp.full((9,), -jnp.inf), shape=(4,))
    assert np.asarray(jax_idx).tolist() == [0, 0, 0, 0]


def test_categorical_frequencies():
    p = torch.tensor([[0.2, 0.3, 0.5], [0.7, 0.0, 0.3]])
    idx = categorical(torch.log(p), 20_000, gen(0))
    assert idx.shape == (2, 20_000)
    freq = torch.stack([(idx == k).float().mean(1) for k in range(3)], 1)
    np.testing.assert_allclose(freq.numpy(), p.numpy(), atol=0.015)
    assert not bool((idx[1] == 1).any())


class _GaussianLikelihood:
    """A likelihood estimator stub: x ~ N(theta, 0.3^2 I)."""

    device = torch.device("cpu")

    def log_prob(self, input, condition):  # (S, B, 2), (B, 2) -> (S, B)
        return -0.5 * ((input - condition) ** 2).sum(-1) / 0.09


XS = np.array([[-1.5, -1.5], [0.0, 1.0], [1.5, -1.0]], np.float32)


def test_sample_batched_matches_a_loop_over_observations():
    prior = BoxUniform(-3 * np.ones(2), 3 * np.ones(2), device="cpu")
    potential = LikelihoodBasedPotential(_GaussianLikelihood(), prior)
    post = MCMCPosterior(potential, proposal=prior, theta_transform=mcmc_transform(prior),
                         num_chains=20, warmup_steps=30)
    out = post.sample_batched((200,), torch.tensor(XS), generator=gen(0))
    assert out.shape == (200, 3, 2)
    assert bool(prior.within_support(out.reshape(-1, 2)).all())
    for b, x in enumerate(XS):
        loop = post.sample((200,), x=x, generator=gen(1 + b))
        np.testing.assert_allclose(out[:, b].mean(0).numpy(), x, atol=0.15)
        np.testing.assert_allclose(out[:, b].mean(0).numpy(), loop.mean(0).numpy(), atol=0.15)

    # A potential without batched_over_x runs the loop itself.
    plain = MCMCPosterior(lambda theta, x_o: potential.batched_over_x(x_o, theta.shape[0])(theta),
                          proposal=prior, theta_transform=mcmc_transform(prior), num_chains=20,
                          warmup_steps=30, device="cpu")
    out2 = plain.sample_batched((100,), torch.tensor(XS), generator=gen(5))
    assert out2.shape == (100, 3, 2)
    np.testing.assert_allclose(out2.mean(0).numpy(), XS, atol=0.15)


def test_sample_interleaves_the_chains():
    prior = BoxUniform(-3 * np.ones(2), 3 * np.ones(2), device="cpu")
    post = MCMCPosterior(lambda theta: logp2(theta) + prior.log_prob(theta), proposal=prior,
                         theta_transform=mcmc_transform(prior), num_chains=7, warmup_steps=10,
                         init_strategy="proposal", device="cpu")
    samples = post.sample((30,), generator=gen(0))
    draws = post._last_chain_draws  # (per chain, chains, D)
    assert samples.shape == (30, 2) and draws.shape == (5, 7, 2)
    assert torch.equal(samples, draws.reshape(-1, 2)[:30])
    assert torch.equal(samples[7], draws[1, 0])
    assert torch.equal(post._latest_sample, samples[-7:])
    log_prob_value = post.log_prob(samples[:4])
    assert log_prob_value.shape == (4,) and bool(torch.isfinite(log_prob_value).all())
    with pytest.raises(ImportError, match="arviz"):
        post.get_arviz_inference_data()


def test_methods_and_later_slice_options():
    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    pot = lambda theta: prior.log_prob(theta)
    for name in ("slice_np", "slice_np_vectorized", "slice", "slice_pymc", "slice_jax"):
        assert MCMCPosterior(pot, proposal=prior, method=name, device="cpu").method.startswith("slice")
    for name in ("hmc", "nuts", "nuts_pyro", "hmc_pymc"):
        assert MCMCPosterior(pot, proposal=prior, method=name, device="cpu").method == name.split("_")[0]
    with pytest.raises(NotImplementedError, match="not supported"):
        MCMCPosterior(pot, proposal=prior, method="gibbs", device="cpu")
    post = MCMCPosterior(pot, proposal=prior, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        post.sample((5,), mesh="auto")
    nuts = post.sample((5,), method="nuts", num_chains=5, warmup_steps=3, max_tree_depth=3)
    assert nuts.shape == (5, 2) and bool(prior.within_support(nuts).all())
    with pytest.raises(ValueError, match="max_sweeps_per_program"):
        post.sample((5,), max_sweeps_per_program=0)


def test_slice_sampler_classes():
    init = torch.zeros(4, 2)
    for cls in (SliceSamplerVectorized, SliceSamplerSerial):
        out = cls(log_prob, init, num_chains=4, thin=2, tuning=10).run(20, generator=gen(0))
        assert isinstance(out, np.ndarray) and out.shape == (4, 5, 2)
    one = SliceSampler(np.zeros(2), log_prob, tuning=10).gen(6, generator=gen(1))
    assert one.shape == (6, 2) and np.isfinite(one).all()
