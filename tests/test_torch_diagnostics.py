"""sbi_tpu_torch's SBC, TARP and misspecification checks against sbi_tpu's,
on the CPU.

- From the same posterior samples and reference points, the marginal SBC
  ranks and the TARP coverage counts equal the JAX package's exactly (the
  coverage fractions within 1e-7).
- tests/test_diagnostics.py's calibrated and miscalibrated cases rerun on
  the port, with its thresholds (the draws are torch's).
- The slice as a whole: Hodgkin-Huxley summaries of the same neurons on
  the same noise in each package, a small NSF posterior with the same
  (bridged) weights, and the log-prob ranks of the same draws: equal
  counts. The port scores the draws by one ``log_prob_batched`` call,
  the JAX package observation by observation; the port's own loop gives
  the same ranks.
- Misspecification: the MMD kernel scale and statistic in the estimator's
  z-scored space within 1e-5 of the JAX package's; the permutation
  p-values (torch's and JAX's permutations differ) on the same side of
  0.05, above it for an observation from the simulations and below for
  an outlier; the log-prob p-value equal with an analytic marginal in each
  package.
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sbi_tpu.diagnostics.misspecification as JM
from sbi_tpu.diagnostics.sbc import _run_sbc_ranks as jax_sbc_ranks
from sbi_tpu.diagnostics.sbc import run_sbc as jax_run_sbc
from sbi_tpu.diagnostics.tarp import run_tarp as jax_run_tarp
from sbi_tpu.inference.posteriors import DirectPosterior as JaxDirectPosterior
from sbi_tpu.neural_nets.net_builders.flow import build_nsf as jax_build_nsf
from sbi_tpu.utils.distributions import MultivariateNormal as JaxMultivariateNormal
from sbi_tpu_torch.diagnostics import (
    calc_misspecification_logprob,
    calc_misspecification_mmd,
    check_sbc,
    check_tarp,
    get_nltp,
    run_sbc,
    run_tarp,
)
from sbi_tpu_torch.diagnostics.misspecification import mmd_scale
from sbi_tpu_torch.diagnostics.sbc import _run_sbc_ranks
from sbi_tpu_torch.inference.posteriors import DirectPosterior
from sbi_tpu_torch.neural_nets.net_builders.flow import build_nsf
from sbi_tpu_torch.simulators import hh_prior, summary_statistics
from sbi_tpu_torch.utils import MultivariateNormal
from sbi_tpu_torch.utils.params_bridge import load_flax_params
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

JHH = importlib.import_module("sbi_tpu.simulators.hodgkin_huxley")
THH = importlib.import_module("sbi_tpu_torch.simulators.hodgkin_huxley")


class _FixedJax:
    """A JAX-side posterior that hands out fixed samples."""

    def __init__(self, samples):
        self.samples = jnp.asarray(samples)

    def sample_batched(self, sample_shape, xs, key=None, **kwargs):
        return self.samples


class _FixedTorch:
    def __init__(self, samples):
        self.samples = torch.as_tensor(samples)
        self._device = torch.device("cpu")

    def sample_batched(self, sample_shape, xs, generator=None, **kwargs):
        return self.samples


def _fixed_problem(n=100, L=120, d=2, seed=0):
    rng = np.random.default_rng(seed)
    thetas = rng.normal(size=(n, d)).astype(np.float32)
    xs = (thetas + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    samples = (0.8 * xs[None] + 0.45 * rng.normal(size=(L, n, d))).astype(np.float32)
    references = rng.uniform(size=(n, d)).astype(np.float32)
    return thetas, xs, samples, references


def test_sbc_ranks_and_tarp_from_the_same_samples_equal_jax():
    thetas, xs, samples, refs = _fixed_problem()
    L = samples.shape[0]
    ranks_j, dap_j = jax_run_sbc(jnp.asarray(thetas), jnp.asarray(xs), _FixedJax(samples),
                                 num_posterior_samples=L, key=jax.random.PRNGKey(0))
    ranks_t, dap_t = run_sbc(thetas, xs, _FixedTorch(samples), num_posterior_samples=L)
    assert ranks_t.dtype == torch.int32 and tuple(ranks_t.shape) == (len(thetas), 2)
    np.testing.assert_array_equal(ranks_t.numpy(), np.asarray(ranks_j))
    np.testing.assert_array_equal(dap_t.numpy(), np.asarray(dap_j))
    for z_score in (True, False):
        ecp_j, alpha_j = jax_run_tarp(jnp.asarray(thetas), jnp.asarray(xs), _FixedJax(samples),
                                      references=jnp.asarray(refs), num_posterior_samples=L,
                                      z_score_theta=z_score, key=jax.random.PRNGKey(0))
        ecp_t, alpha_t = run_tarp(thetas, xs, _FixedTorch(samples), references=refs,
                                  num_posterior_samples=L, z_score_theta=z_score)
        # coverage counts equal; the fractions within an ulp (the means divide differently)
        np.testing.assert_array_equal(np.rint(ecp_t.numpy() * len(thetas)),
                                      np.rint(np.asarray(ecp_j) * len(thetas)))
        np.testing.assert_allclose(ecp_t.numpy(), np.asarray(ecp_j), rtol=0, atol=1e-7)
        np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), atol=1e-7)


class _AnalyticPosterior:
    """Exactly calibrated 'posterior' of theta | x with x = theta + noise
    (tests/test_diagnostics.py:16-28)."""

    _device = torch.device("cpu")

    def __init__(self, obs_var=0.25, prior_var=1.0, contraction=1.0):
        self.post_var = 1.0 / (1.0 / prior_var + 1.0 / obs_var)
        self.gain = self.post_var / obs_var
        self.contraction = contraction

    def sample_batched(self, sample_shape, xs, generator=None, **kwargs):
        eps = torch.randn((sample_shape[0],) + tuple(xs.shape), generator=generator)
        return self.contraction * (self.gain * xs[None] + self.post_var**0.5 * eps)


def _calibration_data(n=150, d=2, seed=0):
    rng = np.random.default_rng(seed)
    thetas = rng.normal(size=(n, d)).astype(np.float32)
    return thetas, (thetas + 0.5 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("contraction, calibrated", [(1.0, True), (0.1, False)])
def test_sbc_calibrated_and_miscalibrated(contraction, calibrated):
    """tests/test_diagnostics.py:38-60 on the port: uniform ranks for the
    exact posterior (min KS p > 0.01), not for one contracted 10x toward
    0 (max KS p < 0.01)."""
    thetas, xs = _calibration_data()
    ranks, dap = run_sbc(thetas, xs, _AnalyticPosterior(contraction=contraction),
                         num_posterior_samples=200, generator=torch.Generator().manual_seed(3))
    checks = check_sbc(ranks, torch.as_tensor(thetas), dap, 200, rng=0)
    assert set(checks) == {"ks_pvals", "c2st_ranks", "c2st_dap"}
    assert all(tuple(v.shape) == (2,) for v in checks.values())
    if calibrated:
        assert float(checks["ks_pvals"].min()) > 0.01, checks["ks_pvals"]
        assert float(checks["c2st_ranks"].max()) < 0.6, checks
    else:
        assert float(checks["ks_pvals"].max()) < 0.01, checks["ks_pvals"]
        assert float(checks["c2st_ranks"].min()) > 0.6, checks


def test_tarp_calibrated():
    """tests/test_diagnostics.py:63-70 on the port."""
    thetas, xs = _calibration_data(n=300)
    ecp, alpha = run_tarp(thetas, xs, _AnalyticPosterior(), num_posterior_samples=300,
                          generator=torch.Generator().manual_seed(5))
    atc, ks = check_tarp(ecp, alpha)
    assert ks > 0.05
    assert float((ecp - alpha).abs().max()) < 0.15


def test_mesh_raises():
    thetas, xs = _calibration_data(n=4)
    with pytest.raises(NotImplementedError, match="later slice"):
        run_sbc(thetas, xs, _AnalyticPosterior(), mesh="auto")
    with pytest.raises(NotImplementedError, match="later slice"):
        run_tarp(thetas, xs, _AnalyticPosterior(), mesh="auto")


# ---------------------------------------------------------------- the slice

N_SIM, N_OBS, N_DRAWS = 24, 6, 200
SMALL = dict(hidden_features=16, num_transforms=2)


@pytest.fixture(scope="module")
def hh_pair():
    """Hodgkin-Huxley summaries of the same N_SIM neurons on the same noise
    in each package (the JAX package's per-neuron draws), and a small NSF
    with the same perturbed weights in each, z-scored on the JAX data."""
    rng = np.random.default_rng(0)
    theta = rng.uniform([50.0, 20.0], [200.0, 60.0], size=(N_SIM, 2)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    x_j = np.asarray(JHH.hodgkin_huxley(jnp.asarray(theta), key=key))
    keys = jax.random.split(key, N_SIM)
    noise = np.stack([np.asarray(0.2 * jax.random.normal(k, (THH.N_STEPS,)) / jnp.sqrt(JHH.DT))
                      for k in keys])
    x_t = summary_statistics(THH._simulate_voltage(torch.as_tensor(theta), torch.as_tensor(noise)))
    je = jax_build_nsf(jnp.asarray(theta), jnp.asarray(x_j), key=jax.random.PRNGKey(2), **SMALL)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), je.params)
    je.params = jax.tree_util.tree_map(jnp.asarray, params)
    te = build_nsf(theta, x_t, device="cpu", **SMALL)
    load_flax_params(
        te, params,
        np.asarray(je.input_transform.loc), np.asarray(je.input_transform.scale),
        np.asarray(je.condition_transform.loc), np.asarray(je.condition_transform.scale),
    )
    return theta, x_j, x_t, je, te


def test_hh_summaries_on_the_same_noise(hh_pair):
    _, x_j, x_t, _, _ = hh_pair
    np.testing.assert_array_equal(x_t[:, 0].numpy(), x_j[:, 0])
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-4, atol=1e-4)


def test_log_prob_ranks_of_a_bridged_hh_posterior_equal_jax(hh_pair):
    theta, x_j, x_t, je, te = hh_pair
    jprior = JHH.hh_prior()
    jpost = JaxDirectPosterior(je, jprior)
    tpost = DirectPosterior(te, hh_prior(device="cpu"))
    draws = np.random.default_rng(4).uniform([50.0, 20.0], [200.0, 60.0],
                                             size=(N_DRAWS, N_OBS, 2)).astype(np.float32)
    thetas = theta[:N_OBS]
    ranks_j = np.asarray(jax_sbc_ranks(jnp.asarray(thetas), jnp.asarray(x_j[:N_OBS]),
                                       jnp.asarray(draws), jpost, "log_prob"))
    ranks_t = _run_sbc_ranks(torch.as_tensor(thetas), x_t[:N_OBS], torch.as_tensor(draws),
                             tpost, "log_prob")
    assert tuple(ranks_t.shape) == (N_OBS, 1)
    assert 0 < ranks_j.mean() < N_DRAWS  # the draws straddle theta*'s log-prob
    np.testing.assert_array_equal(ranks_t.numpy(), ranks_j)
    # the port's observation-by-observation loop (no log_prob_batched)
    looped = SimpleNamespace(log_prob=tpost.log_prob)
    np.testing.assert_array_equal(
        _run_sbc_ranks(torch.as_tensor(thetas), x_t[:N_OBS], torch.as_tensor(draws), looped,
                       "log_prob").numpy(), ranks_j)
    with torch.no_grad():  # the leakage estimates are cached per x: the same ones
        want = [-float(tpost.log_prob(thetas[i][None], x=x_t[i][None])[0]) for i in range(3)]
    np.testing.assert_allclose(get_nltp(thetas[:3], x_t[:3], tpost).numpy(), want, rtol=1e-6)


def test_transform_to_noise_of_a_bridged_hh_posterior_equals_jax(hh_pair):
    """LC2ST_NF's theta -> z map: the estimator's z-scoring and every flow
    layer forward, against the JAX flow's layers on the same weights
    (within 1e-4), and the port's log_prob as the base density of that z
    plus the log-dets."""
    theta, x_j, x_t, je, te = hh_pair

    def to_noise(module, h, context):
        ctx = module._embed(context)
        for layer in module.layers:
            h, _ = layer.forward(h, ctx)
        return h

    zt = jax.vmap(je.input_transform.forward_and_log_det)(jnp.asarray(theta))[0]
    z_j = np.asarray(jax.jit(lambda p, h, c: je.net.apply(p, h, c, method=to_noise))(
        je.params, zt, je._embed_condition(jnp.asarray(x_j))))
    with torch.no_grad():
        z_t = te.transform_to_noise(torch.as_tensor(theta), x_t)
        lp = te.log_prob(torch.as_tensor(theta)[None], x_t)[0]
        _, ldj_in = te.input_transform.forward_and_log_det(torch.as_tensor(theta))
        _, ldj = te.net.transform_to_noise(te.input_transform.forward(torch.as_tensor(theta)),
                                           te._embed_condition(x_t))
    assert z_t.shape == (N_SIM, 2)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-4, atol=1e-4)
    base = (-0.5 * z_t**2 - 0.5 * np.log(2 * np.pi)).sum(-1)
    torch.testing.assert_close(lp, base + ldj + ldj_in, rtol=1e-5, atol=1e-5)


def test_misspecification_mmd_matches_jax(hh_pair):
    """Embed mode: both packages test in their estimator's z-scored
    condition space, with the simulated x of the JAX package."""
    _, x_j, _, je, te = hh_pair
    rng = np.random.default_rng(5)
    x = np.concatenate([x_j, x_j + 0.05 * x_j.std(0) * rng.normal(size=x_j.shape)]).astype(np.float32)
    x = np.concatenate([x] * 8)  # 384 rows: the null subsets draw from them
    for x_o, well_specified in ((x[3], True), (x[3] + 3 * x.std(0), False)):
        p_t, (stat_t, null_t) = calc_misspecification_mmd(
            SimpleNamespace(_neural_net=te), x_obs=torch.as_tensor(x_o), x=torch.as_tensor(x),
            generator=torch.Generator().manual_seed(0))
        p_j, (stat_j, null_j) = JM.calc_misspecification_mmd(
            SimpleNamespace(_neural_net=je), x_obs=jnp.asarray(x_o), x=jnp.asarray(x),
            key=jax.random.PRNGKey(0))
        np.testing.assert_allclose(float(stat_t), float(stat_j), rtol=1e-5)
        assert null_t.shape == (100,)
        assert (float(p_t) > 0.05) == (float(p_j) > 0.05) == well_specified, (float(p_t), float(p_j))
    z = np.asarray(je._embed_condition(jnp.asarray(x)))
    ref = z[:200]
    d2 = jnp.sum((ref[:, None, :] - ref[None, :, :]) ** 2, axis=-1)  # JAX's own expression
    np.testing.assert_allclose(float(mmd_scale(te._embed_condition(torch.as_tensor(x)))),
                               float(jnp.sqrt(jnp.median(d2) / 2.0)), rtol=1e-5)


def test_misspecification_logprob_matches_jax():
    rng = np.random.default_rng(6)
    mean, cov = np.array([0.5, -1.0], np.float32), np.array([[1.0, 0.3], [0.3, 0.5]], np.float32)
    x = rng.multivariate_normal(mean, cov, size=500).astype(np.float32)
    x_obs = np.array([[0.5, -1.0], [2.5, 1.0], [4.0, -4.0]], np.float32)
    p_t, (lp_obs_t, lp_sim_t) = calc_misspecification_logprob(
        MultivariateNormal(torch.as_tensor(mean), covariance_matrix=torch.as_tensor(cov), device="cpu"),
        torch.as_tensor(x_obs), torch.as_tensor(x))
    p_j, (lp_obs_j, lp_sim_j) = JM.calc_misspecification_logprob(
        JaxMultivariateNormal(jnp.asarray(mean), covariance_matrix=jnp.asarray(cov)), x_obs, x)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(lp_sim_t.numpy(), np.asarray(lp_sim_j), atol=1e-5)
    assert p_t[0] > 0.05 and p_t[2] < 0.05
