"""sbi_tpu_torch's Hodgkin-Huxley simulator against sbi_tpu's, on the CPU.

- Traces on the same noise: both packages integrate the tutorial's four
  neurons (one onset spike for two of them, regular firing for the other
  two) for 6,000 float32 steps from the
  JAX package's own noise draws, at noise 0 and 0.2. XLA's and torch's
  exp differ in the last bits, and the spikes amplify that: the traces
  agree within 0.1 mV everywhere (measured: at most 0.0086 mV, on a
  spike's flank) and within 1e-3 mV at the median, with the same spike counts.
- summary_statistics on one shared trace: the spike count exactly, the
  other six within rtol 1e-5 (measured: 1.1e-6).
- The prior's bounds, a 64-neuron batch's shapes and finite share, and
  theta's device kept.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu_torch.simulators import hh_prior, hodgkin_huxley, summary_statistics
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

J = importlib.import_module("sbi_tpu.simulators.hodgkin_huxley")
T = importlib.import_module("sbi_tpu_torch.simulators.hodgkin_huxley")

# The tutorial's four neurons (docs/tutorials/05_hodgkin_huxley.md:58-59).
THETAS = np.array([[60.0, 25.0], [120.0, 36.0], [180.0, 30.0], [120.0, 55.0]], np.float32)
NOISE_STDS = (0.0, 0.2)
TRACE_ATOL, TRACE_MEDIAN_ATOL, STATS_RTOL = 0.1, 1e-3, 1e-5


@pytest.fixture(scope="module")
def traces():
    """Both packages' traces of THETAS at each noise level, on the JAX
    package's noise: {noise_std: (jax (4, T), torch (4, T))}."""
    keys = jax.random.split(jax.random.PRNGKey(0), len(THETAS))
    noise, jax_vs = [], []
    for std in NOISE_STDS:
        for theta, key in zip(THETAS, keys):
            # _simulate_voltage's own draw (sbi_tpu/.../hodgkin_huxley.py:63)
            noise.append(np.asarray(std * jax.random.normal(key, (T.N_STEPS,)) / jnp.sqrt(J.DT)))
            jax_vs.append(np.asarray(J._simulate_voltage(jnp.asarray(theta), std, key)))
    thetas = np.concatenate([THETAS] * len(NOISE_STDS))
    torch_vs = T._simulate_voltage(torch.as_tensor(thetas), torch.as_tensor(np.stack(noise))).numpy()
    jax_vs = np.stack(jax_vs)
    n = len(THETAS)
    return {std: (jax_vs[i * n:(i + 1) * n], torch_vs[i * n:(i + 1) * n])
            for i, std in enumerate(NOISE_STDS)}


@pytest.mark.parametrize("noise_std", NOISE_STDS)
def test_traces_match_jax_on_the_same_noise(traces, noise_std):
    vj, vt = traces[noise_std]
    assert vt.shape == (len(THETAS), T.N_STEPS) and np.isfinite(vt).all()
    diff = np.abs(vt - vj)
    assert diff.max() < TRACE_ATOL, diff.max()
    assert np.median(diff) < TRACE_MEDIAN_ATOL
    spikes_j = np.asarray(jax.vmap(J.summary_statistics)(jnp.asarray(vj)))[:, 0]
    spikes_t = summary_statistics(torch.as_tensor(vt))[:, 0].numpy()
    np.testing.assert_array_equal(spikes_t, spikes_j)
    assert (spikes_t >= 1).all()  # every neuron fires; two of them regularly


def test_summary_statistics_on_one_shared_trace(traces):
    vs = traces[0.2][0]  # the JAX package's traces, fed to both packages
    sj = np.asarray(jax.vmap(J.summary_statistics)(jnp.asarray(vs)))
    st = summary_statistics(torch.as_tensor(vs)).numpy()
    assert st.shape == (len(THETAS), 7)
    np.testing.assert_array_equal(st[:, 0], sj[:, 0])
    np.testing.assert_allclose(st[:, 1:], sj[:, 1:], rtol=STATS_RTOL, atol=0)
    # one trace, unbatched
    np.testing.assert_allclose(summary_statistics(torch.as_tensor(vs[0])).numpy(), st[0], rtol=1e-6)


def test_prior_matches_jax():
    prior, jprior = hh_prior(device="cpu"), J.hh_prior()
    np.testing.assert_array_equal(prior.low.numpy(), np.asarray(jprior.low))
    np.testing.assert_array_equal(prior.high.numpy(), np.asarray(jprior.high))
    theta = prior.sample((500,), generator=torch.Generator().manual_seed(0))
    assert theta.shape == (500, 2)
    assert ((theta >= prior.low) & (theta <= prior.high)).all()
    inside = np.array([[100.0, 40.0], [250.0, 40.0]], np.float32)
    np.testing.assert_array_equal(np.isfinite(prior.log_prob(torch.as_tensor(inside)).numpy()),
                                  np.isfinite(np.asarray(jprior.log_prob(jnp.asarray(inside)))))


def test_batch_shapes_finite_share_and_device():
    """64 prior draws: (64, 7) summaries, finite as in
    tests/test_hh_amortized.py:22, on theta's device; the traces of the
    same generator state summarise to them."""
    prior = hh_prior(device="cpu")
    theta = prior.sample((64,), generator=torch.Generator().manual_seed(1))
    x = hodgkin_huxley(theta, generator=torch.Generator().manual_seed(2))
    assert x.shape == (64, 7) and x.dtype == torch.float32 and x.device == theta.device
    assert torch.isfinite(x).all(dim=1).float().mean() > 0.99
    vs = hodgkin_huxley(theta, generator=torch.Generator().manual_seed(2), return_trace=True)
    assert vs.shape == (64, T.N_STEPS) and vs.device == theta.device
    torch.testing.assert_close(summary_statistics(vs), x, rtol=0, atol=0)
    # the spike counts vary over the prior (silent to fast-firing neurons)
    assert x[:, 0].min() < x[:, 0].max()
