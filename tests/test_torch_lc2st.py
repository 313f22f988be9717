"""sbi_tpu_torch's LC2ST and LC2ST_NF against sbi_tpu's, on the CPU.

- The fold indices, the permutation null's swap masks, the NF null's
  N(0, I) draws and every classifier's seed equal the JAX package's (both
  draw them from numpy's RandomState(seed)); the JAX side's classifier
  fits are recorded, not run.
- On the JAX package's fitted sklearn classifiers, copied in by
  ``params_bridge.sklearn_mlp_to_torch``, the observed and null statistics
  agree within 1e-6 and the p-values are equal.
- The null classifiers train as one batched run; each member equals the
  same member trained alone within 1e-6 (its draws come from its own
  generator).
- tests/test_lc2st.py's three cases rerun on the port, with its
  thresholds (the classifiers' draws are torch's).
"""

import numpy as np
import pytest
import torch

import sbi_tpu.diagnostics.lc2st as JL
from sbi_tpu_torch.diagnostics import LC2ST, LC2ST_NF
from sbi_tpu_torch.utils.mlp_classifier import BatchedMLPClassifier
from sbi_tpu_torch.utils.params_bridge import sklearn_mlp_to_torch
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)


def _joint(n=400, d=2, seed=0, shift=0.0):
    """tests/test_lc2st.py's calibration set: theta ~ N(x, I) posterior
    draws; ``shift`` biases q."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    theta = x + rng.randn(n, d).astype(np.float32)
    post = x + rng.randn(n, d).astype(np.float32) + shift
    return theta, x, post


def _record_jax_fits(monkeypatch):
    calls = []

    def record(self, theta_p, theta_q, x_p, x_q, seed):
        calls.append((np.asarray(theta_p), np.asarray(theta_q), np.asarray(x_p), seed))
        return None

    monkeypatch.setattr(JL.LC2ST, "_train_single", record)
    return calls


def _record_port_fits(monkeypatch):
    calls = []

    def record(self, pairs, seeds):
        for (a, b, idx), seed in zip(pairs, seeds):
            calls.append((a[idx].numpy(), b[idx].numpy(), self.x_p[idx].numpy(), seed))
        return None

    monkeypatch.setattr(LC2ST, "_train", record)
    return calls


@pytest.mark.parametrize("nf", [False, True])
def test_folds_swap_masks_null_draws_and_seeds_equal_jax(monkeypatch, nf):
    theta, x, post = _joint(n=101)
    kwargs = dict(num_folds=3, num_ensemble=2, num_trials_null=4, seed=5)
    if nf:
        flow = lambda t, xx: np.asarray(t) - np.asarray(xx)  # noqa: E731
        jax_lc = JL.LC2ST_NF(theta, x, post, flow_inverse_transform=flow, **kwargs)
        port = LC2ST_NF(theta, x, post, flow_inverse_transform=flow, device="cpu", **kwargs)
        np.testing.assert_allclose(port.theta_p.numpy(), jax_lc.theta_p, rtol=1e-6)  # base draws
        np.testing.assert_allclose(port.theta_q.numpy(), jax_lc.theta_q, rtol=1e-6)  # z = T^-1
    else:
        jax_lc = JL.LC2ST(theta, x, post, **kwargs)
        port = LC2ST(theta, x, post, device="cpu", **kwargs)
    for a, b in zip(port._fold_train_indices(), jax_lc._fold_train_indices()):
        np.testing.assert_array_equal(a, b)
    jax_calls, port_calls = _record_jax_fits(monkeypatch), _record_port_fits(monkeypatch)
    for lc in (jax_lc, port):
        lc.train_on_observed_data()
        lc.train_under_null_hypothesis()
    assert len(port_calls) == len(jax_calls) == 3 * 2 + 4 * 3
    for (pa, pb, px, ps), (ja, jb, jx, js) in zip(port_calls, jax_calls):
        assert ps == js
        np.testing.assert_allclose(pa, ja, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pb, jb, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(px, jx)


@pytest.fixture(scope="module")
def jax_trained():
    """The JAX package's LC2ST, trained with sklearn: 2 folds, 4 null trials."""
    theta, x, post = _joint(n=200, shift=0.3)
    lc = JL.LC2ST(theta, x, post, num_folds=2, num_trials_null=4)
    lc.train_on_observed_data()
    lc.train_under_null_hypothesis()
    return (theta, x, post), lc


def test_statistics_on_bridged_sklearn_classifiers(jax_trained):
    (theta, x, post), jax_lc = jax_trained
    port = LC2ST(theta, x, post, num_folds=2, num_trials_null=4, device="cpu")
    port.state.clfs = sklearn_mlp_to_torch(jax_lc.state.clfs, device="cpu")
    port.state.clfs_null = sklearn_mlp_to_torch(
        [clf for trial in jax_lc.state.clfs_null for clf in trial], device="cpu")
    port.state.trained = port.state.trained_null = True
    theta_o = np.random.RandomState(7).randn(150, 2) + 0.3
    x_o = np.zeros(2)
    stat_j = jax_lc.get_statistic_on_observed_data(theta_o, x_o)
    stat_t = port.get_statistic_on_observed_data(theta_o, x_o)
    assert abs(stat_t - stat_j) < 1e-6
    np.testing.assert_allclose(port.scores.observed, jax_lc.scores.observed, atol=1e-6)
    null_j = jax_lc.get_statistics_under_null_hypothesis(theta_o, x_o)
    null_t = port.get_statistics_under_null_hypothesis(theta_o, x_o)
    assert null_t.shape == (4,)
    np.testing.assert_allclose(null_t, null_j, atol=1e-6, rtol=0)
    assert port.p_value(theta_o, x_o) == jax_lc.p_value(theta_o, x_o)


def test_batched_null_training_equals_member_by_member():
    theta, x, post = _joint(n=150)
    lc = LC2ST(theta, x, post, num_trials_null=3, device="cpu")
    lc.train_under_null_hypothesis()
    batched = lc.state.clfs_null
    assert batched.num_members == 3
    pairs = lc._null_pairs()
    for t, (a, b) in enumerate(pairs):
        data = torch.cat([torch.cat([a, lc.x_p], 1), torch.cat([b, lc.x_p], 1)])[None]
        labels = torch.cat([torch.zeros(150), torch.ones(150)])[None]
        alone = BatchedMLPClassifier((20, 20), max_iter=300, random_state=[lc.seed + 1000 + t],
                                     early_stopping=True, n_iter_no_change=20,
                                     device="cpu").fit(data, labels)
        assert int(alone.n_iter_[0]) == int(batched.n_iter_[t])
        torch.testing.assert_close(alone._flat[0], batched._flat[t], rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_folds", [1, 3])
def test_lc2st_calibrated_accepts(num_folds):
    """tests/test_lc2st.py:22-35 on the port."""
    theta, x, post = _joint()
    lc = LC2ST(theta, x, post, num_trials_null=20, num_folds=num_folds, device="cpu")
    lc.train_on_observed_data()
    lc.train_under_null_hypothesis()
    assert lc.state.clfs.num_members == num_folds
    assert lc.state.clfs_null.num_members == 20 * num_folds
    theta_o = np.random.RandomState(7).randn(200, 2)
    p = lc.p_value(theta_o, np.zeros(2))
    assert p > 0.05, f"calibrated posterior rejected (p={p})"


def test_lc2st_detects_bias():
    """tests/test_lc2st.py:38-45 on the port."""
    theta, x, post = _joint(shift=1.5)
    lc = LC2ST(theta, x, post, num_trials_null=20, num_folds=2, device="cpu")
    lc.train_on_observed_data()
    lc.train_under_null_hypothesis()
    theta_o = np.random.RandomState(7).randn(200, 2) + 1.5
    assert lc.reject_test(theta_o, np.zeros(2)), "biased posterior accepted"


def test_lc2st_nf_null_and_folds():
    """tests/test_lc2st.py:48-63 on the port."""
    theta, x, post = _joint()
    lc = LC2ST_NF(
        theta,
        x,
        post,
        flow_inverse_transform=lambda t, xx: np.asarray(t) - np.asarray(xx),
        num_trials_null=15,
        num_folds=2,
        device="cpu",
    )
    lc.train_on_observed_data()
    lc.train_under_null_hypothesis()
    z_o = np.random.RandomState(3).randn(200, 2)
    p = lc.p_value(z_o, np.zeros(2))
    assert p > 0.05, f"calibrated NF posterior rejected (p={p})"
