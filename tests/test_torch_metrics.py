"""sbi_tpu_torch's two-sample metrics and its batched MLP classifier against
sbi_tpu's, on the CPU.

- MMD (unbiased squared, biased, the square root), both hypothesis tests,
  Sinkhorn W2 (batched and not), posterior shrinkage and z-score on the
  same numpy inputs: within 1e-5 relative, or 1e-6 absolute (float32 on
  both sides; the unbiased MMD^2 of equal distributions, ~3e-4, is a
  difference of kernel means of order 1).
- BatchedMLPClassifier on the weights of fitted sklearn MLPClassifiers
  (``params_bridge.sklearn_mlp_to_torch``): predict_proba, the regularised
  loss and its gradient equal sklearn's (``_backprop``) within 1e-12 in
  float64 and 1e-6 in float32.
- c2st is the JAX package's recipe with sklearn's MLP algorithm in
  PyTorch, so its draws differ from sklearn's: on the same samples, both
  read identical sets within 0.5 +- 0.06, and a 0.5-sd shift in 3-D (300
  a side, where sklearn's c2st runs its 1,000 epochs in every fold) gives
  a port mean over 3 seeds within 0.03 of sklearn's. The samples are
  shared, so only the classifiers' draws differ: the port and sklearn read
  0.005, 0.010 and 0.003 apart per seed. Its folds are KFold's.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold
from sklearn.neural_network import MLPClassifier

import sbi_tpu.utils.metrics as J
import sbi_tpu_torch.utils.metrics as T
from sbi_tpu_torch.utils.params_bridge import sklearn_mlp_to_torch
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6


def _samples(n=300, d=3, shift=0.5, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=batch + (n, d)).astype(np.float32)
    y = (rng.normal(size=batch + (n, d)) + shift).astype(np.float32)
    return x, y


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [None, 1.3])
def test_mmd_matches_jax(scale):
    x, y = _samples()
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    _close(T.unbiased_mmd_squared(tx, ty, scale), J.unbiased_mmd_squared(x, y, scale))
    _close(T.biased_mmd(tx, ty, scale), J.biased_mmd(x, y, scale))
    for squared in (False, True):
        _close(T.mmd(tx, ty, scale, squared), J.mmd(x, y, scale, squared))


@pytest.mark.parametrize("test", ["biased_mmd_hypothesis_test", "unbiased_mmd_squared_hypothesis_test"])
@pytest.mark.parametrize("shift", [0.0, 5.0])
def test_mmd_hypothesis_tests_match_jax(test, shift):
    x, y = _samples(shift=shift, seed=3)
    stat, threshold = getattr(T, test)(torch.as_tensor(x), torch.as_tensor(y))
    stat_j, threshold_j = getattr(J, test)(jnp.asarray(x), jnp.asarray(y))
    _close(stat, stat_j)
    assert threshold == threshold_j
    assert (stat > threshold) == (shift > 0)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_sinkhorn_w2_matches_jax(batch):
    x, y = _samples(n=64, shift=1.0, seed=2, batch=batch)
    got = T.wasserstein_2_squared(torch.as_tensor(x), torch.as_tensor(y[..., :-1, :]), epsilon=0.5)
    want = J.wasserstein_2_squared(x, y[..., :-1, :], epsilon=0.5)
    assert tuple(got.shape) == batch
    _close(got, want)


def test_shrinkage_and_zscore_match_jax():
    rng = np.random.default_rng(0)
    prior = rng.normal(scale=2.0, size=(2000, 2)).astype(np.float32)
    post = (1.0 + 0.5 * rng.normal(size=(2000, 2))).astype(np.float32)
    _close(T.posterior_shrinkage(torch.as_tensor(prior), torch.as_tensor(post)),
           J.posterior_shrinkage(prior, post))
    _close(T.posterior_zscore(torch.as_tensor(np.zeros(2, np.float32)), torch.as_tensor(post)),
           J.posterior_zscore(np.zeros(2), post))


@pytest.fixture(scope="module")
def fitted_sklearn():
    """Three sklearn MLPs of c2st's shape (hidden (30, 30) for 3-D), each
    fitted on its own data set, briefly."""
    rng = np.random.RandomState(0)
    clfs, Xs, ys = [], [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # max_iter reached
        for t in range(3):
            X = rng.randn(300, 3)
            y = (X[:, 0] + 0.5 * rng.randn(300) > 0).astype(np.float64)
            clfs.append(MLPClassifier(hidden_layer_sizes=(30, 30), max_iter=20,
                                      random_state=t).fit(X, y))
            Xs.append(X)
            ys.append(y)
    return clfs, np.stack(Xs), np.stack(ys)


def _sklearn_backprop(clf, X, y):
    acts = [X] + [None] * (len(clf.coefs_))
    deltas = [None] * len(clf.coefs_)
    coef_grads = [np.empty_like(w) for w in clf.coefs_]
    intercept_grads = [np.empty_like(b) for b in clf.intercepts_]
    loss, coef_grads, intercept_grads = clf._backprop(X, y[:, None], None, acts, deltas,
                                                      coef_grads, intercept_grads)
    flat = np.concatenate([np.concatenate([w.ravel(), b.ravel()])
                           for w, b in zip(coef_grads, intercept_grads)])
    return loss, flat


@pytest.mark.parametrize("dtype, atol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_classifier_on_sklearn_weights(fitted_sklearn, dtype, atol):
    clfs, X, y = fitted_sklearn
    batched = sklearn_mlp_to_torch(clfs, device="cpu", dtype=dtype)
    assert batched.num_members == 3 and batched.hidden_layer_sizes == (30, 30)
    for l, w in enumerate(batched.coefs_):
        np.testing.assert_allclose(w[1].numpy(), clfs[1].coefs_[l], atol=atol)
    proba = batched.predict_proba(X)
    assert tuple(proba.shape) == (3, 300)
    want = np.stack([c.predict_proba(x)[:, 1] for c, x in zip(clfs, X)])
    np.testing.assert_allclose(proba.numpy(), want, atol=atol, rtol=0)
    np.testing.assert_array_equal(batched.predict(X).numpy(),
                                  np.stack([c.predict(x) for c, x in zip(clfs, X)]))
    # one X shared by every member
    np.testing.assert_allclose(batched.predict_proba(X[0]).numpy()[2],
                               clfs[2].predict_proba(X[0])[:, 1], atol=atol, rtol=0)
    losses, grads = zip(*(_sklearn_backprop(c, x, t) for c, x, t in zip(clfs, X, y)))
    np.testing.assert_allclose(batched.loss(X, y).numpy(), losses, atol=atol, rtol=0)
    Xt, yt = torch.as_tensor(X, dtype=dtype), torch.as_tensor(y, dtype=dtype)
    _, grad, rows = batched._loss_and_grad(batched._flat, Xt, yt, torch.ones_like(yt))
    assert rows.tolist() == [300.0] * 3
    np.testing.assert_allclose(grad.numpy(), np.stack(grads), atol=atol, rtol=0)


def test_c2st_folds_are_kfolds():
    for n, seed in ((100, 1), (1003, 7)):
        want = [test for _, test in KFold(5, shuffle=True, random_state=seed).split(np.zeros(n))]
        got = T.kfold_test_indices(n, 5, seed)
        assert len(got) == 5
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_c2st_identical_sets_against_sklearn():
    """1-D, 1,000 a side (the shape of check_sbc's C2STs)."""
    x, y = _samples(n=1000, d=1, shift=0.0, seed=11)
    ours = float(T.c2st(torch.as_tensor(x), torch.as_tensor(y)))
    theirs = float(J.c2st(x, y))
    assert abs(ours - 0.5) <= 0.06 and abs(theirs - 0.5) <= 0.06, (ours, theirs)


def test_c2st_shift_against_sklearn():
    ours, theirs = [], []
    for seed in range(3):
        x, y = _samples(n=300, d=3, shift=0.5, seed=100 + seed)
        ours.append(float(T.c2st(torch.as_tensor(x), torch.as_tensor(y), seed=seed)))
        theirs.append(float(J.c2st(x, y, seed=seed)))
    assert abs(np.mean(ours) - np.mean(theirs)) <= 0.03, (ours, theirs)
    assert np.mean(ours) > 0.56  # a shift the classifier sees


def test_c2st_returns_on_the_samples_device_and_warns_on_imbalance():
    x, y = _samples(n=60, d=1, shift=3.0)
    with pytest.warns(UserWarning, match="unbalanced"):
        score = T.c2st(torch.as_tensor(x), torch.as_tensor(y[:40]))
    assert score.device == torch.device("cpu") and score.dtype == torch.float32
    assert float(score) > 0.8
    with pytest.raises(NotImplementedError, match="accuracy"):
        T.c2st(torch.as_tensor(x), torch.as_tensor(y), scoring="roc_auc")
    x, y = _samples(n=500, d=1, shift=0.0, seed=5)
    T.check_c2st(torch.as_tensor(x), torch.as_tensor(y), alg="identical")
