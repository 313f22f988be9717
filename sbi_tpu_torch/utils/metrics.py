"""Two-sample metrics: C2ST, MMD, Sinkhorn W2, posterior shrinkage and z-score.

PyTorch counterpart of ``sbi_tpu/utils/metrics.py``. ``c2st`` runs the JAX
package's recipe (z-scoring, ``KFold(n_folds, shuffle=True,
random_state=seed)``, sklearn's MLP) with the MLP rebuilt in PyTorch
(``mlp_classifier.BatchedMLPClassifier``): the folds train as one batched
run on the samples' device, so it runs on the card without sklearn. Only
``classifier="rf"`` imports sklearn, inside the function. ``c2st_torch`` is
the counterpart of ``c2st_jax``. Arrays that are not tensors go to
``device`` (None: cuda); tensors stay where they are.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mlp_classifier import BatchedMLPClassifier
from .sbiutils import next_generator, resolve_device


def as_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device`` is
    given; anything else goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=x.device if device is None else device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve_device(device))


# ---------------------------------------------------------------------------
# C2ST (classifier two-sample test) — ref `sbi/utils/metrics.py:56`
# ---------------------------------------------------------------------------


def kfold_test_indices(n: int, n_folds: int, seed: int):
    """The test indices of ``KFold(n_folds, shuffle=True, random_state=seed)``
    over n rows, in ascending order as ``split`` gives them: numpy's
    ``RandomState(seed)`` permutation, cut into folds whose first
    ``n % n_folds`` hold one row more."""
    perm = np.random.RandomState(seed).permutation(n)
    sizes = np.full(n_folds, n // n_folds)
    sizes[: n % n_folds] += 1
    return [np.sort(f) for f in np.split(perm, np.cumsum(sizes)[:-1])]


def c2st(
    X,
    Y,
    seed: int = 1,
    n_folds: int = 5,
    scoring: str = "accuracy",
    z_score: bool = True,
    classifier: str = "mlp",
    device=None,
) -> torch.Tensor:
    """Cross-validated classifier accuracy separating X from Y (0.5 = same).

    With ``classifier="mlp"`` the folds' MLPs (hidden (10 d, 10 d),
    ``max_iter=1000``, no early stopping, all seeded ``seed`` as sklearn's
    clones are) train as one batched run on X's device (``device`` for
    arrays). ``classifier="rf"`` is sklearn's random forest, on the host.
    """
    X = as_tensor(X, device, torch.float64)
    Y = as_tensor(Y, X.device, torch.float64)
    if X.shape[0] == 0 or Y.shape[0] == 0:
        raise ValueError("c2st: empty sample set")
    imbalance = max(X.shape[0], Y.shape[0]) / min(X.shape[0], Y.shape[0])
    if imbalance > 1.1:
        # Accuracy under class imbalance is inflated toward the majority
        # fraction (e.g. 2:1 -> 0.667 for IDENTICAL distributions), which
        # silently corrupts the metric.
        warnings.warn(
            f"c2st: unbalanced sample sets ({X.shape[0]} vs {Y.shape[0]}); "
            "accuracy is biased toward "
            f"{max(X.shape[0], Y.shape[0]) / (X.shape[0] + Y.shape[0]):.3f} "
            "for identical distributions. Subsample to equal sizes."
        )
    if z_score:
        mu, sigma = X.mean(0), X.std(0, correction=0)
        sigma = torch.where(sigma < 1e-12, 1e-12, sigma)
        X, Y = (X - mu) / sigma, (Y - mu) / sigma

    ndim = X.shape[1]
    data = torch.cat([X, Y])
    target = torch.cat([torch.zeros(X.shape[0], dtype=X.dtype, device=X.device),
                        torch.ones(Y.shape[0], dtype=X.dtype, device=X.device)])
    if classifier == "rf":
        from sklearn.ensemble import RandomForestClassifier
        from sklearn.model_selection import KFold, cross_val_score

        shuffle = KFold(n_splits=n_folds, shuffle=True, random_state=seed)
        scores = cross_val_score(RandomForestClassifier(random_state=seed), data.cpu().numpy(),
                                 target.cpu().numpy(), cv=shuffle, scoring=scoring)
        return torch.tensor(float(np.mean(scores)), dtype=torch.float32, device=X.device)
    if scoring != "accuracy":
        raise NotImplementedError(f"c2st(classifier='mlp') scores by accuracy, not {scoring!r}")

    # Training rows of each fold in ascending order (KFold's), padded to
    # the largest fold's count; the test rows likewise, with a mask.
    n = data.shape[0]
    folds = kfold_test_indices(n, n_folds, seed)
    trains = [np.setdiff1d(np.arange(n), f) for f in folds]
    n_train = max(len(t) for t in trains)
    n_test = max(len(f) for f in folds)
    pad = lambda idx, size: np.concatenate([idx, np.zeros(size - len(idx), np.int64)])
    train_idx = torch.as_tensor(np.stack([pad(t, n_train) for t in trains]), device=X.device)
    test_idx = torch.as_tensor(np.stack([pad(f, n_test) for f in folds]), device=X.device)
    test_w = torch.as_tensor(np.stack([np.arange(n_test) < len(f) for f in folds]),
                             dtype=torch.float32, device=X.device)
    data32, target32 = data.float(), target.float()
    clf = BatchedMLPClassifier(
        hidden_layer_sizes=(10 * ndim, 10 * ndim), max_iter=1000,
        random_state=[seed] * n_folds, device=X.device,
    ).fit(data32[train_idx], target32[train_idx], n_samples=[len(t) for t in trains])
    correct = (clf.predict(data32[test_idx]) == target32[test_idx]).float() * test_w
    return (correct.sum(1) / test_w.sum(1)).mean()


def check_c2st(x, y, alg: str = "", tol: float = 0.1) -> None:
    """Assert c2st in [0.5 - tol, 0.5 + tol] (ref `metrics.py:167`)."""
    score = float(c2st(x, y))
    assert 0.5 - tol <= score <= 0.5 + tol, (
        f"C2ST for {alg} was {score:.3f}, not within 0.5 +/- {tol}."
    )


def c2st_torch(
    X,
    Y,
    generator: Optional[torch.Generator] = None,
    hidden: int = 64,
    num_epochs: int = 200,
    lr: float = 1e-3,
) -> torch.Tensor:
    """Holdout accuracy of an MLP separating X from Y, on X's device.

    Counterpart of ``c2st_jax`` (``sbi_tpu/utils/metrics.py:88-154``): a
    2-layer ReLU MLP trained full-batch with Adam on an 80/20 holdout split
    of the z-scored samples. ``generator`` (on that device) draws the split
    and the initial weights.
    """
    X = torch.as_tensor(X, dtype=torch.float32)
    Y = torch.as_tensor(Y, dtype=torch.float32, device=X.device)
    device = X.device
    g = next_generator(generator, device)
    mu, sigma = X.mean(0), X.std(0, correction=0).clamp(min=1e-6)
    data = torch.cat([(X - mu) / sigma, (Y - mu) / sigma])
    labels = torch.cat([torch.zeros(X.shape[0], device=device), torch.ones(Y.shape[0], device=device)])
    n = data.shape[0]
    perm = torch.randperm(n, generator=g, device=device)
    data, labels = data[perm], labels[perm]
    n_train = int(0.8 * n)
    xtr, ytr, xte, yte = data[:n_train], labels[:n_train], data[n_train:], labels[n_train:]

    d = data.shape[1]
    shapes = ((d, hidden), (hidden, hidden), (hidden, 1))
    weights = [(torch.randn(s, generator=g, device=device) / math.sqrt(s[0])).requires_grad_()
               for s in shapes]
    biases = [torch.zeros(s[1], device=device, requires_grad=True) for s in shapes]

    def logits(x):
        h = torch.relu(x @ weights[0] + biases[0])
        h = torch.relu(h @ weights[1] + biases[1])
        return (h @ weights[2] + biases[2])[:, 0]

    opt = torch.optim.Adam(weights + biases, lr=lr, foreach=True)
    with torch.enable_grad():
        for _ in range(num_epochs):
            opt.zero_grad(set_to_none=True)
            F.binary_cross_entropy_with_logits(logits(xtr), ytr).backward()
            opt.step()
    with torch.no_grad():
        return ((logits(xte) > 0).float() == yte).float().mean()


# ---------------------------------------------------------------------------
# MMD — ref `sbi/utils/metrics.py:178-292`
# ---------------------------------------------------------------------------


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def median(t: torch.Tensor) -> torch.Tensor:
    """numpy's median: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one)."""
    s = t.flatten().sort().values
    k = s.numel()
    return 0.5 * (s[(k - 1) // 2] + s[k // 2])


def _median_heuristic(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xy = torch.cat([x, y])
    return torch.sqrt(median(_sq_dists(xy, xy)) / 2.0)


def _pair(x, y):
    x = as_tensor(x)
    return x, as_tensor(y, x.device)


def unbiased_mmd_squared(x, y, scale: Optional[float] = None) -> torch.Tensor:
    x, y = _pair(x, y)
    sigma = _median_heuristic(x, y) if scale is None else scale
    gamma = 1.0 / (2.0 * sigma**2)
    n, m = x.shape[0], y.shape[0]
    kxx = torch.exp(-gamma * _sq_dists(x, x))
    kyy = torch.exp(-gamma * _sq_dists(y, y))
    kxy = torch.exp(-gamma * _sq_dists(x, y))
    sum_xx = (kxx.sum() - torch.trace(kxx)) / (n * (n - 1))
    sum_yy = (kyy.sum() - torch.trace(kyy)) / (m * (m - 1))
    return sum_xx + sum_yy - 2 * kxy.mean()


def biased_mmd(x, y, scale: Optional[float] = None) -> torch.Tensor:
    x, y = _pair(x, y)
    sigma = _median_heuristic(x, y) if scale is None else scale
    gamma = 1.0 / (2.0 * sigma**2)
    kxx = torch.exp(-gamma * _sq_dists(x, x)).mean()
    kyy = torch.exp(-gamma * _sq_dists(y, y)).mean()
    kxy = torch.exp(-gamma * _sq_dists(x, y)).mean()
    return torch.sqrt(torch.clamp(kxx + kyy - 2 * kxy, min=0.0))


def mmd(x, y, scale=None, squared: bool = False) -> torch.Tensor:
    out = unbiased_mmd_squared(x, y, scale)
    return out if squared else torch.sqrt(torch.clamp(out, min=0.0))


def biased_mmd_hypothesis_test(x, y, alpha: float = 0.05):
    """(mmd, threshold) pair for the biased-MMD two-sample test
    (ref `sbi/utils/metrics.py:277-282`); mmd < threshold accepts H0."""
    assert x.shape[0] == y.shape[0]
    mmd_biased = float(biased_mmd(x, y))
    threshold = np.sqrt(2 / x.shape[0]) * (1 + np.sqrt(-2 * np.log(alpha)))
    return mmd_biased, threshold


def unbiased_mmd_squared_hypothesis_test(x, y, alpha: float = 0.05):
    """(mmd^2, threshold) for the unbiased-MMD^2 two-sample test
    (ref `sbi/utils/metrics.py:285-290`)."""
    assert x.shape[0] == y.shape[0]
    mmd_square_unbiased = float(unbiased_mmd_squared(x, y))
    threshold = (4 / np.sqrt(x.shape[0])) * np.sqrt(-np.log(alpha))
    return mmd_square_unbiased, threshold


# ---------------------------------------------------------------------------
# Sinkhorn Wasserstein-2 — ref `sbi/utils/metrics.py:293`
# ---------------------------------------------------------------------------


def wasserstein_2_squared(x, y, epsilon: float = 1e-1, max_iter: int = 1000,
                          tol: float = 1e-9) -> torch.Tensor:
    """Entropy-regularized W2^2 by log-domain Sinkhorn, ``max_iter`` fixed
    iterations. (m, d) / (n, d) inputs give (), batched (B, m, d) / (B, n,
    d) give (B,)."""
    x, y = _pair(x, y)
    assert x.ndim == y.ndim, "x and y must both be batched or both unbatched"
    batched = x.ndim == 3
    if not batched:
        x, y = x[None], y[None]
    n, m = x.shape[1], y.shape[1]
    C = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)  # (B, n, m)
    log_a = torch.full((n,), -math.log(n), device=x.device)
    log_b = torch.full((m,), -math.log(m), device=x.device)
    f = torch.zeros((x.shape[0], n), device=x.device)
    g = torch.zeros((x.shape[0], m), device=x.device)
    for _ in range(max_iter):
        # f_i = -eps * LSE_j[(g_j - C_ij)/eps + log b_j], and symmetrically.
        f = -epsilon * torch.logsumexp((g[:, None, :] - C) / epsilon + log_b[None, None, :], dim=2)
        g = -epsilon * torch.logsumexp((f[:, :, None] - C) / epsilon + log_a[None, :, None], dim=1)
    log_P = (f[:, :, None] + g[:, None, :] - C) / epsilon + log_a[None, :, None] + log_b[None, None, :]
    out = (torch.exp(log_P) * C).sum((1, 2))
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# Posterior quality scalars — ref `sbi/utils/metrics.py:426,468`
# ---------------------------------------------------------------------------


def posterior_shrinkage(prior_samples, post_samples) -> torch.Tensor:
    prior_samples, post_samples = _pair(prior_samples, post_samples)
    return 1.0 - post_samples.var(0, correction=0) / prior_samples.var(0, correction=0)


def posterior_zscore(true_theta, post_samples) -> torch.Tensor:
    post_samples = as_tensor(post_samples)
    true_theta = as_tensor(true_theta, post_samples.device).reshape(-1)
    return torch.abs((post_samples.mean(0) - true_theta) / post_samples.std(0, correction=0))
