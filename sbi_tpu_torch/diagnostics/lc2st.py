"""LC2ST: local classifier two-sample test (Linhart et al. 2023).

PyTorch counterpart of ``sbi_tpu/diagnostics/lc2st.py`` (LC2ST, LC2ST_NF).
Classifiers learn to tell (theta_q, x) from (theta_p, x) over calibration
data; the local statistic at x_o is the mean squared distance of their
predicted probabilities from 1/2 over posterior draws, against a null
distribution from permutation trials (LC2ST) or from fresh N(0, I) draws
in the flow's base space (LC2ST_NF).

The classifiers are sklearn's MLP algorithm rebuilt in PyTorch
(``utils.mlp_classifier.BatchedMLPClassifier``): the observed classifiers
train as one batched run, and all ``num_trials_null * num_folds`` null
classifiers as another, on ``device``. Fold indices, swap masks and the NF
null draws come from ``np.random.RandomState(seed)`` exactly as in the JAX
package; the classifiers' seeds (``seed + 37 f + i`` and ``seed + 1000 +
37 f + t``) seed torch generators. Statistics run on the device and return
numpy, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..utils.metrics import as_tensor
from ..utils.mlp_classifier import BatchedMLPClassifier
from ..utils.sbiutils import resolve_device


@dataclass
class LC2STScores:
    """Scores container (reference export)."""

    observed: Optional[np.ndarray] = None
    null: List[np.ndarray] = field(default_factory=list)


@dataclass
class LC2STState:
    """Trained-state container: ``clfs`` holds the observed classifiers
    (members fold-major, then ensemble), ``clfs_null`` the null ones
    (members trial-major, then fold), each one ``BatchedMLPClassifier``."""

    clfs: Optional[BatchedMLPClassifier] = None
    clfs_null: Optional[BatchedMLPClassifier] = None
    trained: bool = False
    trained_null: bool = False


def _build_clf(seeds, ndim: int, device, classifier: str = "mlp") -> BatchedMLPClassifier:
    if classifier != "mlp":
        raise NotImplementedError(
            f"LC2ST(classifier={classifier!r}): the port trains sklearn's MLP algorithm "
            "on the device; other classifiers come with a later slice."
        )
    return BatchedMLPClassifier(
        hidden_layer_sizes=(10 * ndim, 10 * ndim),
        max_iter=300,
        random_state=seeds,
        early_stopping=True,
        n_iter_no_change=20,
        device=device,
    )


class LC2ST:
    def __init__(
        self,
        thetas,
        xs,
        posterior_samples,
        seed: int = 1,
        num_ensemble: int = 1,
        num_folds: int = 1,
        classifier: str = "mlp",
        z_score: bool = False,
        num_trials_null: int = 100,
        permutation: bool = True,
        device=None,
        **classifier_kwargs,
    ):
        """thetas / xs are calibration joint draws, posterior_samples one
        posterior draw per x. ``num_folds > 1`` enables cross-validation:
        each fold's classifier trains on the other K-1 folds, and the local
        statistic averages the probabilities of all fold classifiers.
        ``device``: None takes thetas' device (cuda for arrays)."""
        if device is None and isinstance(thetas, torch.Tensor):
            device = thetas.device
        self.device = resolve_device(device)
        self.theta_p = as_tensor(thetas, self.device)
        self.x_p = as_tensor(xs, self.device).reshape(len(self.theta_p), -1)
        self.theta_q = as_tensor(posterior_samples, self.device)
        self.seed = seed
        self.num_ensemble = num_ensemble
        self.num_folds = num_folds
        self.classifier = classifier
        self.num_trials_null = num_trials_null
        self.permutation = permutation
        self.state = LC2STState()
        self.scores = LC2STScores()
        if z_score:
            self._mu = self.theta_p.mean(0)
            self._sigma = self.theta_p.std(0, correction=0) + 1e-12
            self.theta_p = (self.theta_p - self._mu) / self._sigma
            self.theta_q = (self.theta_q - self._mu) / self._sigma
        else:
            self._mu, self._sigma = 0.0, 1.0

    # ------------------------------------------------------------- training
    def _fold_train_indices(self):
        """Train-split indices per fold (all data when num_folds == 1)."""
        n = len(self.theta_p)
        if self.num_folds <= 1:
            return [np.arange(n)]
        rng = np.random.RandomState(self.seed)
        perm = rng.permutation(n)
        folds = np.array_split(perm, self.num_folds)
        return [
            np.concatenate([f for j, f in enumerate(folds) if j != i])
            for i in range(self.num_folds)
        ]

    def _train(self, pairs, seeds) -> BatchedMLPClassifier:
        """One batched run: member k separates (a_k[idx_k], x[idx_k]),
        class 0, from (b_k[idx_k], x[idx_k]), class 1, for ``pairs`` of
        (a_k, b_k, idx_k); members with fewer rows are padded."""
        sizes = [2 * len(idx) for _, _, idx in pairs]
        n = max(sizes)
        data, labels = [], []
        for (a, b, idx), size in zip(pairs, sizes):
            idx = torch.as_tensor(idx, device=self.device)
            x = self.x_p[idx]
            rows = torch.cat([torch.cat([a[idx], x], 1), torch.cat([b[idx], x], 1)])
            label = torch.cat([torch.zeros(len(idx), device=self.device),
                               torch.ones(len(idx), device=self.device)])
            data.append(torch.nn.functional.pad(rows, (0, 0, 0, n - size)))
            labels.append(torch.nn.functional.pad(label, (0, n - size)))
        clf = _build_clf(seeds, self.theta_p.shape[1], self.device, self.classifier)
        return clf.fit(torch.stack(data), torch.stack(labels), n_samples=sizes)

    def train_on_observed_data(self, seed: Optional[int] = None):
        """Train the (fold x ensemble) classifiers distinguishing q from p."""
        seed = self.seed if seed is None else seed
        folds = self._fold_train_indices()
        pairs = [(self.theta_p, self.theta_q, idx) for idx in folds for _ in range(self.num_ensemble)]
        seeds = [seed + 37 * f + i for f in range(len(folds)) for i in range(self.num_ensemble)]
        self.state.clfs = self._train(pairs, seeds)
        self.state.trained = True
        return self

    def _null_pairs(self):
        """(a_t, b_t) of each null trial: the permutation null swaps which
        member of each (theta_p, theta_q) pair gets which label."""
        rng = np.random.RandomState(self.seed)
        swaps = np.stack([rng.rand(len(self.theta_p)) < 0.5 for _ in range(self.num_trials_null)])
        swaps = torch.as_tensor(swaps, device=self.device)[:, :, None]
        a = torch.where(swaps, self.theta_q, self.theta_p)
        b = torch.where(swaps, self.theta_p, self.theta_q)
        return list(zip(a, b))

    def train_under_null_hypothesis(self):
        """All num_trials_null x num_folds null classifiers, one batched run."""
        folds = self._fold_train_indices()
        trials = self._null_pairs()
        pairs = [(a, b, idx) for a, b in trials for idx in folds]
        seeds = [self.seed + 1000 + 37 * f + t for t in range(len(trials)) for f in range(len(folds))]
        self.state.clfs_null = self._train(pairs, seeds)
        self.state.trained_null = True
        return self

    # ------------------------------------------------------------ statistics
    def _probs(self, clf: BatchedMLPClassifier, theta_o, x_o) -> torch.Tensor:
        """P(class q) of each member at (theta_o, x_o): (members, n)."""
        x_o = as_tensor(x_o, self.device).reshape(1, -1)
        data = torch.cat([theta_o, x_o.expand(len(theta_o), -1)], 1)
        return clf.predict_proba(data)

    def _theta_o(self, theta_o) -> torch.Tensor:
        return (as_tensor(theta_o, self.device) - self._mu) / self._sigma

    def get_statistic_on_observed_data(self, theta_o, x_o) -> float:
        """Local statistic at x_o: mean (prob - 0.5)^2 over posterior draws."""
        assert self.state.trained, "Call train_on_observed_data() first."
        probs = self._probs(self.state.clfs, self._theta_o(theta_o), x_o).mean(0)
        self.scores.observed = probs.cpu().numpy()
        return float(((probs - 0.5) ** 2).mean())

    def get_statistics_under_null_hypothesis(self, theta_o, x_o) -> np.ndarray:
        assert self.state.trained_null, "Call train_under_null_hypothesis() first."
        probs = self._probs(self.state.clfs_null, self._theta_o(theta_o), x_o)
        probs = probs.reshape(self.num_trials_null, -1, probs.shape[-1]).mean(1)  # (trials, n)
        stats = ((probs - 0.5) ** 2).mean(1)
        self.scores.null.extend(probs.cpu().numpy())
        return stats.cpu().numpy()

    def p_value(self, theta_o, x_o) -> float:
        stat = self.get_statistic_on_observed_data(theta_o, x_o)
        null = self.get_statistics_under_null_hypothesis(theta_o, x_o)
        return float((null >= stat).mean())

    def reject_test(self, theta_o, x_o, alpha: float = 0.05) -> bool:
        return self.p_value(theta_o, x_o) < alpha


class LC2ST_NF(LC2ST):
    """LC2ST in the flow's base space (ref `lc2st.py:886`): z = T^-1(theta; x)
    should be standard normal for every x, so the null needs no permutation:
    fresh N(0, I) draws give exact null trials."""

    def __init__(
        self,
        thetas,
        xs,
        posterior_samples,
        flow_inverse_transform=None,
        flow_base_samples=None,
        num_trials_null: int = 100,
        **kwargs,
    ):
        """``flow_inverse_transform(thetas, xs)`` maps calibration pairs to
        the base space (the caller's flow, on its device)."""
        z_p = thetas if flow_inverse_transform is None else flow_inverse_transform(thetas, xs)
        if flow_base_samples is None:
            rng = np.random.RandomState(kwargs.get("seed", 1))
            flow_base_samples = rng.randn(*tuple(z_p.shape))
        kwargs["permutation"] = False
        if kwargs.get("device") is None and isinstance(z_p, torch.Tensor):
            kwargs["device"] = z_p.device
        super().__init__(
            thetas=flow_base_samples,  # class p = base normal
            xs=xs,
            posterior_samples=z_p,  # class q = inverse-mapped posterior
            num_trials_null=num_trials_null,
            **kwargs,
        )

    def _null_pairs(self):
        """Null trials with fresh N(0, I) against N(0, I): no permutation."""
        rng = np.random.RandomState(self.seed)
        draws = [(rng.randn(*self.theta_p.shape), rng.randn(*self.theta_q.shape))
                 for _ in range(self.num_trials_null)]
        a = as_tensor(np.stack([d[0] for d in draws]), self.device)
        b = as_tensor(np.stack([d[1] for d in draws]), self.device)
        return list(zip(a, b))
