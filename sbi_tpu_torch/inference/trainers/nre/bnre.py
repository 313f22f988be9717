"""BNRE (Delaunoy et al. 2022): NRE-A plus a balancing regularizer
(PyTorch counterpart of ``sbi_tpu/inference/trainers/nre/bnre.py``)."""

from __future__ import annotations

import torch

from .nre_a import binary_cross_entropy
from ..base import contrast_indices
from .nre_base import RatioEstimatorTrainer, classifier_logits


def bnre_loss(est, theta, x, atomic_idx, regularization_strength: float = 100.0) -> torch.Tensor:
    """(B,) NRE-A's loss plus ``regularization_strength`` times the
    balancing term (mean sigma(l_0) + sigma(l_1) - 1)^2. The term is one
    scalar for the batch, added to every row, so the batch mean is the
    objective."""
    logits = classifier_logits(est, theta, x, atomic_idx)
    balance = (torch.sigmoid(logits[:, 0]) + torch.sigmoid(logits[:, 1]) - 1.0).mean() ** 2
    return binary_cross_entropy(logits) + regularization_strength * balance


class BNRE(RatioEstimatorTrainer):
    _ensemble_num_atoms = 2

    def train(self, regularization_strength: float = 100.0, **kwargs):
        kwargs["loss_kwargs"] = dict(kwargs.get("loss_kwargs") or {},
                                     regularization_strength=regularization_strength)
        kwargs.setdefault("num_atoms", 2)
        return super().train(**kwargs)

    def _draw_atoms(self, B, num_atoms, generator, device, batch_shape=(), **loss_kwargs):
        return (contrast_indices(B, 2, generator, device, batch_shape),)

    def _loss(self, est, theta, x, atomic_idx, regularization_strength: float = 100.0,
              **loss_kwargs):
        return bnre_loss(est, theta, x, atomic_idx, regularization_strength)
