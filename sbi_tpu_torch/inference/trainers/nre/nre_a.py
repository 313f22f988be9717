"""NRE-A / AALR (Hermans et al. 2020): binary cross-entropy over the joint
and a marginal pair, exactly 2 atoms (PyTorch counterpart of
``sbi_tpu/inference/trainers/nre/nre_a.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import contrast_indices
from .nre_base import RatioEstimatorTrainer, classifier_logits


def binary_cross_entropy(logits: torch.Tensor) -> torch.Tensor:
    """(B,) mean of the BCE of column 0 (joint, label 1) and column 1
    (marginal, label 0) of (B, 2) logits."""
    return 0.5 * (-F.logsigmoid(logits[:, 0]) - F.logsigmoid(-logits[:, 1]))


def nre_a_loss(est, theta, x, atomic_idx) -> torch.Tensor:
    """(B,) NRE-A losses at the (B, 2) atoms ``atomic_idx``."""
    return binary_cross_entropy(classifier_logits(est, theta, x, atomic_idx))


class NRE_A(RatioEstimatorTrainer):
    _ensemble_num_atoms = 2

    def train(self, **kwargs):
        kwargs.setdefault("num_atoms", 2)
        if kwargs["num_atoms"] != 2:
            raise ValueError("NRE-A uses exactly 2 atoms.")
        return super().train(**kwargs)

    def _draw_atoms(self, B, num_atoms, generator, device, batch_shape=(), **loss_kwargs):
        return (contrast_indices(B, 2, generator, device, batch_shape),)

    def _loss(self, est, theta, x, atomic_idx, **loss_kwargs):
        return nre_a_loss(est, theta, x, atomic_idx)


AALR = NRE_A
SNRE_A = NRE_A
