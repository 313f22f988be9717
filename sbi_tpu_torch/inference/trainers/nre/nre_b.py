"""NRE-B / SRE (Durkan et al. 2020): a 1-of-M softmax over contrastive
atoms, 10 by default (PyTorch counterpart of
``sbi_tpu/inference/trainers/nre/nre_b.py``)."""

from __future__ import annotations

import torch

from ..base import contrast_indices
from .nre_base import RatioEstimatorTrainer, classifier_logits


def nre_b_loss(est, theta, x, atomic_idx) -> torch.Tensor:
    """(B,) -log softmax of column 0 (the joint pair) of the (B, M) logits."""
    logits = classifier_logits(est, theta, x, atomic_idx)
    return -(logits[:, 0] - torch.logsumexp(logits, dim=-1))


class NRE_B(RatioEstimatorTrainer):
    def _draw_atoms(self, B, num_atoms, generator, device, batch_shape=(), **loss_kwargs):
        # A last batch shorter than num_atoms still works.
        return (contrast_indices(B, min(num_atoms, B), generator, device, batch_shape),)

    def _loss(self, est, theta, x, atomic_idx, **loss_kwargs):
        return nre_b_loss(est, theta, x, atomic_idx)


SRE = NRE_B
SNRE = NRE_B
SNRE_B = NRE_B
NRE = NRE_B
