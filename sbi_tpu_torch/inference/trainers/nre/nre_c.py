"""NRE-C / CNRE (Miller et al. 2022): K contrastive classes plus an
independent class, weighted by gamma, for asymptotically exact ratios
(PyTorch counterpart of ``sbi_tpu/inference/trainers/nre/nre_c.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import contrast_indices
from .nre_base import RatioEstimatorTrainer, classifier_logits, random_permutation


def nre_c_loss(est, theta, x, joint_idx, perm, marginal_idx, gamma: float = 1.0) -> torch.Tensor:
    """(B,) losses. The joint set pairs x_i with theta's atoms
    ``joint_idx``; the marginal set with the atoms ``marginal_idx`` of
    theta[perm], all independent of x. M = joint_idx.shape[1]."""
    M = joint_idx.shape[1]
    logits_joint = classifier_logits(est, theta, x, joint_idx)
    logits_marg = classifier_logits(est, theta[perm], x, marginal_idx)
    log_gamma_k = math.log(gamma) - math.log(M)
    # log q(y = 0 | marginal draws) and log q(y = k* | joint draws)
    log_q0 = -F.softplus(torch.logsumexp(logits_marg + log_gamma_k, dim=-1))
    lse_j = torch.logsumexp(logits_joint + log_gamma_k, dim=-1)
    log_qk = log_gamma_k + logits_joint[:, 0] - F.softplus(lse_j)
    return -(log_q0 / (1.0 + gamma) + gamma / (1.0 + gamma) * log_qk)


class NRE_C(RatioEstimatorTrainer):
    def train(self, num_classes: int = 5, gamma: float = 1.0, **kwargs):
        kwargs["loss_kwargs"] = dict(kwargs.get("loss_kwargs") or {}, num_classes=num_classes,
                                     gamma=gamma)
        kwargs.setdefault("num_atoms", num_classes)
        return super().train(**kwargs)

    def _draw_atoms(self, B, num_atoms, generator, device, batch_shape=(), num_classes: int = 5,
                    **loss_kwargs):
        """(joint atoms, perm, marginal atoms) with M = min(num_classes, B -
        1) + 1 atoms a row, the joint slot included; ``num_atoms`` is not
        used, as in the JAX package."""
        M = min(num_classes, B - 1) + 1
        return (contrast_indices(B, M, generator, device, batch_shape),
                random_permutation(B, generator, device, batch_shape),
                contrast_indices(B, M, generator, device, batch_shape))

    def _loss(self, est, theta, x, joint_idx, perm, marginal_idx, gamma: float = 1.0,
              **loss_kwargs):
        return nre_c_loss(est, theta, x, joint_idx, perm, marginal_idx, gamma)


CNRE = NRE_C
SNRE_C = NRE_C
