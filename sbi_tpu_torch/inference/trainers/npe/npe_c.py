"""NPE-C / APT (Greenberg et al. 2019): the atomic proposal-posterior loss.

PyTorch counterpart of ``sbi_tpu/inference/trainers/npe/npe_c.py``. Each
row of a batch is contrasted with M - 1 other rows of the same batch,
drawn on the device; the loss is -log of the true atom's share of
q(theta | x) / prior(theta) over the M atoms. The non-atomic mixture-of-
Gaussians loss needs MDNs, which come with a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..base import _LATER_SLICE
from .npe_base import PosteriorEstimatorTrainer


class NPE_C(PosteriorEstimatorTrainer):
    def __init__(
        self,
        prior=None,
        density_estimator="maf",
        device=None,
        logging_level="WARNING",
        summary_writer=None,
        show_progress_bars: bool = True,
        **kwargs,
    ):
        super().__init__(
            prior=prior,
            density_estimator=density_estimator,
            device=device,
            logging_level=logging_level,
            summary_writer=summary_writer,
            show_progress_bars=show_progress_bars,
            **kwargs,
        )
        self._num_atoms = 10
        self._use_combined_loss = False

    def train(self, num_atoms: int = 10, use_combined_loss: bool = False, **kwargs):
        """``num_atoms`` per row (10, as the reference); ``use_combined_loss``
        adds the masks-weighted first-round loss on prior-round rows."""
        self._num_atoms = num_atoms
        self._use_combined_loss = use_combined_loss
        return super().train(**kwargs)

    def _make_proposal_loss_fn(self, proposal, calibration_kernel) -> Callable:
        if self.use_non_atomic_loss:
            return self._make_mog_loss_fn(proposal)
        est = self._neural_net
        prior = self._prior
        num_atoms = self._num_atoms
        use_combined_loss = self._use_combined_loss

        def loss_fn(theta_b, x_b, masks_b, generator):
            B = theta_b.shape[0]
            M = min(num_atoms, B)
            device = theta_b.device
            # Row i contrasts with M - 1 distinct rows != i: the first M - 1
            # of a random permutation of 0..B-2, mapped j -> j + (j >= i).
            picks = torch.rand((B, B - 1), generator=generator, device=device).argsort(dim=1)[:, : M - 1]
            row_idx = torch.arange(B, device=device)[:, None]
            contrast_idx = picks + (picks >= row_idx)
            atomic_idx = torch.cat([row_idx, contrast_idx], dim=1)  # (B, M)
            atomic_theta = theta_b[atomic_idx]  # (B, M, D)

            # q(atomic_theta | x_i): (M, B) in the (sample, batch, event) API.
            lp_posterior = est.log_prob(atomic_theta.transpose(0, 1), x_b)
            lp_prior = prior.log_prob(atomic_theta.reshape(B * M, -1)).reshape(B, M).T
            log_frac = lp_posterior - lp_prior
            # The true atom is row 0.
            lp_proposal_posterior = log_frac[0] - torch.logsumexp(log_frac, dim=0)
            if use_combined_loss:
                lp_non_atomic = est.log_prob(theta_b[None], x_b)[0]
                lp_proposal_posterior = masks_b.reshape(-1) * lp_non_atomic + lp_proposal_posterior
            loss = -lp_proposal_posterior
            if calibration_kernel is not None:
                loss = loss * calibration_kernel(x_b)
            return loss

        return loss_fn

    def _make_mog_loss_fn(self, proposal) -> Callable:
        raise NotImplementedError(f"The non-atomic (MoG) NPE-C loss needs MDNs, which {_LATER_SLICE}.")


# Aliases, as in the JAX package.
NPE = NPE_C
SNPE = NPE_C
SNPE_C = NPE_C
APT = NPE_C
