"""NPE-B / SNPE-B (Lueckmann et al. 2017): the importance-weighted loss.

PyTorch counterpart of ``sbi_tpu/inference/trainers/npe/npe_b.py``:
loss = -(prior(theta) / proposal(theta)) * log q(theta | x), the weight
detached and its log clipped to [-10, 10].
"""

from __future__ import annotations

import torch

from .npe_base import PosteriorEstimatorTrainer


class NPE_B(PosteriorEstimatorTrainer):
    def _make_proposal_loss_fn(self, proposal, calibration_kernel):
        est = self._neural_net
        prior = self._prior
        # A posterior proposal is scored by its estimator at its x_o,
        # without the leakage normalizer (a constant in theta).
        prop_est = getattr(proposal, "posterior_estimator", None)
        prop_x = getattr(proposal, "default_x", None)
        if prop_est is not None and prop_x is not None:
            def proposal_log_prob(theta_b):
                return prop_est.log_prob(theta_b[:, None, :], prop_x)[:, 0]
        else:
            def proposal_log_prob(theta_b):
                return proposal.log_prob(theta_b)

        def loss_fn(theta_b, x_b, masks_b, generator):
            lp = est.log_prob(theta_b[None], x_b)[0]
            with torch.no_grad():
                logw = torch.clamp(prior.log_prob(theta_b) - proposal_log_prob(theta_b), -10.0, 10.0)
                w = torch.exp(logw)
            if calibration_kernel is not None:
                w = w * calibration_kernel(x_b)
            return -w * lp

        return loss_fn


SNPE_B = NPE_B
