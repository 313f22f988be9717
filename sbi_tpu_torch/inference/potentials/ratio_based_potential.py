"""Ratio-based potential: sum_t log r(x_t, theta) + log p(theta).

PyTorch counterpart of ``sbi_tpu/inference/potentials/ratio_based_potential.py``.
The iid trials and the parameter sets are one (T * B) batch of classifier
rows: one classifier pass scores them all.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...neural_nets.estimators.ratio_estimators import RatioEstimator
from ...utils.sbiutils import ensure_theta_batched
from ...utils.transforms import mcmc_transform
from .base_potential import BasePotential


def _log_ratios_over_trials(x: torch.Tensor, theta: torch.Tensor,
                            ratio_estimator: RatioEstimator) -> torch.Tensor:
    """sum_t log r(x_t, theta) for every theta: x (T, *x_event), theta
    (B, D) -> (B,)."""
    T, B = x.shape[0], theta.shape[0]
    x_rep = x[:, None].expand((T, B) + tuple(x.shape[1:])).reshape((T * B,) + tuple(x.shape[1:]))
    theta_rep = theta[None].expand(T, B, theta.shape[1]).reshape(T * B, theta.shape[1])
    return ratio_estimator.log_ratio(theta_rep, x_rep).reshape(T, B).sum(dim=0)


class RatioBasedPotential(BasePotential):
    allow_iid_x = True

    def __init__(self, ratio_estimator: RatioEstimator, prior, x_o=None, device=None):
        self.ratio_estimator = ratio_estimator
        super().__init__(prior, x_o, ratio_estimator.device if device is None else device)

    def __call__(self, theta, track_gradients: bool = True):
        theta = ensure_theta_batched(theta, self.device)
        log_ratio = _log_ratios_over_trials(self.x_o, theta, self.ratio_estimator)
        prior_lp = self.prior.log_prob(theta) if self.prior is not None else 0.0
        return log_ratio + prior_lp

    def batched_over_x(self, xs, reps: int):
        """A potential for batched observations: chain i of B * reps is
        scored against observation i // reps (one x per chain, no iid
        trials). ``MCMCPosterior.sample_batched`` runs all observations'
        chains through it in one sampler run."""
        est, prior = self.ratio_estimator, self.prior
        xs = torch.atleast_2d(torch.as_tensor(xs, dtype=torch.float32, device=self.device))
        xs_rep = xs.repeat_interleave(reps, dim=0)

        def potential(theta: torch.Tensor) -> torch.Tensor:
            logits = est.log_ratio(theta, xs_rep)
            return logits + (prior.log_prob(theta) if prior is not None else 0.0)

        return potential


def ratio_estimator_based_potential(
    ratio_estimator: RatioEstimator,
    prior,
    x_o,
    enable_transform: bool = True,
) -> Tuple[RatioBasedPotential, object]:
    """Returns (potential, theta_transform to unconstrained space)."""
    potential_fn = RatioBasedPotential(ratio_estimator, prior, x_o)
    theta_transform = mcmc_transform(prior, enable_transform=enable_transform)
    return potential_fn, theta_transform
