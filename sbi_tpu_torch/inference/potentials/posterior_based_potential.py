"""Posterior-based potential: log q(theta | x_o), -inf outside prior support.

PyTorch counterpart of
``sbi_tpu/inference/potentials/posterior_based_potential.py``, with the
batched potential that ``MCMCPosterior.sample_batched`` runs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ...neural_nets.estimators.base import ConditionalDensityEstimator
from ...utils.sbiutils import ensure_theta_batched, within_support
from ...utils.transforms import mcmc_transform
from .base_potential import BasePotential


class PosteriorBasedPotential(BasePotential):
    allow_iid_x = False

    def __init__(self, posterior_estimator: ConditionalDensityEstimator, prior,
                 x_o=None, device=None):
        self.posterior_estimator = posterior_estimator
        super().__init__(prior, x_o, posterior_estimator.device if device is None else device)

    def __call__(self, theta, track_gradients: bool = True):
        theta = ensure_theta_batched(theta, self.device)
        x = self.x_o  # (1, *event) — iid not allowed for the NPE potential
        lp = self.posterior_estimator.log_prob(theta[:, None, :], x)[:, 0]
        if self.prior is not None:
            in_support = within_support(self.prior, theta)
            lp = torch.where(in_support, lp, torch.full_like(lp, -math.inf))
        return lp

    def batched_over_x(self, xs, reps: int):
        """A potential for batched observations: chain i of B * reps is
        scored against observation i // reps."""
        est, prior = self.posterior_estimator, self.prior
        xs = torch.atleast_2d(torch.as_tensor(xs, dtype=torch.float32, device=self.device))
        xs_rep = xs.repeat_interleave(reps, dim=0)

        def potential(theta: torch.Tensor) -> torch.Tensor:
            lp = est.log_prob(theta[None], xs_rep)[0]
            if prior is not None:
                lp = torch.where(within_support(prior, theta), lp, torch.full_like(lp, -math.inf))
            return lp

        return potential


def posterior_estimator_based_potential(
    posterior_estimator: ConditionalDensityEstimator,
    prior,
    x_o,
    enable_transform: bool = True,
) -> Tuple[PosteriorBasedPotential, object]:
    """Returns (potential, theta_transform to unconstrained space)."""
    potential_fn = PosteriorBasedPotential(posterior_estimator, prior, x_o)
    theta_transform = mcmc_transform(prior, enable_transform=enable_transform)
    return potential_fn, theta_transform
