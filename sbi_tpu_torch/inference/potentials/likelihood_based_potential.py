"""Likelihood-based potential: sum_t log p(x_t | theta) + log p(theta).

PyTorch counterpart of
``sbi_tpu/inference/potentials/likelihood_based_potential.py``. The iid
trials ride the estimator's sample axis: T trials and B parameter sets are
one (T, B, *x_event) input, so one flow pass, and one spline launch per
layer, scores them all. ``MixedLikelihoodBasedPotential`` (MNLE) comes
with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...neural_nets.estimators.base import ConditionalDensityEstimator
from ...utils.sbiutils import ensure_theta_batched
from ...utils.transforms import mcmc_transform
from .base_potential import BasePotential


def _log_likelihoods_over_trials(x: torch.Tensor, theta: torch.Tensor,
                                 estimator: ConditionalDensityEstimator) -> torch.Tensor:
    """sum_t log p(x_t | theta) for every theta: x (T, *x_event), theta
    (B, D) -> (B,)."""
    T, B = x.shape[0], theta.shape[0]
    x_rep = x[:, None].expand((T, B) + tuple(x.shape[1:]))
    return estimator.log_prob(x_rep, theta).sum(dim=0)


class LikelihoodBasedPotential(BasePotential):
    allow_iid_x = True

    def __init__(self, likelihood_estimator: ConditionalDensityEstimator, prior,
                 x_o=None, device=None):
        self.likelihood_estimator = likelihood_estimator
        super().__init__(prior, x_o, likelihood_estimator.device if device is None else device)

    def __call__(self, theta, track_gradients: bool = True):
        theta = ensure_theta_batched(theta, self.device)
        log_likelihood = _log_likelihoods_over_trials(self.x_o, theta, self.likelihood_estimator)
        prior_lp = self.prior.log_prob(theta) if self.prior is not None else 0.0
        return log_likelihood + prior_lp

    def batched_over_x(self, xs, reps: int):
        """A potential for batched observations: chain i of B * reps is
        scored against observation i // reps (one x per chain, no iid
        trials). ``MCMCPosterior.sample_batched`` runs all observations'
        chains through it in one sampler run."""
        est, prior = self.likelihood_estimator, self.prior
        xs = torch.atleast_2d(torch.as_tensor(xs, dtype=torch.float32, device=self.device))
        xs_rep = xs.repeat_interleave(reps, dim=0)

        def potential(theta: torch.Tensor) -> torch.Tensor:
            lp = est.log_prob(xs_rep[None], theta)[0]
            return lp + (prior.log_prob(theta) if prior is not None else 0.0)

        return potential

    def condition_on_theta(self, local_theta, dims_global_theta):
        """A potential over the global dims of theta, with one row of local
        parameters fixed per trial: log p(x_t | theta_global, local_t)
        summed over the trials (no prior term)."""
        dims_global_theta = list(dims_global_theta)
        estimator, x_o = self.likelihood_estimator, self.x_o
        local_theta = torch.as_tensor(local_theta, dtype=torch.float32, device=x_o.device)
        D = len(dims_global_theta) + local_theta.shape[1]
        dims_local = torch.tensor([d for d in range(D) if d not in dims_global_theta],
                                  device=x_o.device)
        dims_global = torch.tensor(dims_global_theta, device=x_o.device)

        def potential(theta_global):
            theta_global = ensure_theta_batched(theta_global, x_o.device)
            B, T = theta_global.shape[0], x_o.shape[0]
            full = theta_global.new_zeros((T, B, D))
            full[:, :, dims_global] = theta_global[None].expand(T, B, -1)
            full[:, :, dims_local] = local_theta[:, None, :].expand(T, B, -1)
            x_rep = x_o[:, None].expand((T, B) + tuple(x_o.shape[1:]))
            lp = estimator.log_prob(
                x_rep.reshape((1, T * B) + tuple(x_o.shape[1:])), full.reshape(T * B, D),
            )[0]
            return lp.reshape(T, B).sum(dim=0)

        return potential


def likelihood_estimator_based_potential(
    likelihood_estimator: ConditionalDensityEstimator,
    prior,
    x_o,
    enable_transform: bool = True,
) -> Tuple[LikelihoodBasedPotential, object]:
    """Returns (potential, theta_transform to unconstrained space)."""
    potential_fn = LikelihoodBasedPotential(likelihood_estimator, prior, x_o)
    theta_transform = mcmc_transform(prior, enable_transform=enable_transform)
    return potential_fn, theta_transform


_MNLE = "MNLE's mixed likelihood potential is not ported yet; it comes with a later slice."


class MixedLikelihoodBasedPotential(LikelihoodBasedPotential):
    """For MNLE estimators (mixed discrete and continuous x)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_MNLE)


def mixed_likelihood_estimator_based_potential(likelihood_estimator, prior, x_o,
                                               enable_transform: bool = True):
    raise NotImplementedError(_MNLE)
