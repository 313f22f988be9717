"""Linear-Gaussian simulators and their analytic posterior.

PyTorch counterpart of ``linear_gaussian``, ``diagonal_linear_gaussian``
and ``true_posterior_linear_gaussian_mvn_prior`` in
``sbi_tpu/simulators/linear_gaussian.py``. Simulators draw their noise from
an explicit ``torch.Generator`` on the device of ``theta``. The samplers of
the truncated posterior under a uniform prior and of the posterior with
discarded dimensions come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.distributions import MultivariateNormal
from ..utils.sbiutils import next_generator


def _f32(value, device) -> torch.Tensor:
    """float32; a tensor keeps its device where ``device`` is None."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def linear_gaussian(
    theta,
    likelihood_shift,
    likelihood_cov,
    generator: Optional[torch.Generator] = None,
    num_discarded_dims: int = 0,
) -> torch.Tensor:
    """x ~ N(theta + shift, cov); with ``num_discarded_dims``, theta's
    trailing dimensions are dropped first."""
    theta = torch.atleast_2d(_f32(theta, None))
    if num_discarded_dims:
        theta = theta[:, :-num_discarded_dims]
    chol = torch.linalg.cholesky(_f32(likelihood_cov, theta.device))
    eps = torch.randn(theta.shape, generator=next_generator(generator, theta.device),
                      device=theta.device)
    return theta + _f32(likelihood_shift, theta.device) + eps @ chol.T


def diagonal_linear_gaussian(theta, std: float = 1.0,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x ~ N(theta, std^2 I)."""
    theta = torch.atleast_2d(_f32(theta, None))
    eps = torch.randn(theta.shape, generator=next_generator(generator, theta.device),
                      device=theta.device)
    return theta + std * eps


def true_posterior_linear_gaussian_mvn_prior(
    x_o,
    likelihood_shift,
    likelihood_cov,
    prior_mean,
    prior_cov,
) -> MultivariateNormal:
    """The conjugate posterior given one or more iid trials ``x_o``
    ((D,) or (num_trials, D)), on ``x_o``'s device."""
    x_o = torch.atleast_2d(_f32(x_o, None))
    device = x_o.device
    num_trials = x_o.shape[0]
    likelihood_shift = _f32(likelihood_shift, device)
    prior_mean = _f32(prior_mean, device)
    prior_prec = torch.linalg.inv(_f32(prior_cov, device))
    lik_prec = torch.linalg.inv(_f32(likelihood_cov, device))
    post_cov = torch.linalg.inv(prior_prec + num_trials * lik_prec)
    xbar = (x_o - likelihood_shift).mean(0)
    post_mean = post_cov @ (num_trials * lik_prec @ xbar + prior_prec @ prior_mean)
    # Symmetrized for the float32 Cholesky.
    post_cov = 0.5 * (post_cov + post_cov.T)
    return MultivariateNormal(post_mean, covariance_matrix=post_cov, device=device)
