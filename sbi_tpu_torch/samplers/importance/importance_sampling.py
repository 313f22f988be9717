"""Importance sampling, sampling-importance-resampling and the PSIS
diagnostic (PyTorch counterpart of
``sbi_tpu/samplers/importance/importance_sampling.py``). No host sync but
where a diagnostic returns a Python float.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ...utils.sbiutils import draw_from_proposal
from ..mcmc.init_strategy import categorical


def importance_sample(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    proposal,
    num_samples: int = 1,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw from the proposal; return (samples, log importance weights),
    a NaN weight as -inf."""
    samples = draw_from_proposal(proposal, generator, num_samples)
    log_weights = potential_fn(samples) - proposal.log_prob(samples)
    log_weights = torch.where(torch.isnan(log_weights), -math.inf, log_weights)
    return samples, log_weights


def sampling_importance_resampling(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    proposal,
    num_samples: int = 1,
    oversampling_factor: int = 32,
    max_sampling_batch_size: int = 10_000,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """SIR: ``num_samples * oversampling_factor`` proposal draws in blocks
    of ``oversampling_factor``, one winner a block drawn with probability
    softmax(log weights of the block)."""
    samples, log_weights = importance_sample(
        potential_fn, proposal, num_samples=num_samples * oversampling_factor, generator=generator)
    blocks = log_weights.reshape(num_samples, oversampling_factor)
    winners = categorical(blocks, 1, generator)[:, 0]
    return samples[torch.arange(num_samples, device=samples.device) * oversampling_factor + winners]


def gpdfit(x: torch.Tensor, sorted: bool = True, eps: float = 1e-8, return_quadrature: bool = False):
    """Fit a generalized Pareto distribution to tail samples (Zhang and
    Stephens 2009), with their bias correction of k; the PSIS k-hat.
    Returns (k, sigma), and the quadrature points and weights with
    ``return_quadrature``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if not sorted:
        x = torch.sort(x).values
    N = x.shape[0]
    prior = 3.0
    M = 30 + int(N**0.5)

    bs = 1.0 - torch.sqrt(M / (torch.arange(1, M + 1, dtype=torch.float32, device=x.device) - 0.5))
    bs = bs / (prior * x[int(N / 4 + 0.5) - 1]) + 1.0 / x[-1]

    ks = torch.log1p(-bs[:, None] * x[None, :]).mean(dim=1)
    Ls = N * (torch.log(-bs / ks) - ks - 1.0)
    ws = 1.0 / torch.exp(Ls[None, :] - Ls[:, None]).sum(dim=1)
    b = (bs * ws).sum()

    k = torch.log1p(-b * x).mean()
    sigma = -k / b
    k = k * N / (N + 10.0) + 5.0 / (N + 10.0) * 0.5
    if return_quadrature:
        return k, sigma, bs, ws
    return k, sigma


def psis_k_hat(log_weights: torch.Tensor) -> float:
    """PSIS k-hat of a set of log importance weights: gpdfit of the
    largest min(N / 5, 3 sqrt(N)) normalized weights, shifted to start at
    0 and clipped at 1e-12. Below 0.5 good, 0.5-0.7 fair, above 0.7
    unreliable."""
    N = log_weights.shape[0]
    w = torch.exp(log_weights - torch.logsumexp(log_weights, dim=0))
    M = int(min(N / 5, 3 * (N**0.5)))
    tail = torch.sort(w).values[-M:]
    k, _ = gpdfit((tail - tail[0]).clamp(min=1e-12))
    return float(k)


def psis_diagnostics(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    q_dist,
    generator: Optional[torch.Generator] = None,
    N: int = 1000,
) -> float:
    """PSIS k-hat of ``q_dist`` as a proposal for the potential, from N
    importance draws."""
    _, log_weights = importance_sample(potential_fn, q_dist, num_samples=N, generator=generator)
    return psis_k_hat(log_weights)


def importance_resampling_weights_ess(log_weights: torch.Tensor) -> torch.Tensor:
    """Effective sample size of the normalized importance weights."""
    logw = log_weights - torch.logsumexp(log_weights, dim=0)
    return torch.exp(-torch.logsumexp(2 * logw, dim=0))
