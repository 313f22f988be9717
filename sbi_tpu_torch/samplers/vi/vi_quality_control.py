"""Quality checks of a fitted variational posterior: the PSIS k-hat and the
proportionality of q to the potential.

PyTorch counterpart of ``sbi_tpu/samplers/vi/vi_quality_control.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..importance.importance_sampling import psis_k_hat


def psis_diagnostics(potential_fn: Callable, q_sample_fn: Callable, q_log_prob_fn: Callable,
                     N: int = 1000, generator: Optional[torch.Generator] = None) -> float:
    """k-hat of the importance weights potential / q over N draws of q
    (``q_sample_fn(generator, N)``): below 0.5 good, above 0.7 bad."""
    samples = q_sample_fn(generator, N)
    return psis_k_hat(potential_fn(samples) - q_log_prob_fn(samples))


def proportional_to_joint_diagnostics(potential_fn: Callable, q_sample_fn: Callable,
                                      q_log_prob_fn: Callable, N: int = 1000,
                                      generator: Optional[torch.Generator] = None) -> float:
    """R^2 of a linear fit of the potential on log q over N draws of q:
    near 1 iff q is proportional to the (unnormalised) posterior."""
    samples = q_sample_fn(generator, N)
    x = q_log_prob_fn(samples)
    y = potential_fn(samples)
    x_c, y_c = x - x.mean(), y - y.mean()
    beta = torch.sum(x_c * y_c) / torch.clamp(torch.sum(x_c**2), min=1e-12)
    resid = y_c - beta * x_c
    return float(1.0 - torch.sum(resid**2) / torch.clamp(torch.sum(y_c**2), min=1e-12))
