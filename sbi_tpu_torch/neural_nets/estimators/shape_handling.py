"""(sample, batch, event) shape convention helpers.

Mirror of ``sbi_tpu/neural_nets/estimators/shape_handling.py``. Every
estimator method takes inputs shaped (sample, batch, *event) and conditions
shaped (batch, *event).
"""

from __future__ import annotations

import torch


def reshape_to_batch_event(x, event_shape, device=None) -> torch.Tensor:
    """Return x with shape (batch, *event_shape)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    event_shape = tuple(event_shape)
    if tuple(x.shape) == event_shape:
        return x.reshape((1, *event_shape))
    n_event = len(event_shape)
    if tuple(x.shape[x.ndim - n_event:]) != event_shape:
        raise ValueError(f"x shape {tuple(x.shape)} incompatible with event shape {event_shape}")
    return x.reshape((-1, *event_shape))


def reshape_to_sample_batch_event(theta, event_shape, leading_is_sample: bool = False,
                                  device=None) -> torch.Tensor:
    """Return theta with shape (sample, batch, *event_shape)."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=device)
    event_shape = tuple(event_shape)
    n_event = len(event_shape)
    if tuple(theta.shape) == event_shape:
        return theta.reshape((1, 1, *event_shape))
    if theta.ndim == n_event + 1:
        if leading_is_sample:
            return theta.reshape((-1, 1, *event_shape))
        return theta.reshape((1, -1, *event_shape))
    if theta.ndim != n_event + 2:
        raise ValueError(
            f"theta shape {tuple(theta.shape)} incompatible with event shape {event_shape}"
        )
    return theta
