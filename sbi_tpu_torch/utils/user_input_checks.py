"""User input processing: priors and simulators in the port's protocol.

PyTorch counterpart of the part of ``sbi_tpu/utils/user_input_checks.py``
(``process_prior``, ``process_simulator``, ``:53-134``) that ``infer()``
needs, for the port's own ``Distribution``s. A sequence of priors
(``MultipleIndependent``) and scipy priors come with a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .distributions import Distribution
from .simulation_utils import accepts_generator


def process_prior(prior: Any, custom_prior_wrapper_kwargs: Optional[dict] = None
                  ) -> Tuple[Distribution, int, bool]:
    """Return (prior, theta_dim, prior_returns_numpy)."""
    if isinstance(prior, Sequence) and not isinstance(prior, (str, bytes)):
        raise NotImplementedError(
            "A sequence of priors (MultipleIndependent) comes with a later slice of the port."
        )
    if isinstance(prior, Distribution):
        if prior.event_shape == () and prior.batch_shape in ((), (1,)):
            raise ValueError(
                "The prior must have batch or event dimension >= 1 (e.g. use "
                "BoxUniform for 1D parameters)."
            )
        shape = prior.event_shape if prior.event_shape else prior.batch_shape
        theta_dim = int(np.prod(shape))
        # Sanity: batched sampling and log_prob.
        s = prior.sample((2,))
        if s.shape[0] != 2:
            raise ValueError(f"prior.sample((2,)) has shape {tuple(s.shape)}")
        lp = prior.log_prob(s)
        if tuple(lp.shape) != (2,):
            raise ValueError(f"prior.log_prob shape {tuple(lp.shape)} != (2,)")
        return prior, theta_dim, False
    if hasattr(prior, "rvs"):
        raise NotImplementedError("scipy priors come with a later slice of the port.")
    raise TypeError(f"Cannot process prior of type {type(prior)}.")


def process_simulator(user_simulator: Callable, prior: Distribution,
                      is_numpy_simulator: bool = False) -> Callable:
    """Wrap a simulator into ``sim(theta, generator=None) -> (B, *x_event)``
    float32 on theta's device. A simulator that fails on, or does not
    return, a batch of two prior draws is called row by row."""
    takes_generator = accepts_generator(user_simulator)

    def call(theta, generator):
        if is_numpy_simulator:
            theta = theta.cpu().numpy()
        if takes_generator:
            return user_simulator(theta, generator=generator)
        return user_simulator(theta)

    probe_theta = prior.sample((2,))
    try:
        probe = torch.as_tensor(call(probe_theta, None), dtype=torch.float32)
        batched = probe.ndim > 0 and probe.shape[0] == 2
    except (TypeError, ValueError, RuntimeError, IndexError):
        batched = False

    if batched:

        def simulator(theta, generator=None):
            out = torch.as_tensor(call(theta, generator), dtype=torch.float32, device=theta.device)
            return torch.atleast_2d(out)

        return simulator

    def simulator_loop(theta, generator=None):
        outs = [torch.atleast_1d(torch.as_tensor(call(t, generator), dtype=torch.float32,
                                                 device=theta.device)) for t in theta]
        return torch.stack(outs)

    return simulator_loop
