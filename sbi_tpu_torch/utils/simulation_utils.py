"""Simulation orchestration (PyTorch counterpart of
``sbi_tpu/utils/simulation_utils.py``).

``simulate_for_sbi`` draws theta from a prior or a trained posterior and
calls the simulator once on the whole batch, on the proposal's device. The
host process pool for black-box CPU simulators (``num_workers > 1``, joblib
in the JAX package) comes with a later slice.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional, Tuple

import torch


def accepts_generator(fn: Callable) -> bool:
    """Whether ``fn`` takes a ``generator`` keyword."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins / odd callables
        return False
    return "generator" in params or any(p.kind == p.VAR_KEYWORD for p in params.values())


def simulate_for_sbi(
    simulator: Callable,
    proposal,
    num_simulations: int,
    num_workers: int = 1,
    simulation_batch_size: Optional[int] = None,
    seed: Optional[int] = None,
    show_progress_bar: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample theta ~ proposal, simulate x = simulator(theta); returns
    (theta, x) as float32 tensors on the proposal's device.

    ``proposal`` is a prior ``Distribution`` or a trained posterior (with a
    default x, for multi-round inference); both sample with
    ``sample(shape, generator=...)``. ``generator`` (on the proposal's
    device) draws theta and is handed to a simulator that takes one; with
    ``seed`` and no generator, a new generator seeded so is used.
    """
    if num_workers > 1:
        raise NotImplementedError(
            "simulate_for_sbi(num_workers > 1) needs a host process pool, which "
            "comes with a later slice of the port."
        )
    from ..inference.posteriors.base_posterior import NeuralPosterior

    device = proposal._device if isinstance(proposal, NeuralPosterior) else proposal.device
    if generator is None and seed is not None:
        generator = torch.Generator(device=device).manual_seed(int(seed))
    theta = proposal.sample((num_simulations,), generator=generator)
    if accepts_generator(simulator):
        x = simulator(theta, generator=generator)
    else:
        x = simulator(theta)
    x = torch.as_tensor(x, dtype=torch.float32, device=theta.device)
    return theta.to(torch.float32), x
