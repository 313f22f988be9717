"""RejectionPosterior: exact rejection sampling against a proposal
(PyTorch counterpart of ``sbi_tpu/inference/posteriors/rejection_posterior.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...samplers.rejection.rejection import rejection_sample
from ...utils.sbiutils import next_generator, resolve_device
from .base_posterior import NeuralPosterior


class RejectionPosterior(NeuralPosterior):
    def __init__(
        self,
        potential_fn,
        proposal=None,
        theta_transform=None,
        max_sampling_batch_size: int = 10_000,
        num_samples_to_find_max: int = 10_000,
        num_iter_to_find_max: int = 100,
        m: float = 1.2,
        device=None,
        x_shape=None,
    ):
        """``device=None`` takes the potential's device (an estimator's),
        else cuda, and raises without CUDA. The proposal defaults to the
        potential's prior."""
        if device is None:
            device = getattr(potential_fn, "device", None)
        super().__init__(potential_fn, theta_transform, resolve_device(device), x_shape)
        self.proposal = proposal if proposal is not None else getattr(potential_fn, "prior", None)
        self.max_sampling_batch_size = max_sampling_batch_size
        self.num_samples_to_find_max = num_samples_to_find_max
        self.num_iter_to_find_max = num_iter_to_find_max
        self.m = m
        self._purpose = "It provides rejection sampling to .sample() from the posterior."

    def sample(self, sample_shape=(), x=None, generator: Optional[torch.Generator] = None,
               show_progress_bars: bool = False, **kwargs) -> torch.Tensor:
        """``sample_shape`` draws; one host sync a proposal batch."""
        self.potential_fn.set_x(self._x_else_default_x(x))
        samples, _ = rejection_sample(
            self.potential_fn,
            self.proposal,
            generator=next_generator(generator, self._device),
            num_samples=math.prod(int(s) for s in sample_shape),
            sample_batch_size=self.max_sampling_batch_size,
            num_samples_to_find_max=self.num_samples_to_find_max,
            num_iter_to_find_max=self.num_iter_to_find_max,
            m=self.m,
        )
        return samples.reshape(tuple(sample_shape) + samples.shape[1:])

    def sample_batched(self, sample_shape, x, generator: Optional[torch.Generator] = None,
                       **kwargs) -> torch.Tensor:
        """One ``sample`` per observation of x (B, ...), as in the JAX
        package: (*sample_shape, B, D)."""
        generator = next_generator(generator, self._device)
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
        outs = [self.sample(sample_shape, x=x[b][None], generator=generator, **kwargs)
                for b in range(x.shape[0])]
        return torch.stack(outs, dim=len(tuple(sample_shape)))
