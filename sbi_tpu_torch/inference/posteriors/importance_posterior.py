"""ImportanceSamplingPosterior: sampling-importance resampling (``"sir"``)
or raw importance draws (``"importance"``), with the PSIS diagnostic
(PyTorch counterpart of ``sbi_tpu/inference/posteriors/importance_posterior.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...samplers.importance.importance_sampling import (
    importance_sample,
    psis_k_hat,
    sampling_importance_resampling,
)
from ...utils.sbiutils import next_generator, resolve_device
from .base_posterior import NeuralPosterior


class ImportanceSamplingPosterior(NeuralPosterior):
    def __init__(
        self,
        potential_fn,
        proposal=None,
        theta_transform=None,
        method: str = "sir",
        oversampling_factor: int = 32,
        max_sampling_batch_size: int = 10_000,
        device=None,
        x_shape=None,
    ):
        """``device=None`` takes the potential's device (an estimator's),
        else cuda, and raises without CUDA. The proposal defaults to the
        potential's prior."""
        if method not in ("sir", "importance"):
            raise ValueError(f"Unknown method {method}")
        if device is None:
            device = getattr(potential_fn, "device", None)
        super().__init__(potential_fn, theta_transform, resolve_device(device), x_shape)
        self.proposal = proposal if proposal is not None else getattr(potential_fn, "prior", None)
        self.method = method
        self.oversampling_factor = oversampling_factor
        self.max_sampling_batch_size = max_sampling_batch_size
        self._purpose = (
            "It provides sampling-importance resampling (SIR) to .sample() from the posterior."
        )

    @torch.no_grad()
    def sample(self, sample_shape=(), x=None, generator: Optional[torch.Generator] = None,
               oversampling_factor: Optional[int] = None, method: Optional[str] = None,
               show_progress_bars: bool = False, **kwargs) -> torch.Tensor:
        """``"sir"``: one SIR winner a block of ``oversampling_factor``
        proposal draws. ``"importance"``: the proposal draws themselves
        (their weights from ``sample_with_weights``). No host sync."""
        generator = next_generator(generator, self._device)
        self.potential_fn.set_x(self._x_else_default_x(x))
        num_samples = math.prod(int(s) for s in sample_shape)
        if (method or self.method) == "sir":
            samples = sampling_importance_resampling(
                self.potential_fn, self.proposal, num_samples=num_samples,
                oversampling_factor=oversampling_factor or self.oversampling_factor,
                generator=generator)
        else:
            samples, _ = importance_sample(self.potential_fn, self.proposal,
                                           num_samples=num_samples, generator=generator)
        return samples.reshape(tuple(sample_shape) + samples.shape[1:])

    @torch.no_grad()
    def sample_with_weights(self, num_samples: int, x=None,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(proposal draws, their log importance weights)."""
        self.potential_fn.set_x(self._x_else_default_x(x))
        return importance_sample(self.potential_fn, self.proposal, num_samples=num_samples,
                                 generator=next_generator(generator, self._device))

    def sample_batched(self, sample_shape, x, generator: Optional[torch.Generator] = None,
                       **kwargs) -> torch.Tensor:
        """One ``sample`` per observation of x (B, ...), as in the JAX
        package: (*sample_shape, B, D)."""
        generator = next_generator(generator, self._device)
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
        outs = [self.sample(sample_shape, x=x[b][None], generator=generator, **kwargs)
                for b in range(x.shape[0])]
        return torch.stack(outs, dim=len(tuple(sample_shape)))

    def evaluate(self, x=None, num_samples: int = 1000,
                 generator: Optional[torch.Generator] = None) -> float:
        """PSIS k-hat of the proposal against the potential."""
        _, log_weights = self.sample_with_weights(num_samples, x=x, generator=generator)
        return psis_k_hat(log_weights)
