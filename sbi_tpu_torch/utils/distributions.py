"""Distributions of the NSF serving path, with explicit generators.

PyTorch counterpart of ``sbi_tpu/utils/distributions.py`` (``Distribution``,
``Uniform``, ``Independent``, ``BoxUniform`` and ``MultivariateNormal``).
Shapes follow the (sample, batch, event) convention:

  - ``sample(sample_shape, generator=None) -> sample_shape + batch + event``
  - ``log_prob(value)`` reduces the event dims
  - ``within_support(value)`` is a boolean mask over the batch dims.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .sbiutils import next_generator, resolve_device

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _tensor(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=resolve_device(device))


class Distribution:
    batch_shape: Tuple[int, ...] = ()
    event_shape: Tuple[int, ...] = ()

    def sample(self, sample_shape=(), generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def mean(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def variance(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.variance)

    def within_support(self, value: torch.Tensor) -> torch.Tensor:
        """Boolean mask over batch dims; default: finite log_prob."""
        return torch.isfinite(self.log_prob(value))


class MultivariateNormal(Distribution):
    """MVN parameterized by covariance, scale_tril or precision."""

    def __init__(self, loc, covariance_matrix=None, scale_tril=None,
                 precision_matrix=None, device=None):
        self.loc = _tensor(loc, device)
        if scale_tril is not None:
            self.scale_tril = _tensor(scale_tril, device)
        elif covariance_matrix is not None:
            self.scale_tril = torch.linalg.cholesky(_tensor(covariance_matrix, device))
        elif precision_matrix is not None:
            cov = torch.linalg.inv(_tensor(precision_matrix, device))
            self.scale_tril = torch.linalg.cholesky(cov)
        else:
            raise ValueError("Provide covariance_matrix, scale_tril, or precision_matrix.")
        self.event_shape = (self.loc.shape[-1],)
        self.batch_shape = tuple(
            torch.broadcast_shapes(self.loc.shape[:-1], self.scale_tril.shape[:-2])
        )

    @property
    def device(self):
        return self.loc.device

    @property
    def covariance_matrix(self):
        return self.scale_tril @ self.scale_tril.transpose(-1, -2)

    def sample(self, sample_shape=(), generator=None):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = torch.randn(shape, generator=next_generator(generator, self.device),
                          device=self.device)
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, eps)

    def log_prob(self, value):
        d = self.event_shape[0]
        diff = value - self.loc
        y = torch.linalg.solve_triangular(
            self.scale_tril, diff.unsqueeze(-1), upper=False
        ).squeeze(-1)
        half_log_det = torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * (y**2).sum(-1) - half_log_det - d * _LOG_SQRT_2PI

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        var = torch.diagonal(self.covariance_matrix, dim1=-2, dim2=-1)
        return var.expand(self.batch_shape + self.event_shape)


class Uniform(Distribution):
    def __init__(self, low, high, device=None):
        self.low = _tensor(low, device)
        self.high = _tensor(high, device)
        self.batch_shape = tuple(torch.broadcast_shapes(self.low.shape, self.high.shape))
        self.event_shape = ()

    @property
    def device(self):
        return self.low.device

    def sample(self, sample_shape=(), generator=None):
        shape = tuple(sample_shape) + self.batch_shape
        u = torch.rand(shape, generator=next_generator(generator, self.device),
                       device=self.device)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        inside = (value >= self.low) & (value <= self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def within_support(self, value):
        return (value >= self.low) & (value <= self.high)

    @property
    def mean(self):
        return (0.5 * (self.low + self.high)).expand(self.batch_shape)

    @property
    def variance(self):
        return ((self.high - self.low) ** 2 / 12.0).expand(self.batch_shape)


class Independent(Distribution):
    """Reinterpret rightmost batch dims of ``base`` as event dims."""

    def __init__(self, base: Distribution, reinterpreted_batch_ndims: int):
        self.base = base
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims
        n = reinterpreted_batch_ndims
        cut = len(base.batch_shape) - n
        self.batch_shape = tuple(base.batch_shape[:cut])
        self.event_shape = tuple(base.batch_shape[cut:]) + tuple(base.event_shape)

    @property
    def device(self):
        return self.base.device

    def sample(self, sample_shape=(), generator=None):
        return self.base.sample(sample_shape, generator=generator)

    def log_prob(self, value):
        lp = self.base.log_prob(value)
        for _ in range(self.reinterpreted_batch_ndims):
            lp = lp.sum(-1)
        return lp

    def within_support(self, value):
        ok = self.base.within_support(value)
        for _ in range(self.reinterpreted_batch_ndims):
            ok = ok.all(-1)
        return ok

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance


class BoxUniform(Independent):
    """Multidimensional uniform over a box (``sbi_tpu`` `distributions.py:315`)."""

    def __init__(self, low, high, device=None):
        low = torch.atleast_1d(_tensor(low, device))
        high = torch.atleast_1d(_tensor(high, device))
        super().__init__(Uniform(low, high, device=low.device), 1)

    @property
    def low(self):
        return self.base.low

    @property
    def high(self):
        return self.base.high
