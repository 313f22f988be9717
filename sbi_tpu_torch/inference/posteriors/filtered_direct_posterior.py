"""FilteredDirectPosterior: a DirectPosterior that drops its lowest-density
draws.

PyTorch counterpart of
``sbi_tpu/inference/posteriors/filtered_direct_posterior.py``: oversample
the estimator, keep the draws whose log-prob reaches the
``filter_quantile`` quantile (linear interpolation, as ``jnp.quantile``)
and that lie in the prior's support, and fill any shortfall with
``DirectPosterior.sample``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...utils.sbiutils import next_generator, within_support
from .direct_posterior import DirectPosterior


def filter_draws(raw: torch.Tensor, log_probs: torch.Tensor, quantile: float, prior,
                 num: int) -> torch.Tensor:
    """The first ``num`` rows of ``raw`` whose log-prob is at least the
    ``quantile`` quantile of ``log_probs`` and that lie in the prior's
    support (fewer where fewer pass). Boolean indexing reads the count of
    kept rows on the host: one sync a call."""
    threshold = torch.quantile(log_probs, quantile)
    ok = (log_probs >= threshold) & within_support(prior, raw)
    return raw[ok][:num]


class FilteredDirectPosterior(DirectPosterior):
    def __init__(
        self,
        posterior_estimator,
        prior,
        filter_quantile: float = 0.0,
        max_sampling_batch_size: int = 10_000,
        device=None,
        x_shape=None,
        enable_transform: bool = True,
    ):
        super().__init__(posterior_estimator, prior, max_sampling_batch_size, device, x_shape,
                         enable_transform)
        self.filter_quantile = filter_quantile
        self._purpose = (
            f"DirectPosterior with low-density sample filtering (quantile={filter_quantile})."
        )

    @torch.no_grad()
    def sample(self, sample_shape=(), x=None, generator: Optional[torch.Generator] = None,
               **kwargs) -> torch.Tensor:
        """``filter_quantile`` 0 samples as ``DirectPosterior``; otherwise
        ceil(1.5 num / (1 - filter_quantile)) draws of the estimator are
        filtered (``filter_draws``) and any shortfall is drawn by
        ``DirectPosterior.sample``."""
        if self.filter_quantile <= 0.0:
            return super().sample(sample_shape, x=x, generator=generator, **kwargs)
        generator = next_generator(generator, self._device)
        x = self._x_else_default_x(x)
        num = math.prod(int(s) for s in sample_shape)
        est = self.posterior_estimator
        # The JAX package rounds up in float32.
        n_raw = int(np.ceil(np.float32(num * (1.0 / (1.0 - self.filter_quantile)) * 1.5)))
        raw = est.sample((n_raw,), x, generator=generator)[:, 0, :]
        log_probs = est.log_prob(raw[:, None, :], x)[:, 0]
        kept = filter_draws(raw, log_probs, self.filter_quantile, self.prior, num)
        if kept.shape[0] < num:
            extra = super().sample((num - kept.shape[0],), x=x, generator=generator, **kwargs)
            kept = torch.cat([kept, extra])
        return kept.reshape(tuple(sample_shape) + est.input_shape)
