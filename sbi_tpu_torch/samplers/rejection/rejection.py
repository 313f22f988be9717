"""Accept-reject sampling (PyTorch counterpart of
``sbi_tpu/samplers/rejection/rejection.py:25-111``).

One proposal batch at a time, one host sync per batch (the number of
accepted samples), until ``num_samples`` are accepted. ``rejection_sample``
(with a learned scaling constant) comes with a later slice.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Optional, Tuple

import torch


def accept_reject_sample(
    proposal: Callable[[torch.Generator, int], torch.Tensor],
    accept_reject_fn: Callable[[torch.Tensor], torch.Tensor],
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    show_progress_bars: bool = False,
    warn_acceptance: float = 0.01,
    sample_batch_size: int = 10_000,
    max_sampling_batches: int = 10_000,
    max_sampling_time: Optional[float] = None,
    proposal_sampling_kwargs: Optional[dict] = None,
    alternative_method: Optional[str] = None,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample until ``num_samples`` pass ``accept_reject_fn``.

    Args:
        proposal: fn(generator, num) -> candidate batch (num, ...);
            ``generator`` is passed through as given (``None`` included).
        accept_reject_fn: fn(samples) -> boolean mask.
    Returns:
        (samples (num_samples, ...), acceptance_rate scalar).
    """
    t_start = time.monotonic()
    proposal_sampling_kwargs = proposal_sampling_kwargs or {}

    accepted = []
    num_accepted = 0
    num_sampled_total = 0
    num_batches = 0
    leakage_warned = False

    while num_accepted < num_samples:
        candidates = proposal(generator, sample_batch_size, **proposal_sampling_kwargs)
        mask = accept_reject_fn(candidates)
        # Host sync point — one per batch, amortized over sample_batch_size.
        acc = candidates[mask]
        accepted.append(acc)
        num_accepted += int(acc.shape[0])
        num_sampled_total += int(candidates.shape[0])
        num_batches += 1

        acceptance_rate = num_accepted / num_sampled_total
        if (
            not leakage_warned
            and num_sampled_total > 1000
            and acceptance_rate < warn_acceptance
        ):
            suggestion = (
                f" Consider sampling with `{alternative_method}`."
                if alternative_method
                else ""
            )
            warnings.warn(
                f"Only {acceptance_rate:.3%} proposal samples were accepted. It "
                f"may take a long time to collect the remaining "
                f"{num_samples - num_accepted} samples.{suggestion}"
            )
            leakage_warned = True
        if num_batches >= max_sampling_batches:
            warnings.warn(
                f"Reached max_sampling_batches={max_sampling_batches}; returning "
                f"{num_accepted} (<{num_samples}) samples."
            )
            break
        if max_sampling_time is not None and time.monotonic() - t_start > max_sampling_time:
            warnings.warn(
                f"Stopped after max_sampling_time={max_sampling_time}s; "
                f"returning {min(num_accepted, num_samples)} "
                f"(<={num_samples}) samples."
            )
            break

    if num_accepted == 0:
        raise RuntimeError("accept_reject_sample: no samples accepted.")
    samples = torch.cat(accepted, dim=0)[:num_samples]
    acceptance_rate = torch.tensor(num_accepted / max(num_sampled_total, 1))
    return samples, acceptance_rate
