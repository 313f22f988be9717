"""Accept-reject and rejection sampling (PyTorch counterpart of
``sbi_tpu/samplers/rejection/rejection.py``).

One proposal batch at a time, one host sync per batch (the number of
accepted samples), until ``num_samples`` are accepted. ``rejection_sample``
first finds the scaling constant M from proposal draws and a gradient
ascent with no host sync.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Any, Callable, Optional, Tuple

import torch

from ...utils.sbiutils import draw_from_proposal


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


def ascend_log_ratio(potential_fn: Callable[[torch.Tensor], torch.Tensor], proposal,
                     theta0: torch.Tensor, num_iter: int = 100, lr: float = 0.01) -> torch.Tensor:
    """``num_iter`` Adam steps (``optax.adam(lr)``: torch's Adam places eps
    as optax does) up potential - proposal.log_prob from ``theta0`` (1, D);
    returns the (1, D) end point. No host sync."""
    theta = theta0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for _ in range(num_iter):
            opt.zero_grad(set_to_none=True)
            (proposal.log_prob(theta) - potential_fn(theta)).sum().backward()
            opt.step()
    return theta.detach()


@torch.no_grad()
def rejection_sample(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    proposal: Any,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 1,
    show_progress_bars: bool = False,
    warn_acceptance: float = 0.01,
    sample_batch_size: int = 10_000,
    num_samples_to_find_max: int = 10_000,
    num_iter_to_find_max: int = 100,
    m: float = 1.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rejection sampling with a learned scaling constant.

    log M is the maximum of potential - proposal.log_prob over
    ``num_samples_to_find_max`` proposal draws and the end of
    ``ascend_log_ratio`` from the best of them (where finite), plus log
    ``m``; then
    proposals are accepted with probability exp(potential - log_prob -
    log M), one batch at a time. Returns (samples, acceptance rate).
    """

    def log_ratio(theta):
        return potential_fn(theta) - proposal.log_prob(theta)

    cand = draw_from_proposal(proposal, generator, num_samples_to_find_max)
    best = cand.index_select(0, log_ratio(cand).argmax().reshape(1))
    best_opt = ascend_log_ratio(potential_fn, proposal, best, num_iter_to_find_max)
    # The ascent may leave a bounded support, where the ratio is NaN: fmax
    # keeps the finite value (the JAX package's max propagates the NaN).
    log_max = torch.fmax(log_ratio(best), log_ratio(best_opt))[0] + math.log(m)

    accepted = []
    num_accepted = num_total = 0
    while num_accepted < num_samples:
        candidates = draw_from_proposal(proposal, generator, sample_batch_size)
        u = torch.rand(sample_batch_size, generator=generator, device=candidates.device)
        acc = candidates[torch.log(u) < log_ratio(candidates) - log_max]
        # Host sync point — one per batch.
        accepted.append(acc)
        num_accepted += int(acc.shape[0])
        num_total += sample_batch_size
        if num_total > 100 * sample_batch_size and num_accepted == 0:
            raise RuntimeError("rejection_sample: acceptance rate ~0.")

    samples = torch.cat(accepted, dim=0)[:num_samples]
    return samples, torch.tensor(num_accepted / num_total)
