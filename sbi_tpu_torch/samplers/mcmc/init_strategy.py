"""MCMC chain initialization strategies.

PyTorch counterpart of ``sbi_tpu/samplers/mcmc/init_strategy.py``
(proposal / sir / resample, after ``sbi/samplers/mcmc/init_strategy.py``):
one batched potential evaluation over the whole candidate set.

The candidates are drawn by ``categorical``, a Gumbel-max as
``jax.random.categorical`` is: the argmax of the weights plus Gumbel noise.
Non-finite weights become -inf and are never drawn, and a row whose weights
are all -inf gives index 0, as in JAX; ``torch.multinomial`` would raise on
both.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...utils.sbiutils import draw_from_proposal, next_generator


def categorical(logits: torch.Tensor, num_samples: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``num_samples`` draws of an index i with probability
    softmax(logits)_i, per row: logits (..., N) -> (..., num_samples)."""
    generator = next_generator(generator, logits.device)
    shape = logits.shape[:-1] + (num_samples, logits.shape[-1])
    u = torch.rand(shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits[..., None, :] + gumbel, dim=-1)


def finite_or_neg_inf(logw: torch.Tensor) -> torch.Tensor:
    """Weights that are NaN or infinite become -inf."""
    return torch.where(torch.isfinite(logw), logw, torch.full_like(logw, -torch.inf))


def proposal_init(proposal, num_chains: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Draw chain inits from the proposal (usually the prior)."""
    return draw_from_proposal(proposal, generator, num_chains)


@torch.no_grad()
def resample_given_potential_fn(
    proposal,
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    num_chains: int,
    num_candidate_samples: int = 10_000,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Resample candidates with weights softmax(potential)."""
    cand = draw_from_proposal(proposal, generator, num_candidate_samples)
    logw = finite_or_neg_inf(potential_fn(cand))
    return cand[categorical(logw, num_chains, generator)]


@torch.no_grad()
def sir_init(
    proposal,
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    num_chains: int,
    sir_num_batches: int = 10,
    sir_batch_size: int = 1000,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sampling-importance-resampling: weights are potential minus the
    proposal's log-prob."""
    cand = draw_from_proposal(proposal, generator, sir_num_batches * sir_batch_size)
    logw = finite_or_neg_inf(potential_fn(cand) - proposal.log_prob(cand))
    return cand[categorical(logw, num_chains, generator)]


class IterateParameters:
    """Iterate over the given parameters, one row per call."""

    def __init__(self, parameters, **kwargs):
        self.iter = torch.atleast_2d(torch.as_tensor(parameters, dtype=torch.float32))
        self._i = 0

    def __call__(self) -> torch.Tensor:
        out = self.iter[self._i % self.iter.shape[0]]
        self._i += 1
        return out
