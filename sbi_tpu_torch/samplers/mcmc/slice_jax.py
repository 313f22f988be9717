"""Vectorized slice sampling: the names of ``sbi_tpu``'s ``slice_jax.py``.

PyTorch module, kept at the JAX package's path so that its counterpart is
easy to find. ``run_slice_vectorized`` is the batched state machine of
``slice_fsm.py`` (the JAX package's default too), and the classes are the
reference's API (``sbi/samplers/mcmc/slice_numpy.py:219,353``) over it.

Left out: the JAX package's sweep-structured sampler
(``run_slice_vectorized_sweep``, ``_slice_sweep``, ``_slice_update_dim``).
It exists there only to cross-validate the state machine, which replaced it
as the sampler.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .slice_fsm import run_slice_vectorized_fsm

run_slice_vectorized = run_slice_vectorized_fsm


class SliceSamplerVectorized:
    """Counterpart of the reference class: all chains advance together in
    one state machine."""

    def __init__(
        self,
        log_prob_fn: Callable,
        init_params,
        num_chains: int = 1,
        thin: Optional[int] = None,
        tuning: int = 50,
        verbose: bool = False,
        init_width: float = 1.0,
        max_width: float = float("inf"),
        num_workers: int = 1,
    ):
        self.log_prob_fn = log_prob_fn
        self.x = torch.as_tensor(init_params, dtype=torch.float32)
        self.num_chains = num_chains
        self.thin = 1 if thin is None or thin == -1 else thin
        self.tuning = tuning
        self.init_width = init_width

    def run(self, num_samples: int, generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Return (num_chains, samples_per_chain, D) as a numpy array, like
        the reference."""
        per_chain = int(math.ceil(num_samples / self.num_chains))
        draws = run_slice_vectorized(
            self.log_prob_fn, self.x, num_samples=per_chain, thin=self.thin,
            warmup_steps=self.tuning, init_width=self.init_width, generator=generator,
        )
        return draws.swapaxes(0, 1).cpu().numpy()


class SliceSamplerSerial(SliceSamplerVectorized):
    """The reference's per-chain sampler: here the vectorized one, which
    targets the same distribution."""


class SliceSampler(SliceSamplerVectorized):
    """The reference's single-chain API: ``SliceSampler(x, lp_f).gen(n)``."""

    def __init__(self, x, lp_f, max_width=float("inf"), init_width: float = 1.0,
                 thin=None, tuning: int = 50, verbose: bool = False):
        super().__init__(
            log_prob_fn=lp_f,
            init_params=torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32)),
            num_chains=1,
            thin=thin,
            tuning=tuning,
            verbose=verbose,
            init_width=init_width,
        )

    def gen(self, n_samples: int, generator: Optional[torch.Generator] = None) -> np.ndarray:
        return self.run(n_samples, generator=generator)[0]
