"""MCMCPosterior: sample a potential with the vectorized slice sampler, HMC
or NUTS.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/mcmc_posterior.py``:
the method names (the reference's ``slice_np_vectorized``, ``slice`` and so
on map onto the vectorized slice sampler, ``hmc_pyro`` and ``nuts_pymc``
and so on onto HMC and NUTS), the init strategies, ``sample`` and
``sample_batched`` (all observations' chains in one slice-sampler run,
whatever the method, as in the JAX package).

Differences from the JAX package:

- The potential is composed with the unconstraining transform on every
  call. The JAX package caches that composition so that ``jit`` reuses its
  compiled program; eager PyTorch compiles nothing.
- ``max_sweeps_per_program="auto"`` resolves to ``None`` (one run): the JAX
  package bounds its device programs on a TPU only, where a long program
  faults the TPU worker. An int still splits the run into chunks.
- ``mesh=`` comes with a later slice and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ...samplers.mcmc.init_strategy import (
    categorical,
    finite_or_neg_inf,
    proposal_init,
    resample_given_potential_fn,
    sir_init,
)
from ...samplers.mcmc.hmc import run_hmc, run_nuts
from ...samplers.mcmc.slice_jax import run_slice_vectorized
from ...utils.sbiutils import draw_from_proposal, next_generator, resolve_device
from ...utils.transforms import transformed_potential
from .base_posterior import NeuralPosterior

_LATER_SLICE = "comes with a later slice of the port"

_METHOD_ALIASES = {
    "slice_np": "slice_jax",
    "slice_np_vectorized": "slice_jax_vectorized",
    "slice": "slice_jax_vectorized",
    "slice_pymc": "slice_jax_vectorized",
    "hmc": "hmc",
    "hmc_pyro": "hmc",
    "hmc_pymc": "hmc",
    "nuts": "nuts",
    "nuts_pyro": "nuts",
    "nuts_pymc": "nuts",
    "slice_jax": "slice_jax",
    "slice_jax_vectorized": "slice_jax_vectorized",
}


def _resolve_method(method: str) -> str:
    if method not in _METHOD_ALIASES:
        raise NotImplementedError(f"MCMC method {method} not supported.")
    return _METHOD_ALIASES[method]


def _resolve_max_sweeps(value):
    if value == "auto":
        return None
    if value is not None and value < 1:
        raise ValueError(f"max_sweeps_per_program must be >= 1, got {value}")
    return value


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(f"Sampling over a device mesh (mesh=) {_LATER_SLICE}.")


class MCMCPosterior(NeuralPosterior):
    def __init__(
        self,
        potential_fn,
        proposal=None,
        theta_transform=None,
        method: str = "slice_jax_vectorized",
        thin: int = -1,
        warmup_steps: int = 200,
        num_chains: int = 20,
        init_strategy: str = "resample",
        init_strategy_parameters: Optional[Dict] = None,
        num_workers: int = 1,
        mp_context: str = "spawn",
        device=None,
        x_shape=None,
    ):
        """Defaults as the reference's: thin 1, warmup 200, 20 chains, init
        ``"resample"``. ``device=None`` takes the potential's device (an
        estimator's), else cuda, and raises without CUDA.

        On strongly multimodal targets (SLCP's 4 symmetric modes)
        ``"resample"`` can gather the chains in the highest modes;
        ``init_strategy="proposal"`` spreads them over the prior.
        """
        if device is None:
            device = getattr(potential_fn, "device", None)
        super().__init__(potential_fn, theta_transform, resolve_device(device), x_shape)
        self.method = _resolve_method(method)
        self.thin = 1 if thin == -1 else thin
        self.warmup_steps = warmup_steps
        self.num_chains = num_chains
        self.init_strategy = init_strategy
        self.init_strategy_parameters = init_strategy_parameters or {}
        self.proposal = proposal if proposal is not None else getattr(potential_fn, "prior", None)
        self._purpose = "It provides MCMC to .sample() from the posterior."

    # ----------------------------------------------------------------- inits
    def _get_initial_params(self, num_chains: int, generator: torch.Generator) -> torch.Tensor:
        """Chain inits in unconstrained space."""
        if self.init_strategy == "proposal":
            inits = proposal_init(self.proposal, num_chains, generator=generator)
        elif self.init_strategy == "resample":
            inits = resample_given_potential_fn(
                self.proposal, self.potential_fn, num_chains, generator=generator,
                **self.init_strategy_parameters,
            )
        elif self.init_strategy == "sir":
            inits = sir_init(
                self.proposal, self.potential_fn, num_chains, generator=generator,
                **self.init_strategy_parameters,
            )
        elif self.init_strategy == "latest_sample":
            if getattr(self, "_latest_sample", None) is not None:
                inits = self._latest_sample[:num_chains]
            else:
                inits = proposal_init(self.proposal, num_chains, generator=generator)
        else:
            raise NotImplementedError(f"init_strategy {self.init_strategy} not supported.")
        return self.theta_transform.forward(inits)

    # ---------------------------------------------------------------- sample
    @torch.no_grad()
    def sample(
        self,
        sample_shape=(),
        x=None,
        generator: Optional[torch.Generator] = None,
        method: Optional[str] = None,
        thin: Optional[int] = None,
        warmup_steps: Optional[int] = None,
        num_chains: Optional[int] = None,
        init_strategy: Optional[str] = None,
        show_progress_bars: bool = False,
        mesh=None,
        **kwargs,
    ) -> torch.Tensor:
        """``sample_shape`` draws, taken from the chains in turn (draw i
        from chain i mod num_chains). The other keyword arguments
        (the slice sampler's ``init_width``, ``max_steps_out``,
        ``max_shrink``, ``tune_width``; HMC's ``num_leapfrog``,
        ``target_accept``, ``jitter_steps``; NUTS's ``max_tree_depth``,
        ``target_accept``; all methods' ``max_sweeps_per_program``) go to
        the sampler."""
        _no_mesh(mesh)
        method = _resolve_method(method) if method else self.method
        generator = next_generator(generator, self._device)
        self.potential_fn.set_x(
            self._x_else_default_x(x),
            x_is_iid=getattr(self.potential_fn, "allow_iid_x", False),
        )
        thin = self.thin if thin is None else (1 if thin == -1 else thin)
        warmup_steps = warmup_steps if warmup_steps is not None else self.warmup_steps
        num_chains = num_chains if num_chains is not None else self.num_chains
        if init_strategy is not None:
            self.init_strategy = init_strategy
        num_samples = math.prod(int(s) for s in sample_shape)

        inits = self._get_initial_params(num_chains, generator)
        pot_u = transformed_potential(self.potential_fn, self.theta_transform)
        per_chain = max(1, math.ceil(num_samples / num_chains))
        runner = {"hmc": run_hmc, "nuts": run_nuts}.get(method, run_slice_vectorized)
        draws_u = runner(
            pot_u, inits, num_samples=per_chain, thin=thin, warmup_steps=warmup_steps,
            generator=generator,
            max_sweeps_per_program=_resolve_max_sweeps(kwargs.pop("max_sweeps_per_program", "auto")),
            **kwargs,
        )
        # (per_chain, C, D) -> flattened with the chains interleaved.
        D = draws_u.shape[-1]
        draws = self.theta_transform.inverse(draws_u.reshape(-1, D))
        self._last_chain_draws = draws.reshape(draws_u.shape)  # for arviz
        samples = draws[:num_samples]
        self._latest_sample = samples[-num_chains:]
        return samples.reshape(tuple(sample_shape) + (D,))

    @torch.no_grad()
    def sample_batched(
        self,
        sample_shape,
        x,
        generator: Optional[torch.Generator] = None,
        num_chains: Optional[int] = None,
        mesh=None,
        **kwargs,
    ) -> torch.Tensor:
        """Batched observations x (B, ...): num_chains chains per
        observation, all B * num_chains of them in one sampler run through
        the potential's ``batched_over_x``; a potential without it is
        sampled one observation at a time. Returns (*sample_shape, B, D)."""
        _no_mesh(mesh)
        generator = next_generator(generator, self._device)
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
        B = x.shape[0]
        num_chains = num_chains or self.num_chains
        num_samples = math.prod(int(s) for s in sample_shape)

        if not hasattr(self.potential_fn, "batched_over_x"):
            out = torch.stack([
                self.sample((num_samples,), x=x[b][None], generator=generator,
                            num_chains=num_chains, **kwargs)
                for b in range(B)
            ], dim=1)  # (num_samples, B, D)
            return out.reshape(tuple(sample_shape) + (B, out.shape[-1]))

        pot_u = transformed_potential(self.potential_fn.batched_over_x(x, num_chains),
                                      self.theta_transform)
        per_chain = max(1, math.ceil(num_samples / num_chains))

        # Inits: num_chains of n_cand shared candidates resampled per
        # observation, from one potential evaluation over all pairs.
        n_cand = int(kwargs.pop("num_init_candidates", 1024))
        cand = draw_from_proposal(self.proposal, generator, n_cand)
        logw = self.potential_fn.batched_over_x(x, n_cand)(cand.repeat(B, 1)).reshape(B, n_cand)
        idx = categorical(finite_or_neg_inf(logw), num_chains, generator)  # (B, num_chains)
        inits_u = self.theta_transform.forward(cand[idx.reshape(-1)])

        draws_u = run_slice_vectorized(
            pot_u, inits_u, num_samples=per_chain, thin=self.thin,
            warmup_steps=self.warmup_steps, generator=generator,
            max_sweeps_per_program=_resolve_max_sweeps(kwargs.pop("max_sweeps_per_program", "auto")),
        )  # (per_chain, B * num_chains, D)
        D = draws_u.shape[-1]
        draws = self.theta_transform.inverse(draws_u.reshape(-1, D)).reshape(
            per_chain, B, num_chains, D)
        out = draws.swapaxes(1, 2).reshape(per_chain * num_chains, B, D)[:num_samples]
        return out.reshape(tuple(sample_shape) + (B, D))

    def log_prob(self, theta, x=None, **kwargs) -> torch.Tensor:
        """The unnormalized potential, as in the reference."""
        return self.potential(theta, x)

    def get_arviz_inference_data(self):
        """``arviz.InferenceData`` of the last ``sample()`` run's draws, per
        chain. arviz is an optional dependency."""
        draws = getattr(self, "_last_chain_draws", None)
        if draws is None:
            raise ValueError("No MCMC draws recorded yet — call `.sample()` first.")
        try:
            import arviz as az
        except ImportError as err:
            raise ImportError(
                "arviz is required for `get_arviz_inference_data`; "
                "install it with `pip install arviz`."
            ) from err
        # (samples per chain, chains, D) -> (chain, draw, D)
        return az.convert_to_inference_data(np.swapaxes(draws.cpu().numpy(), 0, 1))
