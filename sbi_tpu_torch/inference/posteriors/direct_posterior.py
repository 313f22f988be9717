"""DirectPosterior: NPE sampling with prior-support rejection and
leakage-corrected log_prob.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/direct_posterior.py``.
``sample_batched`` fills observations that starve in the rejection loop by
one vectorized MCMC run over them (``starvation_policy="mcmc"``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...neural_nets.estimators.base import ConditionalDensityEstimator
from ...samplers.rejection.rejection import accept_reject_sample
from ...utils.sbiutils import ensure_theta_batched, next_generator, within_support
from ..potentials.posterior_based_potential import posterior_estimator_based_potential
from .base_posterior import NeuralPosterior


class DirectPosterior(NeuralPosterior):
    def __init__(
        self,
        posterior_estimator: ConditionalDensityEstimator,
        prior,
        max_sampling_batch_size: int = 10_000,
        device=None,
        x_shape=None,
        enable_transform: bool = True,
    ):
        if device is not None and torch.device(device) != posterior_estimator.device:
            raise ValueError(
                f"device {device} differs from the estimator's "
                f"{posterior_estimator.device}; move the estimator first."
            )
        potential_fn, theta_transform = posterior_estimator_based_potential(
            posterior_estimator, prior, x_o=None, enable_transform=enable_transform
        )
        super().__init__(potential_fn, theta_transform, posterior_estimator.device, x_shape)
        self.prior = prior
        self.posterior_estimator = posterior_estimator
        self.max_sampling_batch_size = max_sampling_batch_size
        self._leakage_density_correction = {}
        self._purpose = (
            "It samples the posterior network and rejects samples that lie "
            "outside of the prior bounds."
        )

    # ----------------------------------------------------------------- sample
    @torch.no_grad()
    def sample(
        self,
        sample_shape=(),
        x=None,
        generator: Optional[torch.Generator] = None,
        max_sampling_batch_size: Optional[int] = None,
        show_progress_bars: bool = False,
        max_sampling_time: Optional[float] = None,
        **kwargs,
    ) -> torch.Tensor:
        generator = next_generator(generator, self._device)
        x = self._x_else_default_x(x)
        num_samples = 1
        for s in sample_shape:
            num_samples *= int(s)
        batch = max_sampling_batch_size or self.max_sampling_batch_size
        est = self.posterior_estimator

        def proposal(g, n):
            return est.sample((n,), x, generator=g)[:, 0, :]

        def accept(samples):
            return within_support(self.prior, samples)

        samples, _ = accept_reject_sample(
            proposal,
            accept,
            num_samples,
            generator=generator,
            sample_batch_size=min(batch, max(num_samples, 1000)),
            warn_acceptance=0.01,
            max_sampling_time=max_sampling_time,
            alternative_method="build_posterior(..., sample_with='mcmc')",
        )
        return samples.reshape(tuple(sample_shape) + est.input_shape)

    @torch.no_grad()
    def sample_batched(
        self,
        sample_shape,
        x,
        generator: Optional[torch.Generator] = None,
        max_sampling_batch_size: Optional[int] = None,
        max_total_proposals: int = 200_000,
        starvation_policy: str = "mcmc",
        mesh=None,
        **kwargs,
    ) -> torch.Tensor:
        """Vectorized over a batch of observations: (sample..., B, D).

        All observations share one rejection loop; each round is ONE batched
        flow inversion over all B conditions plus a vectorized scatter-fill
        (per-column cumsum -> flat scatter, overflow into a discarded row).
        The per-round proposal count grows geometrically up to
        ``max_sampling_batch_size``.

        Observations still starved after ``max_total_proposals`` proposals
        are not filled with duplicates. ``starvation_policy``:
          - ``"mcmc"`` (default): their columns are replaced by exact samples
            of their truncated posteriors, from one vectorized slice-sampling
            run over all of them (``MCMCPosterior.sample_batched``).
          - ``"raise"``: RuntimeError naming the starved acceptance rate.
        """
        if starvation_policy not in ("mcmc", "raise"):
            raise ValueError(f"Unknown starvation_policy {starvation_policy!r}")
        if mesh is not None:
            raise NotImplementedError(
                "sample_batched(mesh=...) is not ported yet; multi-GPU sharding "
                "comes with a later slice."
            )
        generator = next_generator(generator, self._device)
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
        B = x.shape[0]
        S = 1
        for s in sample_shape:
            S *= int(s)
        est = self.posterior_estimator
        D = est.input_shape[0]
        max_batch = max_sampling_batch_size or self.max_sampling_batch_size
        per_round = min(max(S, 256), max_batch)

        # Row S*B of the buffer takes every proposal that is rejected or
        # arrives after its column is full; it is dropped at the end.
        collected = torch.zeros((S * B + 1, D), device=self._device)
        counts = torch.zeros((B,), dtype=torch.long, device=self._device)
        col = torch.arange(B, device=self._device)[None, :]
        proposals = 0
        while proposals < max_total_proposals:
            R = per_round
            cand = est.sample((R,), x, generator=generator)  # (R, B, D)
            ok = within_support(self.prior, cand.reshape(-1, D)).reshape(R, B)
            slots = counts[None, :] + torch.cumsum(ok.long(), dim=0) - 1  # (R, B)
            valid = ok & (slots < S)
            flat_idx = torch.where(valid, slots * B + col, torch.full_like(slots, S * B))
            collected[flat_idx.reshape(-1)] = cand.reshape(-1, D)
            counts = torch.clamp(counts + ok.sum(dim=0), max=S)
            proposals += R
            if int(counts.min()) >= S:
                break
            per_round = min(per_round * 4, max_batch)

        counts_np = counts.cpu().numpy()
        worst = int(counts_np.min())
        if worst < S:
            starved = [b for b in range(B) if int(counts_np[b]) < S]
            acceptance = worst / proposals
            if starvation_policy == "raise":
                raise RuntimeError(
                    f"sample_batched: {len(starved)}/{B} observations starved "
                    f"after {proposals} proposals (worst acceptance "
                    f"{acceptance:.2e}) — the posterior leaks (almost) all "
                    "mass outside the prior support for these x. Retrain, or "
                    "use starvation_policy='mcmc' / sample_with='mcmc'."
                )
            out = self._mcmc_fill_starved(collected[: S * B].reshape(S, B, D), x, starved, S,
                                          generator)
            return out.reshape(tuple(sample_shape) + (B, D))
        return collected[: S * B].reshape(tuple(sample_shape) + (B, D))

    def _mcmc_fill_starved(self, collected, x, starved, S, generator):
        """Replace the starved observations' columns of ``collected`` (S, B,
        D) with samples of their truncated posteriors from one vectorized
        MCMC run over all of them."""
        from .mcmc_posterior import MCMCPosterior

        mcmc = MCMCPosterior(
            self.potential_fn,
            proposal=self.prior,
            theta_transform=self.theta_transform,
            num_chains=min(100, max(20, S // 10)),
            warmup_steps=200,
        )
        idx = torch.as_tensor(starved, device=self._device)
        collected[:, idx] = mcmc.sample_batched((S,), x=x[idx], generator=generator)
        return collected

    # ---------------------------------------------------------------- log_prob
    def log_prob(
        self,
        theta,
        x=None,
        norm_posterior: bool = True,
        leakage_correction_params: Optional[dict] = None,
        **kwargs,
    ) -> torch.Tensor:
        """Leakage-corrected normalized log prob."""
        theta = ensure_theta_batched(theta, self._device)
        x = self._x_else_default_x(x)
        est = self.posterior_estimator
        lp = est.log_prob(theta[:, None, :], x)[:, 0]
        in_support = within_support(self.prior, theta)
        lp = torch.where(in_support, lp, torch.full_like(lp, -math.inf))
        if norm_posterior:
            params = leakage_correction_params or {}
            log_factor = torch.log(self.leakage_correction(x, **params))
            lp = lp - log_factor
        return lp

    @torch.no_grad()
    def leakage_correction(
        self,
        x,
        num_rejection_samples: int = 10_000,
        force_update: bool = False,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ) -> torch.Tensor:
        """Acceptance mass inside the prior support, cached per-x. Returns a
        per-observation tensor of shape ``(B,)`` for batched ``x`` (B > 1)
        and a scalar for a single observation."""
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
        cache_key = np.ascontiguousarray(x.cpu().numpy()).tobytes()
        if not force_update and cache_key in self._leakage_density_correction:
            return self._leakage_density_correction[cache_key]
        est = self.posterior_estimator
        B = x.shape[0]
        samples = est.sample((num_rejection_samples,), x, generator=generator)  # (N, B, D)
        D = samples.shape[-1]
        ok = within_support(self.prior, samples.reshape(-1, D)).reshape(num_rejection_samples, B)
        acceptance = ok.float().mean(dim=0)  # per-observation
        acceptance = acceptance.clamp(1e-9, 1.0)
        if B == 1:
            acceptance = acceptance[0]
        self._leakage_density_correction[cache_key] = acceptance
        return acceptance

    def log_prob_batched(self, theta, x, **kwargs) -> torch.Tensor:
        """theta (S, B, D), x (B, ...) -> (S, B)."""
        est = self.posterior_estimator
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self._device)
        lp = est.log_prob(theta, x)
        S, B = lp.shape
        in_support = within_support(self.prior, theta.reshape(S * B, -1)).reshape(S, B)
        lp = torch.where(in_support, lp, torch.full_like(lp, -math.inf))
        corrections = torch.log(torch.atleast_1d(self.leakage_correction(x)))
        return lp - corrections[None, :]
