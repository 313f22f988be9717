"""VectorFieldPosterior for NPSE and FMPE.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/vector_field_posterior.py``
for one observation and for a batch of observations: ``sample`` by the
reverse SDE (``Diffuser``) or the probability-flow ODE, then rejection on
the prior's support; ``sample_batched`` (one reverse-SDE run over all
observations and a scatter-fill); ``log_prob`` by the CNF. iid
observations, guidance and ``map`` come with later slices.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch

from ...samplers.rejection.rejection import accept_reject_sample
from ...samplers.score.diffuser import Diffuser
from ...utils.sbiutils import ensure_theta_batched, next_generator, within_support
from ..potentials.vector_field_potential import refuse_iid, vector_field_estimator_based_potential
from .base_posterior import NeuralPosterior

_LATER_SLICE = "comes with a later slice of the port"


class VectorFieldPosterior(NeuralPosterior):
    def __init__(
        self,
        vector_field_estimator,
        prior,
        max_sampling_batch_size: int = 10_000,
        device=None,
        x_shape=None,
        enable_transform: bool = True,
        sample_with: str = "sde",
        **kwargs,
    ):
        if device is not None and torch.device(device) != vector_field_estimator.device:
            raise ValueError(
                f"device {device} differs from the estimator's "
                f"{vector_field_estimator.device}; move the estimator first."
            )
        if sample_with not in ("sde", "ode"):
            raise ValueError("sample_with must be 'sde' or 'ode'.")
        potential_fn, theta_transform = vector_field_estimator_based_potential(
            vector_field_estimator, prior, x_o=None, enable_transform=enable_transform)
        super().__init__(potential_fn, theta_transform, vector_field_estimator.device, x_shape)
        self.prior = prior
        self.vector_field_estimator = vector_field_estimator
        self.sample_with = sample_with
        self.max_sampling_batch_size = max_sampling_batch_size
        self._purpose = "It samples from the diffusion model given the vector field estimator."

    # ----------------------------------------------------------------- sample
    def _proposal(self, x, method, predictor, corrector, corrector_params, steps, ts):
        """``fn(generator, n) -> (n, D)`` draws for the one observation
        ``x`` (1, ...), by the reverse SDE or the probability-flow ODE (at
        the potential's ``ode_steps``)."""
        if method == "sde":
            self._check_sde()
            diffuser = Diffuser(self.vector_field_estimator, predictor=predictor,
                                corrector=corrector, corrector_params=corrector_params)
            return lambda g, n: diffuser.run(n, x, steps=steps, ts=ts, generator=g)[:, 0, :]
        if method == "ode":
            node = self.potential_fn.neural_ode(x)

            def proposal(g, n):
                with torch.no_grad():
                    return node.sample(n, g)

            return proposal
        raise NotImplementedError(f"sample_with='{method}' not supported.")

    def _check_sde(self):
        if not self.vector_field_estimator.SDE_DEFINED:
            raise NotImplementedError(
                "sample_with='sde' needs a score estimator (NPSE); flow matching defines no "
                "SDE: sample with 'ode'.")

    def sample(
        self,
        sample_shape=(),
        x=None,
        generator: Optional[torch.Generator] = None,
        predictor: str = "euler_maruyama",
        corrector: Optional[str] = None,
        corrector_params: Optional[dict] = None,
        steps: int = 500,
        ts=None,
        sample_with: Optional[str] = None,
        show_progress_bars: bool = False,
        guidance_method: Optional[str] = None,
        guidance_params: Optional[dict] = None,
        **kwargs,
    ) -> torch.Tensor:
        """Draws for one observation: by default the reverse SDE in
        ``steps`` = 500 steps (``sample_with`` of the posterior), each batch
        of proposals then rejected outside the prior's support."""
        refuse_iid(None, iid_method=kwargs.get("iid_method"), guidance_method=guidance_method)
        generator = next_generator(generator, self._device)
        x = self._x_else_default_x(x)
        self.potential_fn.set_x(x)
        num_samples = 1
        for s in sample_shape:
            num_samples *= int(s)
        proposal = self._proposal(x, sample_with or self.sample_with, predictor, corrector,
                                  corrector_params, steps, ts)
        samples, _ = accept_reject_sample(
            proposal,
            lambda s: within_support(self.prior, s),
            num_samples,
            generator=generator,
            sample_batch_size=min(self.max_sampling_batch_size, max(num_samples, 1000)),
        )
        return samples.reshape(tuple(sample_shape) + self.vector_field_estimator.input_shape)

    def sample_via_ode(self, sample_shape=(), x=None, generator=None, **kwargs) -> torch.Tensor:
        return self.sample(sample_shape, x=x, generator=generator, sample_with="ode", **kwargs)

    def sample_batched(
        self,
        sample_shape,
        x,
        generator: Optional[torch.Generator] = None,
        predictor: str = "euler_maruyama",
        corrector: Optional[str] = None,
        corrector_params: Optional[dict] = None,
        steps: int = 500,
        ts=None,
        max_rejection_rounds: int = 20,
        mesh=None,
        **kwargs,
    ) -> torch.Tensor:
        """Draws for each row of ``x``: (sample..., B, D).

        By the SDE, one reverse-SDE run per round advances every
        observation's candidates, and a scatter-fill (as in
        ``DirectPosterior.sample_batched``) keeps those in the prior's
        support, one host sync a round. An observation still short after
        ``max_rejection_rounds`` rounds is filled by resampling its accepted
        draws, with a warning; one with none raises. By the ODE, each
        observation is sampled in turn."""
        if mesh is not None:
            raise NotImplementedError(f"sample_batched(mesh=...) {_LATER_SLICE}.")
        method = kwargs.pop("sample_with", None) or self.sample_with
        generator = next_generator(generator, self._device)
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
        B = x.shape[0]
        if method != "sde" or B == 1:
            outs = [self.sample(sample_shape, x=x[b][None], generator=generator,
                                sample_with=method, predictor=predictor, corrector=corrector,
                                corrector_params=corrector_params, steps=steps, ts=ts, **kwargs)
                    for b in range(B)]
            return torch.stack(outs, dim=len(tuple(sample_shape)))

        refuse_iid(None, iid_method=kwargs.get("iid_method"))
        self._check_sde()
        D = self.vector_field_estimator.input_shape[0]
        S = 1
        for s in sample_shape:
            S *= int(s)
        per_round = max(min(S, self.max_sampling_batch_size), 256)
        diffuser = Diffuser(self.vector_field_estimator, predictor=predictor, corrector=corrector,
                            corrector_params=corrector_params)
        # Row S*B takes every candidate rejected or past its column's S.
        collected = torch.zeros((S * B + 1, D), device=self._device)
        counts = torch.zeros((B,), dtype=torch.long, device=self._device)
        col = torch.arange(B, device=self._device)[None, :]
        for _ in range(max_rejection_rounds):
            cand = diffuser.run(per_round, x, steps=steps, ts=ts, generator=generator)  # (R, B, D)
            ok = within_support(self.prior, cand.reshape(-1, D)).reshape(per_round, B)
            slots = counts[None, :] + torch.cumsum(ok.long(), dim=0) - 1
            valid = ok & (slots < S)
            flat_idx = torch.where(valid, slots * B + col, torch.full_like(slots, S * B))
            collected[flat_idx.reshape(-1)] = cand.reshape(-1, D)
            counts = torch.clamp(counts + ok.sum(dim=0), max=S)
            if int(counts.min()) >= S:
                break
        collected = collected[: S * B].reshape(S, B, D)
        worst = int(counts.min())
        if worst == 0:
            raise RuntimeError(
                "sample_batched: no samples accepted for at least one observation within the "
                "sampling budget — the diffusion posterior puts (almost) all mass outside the "
                "prior support for that x. Retrain or sample via MCMC for it.")
        if worst < S:
            warnings.warn(
                "sample_batched: sampling budget exhausted before all observations collected "
                f"{S} in-support samples (worst: {worst}); starved rows are resampled from the "
                "accepted draws.")
            idx = (torch.rand((S, B), generator=generator, device=self._device)
                   * counts[None, :]).long()
            filled = torch.take_along_dim(collected, idx[:, :, None], dim=0)
            row = torch.arange(S, device=self._device)[:, None]
            collected = torch.where((row < counts[None, :])[:, :, None], collected, filled)
        return collected.reshape(tuple(sample_shape) + (B, D))

    # ---------------------------------------------------------------- log_prob
    @torch.no_grad()
    def log_prob(self, theta, x=None, norm_posterior: bool = False, **kwargs) -> torch.Tensor:
        """log p(theta | x) by the CNF (the potential's ``ode_steps`` RK4
        steps, exact divergence), -inf outside the prior's support."""
        theta = ensure_theta_batched(theta, self._device)
        x = self._x_else_default_x(x)
        refuse_iid(x)
        lp = self.potential_fn.neural_ode(x).log_prob(theta)
        return torch.where(within_support(self.prior, theta), lp, torch.full_like(lp, -math.inf))

    def map(self, x=None, **kwargs):
        raise NotImplementedError(f"VectorFieldPosterior.map (gradient ascent) {_LATER_SLICE}.")
