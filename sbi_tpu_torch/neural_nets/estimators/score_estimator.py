"""Conditional score estimators with VP / subVP / VE SDE schedules.

PyTorch counterpart of ``sbi_tpu/neural_nets/estimators/score_estimator.py``.
The network predicts the noise eps-hat; the score in z space is
-eps_hat / std_t.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...utils.sbiutils import next_generator
from .base import ConditionalVectorFieldEstimator, as_times


class ConditionalScoreEstimator(ConditionalVectorFieldEstimator):
    """Base score estimator; subclasses fix the SDE geometry."""

    SCORE_DEFINED = True
    SDE_DEFINED = True
    MARGINALS_DEFINED = True

    t_min: float = 1e-3
    t_max: float = 1.0

    def __init__(
        self,
        net,
        input_shape,
        condition_shape,
        input_transform=None,
        condition_transform=None,
        weight_fn: str = "max_likelihood",
        condition_dropout: float = 0.0,
    ):
        super().__init__(net, input_shape, condition_shape, input_transform, condition_transform)
        self.weight_fn = weight_fn
        # > 0 enables classifier-free guidance: the condition is zeroed with
        # this probability in training, so the net also learns the
        # unconditional score.
        self.condition_dropout = condition_dropout

    # --------------------------------------------------------------- forward
    def forward(self, input, condition, time) -> torch.Tensor:
        """Score in raw theta space: input (B, D) raw, condition (B, ...)
        raw, time a number or (B,) -> (B, D)."""
        z, _ = self.input_transform.forward_and_log_det(input)
        score_z = self.score_z_fn(z, self._embed_condition(condition), time)
        # d z / d theta = 1 / scale, so score_theta = score_z / scale.
        scale = getattr(self.input_transform, "scale", None)
        return score_z if scale is None else score_z / scale

    def score(self, input, condition, time) -> torch.Tensor:
        return self.forward(input, condition, time)

    def ode_fn(self, input, condition, time) -> torch.Tensor:
        """Probability-flow ODE velocity in z space (input is z)."""
        return self.ode_z_fn(input, self._embed_condition(condition), time)

    def score_z_fn(self, z, condition_z, time, embedded: bool = False) -> torch.Tensor:
        """Score in z space; ``condition_z`` z-scored (or embedded, with
        ``embedded=True``)."""
        t = as_times(time, z.shape[0], z.device)
        return -self._net(z, condition_z, t, embedded) / self.std_fn(t)[:, None]

    def ode_z_fn(self, z, condition_z, time, embedded: bool = False) -> torch.Tensor:
        """Probability-flow ODE velocity in z space: drift - g^2 score / 2."""
        t = as_times(time, z.shape[0], z.device)
        score_z = self.score_z_fn(z, condition_z, t, embedded)
        return self.drift_fn(z, t) - 0.5 * self.diffusion_fn(z, t) ** 2 * score_z

    # ------------------------------------------------------------------ loss
    def loss(self, input, condition, times: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoising score matching, per row (B,):
        ||eps_hat(mean_t z + std_t eps, x, t) - eps||^2 / D.

        ``times`` (B,) default uniform on [t_min, t_max]; ``noise`` (B, D)
        the eps, default standard normal. Both are drawn from
        ``generator``."""
        z, _ = self.input_transform.forward_and_log_det(input)
        zc = self._embed_condition(condition)
        B = z.shape[0]
        gen = next_generator(generator, z.device)
        if times is None:
            times = self.t_min + (self.t_max - self.t_min) * torch.rand(
                B, generator=gen, device=z.device)
        eps = torch.randn(z.shape, generator=gen, device=z.device) if noise is None else noise
        z_t = self.mean_t_fn(times)[:, None] * z + self.std_fn(times)[:, None] * eps
        if self.condition_dropout > 0.0:
            keep = torch.rand(B, generator=gen, device=z.device) < 1.0 - self.condition_dropout
            zc = zc * keep.reshape((B,) + (1,) * (zc.dim() - 1))
        eps_hat = self.net(z_t, zc, times)
        return ((eps_hat - eps) ** 2).mean(dim=-1)


class VPScoreEstimator(ConditionalScoreEstimator):
    """Variance-preserving SDE (DDPM-like)."""

    def __init__(self, *args, beta_min: float = 0.1, beta_max: float = 20.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.beta_min = beta_min
        self.beta_max = beta_max

    def _beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def _int_beta(self, t):
        return self.beta_min * t + 0.5 * t**2 * (self.beta_max - self.beta_min)

    def mean_t_fn(self, times):
        return torch.exp(-0.5 * self._int_beta(times))

    def std_fn(self, times):
        return torch.sqrt(torch.clamp(1.0 - torch.exp(-self._int_beta(times)), min=1e-6))

    def drift_fn(self, input, times):
        return -0.5 * self._beta(times)[:, None] * input

    def diffusion_fn(self, input, times):
        return torch.sqrt(self._beta(times))[:, None]


class SubVPScoreEstimator(VPScoreEstimator):
    """Sub-VP SDE."""

    def std_fn(self, times):
        return torch.clamp(1.0 - torch.exp(-self._int_beta(times)), min=1e-4)

    def diffusion_fn(self, input, times):
        disc = 1.0 - torch.exp(-2.0 * self._int_beta(times))
        return torch.sqrt(self._beta(times) * disc)[:, None]


class VEScoreEstimator(ConditionalScoreEstimator):
    """Variance-exploding SDE (SMLD)."""

    def __init__(self, *args, sigma_min: float = 0.01, sigma_max: float = 10.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def _sigma(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def mean_t_fn(self, times):
        return torch.ones_like(times)

    def std_fn(self, times):
        return self._sigma(times)

    def drift_fn(self, input, times):
        return torch.zeros_like(input)

    def diffusion_fn(self, input, times):
        log_ratio = math.log(self.sigma_max / self.sigma_min)
        return (self._sigma(times) * math.sqrt(2.0 * log_ratio))[:, None]
