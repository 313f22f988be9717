"""Flow-matching estimator (rectified flow / conditional OT paths).

PyTorch counterpart of
``sbi_tpu/neural_nets/estimators/flowmatching_estimator.py``. Path:
z_t = (1 - t) z0 + t z1, z0 ~ N(0, I), z1 = data; target velocity z1 - z0.
Time runs from 0 (noise) to 1 (data).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.sbiutils import next_generator
from .base import ConditionalVectorFieldEstimator, as_times


class FlowMatchingEstimator(ConditionalVectorFieldEstimator):
    SCORE_DEFINED = True
    SDE_DEFINED = False
    MARGINALS_DEFINED = True

    t_min: float = 0.0
    t_max: float = 1.0

    def __init__(self, net, input_shape, condition_shape, input_transform=None,
                 condition_transform=None, noise_scale: float = 1e-3,
                 gaussian_baseline: bool = False):
        super().__init__(net, input_shape, condition_shape, input_transform, condition_transform)
        self.noise_scale = noise_scale
        self.gaussian_baseline = gaussian_baseline

    def _baseline_velocity(self, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The analytic velocity of the data's Gaussian fit, which the net
        corrects: in z space that fit is N(0, I), so with independent z0, z1
        ~ N(0, I) on the OT path E[z1 - z0 | z_t] = (2t - 1) z_t / ((1 - t)^2
        + t^2). ``t`` is (B,)."""
        t = t[:, None]
        return (2.0 * t - 1.0) * z / ((1.0 - t) ** 2 + t**2)

    # --------------------------------------------------------------- forward
    def ode_z_fn(self, z, condition_z, time, embedded: bool = False) -> torch.Tensor:
        """Velocity in z space; ``condition_z`` z-scored (or embedded, with
        ``embedded=True``)."""
        t = as_times(time, z.shape[0], z.device)
        v = self._net(z, condition_z, t, embedded)
        if self.gaussian_baseline:
            v = v + self._baseline_velocity(z, t)
        return v

    def forward(self, input, condition, time) -> torch.Tensor:
        """Velocity in z space: input here is z_t (B, D)."""
        return self.ode_z_fn(input, self._embed_condition(condition), time)

    def ode_fn(self, input, condition, time) -> torch.Tensor:
        return self.forward(input, condition, time)

    def score_z_fn(self, z, condition_z, time, embedded: bool = False) -> torch.Tensor:
        """Score from the velocity, for the SDE samplers: with z0 ~ N(0, I),
        E[z1 | z_t] = z_t + (1 - t) v and score = (t E[z1 | z_t] - z_t) /
        (1 - t)^2, 1 - t clipped at ``noise_scale``."""
        t = as_times(time, z.shape[0], z.device)
        v = self.ode_z_fn(z, condition_z, t, embedded)
        one_m_t = torch.clamp(1.0 - t[:, None], min=self.noise_scale)
        z1_hat = z + one_m_t * v
        return (t[:, None] * z1_hat - z) / one_m_t**2

    def score(self, input, condition, time) -> torch.Tensor:
        """The score in z space (input is z_t), as ``score_z_fn``."""
        return self.score_z_fn(input, self._embed_condition(condition), time)

    # marginal statistics of the rectified-flow path
    def mean_t_fn(self, times):
        return times

    def std_fn(self, times):
        return torch.clamp(1.0 - times, min=self.noise_scale)

    # ------------------------------------------------------------------ loss
    def loss(self, input, condition, times: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Flow-matching loss per row (B,): ||v_hat(z_t, x, t) - (z1 -
        z0)||^2 / D. ``times`` (B,) default uniform on [0, 1); ``noise``
        (B, D) the z0, default standard normal; both from ``generator``."""
        z1, _ = self.input_transform.forward_and_log_det(input)
        zc = self._embed_condition(condition)
        B = z1.shape[0]
        gen = next_generator(generator, z1.device)
        if times is None:
            times = torch.rand(B, generator=gen, device=z1.device)
        z0 = torch.randn(z1.shape, generator=gen, device=z1.device) if noise is None else noise
        t = times[:, None]
        z_t = (1.0 - t) * z0 + t * z1
        v_hat = self.net(z_t, zc, times)
        if self.gaussian_baseline:
            # the net regresses only the residual to the analytic baseline
            v_hat = v_hat + self._baseline_velocity(z_t, times)
        return ((v_hat - (z1 - z0)) ** 2).mean(dim=-1)
