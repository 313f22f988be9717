"""Reverse-SDE sampling: the predictor-corrector loop.

PyTorch counterpart of ``sbi_tpu/samplers/score/diffuser.py``: the
predictor and corrector registries, Euler-Maruyama, the Langevin and
(pseudo) Gibbs correctors, and ``Diffuser.run`` for one or a batch of
observations. All samples advance together; the time grid is Python floats
on the host and every per-step quantity stays on the device, so a step
raises no host sync. The run with an explicit score function (iid
composition and guidance) comes with a later slice.

Predictors are ``fn(estimator, z, condition, t0, t1, generator)`` and
correctors ``fn(estimator, z, condition, t, generator, **params)``, where
``condition`` is the observation already embedded
(``estimator.embed_condition``), one row per row of z.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Optional, Union

import torch

from ...utils.sbiutils import next_generator

PREDICTORS = {}
CORRECTORS = {}


def register_predictor(name):
    def deco(fn):
        PREDICTORS[name] = fn
        return fn

    return deco


def register_corrector(name):
    def deco(fn):
        CORRECTORS[name] = fn
        return fn

    return deco


def _times(t: float, z: torch.Tensor) -> torch.Tensor:
    return torch.full((z.shape[0],), float(t), device=z.device)


@register_predictor("euler_maruyama")
def euler_maruyama_predictor(estimator, z, condition, t0: float, t1: float, generator):
    """One reverse-SDE Euler-Maruyama step from t0 to t1 (< t0):
    dz = [f(z, t) - g(t)^2 s(z, t)] dt + g(t) dW in reverse time."""
    dt = t1 - t0  # negative
    t0b = _times(t0, z)
    score = estimator.score_z_fn(z, condition, t0b, embedded=True)
    drift = estimator.drift_fn(z, t0b)
    diff = estimator.diffusion_fn(z, t0b)
    eps = torch.randn(z.shape, generator=generator, device=z.device)
    return z + (drift - diff**2 * score) * dt + diff * math.sqrt(-dt) * eps


@register_corrector("langevin")
def langevin_corrector(estimator, z, condition, t: float, generator, snr: float = 0.16,
                       num_steps: int = 1, **kwargs):
    """Langevin steps at time t, the step size set from the signal-to-noise
    ratio ``snr`` and the mean score norm (on the device)."""
    tb = _times(t, z)
    noise_norm = math.sqrt(z.shape[-1])
    for _ in range(num_steps):
        score = estimator.score_z_fn(z, condition, tb, embedded=True)
        noise = torch.randn(z.shape, generator=generator, device=z.device)
        grad_norm = torch.linalg.vector_norm(score, dim=-1, keepdim=True).mean()
        eps = 2 * (snr * noise_norm / torch.clamp(grad_norm, min=1e-8)) ** 2
        z = z + eps * score + torch.sqrt(2 * eps) * noise
    return z


@register_corrector("gibbs")
def gibbs_corrector(estimator, z, condition, t: float, generator, t_prev: Optional[float] = None,
                    num_steps: int = 5, **kwargs):
    """(Pseudo) Gibbs corrector: re-noise one step forward by the forward
    SDE (t -> t_prev), then denoise by the reverse predictor (t_prev -> t),
    a move that keeps the time-t marginal."""
    t1 = float(t)
    t0 = float(t_prev) if t_prev is not None else min(t1 * 1.25 + 1e-3, estimator.t_max)
    dt = t0 - t1  # positive: forward in diffusion time
    t1b = _times(t1, z)
    for _ in range(num_steps):
        f = estimator.drift_fn(z, t1b)
        g = estimator.diffusion_fn(z, t1b)
        eps = torch.randn(z.shape, generator=generator, device=z.device)
        z = z + f * dt + g * math.sqrt(dt) * eps
        z = euler_maruyama_predictor(estimator, z, condition, t0, t1, generator)
    return z


def _takes_t_prev(corrector: Callable) -> bool:
    """Whether a corrector declares ``t_prev`` (or ``**kwargs``): the
    registry is public, and correctors without it keep working."""
    try:
        params = inspect.signature(corrector).parameters
    except (TypeError, ValueError):
        return False
    return "t_prev" in params or any(p.kind is inspect.Parameter.VAR_KEYWORD
                                     for p in params.values())


class Diffuser:
    """Predictor-corrector reverse diffusion."""

    def __init__(
        self,
        vector_field_estimator,
        predictor: Union[str, Callable] = "euler_maruyama",
        corrector: Optional[Union[str, Callable]] = None,
        corrector_params: Optional[dict] = None,
    ):
        self.estimator = vector_field_estimator
        self.predictor = PREDICTORS[predictor] if isinstance(predictor, str) else predictor
        self.corrector = CORRECTORS[corrector] if isinstance(corrector, str) else corrector
        self.corrector_params = corrector_params or {}

    @torch.no_grad()
    def run(
        self,
        num_samples: int,
        x,
        steps: int = 500,
        ts=None,
        generator: Optional[torch.Generator] = None,
        score_fn: Optional[Callable] = None,
    ) -> torch.Tensor:
        """Samples (num_samples, B, D) in raw theta space, for the B rows of
        ``x``. ``ts`` (default ``solve_schedule(steps)``, t_max -> t_min) is
        read on the host once, before the loop."""
        if score_fn is not None:
            raise NotImplementedError(
                "Diffuser.run(score_fn=...) (iid composition and guidance) comes with a later "
                "slice of the port.")
        est = self.estimator
        device = est.device
        gen = next_generator(generator, device)
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=device))
        B, D = x.shape[0], est.input_shape[0]
        # Embedded once, repeated observation-major: rows b*S .. b*S + S - 1
        # belong to observation b.
        c = est.embed_condition(est._embed_condition(x))
        cond_rep = c.repeat_interleave(num_samples, dim=0)
        grid = est.solve_schedule(steps) if ts is None else torch.as_tensor(ts, dtype=torch.float32)
        grid = grid.tolist()
        z = est.std_at(grid[0]) * torch.randn((B * num_samples, D), generator=gen, device=device)
        corrector, extra = self.corrector, {}
        takes_t_prev = corrector is not None and _takes_t_prev(corrector)
        for t0, t1 in zip(grid[:-1], grid[1:]):
            z = self.predictor(est, z, cond_rep, t0, t1, gen)
            if corrector is not None:
                if takes_t_prev:
                    extra = {"t_prev": t0}
                z = corrector(est, z, cond_rep, t1, gen, **extra, **self.corrector_params)
        theta = est.input_transform.inverse(z)
        if B == 1:
            return theta.reshape(num_samples, 1, D)
        return theta.reshape(B, num_samples, D).transpose(0, 1)
