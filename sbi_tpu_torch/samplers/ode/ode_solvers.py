"""Neural-ODE solving and the CNF log-prob.

PyTorch counterpart of ``sbi_tpu/samplers/ode/ode_solvers.py``: fixed-grid
RK4, with the divergence for the log-prob exact (a per-sample Jacobian by
forward-mode AD, ``torch.func.jacfwd`` under ``vmap``: the low-dim theta
spaces of SBI) or the Hutchinson estimate. The time grid is Python floats
on the host, so a step raises no host sync.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

from ...utils.sbiutils import next_generator

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _grid(t0: float, t1: float, num_steps: int) -> List[float]:
    """``num_steps + 1`` float32 times from t0 to t1, as Python floats."""
    return torch.linspace(float(t0), float(t1), num_steps + 1).tolist()


def rk4_step(f: Callable, z: torch.Tensor, t0: float, dt: float) -> torch.Tensor:
    k1 = f(z, t0)
    k2 = f(z + 0.5 * dt * k1, t0 + 0.5 * dt)
    k3 = f(z + 0.5 * dt * k2, t0 + 0.5 * dt)
    k4 = f(z + dt * k3, t0 + dt)
    return z + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def odeint_rk4(f: Callable, z0: torch.Tensor, t0: float, t1: float,
               num_steps: int = 64) -> torch.Tensor:
    """Integrate dz/dt = f(z, t) from t0 to t1 on a fixed grid."""
    ts = _grid(t0, t1, num_steps)
    z = z0
    for a, b in zip(ts[:-1], ts[1:]):
        z = rk4_step(f, z, a, b - a)
    return z


def _exact_divergence(f: Callable) -> Callable:
    """(z, t) -> (f(z, t), div f) with the exact per-sample divergence: the
    trace of each row's D x D Jacobian, by forward-mode AD."""

    def fn(z, t):
        def single(zi):
            out = f(zi[None], t)[0]
            return out, out

        jac, value = torch.func.vmap(torch.func.jacfwd(single, has_aux=True))(z)
        return value, jac.diagonal(dim1=-2, dim2=-1).sum(-1)

    return fn


def _hutchinson_divergence(f: Callable, eps: torch.Tensor) -> Callable:
    """(z, t) -> (f(z, t), eps^T J eps) with a fixed probe ``eps``."""

    def fn(z, t):
        value, jvp = torch.func.jvp(lambda u: f(u, t), (z,), (eps,))
        return value, (jvp * eps).sum(-1)

    return fn


def odeint_with_logdet(
    f: Callable,
    z0: torch.Tensor,
    t0: float,
    t1: float,
    num_steps: int = 64,
    exact: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CNF flow with the instantaneous change of variables, d log p / dt =
    -div f, by RK4 on the augmented system. Returns (z(t1), the integral
    of div f from t0 to t1)."""
    if exact:
        aug = _exact_divergence(f)
    else:
        eps = torch.randn(z0.shape, generator=next_generator(generator, z0.device),
                          device=z0.device)
        aug = _hutchinson_divergence(f, eps)
    ts = _grid(t0, t1, num_steps)
    z, ld = z0.contiguous(), z0.new_zeros(z0.shape[0])  # a dual tensor needs its own memory
    for a, b in zip(ts[:-1], ts[1:]):
        dt = b - a
        k1z, k1l = aug(z, a)
        k2z, k2l = aug(z + 0.5 * dt * k1z, a + 0.5 * dt)
        k3z, k3l = aug(z + 0.5 * dt * k2z, a + 0.5 * dt)
        k4z, k4l = aug(z + dt * k3z, a + dt)
        z = z + dt / 6.0 * (k1z + 2 * k2z + 2 * k3z + k4z)
        ld = ld + dt / 6.0 * (k1l + 2 * k2l + 2 * k3l + k4l)
    return z, ld


class NeuralODE:
    """CNF distribution over theta given an ODE velocity field: time runs
    from ``t_noise`` to ``t_data``, mapping N(0, noise_std^2 I) noise to
    data in z space; ``input_transform`` maps z back to theta."""

    def __init__(
        self,
        ode_fn: Callable,  # (z (B, D), t float) -> (B, D)
        input_transform,
        dim: int,
        t_noise: float,
        t_data: float,
        num_steps: int = 64,
        noise_std: float = 1.0,
        device=None,
    ):
        self.ode_fn = ode_fn
        self.input_transform = input_transform
        self.dim = dim
        self.t_noise = t_noise
        self.t_data = t_data
        self.num_steps = num_steps
        self.noise_std = noise_std
        self.device = device

    def sample(self, num_samples: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z0 = self.noise_std * torch.randn((num_samples, self.dim), device=self.device,
                                          generator=next_generator(generator, self.device))
        z1 = odeint_rk4(self.ode_fn, z0, self.t_noise, self.t_data, self.num_steps)
        return self.input_transform.inverse(z1)

    def log_prob(self, theta: torch.Tensor) -> torch.Tensor:
        """The base log-density of the noise the ODE maps theta to, plus the
        integrated divergence and the z-scoring's log-det."""
        z1, ldj = self.input_transform.forward_and_log_det(theta)
        z0, logdet = odeint_with_logdet(self.ode_fn, z1, self.t_data, self.t_noise, self.num_steps)
        base_lp = (-0.5 * (z0 / self.noise_std) ** 2 - math.log(self.noise_std)
                   - _LOG_SQRT_2PI).sum(-1)
        # Integrating backward accumulates +div: log p(data) = base + logdet.
        return base_lp + logdet + ldj


def build_neural_ode(estimator, condition, num_steps: int = 64) -> NeuralODE:
    """The CNF over theta given one observation (the first row of
    ``condition``): the estimator's probability-flow velocity, with the
    observation embedded once. Score estimators run from t_max (noise of
    std ``std_fn(t_max)``) to t_min; flow matching from 0 (std 1) to 1."""
    est = estimator
    condition = torch.atleast_2d(torch.as_tensor(condition, dtype=torch.float32,
                                                 device=est.device))
    with torch.no_grad():
        c = est.embed_condition(est._embed_condition(condition[:1]))

    def f(z, t):
        return est.ode_z_fn(z, c, t, embedded=True)

    if est.SDE_DEFINED:
        t_noise, t_data, noise_std = est.t_max, est.t_min, est.std_at(est.t_max)
    else:
        t_noise, t_data, noise_std = est.t_min, est.t_max, 1.0
    return NeuralODE(ode_fn=f, input_transform=est.input_transform, dim=est.input_shape[0],
                     t_noise=t_noise, t_data=t_data, num_steps=num_steps, noise_std=noise_std,
                     device=est.device)
