"""Benchmark tasks of the ported paths: two_moons, slcp and gaussian_linear.

PyTorch counterpart of ``sbi_tpu/simulators/tasks.py`` (simulators, SLCP's
exact likelihood and ``get_task`` for these three tasks). Simulators draw
their noise from an explicit ``torch.Generator`` on the device of ``theta``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..utils.distributions import BoxUniform, Distribution, MultivariateNormal
from ..utils.sbiutils import ensure_theta_batched, next_generator, resolve_device
from .linear_gaussian import linear_gaussian, true_posterior_linear_gaussian_mvn_prior


def two_moons_simulator(theta, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    theta = ensure_theta_batched(theta)
    g = next_generator(generator, theta.device)
    n = theta.shape[0]
    u = torch.rand((n,), generator=g, device=theta.device)
    a = -math.pi / 2 + math.pi * u
    r = 0.1 + 0.01 * torch.randn((n,), generator=g, device=theta.device)
    p = torch.stack([r * torch.cos(a) + 0.25, r * torch.sin(a)], dim=-1)
    sq2 = math.sqrt(2.0)
    shift = torch.stack(
        [-(theta[:, 0] + theta[:, 1]).abs() / sq2,
         (-theta[:, 0] + theta[:, 1]) / sq2],
        dim=-1,
    )
    return p + shift


def _slcp_cov(theta: torch.Tensor) -> torch.Tensor:
    s1 = theta[..., 2] ** 2
    s2 = theta[..., 3] ** 2
    rho = torch.tanh(theta[..., 4])
    c11 = s1**2
    c22 = s2**2
    c12 = rho * s1 * s2
    row1 = torch.stack([c11, c12], dim=-1)
    row2 = torch.stack([c12, c22], dim=-1)
    return torch.stack([row1, row2], dim=-2)  # (..., 2, 2)


def slcp_simulator(theta, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SLCP: 4 iid draws from a 2D Gaussian whose mean/cov come from theta."""
    theta = ensure_theta_batched(theta)
    g = next_generator(generator, theta.device)
    n = theta.shape[0]
    mean = theta[:, :2]
    cov = _slcp_cov(theta)
    # jitter for numerical stability of cholesky near rho=+-1
    chol = torch.linalg.cholesky(cov + 1e-6 * torch.eye(2, device=theta.device))
    eps = torch.randn((n, 4, 2), generator=g, device=theta.device)
    draws = mean[:, None, :] + torch.einsum("nij,ntj->nti", chol, eps)
    return draws.reshape(n, 8)


def slcp_log_likelihood(theta: torch.Tensor, x) -> torch.Tensor:
    """Exact log p(x | theta); theta (..., 5), x (8,) one observation (four
    2-D draws) -> (...,). Mirror of ``sbi_tpu/simulators/tasks.py:115``.

    The 2 x 2 Cholesky factor and the triangular solve are written out:
    ``torch.linalg.cholesky`` checks its result on the host, a device sync
    on every potential evaluation of an MCMC run."""
    x = torch.as_tensor(x, dtype=torch.float32, device=theta.device).reshape(4, 2)
    cov = _slcp_cov(theta)
    c11 = cov[..., 0, 0] + 1e-6
    c12 = cov[..., 0, 1]
    c22 = cov[..., 1, 1] + 1e-6
    l11 = torch.sqrt(c11)
    l21 = c12 / l11
    l22 = torch.sqrt(c22 - l21**2)
    diff = x - theta[..., None, :2]  # (..., 4, 2)
    y1 = diff[..., 0] / l11[..., None]
    y2 = (diff[..., 1] - l21[..., None] * y1) / l22[..., None]
    half_logdet = torch.log(l11) + torch.log(l22)
    lp_each = -0.5 * (y1**2 + y2**2) - half_logdet[..., None] - math.log(2 * math.pi)
    return lp_each.sum(-1)


@dataclass
class Task:
    name: str
    prior: Distribution
    simulator: Callable
    theta_dim: int
    x_dim: int
    reference_sampler: Optional[Callable] = None
    log_likelihood: Optional[Callable] = None

    def default_x_o(self, generator: Optional[torch.Generator] = None, theta_o=None):
        if theta_o is None:
            theta_o = self.prior.sample((1,), generator=generator)
        x_o = self.simulator(theta_o, generator=generator)
        return theta_o, x_o


def get_task(name: str, device=None) -> Task:
    if name == "two_moons":
        return Task(
            name="two_moons",
            prior=BoxUniform(-torch.ones(2), torch.ones(2), device=device),
            simulator=two_moons_simulator,
            theta_dim=2,
            x_dim=2,
        )
    if name == "slcp":
        return Task(
            name="slcp",
            prior=BoxUniform(-3 * torch.ones(5), 3 * torch.ones(5), device=device),
            simulator=slcp_simulator,
            theta_dim=5,
            x_dim=8,
            log_likelihood=slcp_log_likelihood,
        )
    if name == "gaussian_linear":
        # 10-D; prior N(0, 0.1 I), likelihood N(theta, 0.1 I).
        device = resolve_device(device)
        eye = 0.1 * torch.eye(10, device=device)
        zeros = torch.zeros(10, device=device)

        def sim(theta, generator=None):
            return linear_gaussian(theta, zeros, eye, generator=generator)

        def ref(x_o, num_samples, generator=None):
            post = true_posterior_linear_gaussian_mvn_prior(x_o, zeros, eye, zeros, eye)
            return post.sample((num_samples,), generator=generator)

        return Task("gaussian_linear", MultivariateNormal(zeros, covariance_matrix=eye, device=device), sim,
                    10, 10, reference_sampler=ref)
    if name in ("linear_mvg_2d", "gaussian_mixture"):
        raise NotImplementedError(
            f"Task '{name}' is not ported yet; it comes with a later slice."
        )
    raise ValueError(f"Unknown task {name}")
