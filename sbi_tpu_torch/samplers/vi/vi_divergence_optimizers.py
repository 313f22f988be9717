"""Variational divergences and their registry.

PyTorch counterpart of ``sbi_tpu/samplers/vi/vi_divergence_optimizers.py``:
the reverse KL with sticking-the-landing (``"rKL"``), the
importance-weighted ELBO (``"IW"``), the self-normalised forward KL
(``"fKL"``) and the Renyi alpha bound (``"alpha"``). Each is a loss over
the variational flow's parameters, which ``VIPosterior.train`` minimises.

Interface: every loss is
  ``fn(params, generator, sample_and_log_prob, log_prob_at, potential_u,
  num_particles, **kwargs) -> scalar``
with ``params`` a dict of the flow's parameters (as its
``named_parameters()`` names them) and
  ``sample_and_log_prob(params, generator, n) -> (u (n, D), log_q (n,))``,
  reparameterised (differentiable in ``params``);
  ``log_prob_at(params, u) -> (n,)``;
  ``potential_u(u) -> (n,)``, the unnormalised log posterior in the
  unconstrained space.
The JAX package's ``stop_gradient(params)`` is the dict of detached
parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

_REGISTRY: Dict[str, Callable] = {}


def register_VI_method(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_VI_method(name: str) -> Callable:
    if name not in _REGISTRY:
        raise NotImplementedError(f"Unknown VI divergence '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_default_VI_method() -> tuple:
    return tuple(sorted(_REGISTRY))


def _detached(params):
    return {k: v.detach() for k, v in params.items()}


@register_VI_method("rKL")
def reverse_kl_loss(params, generator, sample_and_log_prob, log_prob_at, potential_u,
                    num_particles, stick_the_landing: bool = True, **kwargs):
    """ELBO / reverse KL. Sticking-the-landing scores the particles under
    detached parameters: the gradient keeps the path term of log q and
    drops its score term (lower variance near the optimum)."""
    u, log_q_path = sample_and_log_prob(params, generator, num_particles)
    log_q = log_prob_at(_detached(params), u) if stick_the_landing else log_q_path
    return torch.mean(log_q - potential_u(u))


@register_VI_method("IW")
def iw_elbo_loss(params, generator, sample_and_log_prob, log_prob_at, potential_u,
                 num_particles, K: int = 8, **kwargs):
    """Importance-weighted ELBO over groups of K particles."""
    n = max(num_particles // K, 1)
    u, log_q = sample_and_log_prob(params, generator, n * K)
    logw = (potential_u(u) - log_q).reshape(n, K)
    return -torch.mean(torch.logsumexp(logw, dim=1) - math.log(K))


@register_VI_method("fKL")
def forward_kl_loss(params, generator, sample_and_log_prob, log_prob_at, potential_u,
                    num_particles, **kwargs):
    """Self-normalised forward KL: -E_p[log q], the weights from q as the
    proposal. The particles and weights carry no gradient, so they are
    drawn without recording one."""
    with torch.no_grad():
        u, log_q = sample_and_log_prob(params, generator, num_particles)
        w = torch.softmax(potential_u(u) - log_q, dim=0)
    return -torch.sum(w * log_prob_at(params, u))


@register_VI_method("alpha")
def renyi_loss(params, generator, sample_and_log_prob, log_prob_at, potential_u,
               num_particles, alpha: float = 0.5, **kwargs):
    """Renyi alpha-divergence bound."""
    u, log_q = sample_and_log_prob(params, generator, num_particles)
    logw = (1.0 - alpha) * (potential_u(u) - log_q)
    return -(torch.logsumexp(logw, dim=0) - math.log(float(num_particles))) / (1.0 - alpha)
