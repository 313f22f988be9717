"""VIPosterior: a normalizing flow q(theta) fitted to the potential.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/vi_posterior.py``:
the flow q built in the unconstrained space and pushed through the link
transform, the divergences of ``samplers/vi`` (rKL, fKL, IW, alpha),
``train``, ``train_amortized`` (a conditional q(theta | x)), ``sample``
(naive or SIR), ``log_prob``, the PSIS ``evaluate`` and ``map``.

Differences from the JAX package:

- ``train`` runs one eager optimizer step an iteration instead of one
  compiled scan; the loss history stays on the device and is read once at
  the end. The optimizer is the JAX package's ``optax.chain(
  clip_by_global_norm(clip_value), adam(exponential_decay(lr, 100,
  gamma)))``: the clip scales every gradient by clip_value / norm where the
  global norm reaches clip_value, and step i's learning rate is lr *
  gamma^(i / 100) (not staircase).
- ``train_amortized`` scores all observations in one flow pass: each
  observation's condition is tiled ``n_particles`` times into rows, as
  ``FlowModule.sample_and_log_prob`` tiles a batch of conditions, where the
  JAX package vmaps the per-observation loss. The loss is the same function
  of the base noise (``_amortized_loss``).
- ``q`` is the flow module (its parameters inside), where the JAX package
  gives (module, params). ``q="naf"`` and ``"unaf"`` (monotone flows) come
  with a later slice and raise ``NotImplementedError``.
- Draws come from a ``torch.Generator``; q's initial weights from the
  global CPU generator, as the builders initialise networks, so a seed
  gives the same q on every device.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Union

import numpy as np
import torch

from ...neural_nets.estimators.base import functional
from ...neural_nets.estimators.flows import FlowModule, init_flax_like_
from ...samplers.importance.importance_sampling import importance_sample, psis_k_hat
from ...samplers.mcmc.init_strategy import finite_or_neg_inf
from ...samplers.vi.vi_divergence_optimizers import get_VI_method
from ...utils.sbiutils import ensure_theta_batched, next_generator, resolve_device
from .base_posterior import NeuralPosterior

_LATER_SLICE = "comes with a later slice of the port (monotone flows)"


def _reverse_perm(dim):
    return ("permutation", dict(perm=tuple(range(dim - 1, -1, -1))))


def _alternating_mask(dim, i):
    if dim == 1:
        return (True,)
    return tuple(bool(m) for m in (np.arange(dim) % 2 == i % 2))


def _q_configs(dim: int, q: str):
    """The JAX package's layer configurations of each q family."""
    if q in ("naf", "unaf"):
        raise NotImplementedError(f"q='{q}' {_LATER_SLICE}.")
    if q == "gaussian_diag":
        return [("diag_affine", {})]  # mean-field Gaussian
    if q == "gaussian":
        # One affine autoregressive layer: a full-covariance Gaussian.
        return [("maf", dict(hidden_features=32, num_blocks=1))]
    configs = []
    if q == "maf":
        for _ in range(3):
            configs.append(("maf", dict(hidden_features=32, num_blocks=2)))
            if dim > 1:
                configs.append(_reverse_perm(dim))
    elif q == "nice":
        for i in range(4):
            configs.append(("additive_coupling",
                            dict(mask=_alternating_mask(dim, i), hidden_features=32)))
            configs.append(("lu_linear", {}))
    elif q == "nsf":  # coupling splines, one pass both ways (K = 8)
        if dim == 1:
            configs = [("rqs_ar", dict(hidden_features=32, num_bins=8))] * 2
        else:
            for i in range(3):
                configs.append(("rqs_coupling", dict(mask=_alternating_mask(dim, i),
                                                     hidden_features=32, num_bins=8)))
                configs.append(("lu_linear", {}))
    else:
        raise NotImplementedError(f"Unknown q '{q}'.")
    return configs


def _make_q_flow(dim: int, q: str, device=None) -> FlowModule:
    """The variational flow over the unconstrained space, initialised as
    flax initialises the JAX package's, from the global CPU generator, on
    ``device``."""
    module = FlowModule(dim=dim, layer_configs=tuple(_q_configs(dim, q)))
    init_flax_like_(module, next_generator(None, "cpu"))
    return module.to(device if device is not None else "cpu")


class _ScheduledAdam:
    """``optax.chain(clip_by_global_norm(clip_value),
    adam(exponential_decay(learning_rate, 100, gamma)))`` over ``params``:
    step i's learning rate is learning_rate * gamma^(i / 100). No host
    sync."""

    def __init__(self, params, learning_rate: float, gamma: float, clip_value: float):
        self.params = list(params)
        self.lr, self.gamma, self.clip_value = learning_rate, gamma, clip_value
        self.count = 0
        self.opt = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                    foreach=True)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        from ..trainers.base import clip_by_global_norm_

        for group in self.opt.param_groups:
            group["lr"] = self.lr * self.gamma ** (self.count / 100)
        clip_by_global_norm_([p.grad for p in self.params if p.grad is not None], self.clip_value)
        self.opt.step()
        self.count += 1


def _amortized_loss(est, pot_xfn, theta_transform, xs, z):
    """The amortized reverse-KL loss of the conditional flow ``est`` over
    observations ``xs`` (X, ...), from base noise ``z`` (n * X, D) in
    sample-major order (row r is particle r // X of observation r % X):
    mean over all rows of log q(u | x) - potential(theta, x) - log|det|."""
    X = xs.shape[0]
    n = z.shape[0] // X
    ctx = est.net._embed(est._embed_condition(xs)).repeat(n, 1)
    u, log_q = est.net.inverse_and_log_prob(z, ctx)
    theta, ldj = theta_transform.inverse_and_log_det(u)
    return torch.mean(log_q - pot_xfn(theta, xs.repeat(n, 1)) - ldj)


class VIPosterior(NeuralPosterior):
    def __init__(
        self,
        potential_fn,
        prior=None,
        q: Union[str, "VIPosterior"] = "maf",
        theta_transform=None,
        vi_method: str = "rKL",
        device=None,
        x_shape=None,
        parameters=None,
        modules=None,
    ):
        """``device=None`` takes the potential's device (an estimator's),
        else cuda, and raises without CUDA."""
        if device is None:
            device = getattr(potential_fn, "device", None)
        super().__init__(potential_fn, theta_transform, resolve_device(device), x_shape)
        self.prior = prior if prior is not None else getattr(self.potential_fn, "prior", None)
        self._q_name = q if isinstance(q, str) else "maf"
        if self._q_name in ("naf", "unaf"):
            raise NotImplementedError(f"q='{self._q_name}' {_LATER_SLICE}.")
        self.vi_method = vi_method
        self._dim = int(self.prior.event_shape[0]) if self.prior is not None else None
        self._q = None
        self._amortized_q = None
        self._trained = False
        self._purpose = "It provides Variational inference to .sample() from the posterior."

    # ------------------------------------------------------------------- q
    def set_vi_method(self, method: str) -> "VIPosterior":
        self.vi_method = method
        return self

    def _ensure_q(self):
        if self._q is None:
            self._q = _make_q_flow(self._dim, self._q_name, device=self._device)

    @property
    def q(self) -> Optional[FlowModule]:
        return self._q

    def _potential_u(self, u):
        theta, ldj = self.theta_transform.inverse_and_log_det(u)
        return self.potential_fn(theta) + ldj

    # ---------------------------------------------------------------- train
    def train(
        self,
        x=None,
        n_particles: int = 256,
        learning_rate: float = 1e-3,
        gamma: float = 0.999,
        max_num_iters: int = 2000,
        min_num_iters: int = 100,
        clip_value: float = 5.0,
        warm_up_rounds: int = 100,
        quality_control: bool = False,
        show_progress_bar: bool = False,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ) -> "VIPosterior":
        """Fit q by the selected divergence for ``max_num_iters`` steps
        (the JAX package's defaults; ``min_num_iters`` and
        ``warm_up_rounds`` are accepted and, as there, unused). The other
        keyword arguments go to the divergence (``K``, ``alpha``,
        ``stick_the_landing``)."""
        self.potential_fn.set_x(self._x_else_default_x(x))
        self._ensure_q()
        generator = next_generator(generator, self._device)
        q = self._q
        loss_impl = get_VI_method(self.vi_method)
        params = dict(q.named_parameters())
        # q's own parameters run q as it is; any others (the detached ones
        # of sticking-the-landing) through a functional call.
        sample_fn = functional(q, lambda n, g: q.sample_and_log_prob(n, None, g))
        log_prob_fn = functional(q, lambda u: q.log_prob(u, None))

        def sample_and_log_prob(p, g, n):
            u, log_q = q.sample_and_log_prob(n, None, g) if p is params else sample_fn(p, n, g)
            return u[:, 0, :], log_q[:, 0]

        def log_prob_at(p, u):
            return q.log_prob(u, None) if p is params else log_prob_fn(p, u)

        opt = _ScheduledAdam(params.values(), learning_rate, gamma, clip_value)
        losses = torch.empty(max_num_iters, device=self._device)
        for i in range(max_num_iters):
            loss = loss_impl(params, generator, sample_and_log_prob, log_prob_at,
                             self._potential_u, n_particles, **kwargs)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses[i] = loss.detach()
        self._trained = True
        self._losses = losses.cpu().numpy()  # the loop's one host read
        if quality_control:
            k_hat = self.evaluate(generator=generator)
            if k_hat > 1.0:
                warnings.warn(
                    f"PSIS k-hat = {k_hat:.2f} > 1.0: the variational approximation is "
                    "unreliable; consider retraining or another vi_method."
                )
        return self

    # ----------------------------------------------------------- amortized
    def _pure_potential_xfn(self):
        """potential(theta (N, D), x (N, ...)) -> (N,), row by row, with no
        state: the likelihood, posterior or ratio estimator's, as the JAX
        package's (its posterior branch has no support mask)."""
        from ..potentials.likelihood_based_potential import LikelihoodBasedPotential
        from ..potentials.posterior_based_potential import PosteriorBasedPotential
        from ..potentials.ratio_based_potential import RatioBasedPotential

        pot, prior = self.potential_fn, self.prior
        if isinstance(pot, LikelihoodBasedPotential):
            est = pot.likelihood_estimator
            return lambda theta, x: est.log_prob(x[None], theta)[0] + prior.log_prob(theta)
        if isinstance(pot, PosteriorBasedPotential):
            est = pot.posterior_estimator
            return lambda theta, x: est.log_prob(theta[None], x)[0]
        if isinstance(pot, RatioBasedPotential):
            est = pot.ratio_estimator
            return lambda theta, x: est.log_ratio(theta, x) + prior.log_prob(theta)
        raise NotImplementedError("train_amortized needs a likelihood/posterior/ratio potential.")

    def _amortized_estimator(self, xs):
        """The conditional q: ``build_nsf`` (hidden 32, 3 transforms, no
        theta z-scoring) over the unconstrained theta, conditioned on x."""
        from ...neural_nets.net_builders.flow import build_nsf

        X = xs.shape[0]
        n = max(X, 8)
        dummy_theta = self.prior.sample((n,))  # sets the shapes only
        return build_nsf(self.theta_transform.forward(dummy_theta),
                         xs[torch.arange(n, device=xs.device) % X], z_score_theta="none",
                         hidden_features=32, num_transforms=3, device=self._device)

    def train_amortized(
        self,
        xs,
        n_particles: int = 128,
        learning_rate: float = 1e-3,
        max_num_iters: int = 2000,
        clip_value: float = 5.0,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ) -> "VIPosterior":
        """Amortized VI: fit a conditional flow q(theta | x) by the reverse
        KL averaged over the observations ``xs``, with ``optax.chain(
        clip_by_global_norm(clip_value), adam(learning_rate))``. Afterwards
        ``sample(x=...)`` works for any x without refitting."""
        generator = next_generator(generator, self._device)
        xs = torch.atleast_2d(torch.as_tensor(xs, dtype=torch.float32, device=self._device))
        est = self._amortized_estimator(xs)
        pot_xfn = self._pure_potential_xfn()
        opt = _ScheduledAdam(est.net.parameters(), learning_rate, 1.0, clip_value)
        shape = (n_particles * xs.shape[0], self._dim)
        for _ in range(max_num_iters):
            z = torch.randn(shape, generator=generator, device=self._device)
            loss = _amortized_loss(est, pot_xfn, self.theta_transform, xs, z)
            opt.zero_grad()
            loss.backward()
            opt.step()
        self._amortized_q = est
        self._trained = True
        return self

    # --------------------------------------------------------------- sample
    @torch.no_grad()
    def sample(self, sample_shape=(), x=None, generator: Optional[torch.Generator] = None,
               **kwargs) -> torch.Tensor:
        """Draws of q pushed through the link transform: ``method="naive"``
        (default), or ``"sir"``, which resamples ``oversampling_factor``
        (default 32) times as many draws of q by their importance weights
        against the potential. After ``train_amortized``, ``x`` selects the
        observation."""
        generator = next_generator(generator, self._device)
        num = math.prod(int(s) for s in sample_shape)
        if self._amortized_q is not None and x is not None:
            x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
            u = self._amortized_q.sample(sample_shape, x, generator=generator)
            theta = self.theta_transform.inverse(u.reshape(-1, self._dim))
            return theta.reshape(tuple(sample_shape) + (self._dim,))
        if not self._trained:
            raise RuntimeError("Call `vi_posterior.train()` first.")
        if kwargs.get("method", "naive") == "sir":
            oversample = int(kwargs.get("oversampling_factor", 32))
            u = self._q.sample(num * oversample, None, generator)[:, 0, :]
            theta_all = self.theta_transform.inverse(u)
            # q's density in theta space, the transform's Jacobian included.
            logw = finite_or_neg_inf(self.potential_fn(theta_all) - self.log_prob(theta_all))
            idx = torch.multinomial(torch.softmax(logw, dim=0), num, replacement=True,
                                    generator=generator)
            theta = theta_all[idx]
        else:
            u = self._q.sample(num, None, generator)[:, 0, :]
            theta = self.theta_transform.inverse(u)
        return theta.reshape(tuple(sample_shape) + (self._dim,))

    def sample_batched(self, sample_shape, x, generator=None, **kwargs):
        raise NotImplementedError(
            "VIPosterior requires training per x; `sample_batched` is not supported "
            "(as in the reference)."
        )

    def log_prob(self, theta, x=None, **kwargs) -> torch.Tensor:
        """log q(theta), the link transform's Jacobian included."""
        if not self._trained:
            raise RuntimeError("Call `vi_posterior.train()` first.")
        theta = ensure_theta_batched(theta, self._device)
        u, ldj = self.theta_transform.forward_and_log_det(theta)
        return self._q.log_prob(u, None) + ldj

    # -------------------------------------------------------------- evaluate
    @torch.no_grad()
    def evaluate(self, x=None, N: int = 1000, generator: Optional[torch.Generator] = None) -> float:
        """PSIS k-hat of q against the potential at the observation q was
        trained on, from N draws: the top M = min(N / 5, 3 sqrt(N)) of the
        normalised weights. ``x`` is accepted for the reference's
        signature, as in the JAX package."""
        posterior = self

        class _QDist:
            def sample(self, sample_shape, generator=None):
                return posterior.sample(sample_shape, generator=generator)

            def log_prob(self, theta):
                return posterior.log_prob(theta)

        _, log_weights = importance_sample(self.potential_fn, _QDist(), num_samples=N,
                                           generator=next_generator(generator, self._device))
        return psis_k_hat(log_weights)
