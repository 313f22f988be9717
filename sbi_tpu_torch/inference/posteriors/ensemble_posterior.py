"""EnsemblePosterior: a weighted mixture, or a product of experts, of
trained posteriors.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/ensemble_posterior.py``
(``EnsemblePotential`` and ``EnsemblePosterior``).

Members that share one architecture and one z-scoring, as
``train_ensemble``'s do, have their potentials evaluated in one
``torch.func.vmap`` over their stacked parameters: a potential evaluation
costs about the host ops of one member, and each spline launch covers every
member (five launches for a five-layer NSF, whatever K). Posterior,
likelihood and ratio estimators' potentials take that route. Other members,
such as posteriors built by hand, are evaluated one by one; both routes
give the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ...neural_nets.estimators.base import functional, stack_nets, stackable
from ...utils.sbiutils import ensure_theta_batched, next_generator
from ..potentials.base_potential import BasePotential
from .base_posterior import NeuralPosterior


def _estimator(potential):
    """The estimator a member potential evaluates, or None."""
    for name in ("posterior_estimator", "likelihood_estimator", "ratio_estimator"):
        est = getattr(potential, name, None)
        if est is not None:
            return est
    return None


def _stacked_members(potentials):
    """(first member's net, the members' stacked parameters) where the
    first potential, run under each member's parameters, is that member's
    potential: one potential class, one prior, the same transform objects
    and stackable nets. None otherwise."""
    first = potentials[0]
    ests = [_estimator(p) for p in potentials]
    if len(potentials) < 2 or any(e is None for e in ests):
        return None
    same = all(
        type(p) is type(first) and p.prior is first.prior
        and e.input_transform is ests[0].input_transform
        and e.condition_transform is ests[0].condition_transform
        for p, e in zip(potentials, ests)
    )
    nets = [e.net for e in ests]
    if not same or not stackable(nets):
        return None
    return nets[0], stack_nets(nets)


def _combine(lps: torch.Tensor, w: torch.Tensor, combination: str) -> torch.Tensor:
    """(K, B) member log-potentials -> (B,): the weighted mean (product of
    experts) or the log of the weighted mixture."""
    if combination == "product":
        return (w[:, None] * lps).sum(0)
    return torch.logsumexp(lps + torch.log(w)[:, None], dim=0)


class EnsemblePotential(BasePotential):
    """Combined member potentials.

    ``combination="mixture"`` (default): logsumexp of the weighted member
    potentials, the potential of the posterior mixture.
    ``combination="product"``: the weighted mean of the member
    log-potentials, a product of experts.
    """

    allow_iid_x = True

    def __init__(self, potential_fns, weights, prior, x_o=None, combination: str = "mixture"):
        if combination not in ("mixture", "product"):
            raise ValueError(f"combination must be 'mixture' or 'product', got {combination!r}")
        self._potentials = list(potential_fns)
        device = self._potentials[0].device
        self._weights = torch.as_tensor(weights, dtype=torch.float32, device=device)
        self._combination = combination
        self._stacked = _stacked_members(self._potentials)
        super().__init__(prior, x_o, device)

    @property
    def vmapped(self) -> bool:
        """Whether the members are evaluated in one vmapped call."""
        return self._stacked is not None

    def set_x(self, x_o, x_is_iid=False, **kwargs):
        for p in self._potentials:
            p.set_x(x_o, x_is_iid)
        return super().set_x(x_o, x_is_iid)

    def _members(self, fns, theta) -> torch.Tensor:
        """(K, B): member k's potential ``fns[k]`` at ``theta``; with
        stacked members, ``fns[0]`` under each member's parameters."""
        if self._stacked is None:
            return torch.stack([f(theta) for f in fns])
        net, params = self._stacked
        return torch.func.vmap(functional(net, fns[0]), in_dims=(0, None))(params, theta)

    def member_potentials(self, theta) -> torch.Tensor:
        """(K, B): every member's potential at ``theta``."""
        return self._members(self._potentials, ensure_theta_batched(theta, self.device))

    def __call__(self, theta, track_gradients: bool = True):
        w = self._weights / self._weights.sum()
        return _combine(self.member_potentials(theta), w, self._combination)

    def batched_over_x(self, xs, reps: int):
        """A potential over B * reps chains, chain i scored against
        observation i // reps: the members' own ``batched_over_x``,
        combined, so that ``MCMCPosterior.sample_batched`` runs all
        observations in one sampler run."""
        fns = [p.batched_over_x(xs, reps) for p in self._potentials]
        w = self._weights / self._weights.sum()
        return lambda theta: _combine(self._members(fns, theta), w, self._combination)


class EnsemblePosterior(NeuralPosterior):
    def __init__(
        self,
        posteriors: Sequence[NeuralPosterior],
        weights: Optional[Sequence[float]] = None,
        theta_transform=None,
        device=None,
        potential_combination: str = "mixture",
    ):
        self.posteriors = list(posteriors)
        K = len(self.posteriors)
        pot_device = self.posteriors[0].potential_fn.device
        self._weights = torch.as_tensor(
            weights if weights is not None else [1.0 / K] * K, dtype=torch.float32,
            device=pot_device)
        prior = getattr(self.posteriors[0].potential_fn, "prior", None)
        potential = EnsemblePotential([p.potential_fn for p in self.posteriors], self._weights,
                                      prior, combination=potential_combination)
        super().__init__(potential, theta_transform or self.posteriors[0].theta_transform, device)
        self._combination = potential_combination
        self._purpose = (
            "EnsemblePosterior: weighted mixture of posteriors."
            if potential_combination == "mixture"
            else "EnsemblePosterior: product of experts over member potentials (sampled by MCMC)."
        )

    @property
    def weights(self) -> torch.Tensor:
        return self._weights / self._weights.sum()

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_poe_mcmc", None)
        return state

    def set_default_x(self, x):
        for p in self.posteriors:
            p.set_default_x(x)
        return super().set_default_x(x)

    def _mcmc(self):
        """The product of experts' sampler: an ``MCMCPosterior`` over the
        combined potential (per-member sampling would give mixture draws)."""
        from .mcmc_posterior import MCMCPosterior

        mcmc = getattr(self, "_poe_mcmc", None)
        if mcmc is None:
            mcmc = self._poe_mcmc = MCMCPosterior(
                self.potential_fn, proposal=self.potential_fn.prior,
                theta_transform=self.theta_transform, device=self._device)
        return mcmc

    def sample(self, sample_shape=(), x=None, generator: Optional[torch.Generator] = None,
               **kwargs) -> torch.Tensor:
        """mixture: member counts drawn from the weights, each member's
        draws, concatenated and shuffled. product: MCMC on the combined
        potential; ``kwargs`` go to ``MCMCPosterior.sample``."""
        generator = next_generator(generator, self._device)
        if self._combination == "product":
            mcmc = self._mcmc().set_default_x(self._x_else_default_x(x))
            return mcmc.sample(sample_shape, generator=generator, **kwargs)
        num = math.prod(int(s) for s in sample_shape)
        member = torch.multinomial(self.weights, num, replacement=True, generator=generator)
        counts = torch.bincount(member, minlength=len(self.posteriors)).tolist()
        outs = [p.sample((n,), x=x, generator=generator, **kwargs)
                for p, n in zip(self.posteriors, counts) if n > 0]
        samples = torch.cat(outs, dim=0)
        perm = torch.randperm(samples.shape[0], generator=generator, device=samples.device)
        return samples[perm].reshape(tuple(sample_shape) + samples.shape[1:])

    def sample_batched(self, sample_shape, x, generator: Optional[torch.Generator] = None,
                       **kwargs) -> torch.Tensor:
        """Vectorized over observations x (B, ...): (*sample_shape, B, D).
        mixture: one ``sample_batched`` per member for all observations,
        then a member drawn per (sample, observation). product: one MCMC
        run over all observations through the combined potential's
        ``batched_over_x``."""
        generator = next_generator(generator, self._device)
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
        B = x.shape[0]
        num = math.prod(int(s) for s in sample_shape)
        if self._combination == "product":
            out = self._mcmc().sample_batched((num,), x=x, generator=generator, **kwargs)
            return out.reshape(tuple(sample_shape) + out.shape[1:])
        member = torch.multinomial(self.weights, num * B, replacement=True,
                                   generator=generator).reshape(num, B)
        per_member = torch.stack([p.sample_batched((num,), x=x, generator=generator, **kwargs)
                                  for p in self.posteriors])  # (K, num, B, D)
        index = member[None, :, :, None].expand(1, num, B, per_member.shape[-1])
        picked = per_member.gather(0, index)[0]
        return picked.reshape(tuple(sample_shape) + picked.shape[1:])

    @torch.no_grad()
    def weight_by_evidence(self, x=None, num_samples: int = 100_000,
                           generator: Optional[torch.Generator] = None,
                           chunk_size: int = 32_768) -> torch.Tensor:
        """Set the member weights to w_k ∝ p̂_k(x_o), each member's model
        evidence at the observation, estimated on one batch of prior draws
        shared by all members (common random numbers): Ẑ_k = mean_j
        exp(potential_k(θ_j) - log π(θ_j)), θ_j ~ π. Meaningful for
        likelihood-based members (potential = log p̂(x_o | θ) + log π(θ)).
        Returns the (K,) log-evidence estimates; the weights, also the
        combined potential's, become their softmax."""
        generator = next_generator(generator, self._device)
        if x is not None:
            self.set_default_x(x)
        prior = self.potential_fn.prior
        if prior is None:
            raise ValueError("Evidence weighting needs a prior.")
        self.potential_fn.set_x(self._x_else_default_x(None))
        parts = []
        for c in range(max(1, -(-num_samples // chunk_size))):
            n_c = min(chunk_size, num_samples - c * chunk_size)
            th = prior.sample((n_c,), generator=generator)
            ll = self.potential_fn.member_potentials(th) - prior.log_prob(th)  # (K, n_c)
            parts.append(torch.logsumexp(ll, dim=1))
        logz = torch.logsumexp(torch.stack(parts, dim=1), dim=1) - math.log(num_samples)
        self._weights = torch.softmax(logz, dim=0)
        self.potential_fn._weights = self._weights
        return logz

    def log_prob(self, theta, x=None, individually: bool = False, **kwargs) -> torch.Tensor:
        """mixture: the log of the weighted member mixture (normalized where
        the members are). product: the weighted mean of the member
        log-probs, an unnormalized density (its normalizer is intractable).
        ``individually``: the (K, B) member log-probs."""
        theta = ensure_theta_batched(theta, self._device)
        lps = torch.stack([p.log_prob(theta, x=x, **kwargs) for p in self.posteriors])
        if individually:
            return lps
        return _combine(lps, self.weights, self._combination)
