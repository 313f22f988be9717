"""NPE_A_Posterior: a MoG posterior with the analytic proposal correction.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/npe_a_posterior.py``
(Papamakarios & Murray 2016, Eqs. 25-26). The MDN trained on proposal
samples approximates the proposal posterior, proportional to
p(theta | x) proposal(theta) / prior(theta); the posterior MoG follows by
the exponential-family quotient
    P'_k   = P_k + P_prior - P_prop
    eta'_k = eta_k + eta_prior - eta_prop
    log a'_k = log a_k + A(P'_k, eta'_k) - A(P_k, eta_k),
with A(P, eta) = 0.5 (eta^T P^-1 eta - log|P|).

Solves and log-determinants go through one unchecked Cholesky factor of
each precision (a matrix that is not positive definite gives NaN, as the
JAX package's factor does). The eigenvalue checks that guard the quotient
(``eigvalsh``) read their error code on the host: one sync per check.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...neural_nets.estimators.mdn import (
    MixtureDensityEstimator,
    MoG,
    _bmv,
    _chol_logdet,
    _chol_solve,
    _cholesky,
)
from ...samplers.rejection.rejection import accept_reject_sample
from ...utils.distributions import MultivariateNormal
from ...utils.sbiutils import ensure_theta_batched, next_generator, within_support
from ..potentials.posterior_based_potential import posterior_estimator_based_potential
from .base_posterior import NeuralPosterior


def _log_partition(L: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """A(P, eta) = 0.5 (eta^T P^-1 eta - log|P|), batched, from the lower
    Cholesky factor L of P."""
    quad = (eta * _chol_solve(L, eta)).sum(-1)
    return 0.5 * (quad - _chol_logdet(L))


class _GaussSpec:
    """Gaussian natural parameters (precision, eta), already transported."""

    def __init__(self, P, eta):
        self.P = P
        self.eta = eta


def _gaussian_natural_params(prior_or_gauss, dim: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(precision, eta) of a Gaussian; zeros for a prior of constant
    density on its support (uniform)."""
    if isinstance(prior_or_gauss, _GaussSpec):
        return prior_or_gauss.P, prior_or_gauss.eta
    if isinstance(prior_or_gauss, MultivariateNormal):
        cov = prior_or_gauss.covariance_matrix
        eye = torch.eye(cov.shape[-1], device=cov.device)
        L_inv = torch.linalg.solve_triangular(_cholesky(cov), eye, upper=False)
        P = L_inv.T @ L_inv
        return P, P @ prior_or_gauss.loc
    device = device if device is not None else getattr(prior_or_gauss, "device", None)
    return torch.zeros((dim, dim), device=device), torch.zeros(dim, device=device)


def correct_mog_for_proposal(
    mog: MoG,
    prior,
    proposal_gaussian: Optional[Tuple[torch.Tensor, torch.Tensor]],
    dim: int,
) -> MoG:
    """The NPE-A quotient correction of a batched MoG (B, K, ...) for a
    single-Gaussian proposal (exact). ``proposal_gaussian=None`` means the
    proposal is the prior, and the correction cancels."""
    P_k = mog.precisions
    eta_k = _bmv(P_k, mog.means)
    P0, eta0 = _gaussian_natural_params(prior, dim, mog.means.device)
    Pp, etap = (P0, eta0) if proposal_gaussian is None else proposal_gaussian

    P_new = P_k + (P0 - Pp)
    eta_new = eta_k + (eta0 - etap)
    # Corrected precisions must stay positive definite: nudge if needed.
    min_eig = torch.linalg.eigvalsh(P_new).min()
    eye = torch.eye(dim, device=P_new.device)
    P_new = torch.where(min_eig <= 1e-6, P_new + (1e-6 - torch.clamp(min_eig, max=0.0)) * eye, P_new)

    L_new = _cholesky(P_new)
    log_alpha = torch.log_softmax(mog.logits, dim=-1)
    log_alpha_new = (log_alpha + _log_partition(L_new, eta_new)
                     - _log_partition(mog.precision_chols, eta_k))
    return MoG(log_alpha_new, _chol_solve(L_new, eta_new), L_new)


def divide_mog_by_proposal_mog(
    density_mog: MoG,
    proposal_mog: MoG,
    prior_natural: Optional[Tuple[torch.Tensor, torch.Tensor]],
    dim: int,
) -> MoG:
    """The pairwise NPE-A quotient, density * prior / proposal, for an
    L-component MoG proposal: K * L components. ``prior_natural`` is
    (P0, eta0) of a Gaussian prior in the shared z-space, or None for a
    uniform prior. Per pair (k, l):
        P_kl   = P_d,k + P0 - P_p,l
        eta_kl = eta_d,k + eta0 - eta_p,l
        log w_kl = log w_d,k - log w_p,l + A(P_kl, eta_kl)
                   - A(P_d,k, eta_d,k) + A(P_p,l, eta_p,l).
    A pair whose quotient is not positive definite (a density component
    sharper than the proposal component it divides) is dropped: weight
    -inf, as the JAX package does."""
    Pd = density_mog.precisions  # (B, K, D, D)
    Pp = proposal_mog.precisions  # (B, L, D, D)
    eta_d = _bmv(Pd, density_mog.means)
    eta_p = _bmv(Pp, proposal_mog.means)
    B, K = Pd.shape[:2]
    L = Pp.shape[1]

    P = Pd[:, :, None] - Pp[:, None, :]  # (B, K, L, D, D)
    eta = eta_d[:, :, None] - eta_p[:, None, :]
    if prior_natural is not None:
        P0, eta0 = prior_natural
        P = P + P0
        eta = eta + eta0

    valid = torch.linalg.eigvalsh(P).min(dim=-1).values > 1e-4  # (B, K, L)
    eye = torch.eye(dim, device=P.device)
    P = torch.where(valid[..., None, None], P, eye)
    eta = torch.where(valid[..., None], eta, torch.zeros_like(eta))

    chol = _cholesky(P)
    log_wd = torch.log_softmax(density_mog.logits, -1)
    log_wp = torch.log_softmax(proposal_mog.logits, -1)
    log_w = (
        log_wd[:, :, None]
        - log_wp[:, None, :]
        + _log_partition(chol, eta)
        - _log_partition(density_mog.precision_chols, eta_d)[:, :, None]
        + _log_partition(proposal_mog.precision_chols, eta_p)[:, None, :]
    )
    log_w = torch.where(valid, log_w, torch.full_like(log_w, -torch.inf))
    return MoG(
        log_w.reshape(B, K * L),
        _chol_solve(chol, eta).reshape(B, K * L, dim),
        chol.reshape(B, K * L, dim, dim),
    )


class NPE_A_Posterior(NeuralPosterior):
    """The NPE-A posterior: the corrected MoG in the estimator's z-space,
    with rejection on the prior's support as ``DirectPosterior`` does."""

    def __init__(
        self,
        posterior_estimator: MixtureDensityEstimator,
        prior,
        proposal=None,
        max_sampling_batch_size: int = 10_000,
        device=None,
        x_shape=None,
    ):
        potential_fn, theta_transform = posterior_estimator_based_potential(
            posterior_estimator, prior, x_o=None
        )
        super().__init__(potential_fn, theta_transform, device or posterior_estimator.device, x_shape)
        self.prior = prior
        self.posterior_estimator = posterior_estimator
        self.proposal = proposal
        self.max_sampling_batch_size = max_sampling_batch_size
        self._purpose = "NPE-A posterior with analytic proposal correction."

    # --------------------------------------------------------------- helpers
    def _corrected_mog(self, x) -> MoG:
        est = self.posterior_estimator
        mog = est.get_uncorrected_mog(x)
        dim = est.input_shape[0]
        device = mog.means.device

        # The MoG lives in the z-scored theta space: transport the prior's
        # and the proposal's natural parameters there through the affine
        # z-scoring, theta = z * scale + loc.
        tr = est.input_transform
        scale = torch.broadcast_to(getattr(tr, "scale", torch.ones(dim, device=device)), (dim,))
        loc = torch.broadcast_to(getattr(tr, "loc", torch.zeros(dim, device=device)), (dim,))

        def to_z(P, eta):
            # P_z = S P S, eta_z = S (eta - P loc), S = diag(scale).
            S = torch.diag(scale)
            return S @ P @ S, S @ (eta - P @ loc)

        if isinstance(self.prior, MultivariateNormal):
            prior_z = _GaussSpec(*to_z(*_gaussian_natural_params(self.prior, dim)))
        else:
            prior_z = self.prior  # flat: zeros in any space

        pm = self.proposal
        if pm is not None and pm is not self.prior and isinstance(pm, NPE_A_Posterior):
            # The full pairwise division by the proposal's MoG, carried from
            # the proposal estimator's z-space through theta into this one
            # (NPE-A refuses retrain_from_scratch, so both usually agree).
            prop_mog = pm._corrected_mog(pm.default_x)
            tr_p = pm.posterior_estimator.input_transform
            scale_p = torch.broadcast_to(getattr(tr_p, "scale", torch.ones(dim, device=device)), (dim,))
            loc_p = torch.broadcast_to(getattr(tr_p, "loc", torch.zeros(dim, device=device)), (dim,))
            a = scale_p / scale  # z_cur = (z_prop * scale_p + loc_p - loc) / scale
            b = (loc_p - loc) / scale
            Ainv = torch.diag(1.0 / a)
            # cov_z = A cov_p A^T, so P_z = A^-T P_p A^-1.
            P_z = Ainv.T @ prop_mog.precisions @ Ainv
            prop_mog_z = MoG(prop_mog.logits, prop_mog.means * a + b, _cholesky(P_z))
            prior_nat = (prior_z.P, prior_z.eta) if isinstance(prior_z, _GaussSpec) else None
            return divide_mog_by_proposal_mog(mog, prop_mog_z, prior_nat, dim)

        return correct_mog_for_proposal(mog, prior_z, None, dim)

    # ---------------------------------------------------------------- public
    @torch.no_grad()
    def sample(self, sample_shape=(), x=None, generator: Optional[torch.Generator] = None,
               **kwargs) -> torch.Tensor:
        generator = next_generator(generator, self._device)
        x = self._x_else_default_x(x)
        est = self.posterior_estimator
        mog = self._corrected_mog(x)
        num = 1
        for s in sample_shape:
            num *= int(s)

        def proposal_fn(g, n):
            return est.input_transform.inverse(mog.sample(n, g)[:, 0, :])

        samples, _ = accept_reject_sample(
            proposal_fn,
            lambda s: within_support(self.prior, s),
            num,
            generator=generator,
            sample_batch_size=min(self.max_sampling_batch_size, max(num, 1000)),
        )
        return samples.reshape(tuple(sample_shape) + est.input_shape)

    @torch.no_grad()
    def log_prob(self, theta, x=None, **kwargs) -> torch.Tensor:
        theta = ensure_theta_batched(theta, self._device)
        x = self._x_else_default_x(x)
        est = self.posterior_estimator
        mog = self._corrected_mog(x)
        z, ldj = est.input_transform.forward_and_log_det(theta)
        # log_prob log-softmaxes the corrected logits: the normalized
        # posterior.
        lp = mog.log_prob(z) + ldj
        return torch.where(within_support(self.prior, theta), lp, torch.full_like(lp, -torch.inf))


def _moment_match(mog: MoG) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single Gaussian with a batched MoG's moments: mean (B, D),
    covariance (B, D, D)."""
    w = torch.softmax(mog.logits, dim=-1)
    mean = torch.einsum("bk,bkd->bd", w, mog.means)
    covs = torch.linalg.inv(mog.precisions)
    diff = mog.means - mean[:, None, :]
    cov = torch.einsum("bk,bkij->bij", w, covs) + torch.einsum("bk,bki,bkj->bij", w, diff, diff)
    return mean, cov
