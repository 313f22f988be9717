"""Mixture-density network estimator (MoG head).

PyTorch counterpart of ``sbi_tpu/neural_nets/estimators/mdn.py``. The net
maps an (embedded) condition to mixture logits, component means and
lower Cholesky factors of the component *precisions*; NPE-A and NPE-C's
non-atomic loss use that parameterization for closed-form proposal
corrections.

The linear algebra runs without host syncs on the card: Cholesky factors
come from ``torch.linalg.cholesky_ex(check_errors=False)`` and solves from
``torch.linalg.solve_triangular`` on factors already in hand (plain
``torch.linalg.cholesky`` / ``inv`` / ``solve`` read their error codes on
the host). A precision that is not positive definite then shows as
non-finite values, which ``MoG.validate`` (the one deliberate host read)
rejects, as the JAX package's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.sbiutils import next_generator
from .base import ConditionalDensityEstimator

_LOG_2PI = math.log(2.0 * math.pi)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, with no host read of the error code: the
    factor of a matrix that is not positive definite is NaN (the
    unchecked factorization would leave finite garbage)."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 b for a lower factor L (..., D, D) and b (..., D)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def _chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log|det(L L^T)| = 2 sum log|diag L|."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1).abs()).sum(-1)


def _bmv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product A (..., D, D) @ v (..., D)."""
    return (A @ v[..., None])[..., 0]


# ---------------------------------------------------------------------------
# MoG container
# ---------------------------------------------------------------------------


@dataclass
class MoG:
    """Batched mixture of Gaussians with precision-Cholesky parameterization.

    logits: (B, K); means: (B, K, D); precision_chols: (B, K, D, D) lower.
    """

    logits: torch.Tensor
    means: torch.Tensor
    precision_chols: torch.Tensor

    @property
    def precisions(self) -> torch.Tensor:
        L = self.precision_chols
        return L @ L.transpose(-1, -2)

    @property
    def weights(self) -> torch.Tensor:
        """Normalized mixture weights (B, K)."""
        return torch.softmax(self.logits, dim=-1)

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    @property
    def num_components(self) -> int:
        return self.means.shape[-2]

    @property
    def batch_shape(self):
        return tuple(self.means.shape[:-2])

    def validate(self) -> None:
        """Raise on non-finite parameters or non-PD precisions (the
        diagonal of a factor must be positive). Reads the tensors on the
        host."""
        logits = self.logits.detach().cpu().numpy()
        means = self.means.detach().cpu().numpy()
        chols = self.precision_chols.detach().cpu().numpy()
        if np.isnan(logits).any() or np.isinf(logits).any():
            raise ValueError("MoG logits contain NaN/Inf.")
        if not np.isfinite(means).all():
            raise ValueError("MoG means contain NaN/Inf.")
        if not np.isfinite(chols).all():
            raise ValueError("MoG precision factors contain NaN/Inf.")
        diag = np.diagonal(chols, axis1=-2, axis2=-1)
        if (diag <= 0).any():
            raise ValueError(
                "MoG precision factors have non-positive diagonal "
                "(precision not positive definite)."
            )

    def detach(self) -> "MoG":
        return MoG(self.logits.detach(), self.means.detach(), self.precision_chols.detach())

    @classmethod
    def from_gaussian(cls, mean, covariance) -> "MoG":
        """Single-component MoG from a mean (D,) or (B, D) and a covariance
        (D, D) or (B, D, D)."""
        mean = torch.atleast_2d(torch.as_tensor(mean, dtype=torch.float32))
        covariance = torch.as_tensor(covariance, dtype=torch.float32, device=mean.device)
        if covariance.ndim == 2:
            covariance = covariance[None]
        precision = torch.linalg.inv_ex(covariance, check_errors=False).inverse
        chol = _cholesky(precision)
        B = mean.shape[0]
        return cls(mean.new_zeros((B, 1)), mean[:, None, :], chol[:, None])

    def condition(self, condition, dims_to_sample) -> "MoG":
        """Condition each component on the fixed dims (those not in
        ``dims_to_sample``) at ``condition``'s values, and reweight the
        components by the exact marginal density of those values,
        ``N(y; mu_c, [P^-1]_cc)``, as the JAX package does."""
        B, K, D = self.means.shape
        device = self.means.device
        free = torch.zeros(D, dtype=torch.bool)
        free[torch.as_tensor(dims_to_sample)] = True
        free_idx = torch.nonzero(free)[:, 0].to(device)
        fixed_idx = torch.nonzero(~free)[:, 0].to(device)
        condition = torch.atleast_2d(torch.as_tensor(condition, dtype=torch.float32, device=device))
        y = condition[:, fixed_idx]  # (B, C)

        P = self.precisions
        P_ss = P[:, :, free_idx][:, :, :, free_idx]
        P_sc = P[:, :, free_idx][:, :, :, fixed_idx]
        mu_s = self.means[:, :, free_idx]
        mu_c = self.means[:, :, fixed_idx]

        diff_c = y[:, None, :] - mu_c  # (B, K, C)
        cond_chols = _cholesky(P_ss)
        cond_means = mu_s - _chol_solve(cond_chols, _bmv(P_sc, diff_c))

        # The exact marginal of the fixed dims: Sigma_cc = [P^-1]_cc.
        cov = torch.linalg.inv_ex(P, check_errors=False).inverse
        cov_cc = cov[:, :, fixed_idx][:, :, :, fixed_idx]
        L_cc = _cholesky(cov_cc)
        quad = (diff_c * _chol_solve(L_cc, diff_c)).sum(-1)  # (B, K)
        C = fixed_idx.shape[0]
        log_marg = -0.5 * (C * _LOG_2PI + _chol_logdet(L_cc) + quad)

        new_logits = torch.log_softmax(self.logits, dim=-1) + log_marg
        new_logits = new_logits - torch.logsumexp(new_logits, dim=-1, keepdim=True)
        return MoG(new_logits, cond_means, cond_chols)

    def log_prob(self, theta: torch.Tensor) -> torch.Tensor:
        """theta (B, D) -> (B,)."""
        D = self.means.shape[-1]
        log_w = torch.log_softmax(self.logits, dim=-1)
        diff = theta[:, None, :] - self.means  # (B, K, D)
        # y = L^T diff, so diff^T P diff = |y|^2.
        y = _bmv(self.precision_chols.transpose(-1, -2), diff)
        quad = (y**2).sum(-1)
        half_logdet = torch.log(torch.diagonal(self.precision_chols, dim1=-2, dim2=-1)).sum(-1)
        log_comp = half_logdet - 0.5 * (D * _LOG_2PI + quad)
        return torch.logsumexp(log_w + log_comp, dim=-1)

    def sample(self, num_samples: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> (num_samples, B, D). The component is the Gumbel-max of the
        logits; a draw is mean + L^-T eps, since Cov = P^-1 = L^-T L^-1."""
        B, K, D = self.means.shape
        device = self.means.device
        generator = next_generator(generator, device)
        u = torch.rand((num_samples, B, K), generator=generator, device=device)
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
        comps = torch.argmax(self.logits + gumbel, dim=-1)  # (S, B)
        rows = torch.arange(B, device=device).expand(num_samples, B)
        means = self.means[rows, comps]  # (S, B, D)
        chols = self.precision_chols[rows, comps]  # (S, B, D, D)
        eps = torch.randn((num_samples, B, D), generator=generator, device=device)
        delta = torch.linalg.solve_triangular(chols.transpose(-1, -2), eps[..., None], upper=True)
        return means + delta[..., 0]

    @staticmethod
    def product(a: "MoG", b: "MoG", subtract_natural=None) -> "MoG":
        """Pairwise product of two MoGs (up to normalization): the NPE-C
        non-atomic closed form (Greenberg et al. 2019, App. A.1).

        ``subtract_natural=(P0, eta0)``, a Gaussian's precision (D, D) and
        ``eta0 = P0 @ mu0`` (D,), divides every pairwise component by that
        Gaussian: the prior correction of the proposal posterior
        ``q * proposal / prior``. The logits omit every term that is
        constant across components; ``log_prob`` normalizes them.
        """
        Pa, Pb = a.precisions, b.precisions
        B, Ka, D = a.means.shape
        Kb = b.means.shape[1]
        P = Pa[:, :, None] + Pb[:, None, :]  # (B, Ka, Kb, D, D)
        eta_a, eta_b = _bmv(Pa, a.means), _bmv(Pb, b.means)
        eta = eta_a[:, :, None] + eta_b[:, None, :]
        if subtract_natural is not None:
            P0, eta0 = subtract_natural
            P = P - P0
            eta = eta - eta0
        chol = _cholesky(P)
        means = _chol_solve(chol, eta)

        # log w_a + log w_b + 0.5 (logdet P_a + logdet P_b - logdet P)
        #   - 0.5 (m_a' P_a m_a + m_b' P_b m_b - m' P m), with P m = eta.
        log_wa = torch.log_softmax(a.logits, -1)
        log_wb = torch.log_softmax(b.logits, -1)
        logdet_P = _chol_logdet(chol)
        logdet_Pa = _chol_logdet(a.precision_chols)
        logdet_Pb = _chol_logdet(b.precision_chols)
        expo_a = (a.means * eta_a).sum(-1)
        expo_b = (b.means * eta_b).sum(-1)
        expo_pp = (means * eta).sum(-1)
        log_n = 0.5 * (-logdet_P + logdet_Pa[:, :, None] + logdet_Pb[:, None, :]) - 0.5 * (
            expo_a[:, :, None] + expo_b[:, None, :] - expo_pp)
        logits = (log_wa[:, :, None] + log_wb[:, None, :] + log_n).reshape(B, Ka * Kb)
        return MoG(logits, means.reshape(B, Ka * Kb, D), chol.reshape(B, Ka * Kb, D, D))


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------


class MDNModule(nn.Module):
    """Condition -> MoG parameters: ``num_layers`` x (Linear, ReLU), then
    the logits, means, diagonal and off-diagonal heads (the flax module's
    ``Dense_{num_layers}`` ... ``Dense_{num_layers + 3}``).

    The precision factor's diagonal is ``softplus(raw) + 1e-4``
    (``scale_parameterization="softplus"``, the reference's) or
    ``exp(clamp(raw, -10, 14))`` (``"log"``: log-precision linear in the
    net's output). The off-diagonal head starts at zero weight, so every
    factor starts diagonal; the diagonal head's bias starts at zero. Its
    entries fill the strict lower triangle in ``tril_indices(D, -1)`` order.
    """

    def __init__(
        self,
        theta_dim: int,
        condition_features: int,
        num_components: int = 10,
        hidden_features: int = 50,
        num_layers: int = 2,
        embedding_net: Optional[nn.Module] = None,
        scale_parameterization: str = "softplus",
    ):
        super().__init__()
        if scale_parameterization not in ("softplus", "log"):
            raise ValueError(f"Unknown scale_parameterization {scale_parameterization!r}")
        self.theta_dim = theta_dim
        self.num_components = num_components
        self.hidden_features = hidden_features
        self.num_layers = num_layers
        self.embedding_net = embedding_net
        self.scale_parameterization = scale_parameterization
        K, D = num_components, theta_dim
        widths = [condition_features] + [hidden_features] * num_layers
        self.hidden = nn.ModuleList(nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.logits = nn.Linear(widths[-1], K)
        self.means = nn.Linear(widths[-1], K * D)
        self.diag = nn.Linear(widths[-1], K * D)
        n_off = D * (D - 1) // 2
        self.off = nn.Linear(widths[-1], K * n_off) if n_off > 0 else None
        if self.off is not None:
            self.off.zero_init = True
        # Position (i, j) of the factor takes entry tril_map[i * D + j] of
        # [0, off..., diag...]: the strict lower triangle in tril_indices
        # order, then the diagonal. An index_select needs no in-place write
        # (the module runs under torch.func.vmap), and its backward is an
        # index_add, with no host sync on the card.
        tril_map = torch.zeros(D * D, dtype=torch.long)
        rows, cols = torch.tril_indices(D, D, -1)
        tril_map[rows * D + cols] = 1 + torch.arange(n_off)
        tril_map[torch.arange(D) * (D + 1)] = 1 + n_off + torch.arange(D)
        self.register_buffer("tril_map", tril_map, persistent=False)

    def forward(self, condition: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = condition
        if self.embedding_net is not None:
            h = self.embedding_net(h)
        h = h.reshape(h.shape[0], -1)
        for layer in self.hidden:
            h = torch.relu(layer(h))
        K, D = self.num_components, self.theta_dim
        logits = self.logits(h)
        means = self.means(h).reshape(-1, K, D)
        diag_raw = self.diag(h).reshape(-1, K, D)
        if self.scale_parameterization == "log":
            diag = torch.exp(torch.clamp(diag_raw, -10.0, 14.0))
        else:
            diag = F.softplus(diag_raw) + 1e-4
        parts = [diag.new_zeros(diag.shape[:-1] + (1,))]
        if self.off is not None:
            parts.append(self.off(h).reshape(-1, K, D * (D - 1) // 2))
        parts.append(diag)
        chol = torch.cat(parts, dim=-1).index_select(-1, self.tril_map).reshape(-1, K, D, D)
        return logits, means, chol


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------


class MixtureDensityEstimator(ConditionalDensityEstimator):
    """MoG conditional density estimator over an ``MDNModule``."""

    def get_mixture_fn(self, condition: torch.Tensor) -> MoG:
        """z-scored condition -> the MoG in the z-scored theta space."""
        return MoG(*self.net(condition))

    def get_uncorrected_mog(self, condition) -> MoG:
        """The MoG in z-space for a raw condition (used by NPE-A and NPE-C)."""
        condition = torch.as_tensor(condition, dtype=torch.float32, device=self.device)
        return self.get_mixture_fn(self._embed_condition(torch.atleast_2d(condition)))

    def _log_prob(self, input, condition):
        return self.get_mixture_fn(condition).log_prob(input)

    def _sample(self, num_samples, condition, generator):
        return self.get_mixture_fn(condition).sample(num_samples, generator)


# The reference's lower-level name.
MultivariateGaussianMDN = MixtureDensityEstimator
