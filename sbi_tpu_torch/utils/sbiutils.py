"""Core utilities: devices, random generators, z-scoring, support checks.

PyTorch counterpart of ``sbi_tpu/utils/sbiutils.py`` (the parts the NSF
serving and training paths use). Where the JAX package threads ``key=``, this package takes
an explicit ``torch.Generator``; ``generator=None`` falls back to a
per-device global generator that ``seed_all_backends`` seeds, mirroring the
JAX package's global key store.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``.

    Raises if CUDA is asked for and absent; never falls back to the CPU. On
    the card, TF32 is switched off for matmuls and convolutions: the
    statistical path runs in full float32, as in ``sbi_tpu``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available. sbi_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run on the CPU."
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


# ---------------------------------------------------------------------------
# Global generators (mirror of `sbi_tpu/utils/sbiutils.py:26-40`)
# ---------------------------------------------------------------------------

_GLOBAL_SEED = [0]
_GLOBAL_GENERATORS: dict = {}


def seed_all_backends(seed: int = 0) -> None:
    """Seed the per-device global generators, torch's and numpy's."""
    _GLOBAL_SEED[0] = int(seed)
    _GLOBAL_GENERATORS.clear()
    np.random.seed(int(seed))
    torch.manual_seed(int(seed))


def next_generator(generator: Optional[torch.Generator] = None, device="cpu") -> torch.Generator:
    """Return ``generator`` if given, else the global generator of ``device``."""
    if generator is not None:
        return generator
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    g = _GLOBAL_GENERATORS.get(device)
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(_GLOBAL_SEED[0])
        _GLOBAL_GENERATORS[device] = g
    return g


# ---------------------------------------------------------------------------
# z-scoring (mirror of `sbi_tpu/utils/sbiutils.py:62-193`)
# ---------------------------------------------------------------------------


def z_score_stats(
    batch: torch.Tensor, structured: bool = False, min_std: float = 1e-7
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean/std over the batch axis. The std is the population std
    (``correction=0``), as ``jnp.std``.

    ``structured=True``: one scalar mean/std across all event dims.
    """
    batch = torch.as_tensor(batch, dtype=torch.float32)
    ones = torch.ones(batch.shape[1:], device=batch.device)
    if structured:
        mean = batch.mean() * ones
        std = batch.std(correction=0) * ones
    else:
        mean = batch.mean(dim=0)
        std = batch.std(dim=0, correction=0)
    std = std.clamp(min=min_std)
    return mean, std


def z_score_parser(z_score_flag=None) -> Tuple[bool, bool]:
    """Parse the z-score flag into (do_z_score, structured) booleans."""
    if isinstance(z_score_flag, bool):
        warnings.warn(
            "Boolean flag for z-scoring is deprecated. Use 'none', "
            "'independent', or 'structured'.",
            stacklevel=2,
        )
        return z_score_flag, False
    if z_score_flag is None or z_score_flag == "none":
        return False, False
    if z_score_flag in ("independent", "structured"):
        return True, z_score_flag == "structured"
    if z_score_flag == "transform_to_unconstrained":
        return False, False
    raise ValueError(
        "Invalid z-scoring option. Use 'none', 'independent', 'structured' "
        "or 'transform_to_unconstrained'."
    )


def assert_transform_to_unconstrained_supported(
    z_score_flag, builder_name: str, suggestion: str = ""
) -> None:
    """Raise when a builder without `transform_to_unconstrained` support
    receives that flag."""
    if z_score_flag == "transform_to_unconstrained":
        raise ValueError(
            f"`z_score='transform_to_unconstrained'` is not supported by "
            f"`{builder_name}`. {suggestion}"
        )


def warn_if_invalid_for_zscoring(x: torch.Tensor, outlier_iqr_factor: float = 10.0) -> None:
    """Warn about a single sample, constant features, or extreme outliers
    (beyond ``outlier_iqr_factor`` IQRs from the quartiles). The statistics
    run on the data's device; only per-dim flags come back to the host."""
    x = torch.as_tensor(x)
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    if x.shape[0] <= 1:
        warnings.warn(
            "Only one data sample provided. Z-scoring requires multiple samples "
            "to compute meaningful statistics. Consider adding more simulations.",
            UserWarning,
            stacklevel=2,
        )
        return
    x = x.to(torch.float32)
    constant = x.std(dim=0, correction=0) < 1e-14
    constant_dims = np.where(constant.cpu().numpy())[0]
    if constant_dims.size > 0:
        warnings.warn(
            f"Data has constant values in dimension(s) {constant_dims.tolist()}. "
            "These dimensions carry no information and will be mapped to zero "
            "after z-scoring.",
            UserWarning,
            stacklevel=2,
        )
        return
    q = torch.quantile(x, torch.tensor([0.25, 0.75], device=x.device), dim=0)
    q1, q3 = q[0], q[1]
    iqr = q3 - q1
    valid_iqr = iqr > 1e-14
    if not bool(valid_iqr.any()):
        return
    lower = q1 - outlier_iqr_factor * iqr
    upper = q3 + outlier_iqr_factor * iqr
    outlier = ((x < lower) | (x > upper)).any(dim=0) & valid_iqr
    outlier_dims = np.where(outlier.cpu().numpy())[0]
    if outlier_dims.size > 0:
        warnings.warn(
            f"Data has extreme outliers in dimension(s) {outlier_dims.tolist()} "
            f"(beyond {outlier_iqr_factor}x IQR from quartiles). This may cause "
            "precision loss during z-scoring, where distinct values become "
            "indistinguishable. Consider removing outliers or z_score='none'.",
            UserWarning,
            stacklevel=2,
        )


def standardizing_transform(batch: torch.Tensor, structured: bool = False):
    from .transforms import AffineTransform

    warn_if_invalid_for_zscoring(batch)
    mean, std = z_score_stats(batch, structured)
    return AffineTransform(mean, std)


# ---------------------------------------------------------------------------
# Invalid simulations (mirror of `sbi_tpu/utils/sbiutils.py:201-240`)
# ---------------------------------------------------------------------------


def handle_invalid_x(x: torch.Tensor, exclude_invalid_x: bool = True) -> Tuple[torch.Tensor, int, int]:
    """Return (is_valid mask, num_nans, num_infs): a row is invalid where
    any of its entries is NaN or infinite. One host sync for the counts."""
    x = torch.as_tensor(x)
    flat = x.reshape(x.shape[0], -1)
    nan_mask = torch.isnan(flat).any(dim=1)
    inf_mask = torch.isinf(flat).any(dim=1)
    num_nans, num_infs = (int(v) for v in torch.stack([nan_mask.sum(), inf_mask.sum()]).tolist())
    if exclude_invalid_x:
        is_valid = ~(nan_mask | inf_mask)
    else:
        is_valid = torch.ones(flat.shape[0], dtype=torch.bool, device=flat.device)
    return is_valid, num_nans, num_infs


def warn_on_invalid_x(num_nans: int, num_infs: int, exclude_invalid_x: bool) -> None:
    if num_nans + num_infs > 0:
        if exclude_invalid_x:
            warnings.warn(
                f"Found {num_nans} NaN simulations and {num_infs} Inf simulations. "
                "They will be excluded from training."
            )
        else:
            warnings.warn(
                f"Found {num_nans} NaN simulations and {num_infs} Inf simulations. "
                "Training might fail."
            )


def nle_nre_apt_msg_on_invalid_x(num_nans, num_infs, exclude_invalid_x, algorithm):
    if num_nans + num_infs > 0:
        warnings.warn(
            f"Found {num_nans} NaN and {num_infs} Inf simulations. Excluding them "
            f"is not exact for {algorithm}; consider a RestrictionEstimator."
        )


# ---------------------------------------------------------------------------
# Support checks and small helpers
# ---------------------------------------------------------------------------


def within_support(distribution, samples: torch.Tensor) -> torch.Tensor:
    """Boolean mask of which samples lie in the distribution's support."""
    if hasattr(distribution, "within_support"):
        return distribution.within_support(samples)
    return torch.isfinite(distribution.log_prob(samples))


def draw_from_proposal(proposal, generator: Optional[torch.Generator], num_samples: int) -> torch.Tensor:
    """Sample ``(num_samples, *event)`` from a prior or from a posterior
    used as a proposal (mirror of ``sbi_tpu/utils/sbiutils.py:43``). The JAX
    package tells the two apart because their ``sample`` signatures differ;
    here both are ``sample(sample_shape, generator=...)``."""
    return proposal.sample((num_samples,), generator=generator)


def mog_log_prob(theta: torch.Tensor, logits_pp: torch.Tensor, means_pp: torch.Tensor,
                 precisions_pp: torch.Tensor) -> torch.Tensor:
    """log prob of a mixture of Gaussians given by unnormalized logits
    (batch, K), means (batch, K, D) and precisions (batch, K, D, D), at
    theta (batch, D) (mirror of ``sbi_tpu/utils/sbiutils.py:261``)."""
    D = theta.shape[-1]
    log_weights = torch.log_softmax(logits_pp, dim=-1)
    diff = theta[:, None, :] - means_pp
    quad = torch.einsum("bki,bkij,bkj->bk", diff, precisions_pp, diff)
    _, logabsdet = torch.linalg.slogdet(precisions_pp)
    log_comp = 0.5 * (logabsdet - D * math.log(2 * math.pi) - quad)
    return torch.logsumexp(log_weights + log_comp, dim=-1)


def ensure_theta_batched(theta, device=None) -> torch.Tensor:
    """float32 tensor with a batch axis; ``device=None`` keeps a tensor's
    device (numpy input lands on the CPU)."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=device)
    if theta.ndim == 1:
        theta = theta[None]
    return theta
