"""Model misspecification checks.

PyTorch counterpart of ``sbi_tpu/diagnostics/misspecification.py``: a
permutation MMD test of x_o against the simulated x (in the estimator's
z-scored condition space, or raw), and the rank of log p(x_o) under a
trained marginal among the log-probs of simulated x.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.metrics import _sq_dists, as_tensor, biased_mmd, median
from ..utils.sbiutils import next_generator


def _mmd_stat(a, b, scale=None) -> torch.Tensor:
    """Biased MMD: well-defined for single-observation a (the unbiased
    estimator divides by n(n-1) and NaNs at n=1)."""
    return biased_mmd(a, b, scale=scale)


def mmd_scale(x: torch.Tensor) -> torch.Tensor:
    """The test's kernel scale: the median heuristic over x's first 200
    rows, sqrt(median of squared distances / 2)."""
    ref = x[:200]
    return torch.sqrt(median(_sq_dists(ref, ref)) / 2.0)


def calc_misspecification_mmd(
    inference=None,
    x_obs=None,
    x=None,
    mode: str = "embed",
    num_permutations: int = 100,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Permutation MMD test of x_o against the simulated x distribution, on
    x's device. Returns (p_value, (mmd_obs, null_mmds)). ``generator``
    draws the permutations."""
    assert x is not None, "Provide training simulations x."
    x = as_tensor(x)
    x = x.reshape(len(x), -1)
    x_obs = torch.atleast_2d(as_tensor(x_obs, x.device))
    x_obs = x_obs.reshape(len(x_obs), -1)

    if mode == "embed" and inference is not None:
        est = getattr(inference, "_neural_net", None)
        if est is not None and hasattr(est, "_embed_condition"):
            # Use the estimator's condition z-scoring as the summary.
            with torch.no_grad():
                x = est._embed_condition(x)
                x_obs = est._embed_condition(x_obs)

    n_obs = x_obs.shape[0]
    # Fixed kernel scale from the simulated distribution (median heuristic),
    # shared between the observed statistic and every null trial.
    ref = x[: min(1000, x.shape[0])]
    sigma = mmd_scale(ref)
    mmd_obs = _mmd_stat(x_obs, ref, scale=sigma)

    # Null: MMD between random subsets of x of size n_obs and the rest.
    g = next_generator(generator, x.device)
    m = min(1000, x.shape[0] - n_obs)
    nulls = []
    for _ in range(num_permutations):
        perm = torch.randperm(x.shape[0], generator=g, device=x.device)
        nulls.append(_mmd_stat(x[perm[:n_obs]], x[perm[n_obs:n_obs + m]], scale=sigma))
    null_mmds = torch.stack(nulls)
    p_value = (null_mmds >= mmd_obs).float().mean()
    return p_value, (mmd_obs, null_mmds)


def calc_misspecification_logprob(
    marginal_estimator,
    x_obs,
    x,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """p-value of log p(x_o) under the distribution of log p(x_sim)
    (ref `:200`). Small p => x_o is atypical => misspecification."""
    x = as_tensor(x)
    x_obs = torch.atleast_2d(as_tensor(x_obs, x.device))
    with torch.no_grad():
        lp_sim = marginal_estimator.log_prob(x)
        lp_obs = marginal_estimator.log_prob(x_obs)
    p_value = (lp_sim[None, :] < lp_obs[:, None]).float().mean(1)
    return p_value, (lp_obs, lp_sim)
