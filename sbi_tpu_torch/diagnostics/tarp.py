"""TARP: Tests of Accuracy with Random Points (Lemos et al. 2023).

PyTorch counterpart of ``sbi_tpu/diagnostics/tarp.py``: the expected
coverage probability against the credibility level, from distances to
random reference points, on the posterior's device; KS / ATC checks.
``mesh=`` comes with a later slice and raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.metrics import as_tensor
from ..utils.sbiutils import next_generator
from .sbc import _LATER_SLICE, get_posterior_samples_on_batch, posterior_device


def _l2(a, b):
    return torch.sqrt(((a - b) ** 2).sum(-1))


def run_tarp(
    thetas,
    xs,
    posterior,
    references=None,
    num_posterior_samples: int = 1000,
    num_bins: Optional[int] = 30,
    z_score_theta: bool = True,
    generator: Optional[torch.Generator] = None,
    use_batched_sampling: bool = True,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ecp, alpha_grid): the expected coverage probability at each
    credibility level. ``generator`` draws the posterior samples, then the
    reference points (uniform on the unit box) where none are given."""
    if mesh is not None:
        raise NotImplementedError(f"run_tarp over a device mesh (mesh=) {_LATER_SLICE}.")
    device = posterior_device(posterior, thetas)
    generator = next_generator(generator, device)
    thetas = as_tensor(thetas, device)
    xs = torch.atleast_2d(as_tensor(xs, device))
    N = thetas.shape[0]
    samples = get_posterior_samples_on_batch(
        posterior, (num_posterior_samples,), xs, generator=generator,
        use_batched_sampling=use_batched_sampling,
    )  # (L, N, D)

    if num_bins is None:
        num_bins = N // 10

    if z_score_theta:
        lo = samples.amin(dim=(0, 1))
        hi = samples.amax(dim=(0, 1))
        scale = torch.clamp(hi - lo, min=1e-9)
        samples = (samples - lo) / scale
        thetas = (thetas - lo) / scale

    if references is None:
        references = torch.rand(thetas.shape, generator=generator, device=device)  # (N, D)
    references = as_tensor(references, device)

    sample_dists = _l2(references[None, :, :], samples)  # (L, N)
    theta_dists = _l2(references, thetas)  # (N,)

    # fraction of posterior samples closer to the reference than theta*
    f = (sample_dists < theta_dists[None, :]).float().mean(0)  # (N,)

    alpha_grid = torch.linspace(0.0, 1.0, num_bins, device=device)
    ecp = (f[None, :] < alpha_grid[:, None]).float().mean(-1)
    return ecp, alpha_grid


def check_tarp(ecp, alpha) -> Tuple[float, float]:
    """Returns (atc, ks_pval) (ref `tarp.py:209`): the area between the
    coverage curve and the diagonal above the midpoint, and a KS test
    between ecp and alpha."""
    import scipy.stats as st

    ecp_np = np.asarray(ecp.cpu() if isinstance(ecp, torch.Tensor) else ecp)
    alpha_np = np.asarray(alpha.cpu() if isinstance(alpha, torch.Tensor) else alpha)
    mid = len(alpha_np) // 2
    atc = float((ecp_np[mid:] - alpha_np[mid:]).sum())
    _, ks_pval = st.ks_2samp(ecp_np, alpha_np)
    return atc, float(ks_pval)
