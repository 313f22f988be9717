"""Simulation-based calibration (SBC).

PyTorch counterpart of ``sbi_tpu/diagnostics/sbc.py``: rank statistics of
theta* among posterior samples, marginal ranks (``reduce_fns="marginals"``)
or log-prob ranks; KS uniformity checks and C2STs. Sampling batches across
observations (``sample_batched``), and everything runs on the posterior's
device: the C2STs are the port's ``c2st``, sklearn's MLP algorithm in
PyTorch. ``mesh=`` comes with a later slice and raises.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.metrics import as_tensor, c2st
from ..utils.sbiutils import next_generator, resolve_device

_LATER_SLICE = "comes with a later slice of the port (multi-GPU sharding)"


def posterior_device(posterior, like=None) -> torch.device:
    """The posterior's device; for an object without one, ``like``'s
    (a tensor), else cuda."""
    device = getattr(posterior, "_device", None)
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return resolve_device(None)


def get_posterior_samples_on_batch(
    posterior,
    sample_shape: Tuple[int, ...],
    xs: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    use_batched_sampling: bool = True,
    mesh=None,
) -> torch.Tensor:
    """(*sample_shape, num_xs, dim_theta): one ``sample_batched`` where the
    posterior has it, else ``sample`` observation by observation."""
    if mesh is not None:
        raise NotImplementedError(f"Sampling over a device mesh (mesh=) {_LATER_SLICE}.")
    if use_batched_sampling:
        try:
            return posterior.sample_batched(sample_shape, xs, generator=generator)
        except (NotImplementedError, AttributeError):
            pass
    outs = [posterior.sample(sample_shape, x=xs[i][None], generator=generator)
            for i in range(xs.shape[0])]
    return torch.stack(outs, dim=len(sample_shape))


def run_sbc(
    thetas,
    xs,
    posterior,
    num_posterior_samples: int = 1000,
    reduce_fns: Union[str, Callable, List[Callable]] = "marginals",
    generator: Optional[torch.Generator] = None,
    use_batched_sampling: bool = True,
    mesh=None,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ranks (N, num_metrics), dap_samples (N, dim)), on the
    posterior's device.

    ranks[i, j] = #{posterior samples with metric_j < metric_j(theta*_i)}.
    """
    if mesh is not None:
        raise NotImplementedError(f"run_sbc over a device mesh (mesh=) {_LATER_SLICE}.")
    device = posterior_device(posterior, thetas)
    thetas = as_tensor(thetas, device)
    xs = torch.atleast_2d(as_tensor(xs, device))
    N = thetas.shape[0]
    assert N == xs.shape[0], "Number of parameters must match number of observations."
    if N < 100:
        warnings.warn(
            "Number of SBC samples should be on the order of 100s to give "
            "reliable results."
        )
    if num_posterior_samples < 100:
        warnings.warn(
            "Number of posterior samples should be on the order of 100s."
        )
    generator = next_generator(generator, device)
    samples = get_posterior_samples_on_batch(
        posterior, (num_posterior_samples,), xs, generator=generator,
        use_batched_sampling=use_batched_sampling,
    )  # (L, N, D)
    dap_samples = samples[0]  # data-averaged posterior draws
    ranks = _run_sbc_ranks(thetas, xs, samples, posterior, reduce_fns)
    return ranks, dap_samples


def _run_sbc_ranks(thetas, xs, samples, posterior, reduce_fns) -> torch.Tensor:
    """Ranks (N, num_metrics) of thetas (N, D) among samples (L, N, D).
    ``"log_prob"`` scores all samples in one ``log_prob_batched`` call where
    the posterior has one, else observation by observation; both subtract
    the same per-observation constant (the leakage correction) from a
    sample's and theta*'s log-prob, so the ranks agree."""
    if isinstance(reduce_fns, str):
        if reduce_fns == "marginals":
            # rank per dimension: fully vectorized comparison
            return (samples < thetas[None, :, :]).sum(0).to(torch.int32)  # (N, D)
        if reduce_fns != "log_prob":
            raise ValueError(f"Unknown reduce_fns {reduce_fns!r}")
        if hasattr(posterior, "log_prob_batched"):
            with torch.no_grad():
                s_val = posterior.log_prob_batched(samples, xs)  # (L, N)
                t_val = posterior.log_prob_batched(thetas[None], xs)  # (1, N)
            return (s_val < t_val).sum(0).to(torch.int32)[:, None]
        reduce_fns = [lambda theta, x: posterior.log_prob(theta, x=x)]
    if callable(reduce_fns):
        reduce_fns = [reduce_fns]

    all_ranks = []
    with torch.no_grad():
        for fn in reduce_fns:
            cols = []
            for i in range(thetas.shape[0]):
                t_val = fn(thetas[i][None], xs[i][None])
                s_val = fn(samples[:, i, :], xs[i][None])
                cols.append((s_val < t_val).sum())
            all_ranks.append(torch.stack(cols))
    return torch.stack(all_ranks, dim=-1).to(torch.int32)


def check_sbc(
    ranks,
    prior_samples,
    dap_samples,
    num_posterior_samples: int = 1000,
    num_c2st_repetitions: int = 1,
    rng: Union[None, int, np.random.RandomState, np.random.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Uniformity checks (ref sbc.py:275-374): KS p-values of the ranks, the
    C2ST of the ranks against uniform draws, and the C2ST of prior draws
    against the data-averaged posterior, per dimension. The C2STs run on
    the ranks' device. ``rng`` draws the uniform reference: a seed or a
    numpy generator; None takes numpy's global state, as the JAX package."""
    import scipy.stats as st

    device = ranks.device if isinstance(ranks, torch.Tensor) else resolve_device(None)
    ranks_np = np.asarray(ranks.cpu() if isinstance(ranks, torch.Tensor) else ranks)
    N, num_metrics = ranks_np.shape

    # KS test of ranks vs uniform
    ks_pvals = np.array([
        st.kstest(ranks_np[:, i], st.uniform(0, num_posterior_samples).cdf)[1]
        for i in range(num_metrics)
    ], dtype=np.float32)

    # c2st between ranks and uniform samples
    if rng is None or isinstance(rng, (int, np.integer)):
        rng = np.random.RandomState(rng) if rng is not None else np.random
    uniform = rng.uniform(0, num_posterior_samples, size=ranks_np.shape)
    ranks_dev = torch.as_tensor(ranks_np, dtype=torch.float64, device=device)
    uniform = torch.as_tensor(uniform, dtype=torch.float64, device=device)
    c2st_ranks = torch.stack([c2st(ranks_dev[:, i:i + 1], uniform[:, i:i + 1])
                              for i in range(num_metrics)])

    # data-averaged posterior should equal the prior
    prior_samples = as_tensor(prior_samples, device)
    dap_samples = as_tensor(dap_samples, device)
    c2st_dap = torch.stack([c2st(prior_samples[:, i:i + 1], dap_samples[:, i:i + 1])
                            for i in range(dap_samples.shape[1])])

    return dict(
        ks_pvals=torch.as_tensor(ks_pvals, device=device),
        c2st_ranks=c2st_ranks.float(),
        c2st_dap=c2st_dap.float(),
    )


def get_nltp(thetas, xs, posterior) -> torch.Tensor:
    """Negative log prob of true parameters (ref diagnostics __init__)."""
    device = posterior_device(posterior, thetas)
    thetas, xs = as_tensor(thetas, device), as_tensor(xs, device)
    with torch.no_grad():
        return torch.stack([-posterior.log_prob(thetas[i][None], x=xs[i][None])[0]
                            for i in range(thetas.shape[0])])
