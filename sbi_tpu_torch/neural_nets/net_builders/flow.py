"""NSF and MAF builders (PyTorch counterpart of
``sbi_tpu/neural_nets/net_builders/flow.py``).

Each builder takes data batches, infers shapes, prepends z-scoring, and
returns a FlowEstimator on ``device`` (``None`` means ``cuda``; it raises
without CUDA). Defaults match the JAX package: NSF hidden 50 / 5
transforms / 10 bins / tail 3.0 / 2 blocks; MAF 50 / 5 / 2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utils.sbiutils import (
    assert_transform_to_unconstrained_supported,
    next_generator,
    resolve_device,
    standardizing_transform,
    z_score_parser,
)
from ...utils.transforms import mcmc_transform
from ..estimators.flows import FlowEstimator, FlowModule, init_flax_like_


def _transforms_for(batch, z_score, dist=None):
    """Input/condition reparametrization for a builder: z-scoring from batch
    statistics, or, for ``"transform_to_unconstrained"``, the bijection
    from the distribution's support (``mcmc_transform``)."""
    if z_score == "transform_to_unconstrained":
        if dist is None:
            raise ValueError(
                "x_dist must be provided when z_score='transform_to_unconstrained'."
            )
        return mcmc_transform(dist)
    do_z, structured = z_score_parser(z_score)
    if not do_z:
        return None
    return standardizing_transform(batch, structured=structured)


def _alternating_mask(dim: int, even: bool) -> np.ndarray:
    mask = np.arange(dim) % 2 == 0
    return mask if even else ~mask


def _build_flow_estimator(
    batch_theta,
    batch_x,
    layer_configs,
    z_score_theta="independent",
    z_score_x="independent",
    embedding_net=None,
    generator: Optional[torch.Generator] = None,
    x_dist=None,
    device=None,
):
    """Build the FlowModule on the CPU from ``generator`` (a CPU generator;
    ``None`` takes the global one), so the same seed gives the same weights
    on every device, then move it to ``device``."""
    device = resolve_device(device)
    batch_theta = torch.as_tensor(batch_theta, dtype=torch.float32, device=device)
    batch_x = torch.as_tensor(batch_x, dtype=torch.float32, device=device)
    dim = batch_theta.shape[-1]

    # `transform_to_unconstrained` applies to the estimator's INPUT (theta
    # for posterior flows); the condition side z-scores as usual.
    assert_transform_to_unconstrained_supported(
        z_score_x, "flow condition", "Use 'independent' or 'structured' for x."
    )
    if embedding_net is not None:
        embedding_net = embedding_net.cpu()
        with torch.no_grad():
            context_features = int(embedding_net(batch_x[:2].cpu()).shape[-1])
    else:
        context_features = int(np.prod(batch_x.shape[1:]))
    module = FlowModule(
        dim=dim,
        layer_configs=tuple(layer_configs),
        embedding_net=embedding_net,
        context_features=context_features,
    )
    init_flax_like_(module, next_generator(generator, "cpu"))
    return FlowEstimator(
        net=module.to(device),
        input_shape=(dim,),
        condition_shape=tuple(batch_x.shape[1:]),
        input_transform=_transforms_for(batch_theta, z_score_theta, x_dist),
        condition_transform=_transforms_for(batch_x, z_score_x),
    )


def build_maf(
    batch_theta,
    batch_x,
    z_score_theta="independent",
    z_score_x="independent",
    hidden_features: int = 50,
    num_transforms: int = 5,
    num_blocks: int = 2,
    embedding_net=None,
    generator: Optional[torch.Generator] = None,
    device=None,
    **kwargs,
):
    """MAF: [affine autoregressive + reverse permutation] x num_transforms."""
    dim = int(torch.as_tensor(batch_theta).shape[-1])
    maf_kw = dict(hidden_features=hidden_features, num_blocks=num_blocks)
    if "affine_log_scale_bounds" in kwargs:
        maf_kw["log_scale_bounds"] = tuple(kwargs["affine_log_scale_bounds"])
    configs = []
    for _ in range(num_transforms):
        configs.append(("maf", dict(maf_kw)))
        if dim > 1:
            configs.append(("permutation", dict(perm=tuple(range(dim - 1, -1, -1)))))
    return _build_flow_estimator(
        batch_theta, batch_x, configs, z_score_theta, z_score_x, embedding_net,
        generator, x_dist=kwargs.get("x_dist"), device=device,
    )


def build_nsf(
    batch_theta,
    batch_x,
    z_score_theta="independent",
    z_score_x="independent",
    hidden_features: int = 50,
    num_transforms: int = 5,
    num_blocks: int = 2,
    num_bins: int = 10,
    tail_bound: float = 3.0,
    embedding_net=None,
    interleave_affine: bool = False,
    affine_log_scale_bounds=(-14.0, 5.0),
    generator: Optional[torch.Generator] = None,
    device=None,
    **kwargs,
):
    """NSF: RQ-spline coupling + LU-linear with alternating masks for
    dim > 2; autoregressive RQ splines + reverse permutation for dim <= 2
    (a coupling can only transform one coordinate per layer there).

    ``interleave_affine=True`` puts a MAF layer with log-scale bounds
    ``affine_log_scale_bounds`` before each spline, in both branches: it
    absorbs a conditional location and scale that spans many orders of
    magnitude, and the spline models the O(1) residual shape."""
    dim = int(torch.as_tensor(batch_theta).shape[-1])
    affine_cfg = ("maf", dict(hidden_features=hidden_features, num_blocks=num_blocks,
                              log_scale_bounds=tuple(affine_log_scale_bounds)))
    configs = []
    if dim <= 2:
        for _ in range(num_transforms):
            if interleave_affine:
                configs.append(affine_cfg)
            configs.append(
                (
                    "rqs_ar",
                    dict(
                        hidden_features=hidden_features,
                        num_blocks=num_blocks,
                        num_bins=num_bins,
                        tail_bound=tail_bound,
                    ),
                )
            )
            if dim > 1:
                configs.append(
                    ("permutation", dict(perm=tuple(range(dim - 1, -1, -1))))
                )
    else:
        for i in range(num_transforms):
            mask = _alternating_mask(dim, even=(i % 2 == 0))
            if interleave_affine:
                configs.append(affine_cfg)
            configs.append(
                (
                    "rqs_coupling",
                    dict(
                        mask=tuple(bool(m) for m in mask),
                        hidden_features=hidden_features,
                        num_blocks=num_blocks,
                        num_bins=num_bins,
                        tail_bound=tail_bound,
                    ),
                )
            )
            configs.append(("lu_linear", {}))
    return _build_flow_estimator(
        batch_theta, batch_x, configs, z_score_theta, z_score_x, embedding_net,
        generator, x_dist=kwargs.get("x_dist"), device=device,
    )
