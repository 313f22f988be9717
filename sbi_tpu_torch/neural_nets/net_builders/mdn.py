"""MDN builder (PyTorch counterpart of
``sbi_tpu/neural_nets/net_builders/mdn.py``).

Defaults match the JAX package: hidden 50, 10 components, 2 layers, and
z-scoring as ``build_nsf``'s. The module is built on the CPU from
``generator`` (so the same seed gives the same weights on every device),
then moved to ``device`` (``None`` means ``cuda``; it raises without CUDA).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utils.sbiutils import assert_transform_to_unconstrained_supported, next_generator, resolve_device
from ..estimators.flows import init_flax_like_
from ..estimators.mdn import MDNModule, MixtureDensityEstimator
from .flow import _transforms_for


def build_mdn(
    batch_theta,
    batch_x,
    z_score_theta: str = "independent",
    z_score_x: str = "independent",
    hidden_features: int = 50,
    num_components: int = 10,
    num_layers: int = 2,
    embedding_net=None,
    scale_parameterization: str = "softplus",
    generator: Optional[torch.Generator] = None,
    device=None,
    **kwargs,
) -> MixtureDensityEstimator:
    """An MDN shaped and z-scored from a data batch."""
    device = resolve_device(device)
    batch_theta = torch.as_tensor(batch_theta, dtype=torch.float32, device=device)
    batch_x = torch.as_tensor(batch_x, dtype=torch.float32, device=device)
    theta_dim = batch_theta.shape[-1]
    assert_transform_to_unconstrained_supported(
        z_score_x, "build_mdn condition", "Use 'independent' or 'structured' for x."
    )
    if embedding_net is not None:
        embedding_net = embedding_net.cpu()
        with torch.no_grad():
            condition_features = int(np.prod(embedding_net(batch_x[:2].cpu()).shape[1:]))
    else:
        condition_features = int(np.prod(batch_x.shape[1:]))
    module = MDNModule(
        theta_dim=theta_dim,
        condition_features=condition_features,
        num_components=num_components,
        hidden_features=hidden_features,
        num_layers=num_layers,
        embedding_net=embedding_net,
        scale_parameterization=scale_parameterization,
    )
    init_flax_like_(module, next_generator(generator, "cpu"))
    return MixtureDensityEstimator(
        net=module.to(device),
        input_shape=(theta_dim,),
        condition_shape=tuple(batch_x.shape[1:]),
        input_transform=_transforms_for(batch_theta, z_score_theta, kwargs.get("x_dist")),
        condition_transform=_transforms_for(batch_x, z_score_x),
    )
