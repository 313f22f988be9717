"""Ratio-classifier builders (PyTorch counterpart of
``sbi_tpu/neural_nets/net_builders/classifier.py``): linear, MLP or ResNet
over the concatenated (theta, x), z-scored from a data batch.

Defaults match the JAX package: hidden 50, 2 layers or 2 blocks. The module
is built on the CPU from ``generator`` (so the same seed gives the same
weights on every device), then moved to ``device`` (``None`` means
``cuda``; it raises without CUDA).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utils.sbiutils import assert_transform_to_unconstrained_supported, next_generator, resolve_device
from ..estimators.flows import init_flax_like_
from ..estimators.ratio_estimators import (
    LinearClassifierModule,
    MLPClassifierModule,
    RatioEstimator,
    ResNetClassifierModule,
)
from .flow import _transforms_for


def _features(batch: torch.Tensor, embedding_net) -> int:
    """The flattened width of ``batch`` after ``embedding_net`` (run on
    two rows on the CPU, which also shapes a lazy first layer)."""
    if embedding_net is None:
        return int(np.prod(batch.shape[1:]))
    with torch.no_grad():
        return int(np.prod(embedding_net(batch[:2].cpu()).shape[1:]))


def _build(make_module, batch_theta, batch_x, z_score_theta, z_score_x, embedding_net_theta,
           embedding_net_x, generator, device) -> RatioEstimator:
    for flag in (z_score_theta, z_score_x):
        assert_transform_to_unconstrained_supported(
            flag, "classifier builders", "Use 'independent' or 'structured'.")
    device = resolve_device(device)
    batch_theta = torch.as_tensor(batch_theta, dtype=torch.float32, device=device)
    batch_x = torch.as_tensor(batch_x, dtype=torch.float32, device=device)
    if embedding_net_theta is not None:
        embedding_net_theta = embedding_net_theta.cpu()
    if embedding_net_x is not None:
        embedding_net_x = embedding_net_x.cpu()
    in_features = (_features(batch_theta, embedding_net_theta)
                   + _features(batch_x, embedding_net_x))
    module = make_module(in_features, embedding_net_theta, embedding_net_x)
    init_flax_like_(module, next_generator(generator, "cpu"))
    return RatioEstimator(
        net=module.to(device),
        theta_shape=tuple(batch_theta.shape[1:]),
        x_shape=tuple(batch_x.shape[1:]),
        theta_transform=_transforms_for(batch_theta, z_score_theta),
        x_transform=_transforms_for(batch_x, z_score_x),
    )


def build_linear_classifier(
    batch_theta, batch_x, z_score_theta="independent", z_score_x="independent",
    embedding_net_theta=None, embedding_net_x=None,
    generator: Optional[torch.Generator] = None, device=None, **kwargs,
) -> RatioEstimator:
    """A linear classifier; as in the JAX package it takes no embedding
    nets (those given are ignored)."""
    return _build(lambda n, *_: LinearClassifierModule(n), batch_theta, batch_x,
                  z_score_theta, z_score_x, None, None, generator, device)


def build_mlp_classifier(
    batch_theta, batch_x, z_score_theta="independent", z_score_x="independent",
    hidden_features: int = 50, embedding_net_theta=None, embedding_net_x=None,
    generator: Optional[torch.Generator] = None, device=None, **kwargs,
) -> RatioEstimator:
    def make(n, emb_theta, emb_x):
        return MLPClassifierModule(n, hidden_features, embedding_net_theta=emb_theta,
                                   embedding_net_x=emb_x)

    return _build(make, batch_theta, batch_x, z_score_theta, z_score_x, embedding_net_theta,
                  embedding_net_x, generator, device)


def build_resnet_classifier(
    batch_theta, batch_x, z_score_theta="independent", z_score_x="independent",
    hidden_features: int = 50, num_blocks: int = 2,
    embedding_net_theta=None, embedding_net_x=None,
    generator: Optional[torch.Generator] = None, device=None, **kwargs,
) -> RatioEstimator:
    def make(n, emb_theta, emb_x):
        return ResNetClassifierModule(n, hidden_features, num_blocks,
                                      embedding_net_theta=emb_theta, embedding_net_x=emb_x)

    return _build(make, batch_theta, batch_x, z_score_theta, z_score_x, embedding_net_theta,
                  embedding_net_x, generator, device)
