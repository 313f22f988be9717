"""Ratio estimator: a classifier over (theta, x) pairs.

PyTorch counterpart of ``sbi_tpu/neural_nets/estimators/ratio_estimators.py``.
The classifier outputs one logit, log r(x, theta), the likelihood-to-evidence
ratio once trained with the NRE losses. The modules take theta and x already
z-scored; their optional embedding nets are applied first, then the two are
flattened and concatenated. Layers are ``nn.Linear``s initialised as flax's
``Dense`` (``flows.init_flax_like_``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...utils.transforms import Transform
from .base import ConditionalEstimator, functional


def _concat(theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([theta.reshape(theta.shape[0], -1), x.reshape(x.shape[0], -1)], dim=-1)


class _EmbeddedClassifier(nn.Module):
    """Applies the optional embedding nets of theta and x and concatenates
    the flattened results."""

    def __init__(self, embedding_net_theta: Optional[nn.Module], embedding_net_x: Optional[nn.Module]):
        super().__init__()
        self.embedding_net_theta = embedding_net_theta
        self.embedding_net_x = embedding_net_x

    def features(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.embedding_net_theta is not None:
            theta = self.embedding_net_theta(theta)
        if self.embedding_net_x is not None:
            x = self.embedding_net_x(x)
        return _concat(theta, x)


class MLPClassifierModule(_EmbeddedClassifier):
    """``num_layers`` x (Linear + ReLU), then a Linear to one logit."""

    def __init__(self, in_features: int, hidden_features: int = 50, num_layers: int = 2,
                 embedding_net_theta: Optional[nn.Module] = None,
                 embedding_net_x: Optional[nn.Module] = None):
        super().__init__(embedding_net_theta, embedding_net_x)
        widths = [in_features] + [hidden_features] * num_layers
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], 1)

    def forward(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = self.features(theta, x)
        for layer in self.hidden:
            h = torch.relu(layer(h))
        return self.out(h)[:, 0]


class ResNetClassifierModule(_EmbeddedClassifier):
    """A Linear to ``hidden_features``, ``num_blocks`` residual blocks
    (h + Linear(ReLU(Linear(ReLU(h))))), then a Linear of ReLU(h) to one
    logit."""

    def __init__(self, in_features: int, hidden_features: int = 50, num_blocks: int = 2,
                 embedding_net_theta: Optional[nn.Module] = None,
                 embedding_net_x: Optional[nn.Module] = None):
        super().__init__(embedding_net_theta, embedding_net_x)
        self.inp = nn.Linear(in_features, hidden_features)
        self.blocks = nn.ModuleList(
            nn.ModuleList([nn.Linear(hidden_features, hidden_features),
                           nn.Linear(hidden_features, hidden_features)])
            for _ in range(num_blocks))
        self.out = nn.Linear(hidden_features, 1)

    def forward(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = self.inp(self.features(theta, x))
        for first, second in self.blocks:
            h = h + second(torch.relu(first(torch.relu(h))))
        return self.out(torch.relu(h))[:, 0]


class LinearClassifierModule(nn.Module):
    """One Linear over the concatenated (theta, x); no embedding nets."""

    def __init__(self, in_features: int):
        super().__init__()
        self.out = nn.Linear(in_features, 1)

    def forward(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.out(_concat(theta, x))[:, 0]


class RatioEstimator(ConditionalEstimator):
    """``log_ratio(theta, x) -> (B,)`` logits through ``net`` after the
    z-scoring of theta (``theta_transform``) and of x (``x_transform``).
    Those are the base class's ``input_transform`` and
    ``condition_transform``, which ``train_ensemble`` and the ensemble
    potential share between members."""

    def __init__(
        self,
        net: nn.Module,
        theta_shape: Tuple[int, ...],
        x_shape: Tuple[int, ...],
        theta_transform: Optional[Transform] = None,
        x_transform: Optional[Transform] = None,
    ):
        super().__init__(net, theta_shape, x_shape, theta_transform, x_transform)

    @property
    def theta_shape(self) -> Tuple[int, ...]:
        return self.input_shape

    @property
    def x_shape(self) -> Tuple[int, ...]:
        return self.condition_shape

    @property
    def theta_transform(self) -> Transform:
        return self.input_transform

    @property
    def x_transform(self) -> Transform:
        return self.condition_transform

    def log_ratio(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.net(self.input_transform.forward(theta), self.condition_transform.forward(x))

    def log_ratio_fn(self, params, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``log_ratio`` as a pure function of the net's parameters (a dict
        named as ``net.named_parameters()`` names them), as the JAX
        package's ``log_ratio_fn(params, theta, x)``."""
        return functional(self.net, self.log_ratio)(params, theta, x)

    def forward(self, theta, x):
        return self.log_ratio(theta, x)

    def __call__(self, theta, x):
        return self.log_ratio(theta, x)
