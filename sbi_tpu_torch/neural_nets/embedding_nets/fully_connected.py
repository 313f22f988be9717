"""Fully-connected embedding nets (PyTorch counterpart of
``sbi_tpu/neural_nets/embedding_nets/fully_connected.py``)."""

from __future__ import annotations

import torch
from torch import nn


class IdentityEmbedding(nn.Module):
    """Flatten-only embedding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)


class FCEmbedding(nn.Module):
    """MLP embedding: ``num_layers`` x (Linear + ReLU), then a Linear to
    ``output_dim``, over the flattened x. As flax's ``Dense``, the first
    layer takes its input width from the first batch it sees."""

    def __init__(self, output_dim: int = 20, num_layers: int = 2, num_hiddens: int = 40):
        super().__init__()
        widths = [num_hiddens] * num_layers + [output_dim]
        self.layers = nn.ModuleList(
            [nn.LazyLinear(widths[0])]
            + [nn.Linear(n_in, n_out) for n_in, n_out in zip(widths[:-1], widths[1:])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)
