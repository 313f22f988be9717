"""CNN embedding nets, 1-D and 2-D (PyTorch counterpart of
``sbi_tpu/neural_nets/embedding_nets/cnn.py``)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class CNNEmbedding(nn.Module):
    """Conv stack (1-D or 2-D, from ``input_shape``) and an MLP head.

    Input: (batch, *input_shape) or any shape that flattens to it, read as
    the JAX package reads it: channels last, (L, C) or (H, W, C) with C =
    ``in_channels``. Each layer is a "same"-padded convolution, a ReLU and
    a max-pool of window and stride ``pool_kernel_size`` that drops an odd
    remainder. The features are flattened channels last, as flax flattens
    them, so the first Linear reads them in the JAX package's order.
    """

    def __init__(
        self,
        input_shape: Tuple[int, ...],
        in_channels: int = 1,
        out_channels_per_layer: Sequence[int] = (16, 32),
        num_conv_layers: int = 2,
        num_linear_layers: int = 2,
        num_linear_units: int = 50,
        output_dim: int = 20,
        kernel_size: int = 5,
        pool_kernel_size: int = 2,
    ):
        super().__init__()
        self.input_shape = tuple(int(s) for s in input_shape)
        if len(self.input_shape) not in (1, 2):
            raise ValueError("CNNEmbedding supports 1D or 2D inputs.")
        if kernel_size % 2 != 1:
            raise ValueError("CNNEmbedding pads 'same' symmetrically: kernel_size must be odd.")
        self.in_channels = in_channels
        self.pool = pool_kernel_size
        conv = nn.Conv1d if len(self.input_shape) == 1 else nn.Conv2d
        channels = [in_channels] + list(out_channels_per_layer[:num_conv_layers])
        self.convs = nn.ModuleList(
            conv(c_in, c_out, kernel_size, padding=kernel_size // 2)
            for c_in, c_out in zip(channels[:-1], channels[1:]))
        spatial = list(self.input_shape)
        for _ in range(num_conv_layers):
            spatial = [s // pool_kernel_size for s in spatial]
        widths = [math.prod(spatial) * channels[-1]] + [num_linear_units] * (num_linear_layers - 1)
        self.linears = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = x.reshape((B,) + self.input_shape + (self.in_channels,))
        h = h.movedim(-1, 1)  # channels first for torch's convolutions
        pool = F.max_pool1d if len(self.input_shape) == 1 else F.max_pool2d
        for conv in self.convs:
            h = pool(torch.relu(conv(h)), self.pool)
        h = h.movedim(1, -1).reshape(B, -1)  # flattened channels last
        for layer in self.linears:
            h = torch.relu(layer(h))
        return self.out(h)
