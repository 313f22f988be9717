"""Classifier two-sample test (C2ST) in PyTorch.

Counterpart of ``sbi_tpu/utils/metrics.py::c2st_jax`` (``:88-154``): a
2-layer ReLU MLP trained full-batch with Adam on an 80/20 holdout split of
the z-scored samples, scored by holdout accuracy (0.5: indistinguishable).
It needs no sklearn, so it runs on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .sbiutils import next_generator


def c2st_torch(
    X,
    Y,
    generator: Optional[torch.Generator] = None,
    hidden: int = 64,
    num_epochs: int = 200,
    lr: float = 1e-3,
) -> torch.Tensor:
    """Holdout accuracy of an MLP separating X from Y, on X's device.

    ``generator`` (on that device) draws the split and the initial weights.
    """
    X = torch.as_tensor(X, dtype=torch.float32)
    Y = torch.as_tensor(Y, dtype=torch.float32, device=X.device)
    device = X.device
    g = next_generator(generator, device)
    mu, sigma = X.mean(0), X.std(0, correction=0).clamp(min=1e-6)
    data = torch.cat([(X - mu) / sigma, (Y - mu) / sigma])
    labels = torch.cat([torch.zeros(X.shape[0], device=device), torch.ones(Y.shape[0], device=device)])
    n = data.shape[0]
    perm = torch.randperm(n, generator=g, device=device)
    data, labels = data[perm], labels[perm]
    n_train = int(0.8 * n)
    xtr, ytr, xte, yte = data[:n_train], labels[:n_train], data[n_train:], labels[n_train:]

    d = data.shape[1]
    shapes = ((d, hidden), (hidden, hidden), (hidden, 1))
    weights = [(torch.randn(s, generator=g, device=device) / math.sqrt(s[0])).requires_grad_()
               for s in shapes]
    biases = [torch.zeros(s[1], device=device, requires_grad=True) for s in shapes]

    def logits(x):
        h = torch.relu(x @ weights[0] + biases[0])
        h = torch.relu(h @ weights[1] + biases[1])
        return (h @ weights[2] + biases[2])[:, 0]

    opt = torch.optim.Adam(weights + biases, lr=lr, foreach=True)
    with torch.enable_grad():
        for _ in range(num_epochs):
            opt.zero_grad(set_to_none=True)
            F.binary_cross_entropy_with_logits(logits(xtr), ytr).backward()
            opt.step()
    with torch.no_grad():
        return ((logits(xte) > 0).float() == yte).float().mean()
