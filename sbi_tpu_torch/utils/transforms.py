"""Bijective transforms (constrained <-> unconstrained space).

PyTorch counterpart of ``sbi_tpu/utils/transforms.py``. Conventions:
  - ``forward`` maps *constrained* -> *unconstrained*, ``inverse`` maps back.
  - ``forward_and_log_det`` returns (y, logdet) with logdet summed over the
    event (last) axis, shape = batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .distributions import BoxUniform, Distribution, Independent, Uniform


class Transform:
    def forward(self, x):
        return self.forward_and_log_det(x)[0]

    def inverse(self, y):
        return self.inverse_and_log_det(y)[0]

    @property
    def inv(self):
        return _Inverted(self)

    def forward_and_log_det(self, x):
        raise NotImplementedError

    def inverse_and_log_det(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y=None):
        return self.forward_and_log_det(x)[1]

    def __call__(self, x):
        return self.forward(x)


class _Inverted(Transform):
    def __init__(self, base):
        self.base = base

    def forward_and_log_det(self, x):
        return self.base.inverse_and_log_det(x)

    def inverse_and_log_det(self, y):
        return self.base.forward_and_log_det(y)

    @property
    def inv(self):
        return self.base


class IdentityTransform(Transform):
    def forward_and_log_det(self, x):
        return x, x.new_zeros(x.shape[:-1])

    def inverse_and_log_det(self, y):
        return y, y.new_zeros(y.shape[:-1])


class AffineTransform(Transform):
    """y = (x - loc) / scale  (z-scoring direction: constrained -> standardized)."""

    def __init__(self, loc, scale):
        self.loc = torch.as_tensor(loc, dtype=torch.float32)
        self.scale = torch.as_tensor(scale, dtype=torch.float32, device=self.loc.device)

    def forward_and_log_det(self, x):
        y = (x - self.loc) / self.scale
        ldj = -torch.log(self.scale.abs()).expand(x.shape).sum(-1)
        return y, ldj

    def inverse_and_log_det(self, y):
        x = y * self.scale + self.loc
        ldj = torch.log(self.scale.abs()).expand(y.shape).sum(-1)
        return x, ldj


class BoxToUnboundedTransform(Transform):
    """Map a box (low, high) to R^D via scaled logit; inverse is sigmoid."""

    def __init__(self, low, high):
        self.low = torch.as_tensor(low, dtype=torch.float32)
        self.high = torch.as_tensor(high, dtype=torch.float32, device=self.low.device)

    def forward_and_log_det(self, x):
        width = self.high - self.low
        u = (x - self.low) / width
        u = u.clamp(1e-7, 1.0 - 1e-7)
        y = torch.log(u) - torch.log1p(-u)
        # d y / d x = 1 / (width * u * (1-u))
        ldj = (-torch.log(width) - torch.log(u) - torch.log1p(-u)).sum(-1)
        return y, ldj

    def inverse_and_log_det(self, y):
        width = self.high - self.low
        # Clamp into the OPEN interval: at |y| >~ 17, float32 sigmoid
        # saturates to exactly 0/1, putting states on the closed boundary
        # where bounded priors have log_prob = -inf.
        u = torch.sigmoid(y).clamp(1e-7, 1.0 - 1e-7)
        x = self.low + width * u
        ldj = (torch.log(width) + F.logsigmoid(y) + F.logsigmoid(-y)).sum(-1)
        return x, ldj


class ComposeTransform(Transform):
    def __init__(self, parts):
        self.parts = tuple(parts)

    def forward_and_log_det(self, x):
        total = 0.0
        for t in self.parts:
            x, ldj = t.forward_and_log_det(x)
            total = total + ldj
        return x, total

    def inverse_and_log_det(self, y):
        total = 0.0
        for t in reversed(self.parts):
            y, ldj = t.inverse_and_log_det(y)
            total = total + ldj
        return y, total


def _transform_for(dist: Distribution, num_dims: int) -> Transform:
    """Pick an unconstraining transform for the prior."""
    if isinstance(dist, BoxUniform):
        return BoxToUnboundedTransform(dist.low, dist.high)
    if isinstance(dist, Independent) and isinstance(dist.base, Uniform):
        return BoxToUnboundedTransform(dist.base.low, dist.base.high)
    if isinstance(dist, Uniform):
        return BoxToUnboundedTransform(dist.low, dist.high)
    # Unbounded support: standardize with prior moments.
    try:
        loc = dist.mean.expand(num_dims)
        scale = dist.stddev.expand(num_dims)
        return AffineTransform(loc, scale)
    except NotImplementedError:
        return IdentityTransform()


def mcmc_transform(prior: Distribution, enable_transform: bool = True) -> Transform:
    """Bijection from the prior's support to unconstrained R^D. ``forward``
    maps constrained -> unconstrained; ``.inv`` maps back."""
    if not enable_transform:
        return IdentityTransform()
    num_dims = int(prior.event_shape[0]) if prior.event_shape else 1
    return _transform_for(prior, num_dims)


def transformed_potential(potential_fn, theta_transform: Transform):
    """Compose a potential with a transform so that MCMC runs unconstrained
    (mirror of ``sbi_tpu/utils/transforms.py:289``):
    ``pot_u(u) = potential(T.inv(u)) + log|det dT.inv/du|``, the log-det
    summed per row."""

    def transformed(u):
        theta, ldj = theta_transform.inverse_and_log_det(u)
        return potential_fn(theta) + ldj

    return transformed
