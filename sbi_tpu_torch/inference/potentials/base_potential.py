"""Potential protocol: unnormalized log-density over theta given x_o.

PyTorch counterpart of ``sbi_tpu/inference/potentials/base_potential.py``.
Potentials are callables ``potential(theta) -> log prob`` with ``set_x`` and
a ``gradient`` through autograd.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional

import torch

from ...utils.sbiutils import ensure_theta_batched


class BasePotential:
    allow_iid_x: bool = False

    def __init__(self, prior: Optional[Any], x_o=None, device=None):
        self.prior = prior
        self.device = None if device is None else torch.device(device)
        self._x_o = None
        self.x_is_iid = False
        if x_o is not None:
            self.set_x(x_o)

    def __call__(self, theta: torch.Tensor, track_gradients: bool = True) -> torch.Tensor:
        raise NotImplementedError

    def gradient(self, theta: torch.Tensor) -> torch.Tensor:
        """d potential / d theta, row by row (rows are independent)."""
        theta = ensure_theta_batched(theta, self.device).detach().requires_grad_(True)
        with torch.enable_grad():
            value = self(theta).sum()
            return torch.autograd.grad(value, theta)[0]

    def set_x(self, x_o, x_is_iid: Optional[bool] = False):
        if x_o is not None:
            x_o = torch.atleast_2d(torch.as_tensor(x_o, dtype=torch.float32, device=self.device))
        self._x_o = x_o
        self.x_is_iid = bool(x_is_iid)
        return self

    @property
    def x_o(self) -> torch.Tensor:
        if self._x_o is None:
            raise ValueError("No observed data x_o; use `set_x`.")
        return self._x_o

    @x_o.setter
    def x_o(self, value):
        self.set_x(value)

    def return_x_o(self) -> Optional[torch.Tensor]:
        return self._x_o


class CustomPotential:
    """Protocol marker for user potentials fn(theta, x_o) -> log prob."""


class CustomPotentialWrapper(BasePotential):
    """Wrap a plain callable into the potential protocol. A callable that
    takes only `theta` is a complete log density: `requires_x` is False."""

    allow_iid_x = True

    def __init__(self, potential_fn: Callable, prior, x_o=None, device=None):
        self._fn = potential_fn
        try:
            params = inspect.signature(potential_fn).parameters
            self.requires_x = len(params) >= 2 or any(
                p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in params.values()
            )
        except (TypeError, ValueError):  # builtins / odd callables
            self.requires_x = True
        super().__init__(prior, x_o, device)

    def __call__(self, theta, track_gradients: bool = True):
        theta = ensure_theta_batched(theta, self.device)
        if self.requires_x:
            return self._fn(theta, self._x_o)
        return self._fn(theta)
