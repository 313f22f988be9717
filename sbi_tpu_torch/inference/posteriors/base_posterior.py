"""NeuralPosterior base class.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/base_posterior.py``:
wraps a potential; ``sample``/``sample_batched`` abstract; ``set_default_x``.
``map()`` needs ``gradient_ascent`` and comes with a later slice.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from ...utils.sbiutils import ensure_theta_batched
from ...utils.transforms import IdentityTransform
from ..potentials.base_potential import BasePotential, CustomPotentialWrapper


class NeuralPosterior:
    def __init__(
        self,
        potential_fn: Union[BasePotential, Any],
        theta_transform=None,
        device=None,
        x_shape: Optional[Tuple[int, ...]] = None,
    ):
        if not isinstance(potential_fn, BasePotential) and callable(potential_fn):
            potential_fn = CustomPotentialWrapper(potential_fn, prior=None, device=device)
        self.potential_fn = potential_fn
        self.theta_transform = theta_transform or IdentityTransform()
        self._device = torch.device(device) if device is not None else potential_fn.device
        self._x_shape = x_shape
        # A potential built with x_o already passes it on as the default.
        self.default_x: Optional[torch.Tensor] = (
            potential_fn.return_x_o() if hasattr(potential_fn, "return_x_o") else None
        )
        self._purpose = ""

    # ------------------------------------------------------------------ x_o
    def set_default_x(self, x) -> "NeuralPosterior":
        self.default_x = torch.atleast_2d(
            torch.as_tensor(x, dtype=torch.float32, device=self._device)
        )
        self.potential_fn.set_x(self.default_x)
        return self

    def _x_else_default_x(self, x) -> Optional[torch.Tensor]:
        if x is not None:
            return torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=self._device))
        if self.default_x is None:
            # A custom potential over theta only needs no observation.
            if getattr(self.potential_fn, "requires_x", True) is False:
                return None
            raise ValueError(
                "Context x needed when a default has not been set. Use "
                "`.set_default_x(x)` or pass `x=...`."
            )
        return self.default_x

    # --------------------------------------------------------------- potential
    def potential(self, theta, x=None, track_gradients: bool = True) -> torch.Tensor:
        theta = ensure_theta_batched(theta, self._device)
        self.potential_fn.set_x(self._x_else_default_x(x))
        return self.potential_fn(theta)

    # ----------------------------------------------------------------- sample
    def sample(self, sample_shape=(), x=None, generator=None, **kwargs) -> torch.Tensor:
        raise NotImplementedError

    def sample_batched(self, sample_shape, x, generator=None, **kwargs) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, theta, x=None, **kwargs) -> torch.Tensor:
        return self.potential(theta, x)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._purpose})"
