"""NeuralPosterior base class.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/base_posterior.py``:
wraps a potential; ``sample``/``sample_batched`` abstract; ``set_default_x``;
``map()`` by multi-start gradient ascent (``utils/sbiutils.gradient_ascent``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from ...utils.sbiutils import ensure_theta_batched, gradient_ascent, next_generator
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
        self._map = None
        self._purpose = ""

    # ------------------------------------------------------------------ x_o
    def set_default_x(self, x) -> "NeuralPosterior":
        self.default_x = torch.atleast_2d(
            torch.as_tensor(x, dtype=torch.float32, device=self._device)
        )
        self.potential_fn.set_x(self.default_x)
        self._map = None
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

    # -------------------------------------------------------------------- MAP
    def map(
        self,
        x=None,
        num_iter: int = 1000,
        num_to_optimize: int = 100,
        learning_rate: float = 0.01,
        init_method="posterior",
        num_init_samples: int = 1000,
        save_best_every: int = 10,
        show_progress_bars: bool = False,
        force_update: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The MAP by multi-start Adam ascent on the potential, in the
        posterior's transformed space, from ``num_init_samples`` draws of
        the posterior (``init_method="posterior"``) or of the prior
        (``"proposal"``), or from given inits (a tensor). Defaults as the
        reference's: 1,000 iterations, 100 starts, lr 0.01. Without ``x``
        the result is cached until ``set_default_x`` or ``force_update``."""
        if x is None and self._map is not None and not force_update:
            return self._map
        self.potential_fn.set_x(self._x_else_default_x(x))
        if isinstance(init_method, torch.Tensor):
            inits = init_method
        elif init_method == "posterior":
            inits = self.sample((num_init_samples,), x=x, generator=generator)
        elif init_method == "proposal":
            inits = self.potential_fn.prior.sample(
                (num_init_samples,), generator=next_generator(generator, self._device))
        else:
            raise ValueError(f"Unknown init_method {init_method}")
        theta_map, _ = gradient_ascent(
            potential_fn=self.potential_fn,
            inits=inits.to(self._device),
            theta_transform=self.theta_transform,
            num_iter=num_iter,
            num_to_optimize=num_to_optimize,
            learning_rate=learning_rate,
            save_best_every=save_best_every,
            show_progress_bars=show_progress_bars,
        )
        if x is None:
            self._map = theta_map
        return theta_map

    def __repr__(self):
        return f"{self.__class__.__name__}({self._purpose})"
