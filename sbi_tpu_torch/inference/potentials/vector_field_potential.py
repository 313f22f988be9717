"""Vector-field based potential: the CNF log-prob, and the score as its
gradient.

PyTorch counterpart of
``sbi_tpu/inference/potentials/vector_field_potential.py`` for one
observation. iid observations (several rows of x, ``x_is_iid``,
``iid_method``) and guidance come with a later slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...samplers.ode.ode_solvers import NeuralODE, build_neural_ode
from ...utils.sbiutils import ensure_theta_batched, within_support
from ...utils.transforms import mcmc_transform
from .base_potential import BasePotential

_LATER_SLICE = "comes with a later slice of the port"


def refuse_iid(x_o, x_is_iid=False, iid_method=None, guidance_method=None) -> None:
    """The iid and guidance options of the JAX package, which this slice
    does not port, raise ``NotImplementedError``."""
    if iid_method is not None or x_is_iid:
        raise NotImplementedError(f"iid observations (x_is_iid, iid_method) {_LATER_SLICE}.")
    if guidance_method is not None:
        raise NotImplementedError(f"guidance_method {_LATER_SLICE}.")
    if x_o is not None and torch.atleast_2d(torch.as_tensor(x_o)).shape[0] > 1:
        raise NotImplementedError(
            f"An x with more than one row (iid observations) {_LATER_SLICE}; use "
            "sample_batched for a batch of observations.")


class VectorFieldBasedPotential(BasePotential):
    allow_iid_x = False

    def __init__(self, vector_field_estimator, prior, x_o=None, device=None, ode_steps: int = 64,
                 iid_method: Optional[str] = None, iid_params=None):
        refuse_iid(None, iid_method=iid_method)
        self.vector_field_estimator = vector_field_estimator
        self.ode_steps = ode_steps
        super().__init__(prior, x_o, vector_field_estimator.device if device is None else device)

    def set_x(self, x_o, x_is_iid: Optional[bool] = False, iid_method=None, iid_params=None,
              guidance_method=None, guidance_params=None, **kwargs):
        refuse_iid(x_o, x_is_iid, iid_method, guidance_method)
        return super().set_x(x_o, False)

    def neural_ode(self, x_o) -> NeuralODE:
        """The CNF given the first row of ``x_o``, at ``ode_steps`` steps."""
        return build_neural_ode(self.vector_field_estimator, x_o, num_steps=self.ode_steps)

    def __call__(self, theta, track_gradients: bool = True) -> torch.Tensor:
        """log p(theta | x_o) by the CNF (``ode_steps`` RK4 steps, exact
        divergence), -inf outside the prior's support."""
        theta = ensure_theta_batched(theta, self.device)
        with torch.set_grad_enabled(track_gradients and torch.is_grad_enabled()):
            lp = self.neural_ode(self.x_o).log_prob(theta)
        if self.prior is not None:
            lp = torch.where(within_support(self.prior, theta), lp, torch.full_like(lp, -math.inf))
        return lp

    def gradient(self, theta, time: Optional[float] = None) -> torch.Tensor:
        """The estimator's score at (about) data time: t_min for score
        estimators, t_max for flow matching, or ``time``."""
        est = self.vector_field_estimator
        theta = ensure_theta_batched(theta, self.device)
        if time is None:
            time = est.t_min if est.SDE_DEFINED else est.t_max
        x = self.x_o
        return est.score(theta, x.expand((theta.shape[0],) + tuple(x.shape[1:])), time)


def vector_field_estimator_based_potential(
    vector_field_estimator, prior, x_o, enable_transform: bool = True, **kwargs
) -> Tuple[VectorFieldBasedPotential, object]:
    """Returns (potential, theta_transform to unconstrained space)."""
    potential_fn = VectorFieldBasedPotential(vector_field_estimator, prior, x_o, **kwargs)
    theta_transform = mcmc_transform(prior, enable_transform=enable_transform)
    return potential_fn, theta_transform
