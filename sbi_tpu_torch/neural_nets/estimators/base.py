"""Conditional estimator base classes.

PyTorch counterpart of ``sbi_tpu/neural_nets/estimators/base.py:33-149``.
The network is an ``nn.Module`` held by the estimator (``self.net``), so its
parameters live on the module. The optional ``input_transform`` (z-scoring
of theta, with its log-det) and ``condition_transform`` (z-scoring of x) are
applied outside the module. Shapes follow the (sample, batch, *event)
convention.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ...utils.transforms import IdentityTransform, Transform
from .shape_handling import reshape_to_batch_event, reshape_to_sample_batch_event


class _Bound(nn.Module):
    """``fn`` as the forward of a module that holds ``net``, so that
    ``torch.func.functional_call`` swaps ``net``'s parameters in while any
    code that uses ``net`` runs."""

    def __init__(self, net: nn.Module, fn: Callable):
        super().__init__()
        self.net = net
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def functional(net: nn.Module, fn: Callable) -> Callable:
    """``fn(*args)``, which calls ``net``, as a pure function
    ``f(params, *args)`` of ``net``'s parameters (a dict named as
    ``net.named_parameters()`` names them; buffers stay ``net``'s own).

    This is what the JAX package's ``log_prob_fn(params, ...)`` gives: a
    function that ``torch.func.grad`` differentiates and ``torch.func.vmap``
    maps over parameters stacked along a leading member axis
    (``torch.func.stack_module_state``), as ensembles of one architecture
    are trained and evaluated."""
    bound = _Bound(net, fn)

    def f(params: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(bound, {f"net.{k}": v for k, v in params.items()}, args)

    return f


def stackable(nets) -> bool:
    """Whether ``nets`` share one architecture: one class, the same
    parameter names and shapes, and equal buffers (masks, index maps), so
    that the first net run under each one's parameters is that net."""
    nets = list(nets)
    first, rest = nets[0], nets[1:]
    shapes = [(k, v.shape) for k, v in first.named_parameters()]
    buffers = dict(first.named_buffers())
    for net in rest:
        if type(net) is not type(first) or [(k, v.shape) for k, v in net.named_parameters()] != shapes:
            return False
        other = dict(net.named_buffers())
        if other.keys() != buffers.keys() or not all(
                b.shape == other[k].shape and torch.equal(b, other[k]) for k, b in buffers.items()):
            return False
    return True


def stack_nets(nets) -> Dict[str, torch.Tensor]:
    """The parameters of ``nets`` (``stackable``) stacked along a new
    leading member axis, detached, named as ``net.named_parameters()``
    names them."""
    params, _ = torch.func.stack_module_state(list(nets))
    return {k: v.detach() for k, v in params.items()}


class ConditionalEstimator:
    """Base: holds an ``nn.Module`` + shapes + transforms."""

    def __init__(
        self,
        net: nn.Module,
        input_shape: Tuple[int, ...],
        condition_shape: Tuple[int, ...],
        input_transform: Optional[Transform] = None,
        condition_transform: Optional[Transform] = None,
    ) -> None:
        self.net = net
        self.input_shape = tuple(input_shape)
        self.condition_shape = tuple(condition_shape)
        self.input_transform = input_transform or IdentityTransform()
        self.condition_transform = condition_transform or IdentityTransform()

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def _embed_condition(self, condition: torch.Tensor) -> torch.Tensor:
        """Apply the condition z-scoring (the module applies the embedding)."""
        return self.condition_transform.forward(condition)

    def loss(self, input: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def snapshot(self) -> "ConditionalEstimator":
        """Copy with the current parameters pinned: posteriors hold a frozen
        view while a trainer keeps updating its estimator. Torch parameters
        are mutable, so the network is deep-copied."""
        snap = copy.copy(self)
        snap.net = copy.deepcopy(self.net)
        return snap


class ConditionalDensityEstimator(ConditionalEstimator):
    """Adds log_prob / sample.

    Subclasses implement ``_log_prob(input_bt, cond_bt)`` over flat batches
    and ``_sample(num, cond_bt, generator)``, both in z-scored space.
    """

    def _log_prob(self, input: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        """input (B, *event_in) z-scored, condition (B, *event_cond) z-scored."""
        raise NotImplementedError

    def _sample(self, num_samples: int, condition: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Return (num_samples, B, *event_in) in z-scored space."""
        raise NotImplementedError

    def log_prob(self, input, condition) -> torch.Tensor:
        """input (S, B, *ev), condition (B, *cond) -> (S, B)."""
        device = self.device
        input = reshape_to_sample_batch_event(input, self.input_shape, device=device)
        condition = reshape_to_batch_event(condition, self.condition_shape, device=device)
        S, B = input.shape[0], input.shape[1]
        z, ldj = self.input_transform.forward_and_log_det(input)
        zc = self._embed_condition(condition)
        flat = z.reshape((S * B,) + self.input_shape)
        cond_rep = zc[None].expand((S,) + tuple(zc.shape)).reshape((S * B,) + tuple(zc.shape[1:]))
        lp = self._log_prob(flat, cond_rep).reshape(S, B)
        return lp + ldj

    def sample(self, sample_shape, condition, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        condition = reshape_to_batch_event(condition, self.condition_shape, device=self.device)
        B = condition.shape[0]
        num = 1
        for s in sample_shape:
            num *= int(s)
        zc = self._embed_condition(condition)
        z = self._sample(num, zc, generator)  # (num, B, *event)
        theta = self.input_transform.inverse(z)
        return theta.reshape(tuple(sample_shape) + (B,) + self.input_shape)

    def loss(self, input, condition) -> torch.Tensor:
        """-log q(input | condition): input (B, *ev), condition (B, *cond) -> (B,)."""
        input = torch.as_tensor(input, dtype=torch.float32, device=self.device)
        return -self.log_prob(input[None], condition)[0]

    def sample_and_log_prob(self, sample_shape, condition, generator=None):
        samples = self.sample(sample_shape, condition, generator=generator)
        lp = self.log_prob(
            samples.reshape((-1,) + tuple(samples.shape[-len(self.input_shape) - 1:])),
            condition,
        )
        return samples, lp.reshape(tuple(sample_shape) + (-1,))


def as_times(time, n: int, device) -> torch.Tensor:
    """``time`` (a number, a 0-d tensor or a (n,) tensor) as a float32
    (n,) tensor on ``device``; a number needs no host sync."""
    if isinstance(time, torch.Tensor):
        return time.to(device=device, dtype=torch.float32).expand(n)
    return torch.full((n,), float(time), device=device)


class ConditionalVectorFieldEstimator(ConditionalEstimator):
    """Base of the score and flow-matching estimators.

    Subclasses give the net's output (``forward``), the SDE geometry
    (``mean_t_fn``, ``std_fn``, ``drift_fn``, ``diffusion_fn``), the score
    and the probability-flow velocity. The net is ``net(z, condition, t)``;
    it also offers ``net.embed(condition)`` and ``net.field(z, embedded,
    t)``, and the z-space methods take ``embedded=True`` with a condition
    already embedded, so that samplers embed x once and not at every step.
    """

    SCORE_DEFINED: bool = True
    SDE_DEFINED: bool = True
    MARGINALS_DEFINED: bool = True

    t_min: float = 0.0
    t_max: float = 1.0

    def _net(self, z, condition, time, embedded: bool = False) -> torch.Tensor:
        t = as_times(time, z.shape[0], z.device)
        if embedded:
            return self.net.field(z, condition, t)
        return self.net(z, condition, t)

    def embed_condition(self, condition: torch.Tensor) -> torch.Tensor:
        """The z-scored condition through the net's embedding, flattened."""
        return self.net.embed(condition)

    def forward(self, input, condition, time) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, input, condition, time):
        return self.forward(input, condition, time)

    # --- SDE geometry --------------------------------------------------------
    def mean_t_fn(self, times: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def std_fn(self, times: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def drift_fn(self, input: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def diffusion_fn(self, input: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def score(self, input, condition, time) -> torch.Tensor:
        raise NotImplementedError

    def ode_fn(self, input, condition, time) -> torch.Tensor:
        """Probability-flow ODE velocity d input / d t."""
        raise NotImplementedError

    def std_at(self, time: float) -> float:
        """``std_fn`` at one time, as a Python float (computed in float32
        on the CPU: no host sync)."""
        return float(self.std_fn(torch.tensor([float(time)]))[0])

    def solve_schedule(self, num_steps: int) -> torch.Tensor:
        """Time grid from t_max down to t_min, a float32 CPU tensor (the
        samplers read it on the host)."""
        return torch.linspace(self.t_max, self.t_min, num_steps)
