"""Neural spline flows as PyTorch modules.

PyTorch counterpart of the NSF and MAF pieces of
``sbi_tpu/neural_nets/estimators/flows.py``: the RQ spline (re-exported from
``ops/rqs.py``, the CUDA kernels on the card), MADE masks, ``MaskedDense``,
``MADENet``, ``MaskedAffineAutoregressive``, ``MaskedRQSAutoregressive``,
``RQSCoupling``, ``AdditiveCoupling`` (NICE), ``LULinear``, ``DiagAffine``,
``Permutation``, ``FlowModule`` and ``FlowEstimator``. The monotone flows,
the circular spline and MADE-MoG come with later slices.

Conventions (as in the JAX package):
  - ``forward`` maps data -> noise (one pass for all layers), ``inverse``
    maps noise -> data (one pass for couplings, D sequential passes for
    autoregressive layers). Both return (output, log-det of shape (batch,)).
  - log_prob(x|ctx) = N(forward(x); 0, I) + sum ldj.
  - Layers take the context already embedded.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The spline: the kernel's wrapper (CUDA kernel on the card, plain version on
# the CPU) and the plain version itself.
from ...ops.rqs import _clip, rational_quadratic_spline, rational_quadratic_spline_plain  # noqa: F401
from ...utils.sbiutils import next_generator
from .base import ConditionalDensityEstimator

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# Flax's lecun_normal: truncated normal at +-2 std, rescaled to unit variance.
_TRUNC_NORMAL_STD = 0.87962566103423978


# ===========================================================================
# MADE masks
# ===========================================================================


def _made_degrees(d: int, hidden: Sequence[int]) -> list:
    """Autoregressive degree assignment. Hidden degrees range over [0, d-1]:
    degree-0 hidden units receive NO theta inputs but DO receive the (unmasked)
    context injection, giving the first output dim (degree 1, which may only
    read hidden degrees < 1) a pure-context channel. Without degree-0 units,
    dim 1's parameters are context-independent."""
    degrees = [np.arange(1, d + 1)]
    for h in hidden:
        degrees.append(np.arange(h) % d)  # 0 .. d-1
    return degrees


def _made_masks(d: int, hidden: Sequence[int], out_mult: int):
    """Masks for MADE, each (in, out): hidden masks (prev<=next), output
    mask (hidden<out)."""
    degrees = _made_degrees(d, hidden)
    masks = []
    for ins, outs in zip(degrees[:-1], degrees[1:]):
        masks.append((outs[None, :] >= ins[:, None]).astype(np.float32))
    out_deg = np.repeat(np.arange(1, d + 1), out_mult)
    masks.append((out_deg[None, :] > degrees[-1][:, None]).astype(np.float32))
    return masks


def _dense(in_features: int, out_features: int, zero_init: bool = False) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    layer.zero_init = zero_init
    return layer


def init_flax_like_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every linear and convolution layer as flax's ``Dense``
    and ``Conv`` do: lecun-normal kernel over the fan-in (or zeros where
    ``zero_init``), zero bias."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                if getattr(m, "zero_init", False):
                    m.weight.zero_()
                else:
                    fan_in = m.weight[0].numel()
                    std = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                m.bias.zero_()
    return module


class MaskedDense(nn.Linear):
    """Linear layer whose weight is multiplied by a fixed 0/1 mask.
    ``mask`` is given as flax's (in, out) and stored as torch's (out, in)."""

    def __init__(self, in_features: int, out_features: int, mask: Any, zero_init: bool = False):
        super().__init__(in_features, out_features)
        self.zero_init = zero_init
        self.register_buffer("mask", torch.as_tensor(np.asarray(mask, np.float32).T.copy()))

    def forward(self, x):
        return F.linear(x, self.weight * self.mask, self.bias)


class MADENet(nn.Module):
    """Masked MLP: (x, context) -> (batch, D, out_mult) autoregressive in x."""

    def __init__(self, dim: int, out_mult: int, hidden_features: int = 50,
                 num_hidden_layers: int = 2, context_features: Optional[int] = None,
                 zero_init_output: bool = True):
        super().__init__()
        self.dim, self.out_mult = dim, out_mult
        hidden = [hidden_features] * num_hidden_layers
        masks = _made_masks(dim, hidden, out_mult)
        layers = [MaskedDense(dim, hidden_features, masks[0])]
        layers += [MaskedDense(hidden_features, hidden_features, m) for m in masks[1:-1]]
        layers.append(MaskedDense(hidden_features, dim * out_mult, masks[-1],
                                  zero_init=zero_init_output))
        self.masked = nn.ModuleList(layers)
        self.context = _dense(context_features, hidden_features) if context_features else None

    def forward(self, x, context=None):
        h = self.masked[0](x)
        if context is not None:
            h = h + self.context(context)
        h = F.relu(h)
        for layer in self.masked[1:-1]:
            h = F.relu(layer(h))
        out = self.masked[-1](h)
        # Output degrees repeat each dim out_mult times.
        return out.reshape(out.shape[0], self.dim, self.out_mult)


# ===========================================================================
# Bijection layers. forward(x, ctx) -> (y, ldj); inverse likewise.
# ===========================================================================


class MaskedAffineAutoregressive(nn.Module):
    """One MAF layer: z = (x - mu(x_<i)) * exp(-log_scale(x_<i)), the log
    scale clipped to ``log_scale_bounds`` (ties split as ``jnp.clip``)."""

    def __init__(self, dim: int, hidden_features: int = 50, num_blocks: int = 2,
                 context_features: Optional[int] = None,
                 log_scale_bounds: Tuple[float, float] = (-5.0, 3.0)):
        super().__init__()
        self.dim = dim
        self.log_scale_bounds = tuple(float(b) for b in log_scale_bounds)
        self.made = MADENet(dim=dim, out_mult=2, hidden_features=hidden_features,
                            num_hidden_layers=num_blocks, context_features=context_features)

    def _params(self, x, context):
        out = self.made(x, context)
        return out[..., 0], _clip(out[..., 1], *self.log_scale_bounds)

    def forward(self, x, context=None):
        mu, log_scale = self._params(x, context)
        return (x - mu) * torch.exp(-log_scale), -log_scale.sum(-1)

    def inverse(self, z, context=None):
        # Sequential over dims: dim i only depends on x_<i, so after D - 1
        # passes every dim's parameters are final and the last pass's
        # log-scale is the log-det's (the JAX package runs one more pass).
        x = torch.zeros_like(z)
        for _ in range(self.dim):
            mu, log_scale = self._params(x, context)
            x = mu + z * torch.exp(log_scale)
        return x, log_scale.sum(-1)


class MaskedRQSAutoregressive(nn.Module):
    """Autoregressive RQ-spline layer (non-circular)."""

    def __init__(self, dim: int, hidden_features: int = 50, num_blocks: int = 2,
                 num_bins: int = 10, tail_bound: float = 3.0,
                 context_features: Optional[int] = None, circular: bool = False):
        super().__init__()
        if circular:
            raise NotImplementedError(
                "The circular spline (NCSF) is not ported yet; it comes with a later slice."
            )
        self.dim, self.num_bins, self.tail_bound = dim, num_bins, tail_bound
        self.made = MADENet(dim=dim, out_mult=3 * num_bins - 1,
                            hidden_features=hidden_features,
                            num_hidden_layers=num_blocks,
                            context_features=context_features)

    def _spline(self, v, x_params, context, inverse):
        out = self.made(x_params, context)
        K = self.num_bins
        return rational_quadratic_spline(
            v, out[..., :K], out[..., K:2 * K], out[..., 2 * K:],
            inverse=inverse, tail_bound=self.tail_bound,
        )

    def forward(self, x, context=None):
        y, ldj = self._spline(x, x, context, inverse=False)
        return y, ldj.sum(-1)

    def inverse(self, z, context=None):
        # D sequential passes; the log-det is the last pass's.
        x = torch.zeros_like(z)
        for _ in range(self.dim):
            x, ldj = self._spline(z, x, context, inverse=True)
        return x, ldj.sum(-1)


class RQSCoupling(nn.Module):
    """RQ-spline coupling layer (nflows NSF recipe). The identity half
    conditions a residual MLP that outputs spline params for the transform
    half. Both directions are a single pass."""

    def __init__(self, dim: int, mask: Any, hidden_features: int = 50,
                 num_blocks: int = 2, num_bins: int = 10, tail_bound: float = 3.0,
                 context_features: Optional[int] = None):
        super().__init__()
        mask = np.asarray(mask, dtype=bool)  # True = identity half
        id_idx, tr_idx = np.where(mask)[0], np.where(~mask)[0]
        self.num_bins, self.tail_bound = num_bins, tail_bound
        self.num_blocks, self.n_trans = num_blocks, len(tr_idx)
        self.register_buffer("id_idx", torch.as_tensor(id_idx, dtype=torch.long))
        self.register_buffer("tr_idx", torch.as_tensor(tr_idx, dtype=torch.long))
        order = np.argsort(np.concatenate([id_idx, tr_idx]))
        self.register_buffer("merge_idx", torch.as_tensor(order, dtype=torch.long))
        # Creation order = flax's Dense_0 .. Dense_{2*num_blocks+1}.
        layers = [_dense(len(id_idx) + (context_features or 0), hidden_features)]
        layers += [_dense(hidden_features, hidden_features) for _ in range(2 * num_blocks)]
        layers.append(_dense(hidden_features, self.n_trans * (3 * num_bins - 1), zero_init=True))
        self.dense = nn.ModuleList(layers)

    def _conditioner(self, x_id, context):
        h = x_id if context is None else torch.cat([x_id, context], dim=-1)
        h = self.dense[0](h)
        for b in range(self.num_blocks):
            r = self.dense[1 + 2 * b](F.relu(h))
            r = self.dense[2 + 2 * b](F.relu(r))
            h = h + r
        out = self.dense[-1](F.relu(h))
        return out.reshape(-1, self.n_trans, 3 * self.num_bins - 1)

    def _transform(self, v, context, inverse):
        x_id = v[:, self.id_idx]
        x_tr = v[:, self.tr_idx]
        p = self._conditioner(x_id, context)
        K = self.num_bins
        y_tr, ldj = rational_quadratic_spline(
            x_tr, p[..., :K], p[..., K:2 * K], p[..., 2 * K:],
            inverse=inverse, tail_bound=self.tail_bound,
        )
        out = torch.cat([x_id, y_tr], dim=1)[:, self.merge_idx]
        return out, ldj.sum(-1)

    def forward(self, x, context=None):
        return self._transform(x, context, inverse=False)

    def inverse(self, z, context=None):
        return self._transform(z, context, inverse=True)


class AdditiveCoupling(nn.Module):
    """NICE additive coupling: the identity half (and the context) feeds
    ``num_blocks`` ReLU layers and a zero-initialised head, whose output
    shifts the other half. Volume-preserving: the log-det is 0."""

    def __init__(self, dim: int, mask: Any, hidden_features: int = 50, num_blocks: int = 2,
                 context_features: Optional[int] = None):
        super().__init__()
        mask = np.asarray(mask, dtype=bool)  # True = identity half
        id_idx, tr_idx = np.where(mask)[0], np.where(~mask)[0]
        self.register_buffer("id_idx", torch.as_tensor(id_idx, dtype=torch.long))
        self.register_buffer("tr_idx", torch.as_tensor(tr_idx, dtype=torch.long))
        order = np.argsort(np.concatenate([id_idx, tr_idx]))
        self.register_buffer("merge_idx", torch.as_tensor(order, dtype=torch.long))
        # Creation order = flax's Dense_0 .. Dense_{num_blocks}.
        widths = [len(id_idx) + (context_features or 0)] + [hidden_features] * num_blocks
        layers = [_dense(a, b) for a, b in zip(widths[:-1], widths[1:])]
        layers.append(_dense(widths[-1], len(tr_idx), zero_init=True))
        self.dense = nn.ModuleList(layers)

    def _transform(self, v, context, sign):
        x_id = v[:, self.id_idx]
        h = x_id if context is None else torch.cat([x_id, context], dim=-1)
        for layer in self.dense[:-1]:
            h = F.relu(layer(h))
        y_tr = v[:, self.tr_idx] + sign * self.dense[-1](h)
        return torch.cat([x_id, y_tr], dim=1)[:, self.merge_idx], v.new_zeros(v.shape[0])

    def forward(self, x, context=None):
        return self._transform(x, context, 1.0)

    def inverse(self, z, context=None):
        return self._transform(z, context, -1.0)


class LULinear(nn.Module):
    """Invertible linear layer W = L U (unit-lower L, upper U), + bias."""

    def __init__(self, dim: int):
        super().__init__()
        D = dim
        self.dim = D
        self.lower = nn.Parameter(torch.zeros(D * (D - 1) // 2))
        self.upper = nn.Parameter(torch.zeros(D * (D - 1) // 2))
        # Unconstrained diag -> positive via exp.
        self.log_diag = nn.Parameter(torch.zeros(D))
        self.bias = nn.Parameter(torch.zeros(D))
        # Same entry order as jnp.tril_indices / jnp.triu_indices.
        self.register_buffer("tril_idx", torch.tril_indices(D, D, -1))
        self.register_buffer("triu_idx", torch.triu_indices(D, D, 1))

    def _get_lu(self):
        D = self.dim
        eye = torch.eye(D, device=self.log_diag.device)
        L = eye.index_put((self.tril_idx[0], self.tril_idx[1]), self.lower)
        U = torch.zeros_like(eye).index_put((self.triu_idx[0], self.triu_idx[1]), self.upper)
        U = U + torch.diag(torch.exp(self.log_diag))
        return L, U

    def forward(self, x, context=None):
        L, U = self._get_lu()
        y = (x @ U.T) @ L.T + self.bias
        return y, self.log_diag.sum().expand(x.shape[0])

    def inverse(self, y, context=None):
        L, U = self._get_lu()
        z = y - self.bias
        z = torch.linalg.solve_triangular(L, z.T, upper=False).T
        x = torch.linalg.solve_triangular(U, z.T, upper=True).T
        return x, (-self.log_diag.sum()).expand(y.shape[0])


class DiagAffine(nn.Module):
    """Elementwise affine bijection x -> exp(log_scale) * x + shift, both
    zero-initialised: a mean-field Gaussian on a standard-normal base (VI's
    ``q="gaussian_diag"``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(dim))
        self.shift = nn.Parameter(torch.zeros(dim))

    def forward(self, x, context=None):
        return x * torch.exp(self.log_scale) + self.shift, self.log_scale.sum().expand(x.shape[0])

    def inverse(self, y, context=None):
        x = (y - self.shift) * torch.exp(-self.log_scale)
        return x, (-self.log_scale.sum()).expand(y.shape[0])


class Permutation(nn.Module):
    """Fixed permutation of dims."""

    def __init__(self, perm: Any):
        super().__init__()
        perm = np.asarray(perm)
        self.register_buffer("perm", torch.as_tensor(perm, dtype=torch.long))
        self.register_buffer("inv_perm", torch.as_tensor(np.argsort(perm), dtype=torch.long))

    def forward(self, x, context=None):
        return x[:, self.perm], x.new_zeros(x.shape[0])

    def inverse(self, z, context=None):
        return z[:, self.inv_perm], z.new_zeros(z.shape[0])


# ===========================================================================
# Flow module: stack of bijections + standard-normal base
# ===========================================================================

_LATER_SLICE_LAYERS = ("monotone_ar",)


class FlowModule(nn.Module):
    """Stack of bijections over a standard normal base, with an optional
    context embedding. Layers are given as (kind, kwargs) tuples, as in the
    JAX package; ``context_features`` is the embedded context's width."""

    def __init__(self, dim: int, layer_configs: Sequence[Tuple[str, Any]],
                 embedding_net: Optional[nn.Module] = None,
                 context_features: Optional[int] = None):
        super().__init__()
        self.dim = dim
        self.embedding_net = embedding_net
        layers = []
        for kind, kw in layer_configs:
            kw = dict(kw)
            if kind == "maf":
                layers.append(MaskedAffineAutoregressive(dim=dim, context_features=context_features, **kw))
            elif kind == "rqs_ar":
                layers.append(MaskedRQSAutoregressive(dim=dim, context_features=context_features, **kw))
            elif kind == "rqs_coupling":
                layers.append(RQSCoupling(dim=dim, context_features=context_features, **kw))
            elif kind == "additive_coupling":
                layers.append(AdditiveCoupling(dim=dim, context_features=context_features, **kw))
            elif kind == "lu_linear":
                layers.append(LULinear(dim=dim, **kw))
            elif kind == "diag_affine":
                layers.append(DiagAffine(dim=dim, **kw))
            elif kind == "permutation":
                layers.append(Permutation(**kw))
            elif kind in _LATER_SLICE_LAYERS:
                raise NotImplementedError(
                    f"Flow layer '{kind}' is not ported yet; it comes with a later slice."
                )
            else:
                raise ValueError(f"Unknown layer kind {kind}")
        self.layers = nn.ModuleList(layers)

    def _embed(self, context):
        if context is None:
            return None
        if self.embedding_net is not None:
            return self.embedding_net(context)
        return context.reshape(context.shape[0], -1)

    def transform_to_noise(self, x, context=None):
        """Data -> noise through every layer; ``context`` is embedded here.
        Returns (z, summed forward log-det)."""
        ctx = self._embed(context)
        total = x.new_zeros(x.shape[0])
        h = x
        for layer in self.layers:
            h, ldj = layer(h, ctx)
            total = total + ldj
        return h, total

    def log_prob(self, x, context=None):
        h, total = self.transform_to_noise(x, context)
        base_lp = (-0.5 * h**2 - _LOG_SQRT_2PI).sum(-1)
        return base_lp + total

    def forward(self, x, context=None):
        return self.log_prob(x, context)

    def inverse(self, z, context=None):
        """Noise -> data through the layers in reverse. ``context`` is
        already embedded, one row per row of ``z``. Returns (x, summed
        inverse log-det)."""
        h = z
        total = z.new_zeros(z.shape[0])
        for layer in reversed(self.layers):
            h, ldj = layer.inverse(h, context)
            total = total + ldj
        return h, total

    def _noise(self, num_samples, context, generator):
        ctx = self._embed(context)
        B = 1 if ctx is None else ctx.shape[0]
        device = next(self.parameters()).device
        z = torch.randn((num_samples * B, self.dim),
                        generator=next_generator(generator, device), device=device)
        # Sample-major tiling, as jnp.tile(ctx, (num_samples, 1)).
        ctx_rep = None if ctx is None else ctx.repeat(num_samples, 1)
        return z, ctx_rep, B

    def sample(self, num_samples, context=None, generator=None):
        z, ctx_rep, B = self._noise(num_samples, context, generator)
        h, _ = self.inverse(z, ctx_rep)
        return h.reshape(num_samples, B, self.dim)

    def inverse_and_log_prob(self, z, context=None):
        """Noise z (N, D) -> (samples (N, D), their log-prob (N,)) in one
        pass; ``context`` is already embedded, one row per row of ``z``."""
        h, total = self.inverse(z, context)
        return h, (-0.5 * z**2 - _LOG_SQRT_2PI).sum(-1) - total

    def sample_and_log_prob(self, num_samples, context=None, generator=None):
        z, ctx_rep, B = self._noise(num_samples, context, generator)
        h, lp = self.inverse_and_log_prob(z, ctx_rep)
        return h.reshape(num_samples, B, self.dim), lp.reshape(num_samples, B)


# ===========================================================================
# Estimator wrapper
# ===========================================================================


class FlowEstimator(ConditionalDensityEstimator):
    """ConditionalDensityEstimator over a FlowModule."""

    def _log_prob(self, input, condition):
        return self.net.log_prob(input, condition)

    def _sample(self, num_samples, condition, generator):
        return self.net.sample(num_samples, condition, generator)

    def transform_to_noise(self, input, condition) -> torch.Tensor:
        """theta (B, D) -> the flow's base-space noise (B, D), one condition
        row per row: the input z-scoring, then every layer forward. This is
        the map ``LC2ST_NF``'s ``flow_inverse_transform`` wants."""
        from .shape_handling import reshape_to_batch_event

        input = reshape_to_batch_event(input, self.input_shape, device=self.device)
        condition = reshape_to_batch_event(condition, self.condition_shape, device=self.device)
        z, _ = self.input_transform.forward_and_log_det(input)
        return self.net.transform_to_noise(z, self._embed_condition(condition))[0]

    def sample_and_log_prob_fn(self, num_samples: int, condition, generator=None):
        """Single-pass sample + log_prob in raw space: (num, B, D), (num, B)."""
        from .shape_handling import reshape_to_batch_event

        condition = reshape_to_batch_event(condition, self.condition_shape, device=self.device)
        zc = self._embed_condition(condition)
        z, lp = self.net.sample_and_log_prob(num_samples, zc, generator)
        theta = self.input_transform.inverse(z)
        _, ldj = self.input_transform.forward_and_log_det(theta)
        return theta, lp + ldj
