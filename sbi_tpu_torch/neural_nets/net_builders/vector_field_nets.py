"""Vector-field networks and builders for score and flow-matching estimators.

PyTorch counterpart of ``sbi_tpu/neural_nets/net_builders/vector_field_nets.py``:
``SinusoidalTimeEmbedding``, ``VectorFieldMLP``, ``AdaLNBlock``,
``VectorFieldAdaMLP``, ``build_score_estimator`` and
``build_flow_matching_estimator``. The DiT-style ``VectorFieldTransformer``
comes with a later slice.

Flax's defaults are kept: ``gelu`` is the tanh approximation, ``LayerNorm``'s
epsilon is 1e-6, and the AdaLN modulation and the AdaMLP's output layer
start at zero. Each net is ``net(z, condition, t)`` and also offers
``embed(condition)`` (the embedding net, flattened) and ``field(z,
embedded, t)``, so that samplers embed the observation once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.sbiutils import (
    assert_transform_to_unconstrained_supported,
    next_generator,
    resolve_device,
    standardizing_transform,
)
from ..estimators.flowmatching_estimator import FlowMatchingEstimator
from ..estimators.flows import init_flax_like_
from ..estimators.score_estimator import SubVPScoreEstimator, VEScoreEstimator, VPScoreEstimator

_LATER_SLICE = "comes with a later slice of the port"
_LN_EPS = 1e-6  # flax's LayerNorm


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _zero_init(layer: nn.Linear) -> nn.Linear:
    layer.zero_init = True
    return layer


class SinusoidalTimeEmbedding(nn.Module):
    """[sin(t f), cos(t f)] over ``dim // 2`` frequencies f, the exp of a
    linspace from 0 to log(max_freq), computed in float64 and rounded to
    float32 (the JAX package's float32 linspace and exp read a few ulps
    off these)."""

    def __init__(self, dim: int = 32, max_freq: float = 1000.0):
        super().__init__()
        lin = torch.linspace(0.0, math.log(max_freq), dim // 2, dtype=torch.float64)
        self.register_buffer("freqs", torch.exp(lin).float(), persistent=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:  # t: (B,)
        angles = t[:, None] * self.freqs[None, :]
        return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class _VectorFieldNet(nn.Module):
    """Shared embedding of the condition: the embedding net (if any), then
    a flatten."""

    def __init__(self, time_emb_dim: int, embedding_net: Optional[nn.Module]):
        super().__init__()
        self.time_embedding = SinusoidalTimeEmbedding(time_emb_dim)
        self.embedding_net = embedding_net

    def embed(self, condition: torch.Tensor) -> torch.Tensor:
        c = condition if self.embedding_net is None else self.embedding_net(condition)
        return c.reshape(c.shape[0], -1)

    def field(self, z, c, t) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, z, condition, t) -> torch.Tensor:
        return self.field(z, self.embed(condition), t)


class VectorFieldMLP(_VectorFieldNet):
    """Residual MLP over [z_t, condition embedding, time embedding]."""

    def __init__(self, dim: int, cond_features: int, hidden_features: int = 100,
                 num_layers: int = 4, time_emb_dim: int = 32,
                 embedding_net: Optional[nn.Module] = None):
        super().__init__(time_emb_dim, embedding_net)
        in_features = dim + cond_features + 2 * (time_emb_dim // 2)
        self.inp = nn.Linear(in_features, hidden_features)
        self.res = nn.ModuleList(nn.Linear(hidden_features, hidden_features)
                                 for _ in range(num_layers - 1))
        self.out = nn.Linear(hidden_features, dim)

    def field(self, z, c, t) -> torch.Tensor:
        h = self.inp(torch.cat([z, c.expand(z.shape[0], -1), self.time_embedding(t)], dim=-1))
        for layer in self.res:
            h = h + layer(gelu(h))
        return self.out(gelu(h))


class AdaLNBlock(nn.Module):
    """AdaLN-Zero conditioning (DiT-style): a parameter-free LayerNorm,
    modulated by shift and scale from the condition, two gelu Linears, and
    a gated residual."""

    def __init__(self, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.mod = _zero_init(nn.Linear(hidden, 3 * hidden))
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, hidden)

    def forward(self, h: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.mod(cond).chunk(3, dim=-1)
        x = F.layer_norm(h, (self.hidden,), eps=_LN_EPS)
        x = x * (1 + scale) + shift
        x = self.fc2(gelu(self.fc1(gelu(x))))
        return h + gate * x


class VectorFieldAdaMLP(_VectorFieldNet):
    """MLP with AdaLN-Zero conditioning on (condition, t)."""

    def __init__(self, dim: int, cond_features: int, hidden_features: int = 100,
                 num_layers: int = 4, time_emb_dim: int = 32,
                 embedding_net: Optional[nn.Module] = None):
        super().__init__(time_emb_dim, embedding_net)
        self.cond = nn.Linear(cond_features + 2 * (time_emb_dim // 2), hidden_features)
        self.inp = nn.Linear(dim, hidden_features)
        self.blocks = nn.ModuleList(AdaLNBlock(hidden_features) for _ in range(num_layers))
        self.norm = nn.LayerNorm(hidden_features, eps=_LN_EPS)
        self.out = _zero_init(nn.Linear(hidden_features, dim))

    def field(self, z, c, t) -> torch.Tensor:
        cond = gelu(self.cond(torch.cat([c.expand(z.shape[0], -1), self.time_embedding(t)], dim=-1)))
        h = self.inp(z)
        for block in self.blocks:
            h = block(h, cond)
        return self.out(self.norm(h))


_NETS = {"mlp": VectorFieldMLP, "ada_mlp": VectorFieldAdaMLP}


def _transforms(batch, z_score):
    assert_transform_to_unconstrained_supported(
        z_score, "vector-field builders", "Use 'independent' or 'structured'."
    )
    if z_score in (None, "none", False):
        return None
    return standardizing_transform(batch, structured=(z_score == "structured"))


def _build(batch_theta, batch_x, net, z_score_theta, z_score_x, hidden_features,
           embedding_net, generator, device):
    """(net on ``device``, input transform, condition transform, dim). The
    net is built and initialised on the CPU from ``generator`` (a CPU
    generator; None takes the global one), so a seed gives the same
    weights on every device; the embedding net's lazy layers take their
    widths from the first two z-scored rows of ``batch_x``."""
    device = resolve_device(device)
    batch_theta = torch.as_tensor(batch_theta, dtype=torch.float32, device=device)
    batch_x = torch.as_tensor(batch_x, dtype=torch.float32, device=device)
    dim = batch_theta.shape[-1]
    cond_t = _transforms(batch_x, z_score_x)
    zc0 = (cond_t.forward(batch_x[:2]) if cond_t else batch_x[:2]).cpu()
    if isinstance(net, str):
        if net == "transformer":
            raise NotImplementedError(f"net='transformer' (VectorFieldTransformer) {_LATER_SLICE}.")
        if net not in _NETS:
            raise ValueError(f"Unknown vector-field net '{net}'; use one of {sorted(_NETS)}.")
        if embedding_net is not None:
            embedding_net = embedding_net.cpu()
            with torch.no_grad():
                cond_features = int(embedding_net(zc0).reshape(2, -1).shape[1])
        else:
            cond_features = int(zc0.reshape(2, -1).shape[1])
        module = _NETS[net](dim=dim, cond_features=cond_features,
                            hidden_features=hidden_features, embedding_net=embedding_net)
        init_flax_like_(module, next_generator(generator, "cpu"))
    else:
        module = net  # a user net: net(z, condition, t), with embed and field
    return module.to(device), _transforms(batch_theta, z_score_theta), cond_t, dim


def build_score_estimator(
    batch_theta,
    batch_x,
    sde_type: str = "ve",
    net="mlp",
    z_score_theta="independent",
    z_score_x="independent",
    hidden_features: int = 100,
    embedding_net=None,
    generator: Optional[torch.Generator] = None,
    device=None,
    **kwargs,
):
    """A score estimator (``sde_type`` "vp", "subvp" or "ve", the default
    as NPSE's) over a ``net`` of "mlp" or "ada_mlp", on ``device`` (None
    means cuda)."""
    classes = {"vp": VPScoreEstimator, "subvp": SubVPScoreEstimator, "ve": VEScoreEstimator}
    if sde_type not in classes:
        raise ValueError(f"Unknown sde_type '{sde_type}'; use one of {sorted(classes)}.")
    module, input_t, cond_t, dim = _build(batch_theta, batch_x, net, z_score_theta, z_score_x,
                                          hidden_features, embedding_net, generator, device)
    return classes[sde_type](
        net=module,
        input_shape=(dim,),
        condition_shape=tuple(torch.as_tensor(batch_x).shape[1:]),
        input_transform=input_t,
        condition_transform=cond_t,
    )


def build_flow_matching_estimator(
    batch_theta,
    batch_x,
    net="mlp",
    z_score_theta="independent",
    z_score_x="independent",
    hidden_features: int = 100,
    embedding_net=None,
    gaussian_baseline: bool = False,
    generator: Optional[torch.Generator] = None,
    device=None,
    **kwargs,
):
    """A flow-matching estimator over a ``net`` of "mlp" or "ada_mlp", on
    ``device`` (None means cuda)."""
    module, input_t, cond_t, dim = _build(batch_theta, batch_x, net, z_score_theta, z_score_x,
                                          hidden_features, embedding_net, generator, device)
    return FlowMatchingEstimator(
        net=module,
        input_shape=(dim,),
        condition_shape=tuple(torch.as_tensor(batch_x).shape[1:]),
        input_transform=input_t,
        condition_transform=cond_t,
        gaussian_baseline=gaussian_baseline,
    )


# The name the JAX package also exports
build_score_matching_estimator = build_score_estimator
