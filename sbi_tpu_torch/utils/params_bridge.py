"""Load ``sbi_tpu`` flow, MDN, ratio-classifier, vector-field and embedding
parameters into this package's estimators and modules.

The JAX package's parameters arrive as a nested dict of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, est.params)``); this module
imports no JAX. Layer names follow flax:

  - ``layers_{i}/Dense_{j}``: ``RQSCoupling``'s conditioner and
    ``AdditiveCoupling``'s shift net, ``Dense_0`` taking ``[x_id, context]``
    and the last ``Dense`` the zero-init head;
  - ``layers_{i}/{log_scale, shift}``: ``DiagAffine``;
  - ``layers_{i}/made/{MaskedDense_j, Dense_0}``: ``MaskedRQSAutoregressive``
    and ``MaskedAffineAutoregressive`` (``Dense_0`` is the context
    injection);
  - ``layers_{i}/{lower, upper, log_diag, bias}``: ``LULinear``;
  - ``Dense_{j}`` of an ``MDNModule``: the hidden layers ``Dense_0`` to
    ``Dense_{L-1}``, then the logits ``Dense_L``, means ``Dense_{L+1}``,
    diagonal ``Dense_{L+2}`` and off-diagonal ``Dense_{L+3}`` heads
    (``L = num_layers``; no off-diagonal head at D = 1);
  - the ratio classifiers: ``Dense_0`` to ``Dense_{L-1}`` the hidden layers
    of an ``MLPClassifierModule`` and ``Dense_L`` its head; ``Dense_0`` the
    input layer of a ``ResNetClassifierModule``, ``Dense_{2i+1}`` and
    ``Dense_{2i+2}`` block i's two layers, the last ``Dense`` the head;
    ``Dense_0`` a ``LinearClassifierModule``; their embedding nets nested
    as ``embedding_net_theta`` and ``embedding_net_x``;
  - ``VectorFieldMLP``: ``Dense_0`` the input layer, ``Dense_1`` to
    ``Dense_{L-1}`` the residual layers, ``Dense_L`` the output;
  - ``VectorFieldAdaMLP``: ``Dense_0`` the (condition, time) layer,
    ``Dense_1`` the input layer, ``Dense_2`` the output, ``LayerNorm_0``
    the final norm, and ``AdaLNBlock_i/{Dense_0, Dense_1, Dense_2}`` each
    block's modulation and two layers;
  - an embedding net nested as ``embedding_net`` inside the net that holds
    it: ``FCEmbedding``'s ``Dense_j``, ``CNNEmbedding``'s ``Conv_j`` then
    ``Dense_j``.

flax ``Dense`` kernels are (in, out) and torch ``Linear`` weights (out, in),
so kernels are transposed; the ``MaskedDense`` masks are built from the same
degrees and stored transposed by the module itself. flax ``Conv`` kernels are
channels last, (k, in, out) or (kh, kw, in, out), and torch's (out, in, k)
or (out, in, kh, kw).

``sklearn_mlp_to_torch`` stacks fitted sklearn ``MLPClassifier``s (their
``coefs_`` and ``intercepts_``, numpy arrays; sklearn is not imported) into
one ``BatchedMLPClassifier``.

``load_flax_flow`` loads an unconditional ``FlowModule`` (the variational
posterior's q) from the flax parameters of the JAX package's
``FlowModule``.

``load_stacked_flax_params`` loads an ensemble's stacked parameters (each
leaf with a leading member axis, as ``train_ensemble`` holds them in
``_ensemble_stacked_params``) into one estimator per member.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..neural_nets.embedding_nets import CNNEmbedding, FCEmbedding, IdentityEmbedding
from ..neural_nets.estimators.base import ConditionalEstimator, stack_nets
from ..neural_nets.estimators.mdn import MDNModule
from ..neural_nets.estimators.ratio_estimators import (
    LinearClassifierModule,
    MLPClassifierModule,
    ResNetClassifierModule,
)
from ..neural_nets.net_builders.vector_field_nets import VectorFieldAdaMLP, VectorFieldMLP
from ..neural_nets.estimators.flows import (
    AdditiveCoupling,
    DiagAffine,
    FlowModule,
    LULinear,
    MADENet,
    MaskedAffineAutoregressive,
    MaskedRQSAutoregressive,
    Permutation,
    RQSCoupling,
)
from .mlp_classifier import ALPHA, BatchedMLPClassifier
from .transforms import AffineTransform


_CLASSIFIERS = (LinearClassifierModule, MLPClassifierModule, ResNetClassifierModule)


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = torch.as_tensor(np.array(src, dtype=np.float32))
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != expected {tuple(dst.shape)}")
    dst.copy_(src.to(dst.device))


def _load_dense(layer: nn.Linear, p: Mapping, name: str) -> int:
    _copy(layer.weight, np.asarray(p["kernel"]).T, f"{name}/kernel")
    _copy(layer.bias, p["bias"], f"{name}/bias")
    return 2


def _load_conv(conv: nn.Module, p: Mapping, name: str) -> int:
    kernel = np.asarray(p["kernel"])
    _copy(conv.weight, np.moveaxis(kernel, (-1, -2), (0, 1)), f"{name}/kernel")
    _copy(conv.bias, p["bias"], f"{name}/bias")
    return 2


def load_flax_embedding(module: nn.Module, p: Mapping, name: str = "embedding_net") -> int:
    """Copy an embedding net's flax parameters into ``module`` (built with
    the same configuration); returns the number of leaves used."""
    if isinstance(module, IdentityEmbedding):
        return 0
    with torch.no_grad():
        if isinstance(module, FCEmbedding):
            return sum(_load_dense(layer, p[f"Dense_{j}"], f"{name}/Dense_{j}")
                       for j, layer in enumerate(module.layers))
        if isinstance(module, CNNEmbedding):
            n = sum(_load_conv(conv, p[f"Conv_{j}"], f"{name}/Conv_{j}")
                    for j, conv in enumerate(module.convs))
            denses = list(module.linears) + [module.out]
            return n + sum(_load_dense(layer, p[f"Dense_{j}"], f"{name}/Dense_{j}")
                           for j, layer in enumerate(denses))
    raise TypeError(f"{name}: no bridge for {type(module).__name__}")


def _load_vector_field(net: nn.Module, tree: Mapping) -> int:
    if isinstance(net, VectorFieldMLP):
        denses = [net.inp] + list(net.res) + [net.out]
        n = sum(_load_dense(d, tree[f"Dense_{j}"], f"Dense_{j}") for j, d in enumerate(denses))
    else:
        n = sum(_load_dense(d, tree[f"Dense_{j}"], f"Dense_{j}")
                for j, d in enumerate((net.cond, net.inp, net.out)))
        for i, block in enumerate(net.blocks):
            name = f"AdaLNBlock_{i}"
            n += sum(_load_dense(d, tree[name][f"Dense_{j}"], f"{name}/Dense_{j}")
                     for j, d in enumerate((block.mod, block.fc1, block.fc2)))
        _copy(net.norm.weight, tree["LayerNorm_0"]["scale"], "LayerNorm_0/scale")
        _copy(net.norm.bias, tree["LayerNorm_0"]["bias"], "LayerNorm_0/bias")
        n += 2
    if net.embedding_net is not None:
        n += load_flax_embedding(net.embedding_net, tree["embedding_net"])
    return n


def _load_classifier(net: nn.Module, tree: Mapping) -> int:
    if isinstance(net, LinearClassifierModule):
        denses = [net.out]
    elif isinstance(net, MLPClassifierModule):
        denses = list(net.hidden) + [net.out]
    else:
        denses = [net.inp] + [layer for block in net.blocks for layer in block] + [net.out]
    n = sum(_load_dense(d, tree[f"Dense_{j}"], f"Dense_{j}") for j, d in enumerate(denses))
    for name in ("embedding_net_theta", "embedding_net_x"):
        embedding = getattr(net, name, None)
        if embedding is not None:
            n += load_flax_embedding(embedding, tree[name], name)
    return n


def _load_made(made: MADENet, p: Mapping, name: str) -> int:
    n = 0
    for j, layer in enumerate(made.masked):
        n += _load_dense(layer, p[f"MaskedDense_{j}"], f"{name}/MaskedDense_{j}")
    if made.context is not None:
        n += _load_dense(made.context, p["Dense_0"], f"{name}/Dense_0")
    return n


def load_flax_params(
    estimator: ConditionalEstimator,
    params: Mapping,
    input_loc=None,
    input_scale=None,
    condition_loc=None,
    condition_scale=None,
) -> ConditionalEstimator:
    """Copy flax parameters into ``estimator.net`` (built with the same
    configuration) and, where given, set its z-scoring transforms to
    ``AffineTransform(loc, scale)`` (for a ratio estimator, the input is
    theta and the condition x). Every leaf must be used exactly once.
    Returns the estimator."""
    tree = params.get("params", params)
    leaves = sum(_count_leaves(v) for v in tree.values())
    used = 0
    device = estimator.device
    with torch.no_grad():
        if isinstance(estimator.net, MDNModule):
            used = _load_mdn(estimator.net, tree)
        if isinstance(estimator.net, (VectorFieldMLP, VectorFieldAdaMLP)):
            used = _load_vector_field(estimator.net, tree)
        if isinstance(estimator.net, _CLASSIFIERS):
            used = _load_classifier(estimator.net, tree)
        used += _load_flow_layers(estimator.net, tree)
    if used != leaves:
        raise ValueError(f"bridged {used} of {leaves} parameter leaves")
    if input_loc is not None:
        estimator.input_transform = _affine(input_loc, input_scale, device)
    if condition_loc is not None:
        estimator.condition_transform = _affine(condition_loc, condition_scale, device)
    return estimator


def _load_flow_layers(net: nn.Module, tree: Mapping) -> int:
    """Copy ``layers_{i}`` of a flax ``FlowModule`` into ``net.layers``
    (none for a net without layers); returns the number of leaves used."""
    used = 0
    for i, layer in enumerate(getattr(net, "layers", ())):
        name = f"layers_{i}"
        if isinstance(layer, Permutation):
            continue
        p = tree[name]
        if isinstance(layer, (RQSCoupling, AdditiveCoupling)):
            for j, dense in enumerate(layer.dense):
                used += _load_dense(dense, p[f"Dense_{j}"], f"{name}/Dense_{j}")
        elif isinstance(layer, (MaskedRQSAutoregressive, MaskedAffineAutoregressive)):
            used += _load_made(layer.made, p["made"], f"{name}/made")
        elif isinstance(layer, (LULinear, DiagAffine)):
            attrs = ("lower", "upper", "log_diag", "bias") if isinstance(layer, LULinear) \
                else ("log_scale", "shift")
            for attr in attrs:
                _copy(getattr(layer, attr), p[attr], f"{name}/{attr}")
                used += 1
        else:
            raise TypeError(f"{name}: no bridge for {type(layer).__name__}")
    return used


def load_flax_flow(module: FlowModule, params: Mapping) -> FlowModule:
    """Copy a flax ``FlowModule``'s parameters into ``module`` (built with
    the same layer configurations and no embedding net). Every leaf must be
    used exactly once. Returns the module."""
    tree = params.get("params", params)
    leaves = sum(_count_leaves(v) for v in tree.values())
    with torch.no_grad():
        used = _load_flow_layers(module, tree)
    if used != leaves:
        raise ValueError(f"bridged {used} of {leaves} parameter leaves")
    return module


def _load_mdn(net: MDNModule, tree: Mapping) -> int:
    if net.embedding_net is not None:
        raise NotImplementedError("bridging an MDN's embedding net comes with a later slice")
    heads = list(net.hidden) + [net.logits, net.means, net.diag]
    if net.off is not None:
        heads.append(net.off)
    return sum(_load_dense(dense, tree[f"Dense_{j}"], f"Dense_{j}") for j, dense in enumerate(heads))


def load_stacked_flax_params(
    estimators: Sequence[ConditionalEstimator],
    stacked_params: Mapping,
    input_loc=None,
    input_scale=None,
    condition_loc=None,
    condition_scale=None,
) -> Dict[str, torch.Tensor]:
    """Load member i's slice of ``stacked_params`` into ``estimators[i]``
    (``load_flax_params``) and return the port's stacked state,
    ``stack_nets`` of their nets. The members share one z-scoring: the
    first member's transforms, as ``train_ensemble`` shares them."""
    first = estimators[0]
    load_flax_params(first, _member(stacked_params, 0), input_loc, input_scale,
                     condition_loc, condition_scale)
    for i, est in enumerate(estimators[1:], start=1):
        load_flax_params(est, _member(stacked_params, i))
        est.input_transform, est.condition_transform = first.input_transform, first.condition_transform
    return stack_nets([est.net for est in estimators])


def _member(tree, i):
    if isinstance(tree, Mapping):
        return {k: _member(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _affine(loc, scale, device: Optional[torch.device]) -> AffineTransform:
    return AffineTransform(
        torch.as_tensor(np.array(loc, np.float32), device=device),
        torch.as_tensor(np.array(scale, np.float32), device=device),
    )


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def sklearn_mlp_to_torch(clfs, device=None, dtype: torch.dtype = torch.float32) -> BatchedMLPClassifier:
    """One ``BatchedMLPClassifier`` whose member t holds ``clfs[t]``'s
    weights. The classifiers share one architecture and sklearn's default
    ``alpha``, the port's ``mlp_classifier.ALPHA``."""
    coefs = [np.stack([np.asarray(c.coefs_[l]) for c in clfs]) for l in range(len(clfs[0].coefs_))]
    intercepts = [np.stack([np.asarray(c.intercepts_[l]) for c in clfs])
                  for l in range(len(clfs[0].intercepts_))]
    if any(c.alpha != ALPHA for c in clfs):
        raise ValueError(f"sklearn_mlp_to_torch: the port's classifier has alpha {ALPHA}")
    return BatchedMLPClassifier.from_weights(coefs, intercepts, device=device, dtype=dtype)
