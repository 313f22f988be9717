"""String -> builder factories, returning ``build_fn(batch_theta, batch_x)``
closures so nets are shaped and z-scored from the first data batch
(PyTorch counterpart of ``sbi_tpu/neural_nets/factory.py``). The port
has ``model="nsf"``, ``"maf"`` and ``"mdn"``, for posteriors and for
likelihoods, the ratio classifiers of ``classifier_nn`` and the
vector-field builders ``posterior_score_nn`` and ``posterior_flow_nn``;
the other models come with later slices.
"""

from __future__ import annotations

from typing import Callable, Optional


def posterior_nn(
    model: str = "maf",
    z_score_theta: Optional[str] = "independent",
    z_score_x: Optional[str] = "independent",
    hidden_features: int = 50,
    num_transforms: int = 5,
    num_bins: int = 10,
    embedding_net=None,
    num_components: int = 10,
    **kwargs,
) -> Callable:
    """Density-estimator builder for NPE.

    Returns ``build_fn(batch_theta, batch_x) -> ConditionalDensityEstimator``.
    ``device`` and ``generator`` pass through ``kwargs`` to the builder.
    """

    def build_fn(batch_theta, batch_x):
        from .net_builders.flow import build_maf, build_nsf
        from .net_builders.mdn import build_mdn

        common = dict(
            z_score_theta=z_score_theta,
            z_score_x=z_score_x,
            hidden_features=hidden_features,
            embedding_net=embedding_net,
            **kwargs,
        )
        if model == "mdn":
            return build_mdn(batch_theta, batch_x, num_components=num_components, **common)
        builders = {"nsf": build_nsf, "maf": build_maf}
        if model not in builders:
            raise NotImplementedError(
                f"posterior_nn(model='{model}') is not ported yet; 'nsf', 'maf' and "
                "'mdn' are. The other models come with later slices."
            )
        return builders[model](
            batch_theta, batch_x, num_transforms=num_transforms, num_bins=num_bins, **common
        )

    return build_fn


def likelihood_nn(
    model: str = "maf",
    z_score_theta: Optional[str] = "independent",
    z_score_x: Optional[str] = "independent",
    hidden_features: int = 50,
    num_transforms: int = 5,
    num_bins: int = 10,
    embedding_net=None,
    num_components: int = 10,
    **kwargs,
) -> Callable:
    """Density-estimator builder for NLE: a density over x conditioned on
    theta, ``posterior_nn`` with (input, condition) swapped.

    Returns ``build_fn(batch_theta, batch_x) -> ConditionalDensityEstimator``.
    """
    inner = posterior_nn(
        model,
        z_score_theta=z_score_x,  # roles swapped: the input is x
        z_score_x=z_score_theta,
        hidden_features=hidden_features,
        num_transforms=num_transforms,
        num_bins=num_bins,
        embedding_net=embedding_net,
        num_components=num_components,
        **kwargs,
    )

    def build_fn(batch_theta, batch_x):
        return inner(batch_x, batch_theta)

    return build_fn


def classifier_nn(
    model: str = "resnet",
    z_score_theta: Optional[str] = "independent",
    z_score_x: Optional[str] = "independent",
    hidden_features: int = 50,
    embedding_net_theta=None,
    embedding_net_x=None,
    **kwargs,
) -> Callable:
    """Ratio-classifier builder for NRE: ``"linear"``, ``"mlp"`` or
    ``"resnet"``. An unknown model raises ``NotImplementedError`` when the
    builder is called, as in the JAX package. ``device`` and ``generator``
    pass through ``kwargs`` to the builder."""

    def build_fn(batch_theta, batch_x):
        from .net_builders.classifier import (
            build_linear_classifier,
            build_mlp_classifier,
            build_resnet_classifier,
        )

        builders = {
            "linear": build_linear_classifier,
            "mlp": build_mlp_classifier,
            "resnet": build_resnet_classifier,
        }
        if model not in builders:
            raise NotImplementedError(f"Unknown classifier model '{model}'.")
        return builders[model](
            batch_theta, batch_x, z_score_theta=z_score_theta, z_score_x=z_score_x,
            hidden_features=hidden_features, embedding_net_theta=embedding_net_theta,
            embedding_net_x=embedding_net_x, **kwargs,
        )

    return build_fn


def posterior_score_nn(
    model: str = "mlp",
    sde_type: str = "ve",
    z_score_theta: Optional[str] = "independent",
    z_score_x: Optional[str] = "independent",
    hidden_features: int = 100,
    embedding_net=None,
    **kwargs,
) -> Callable:
    """Score-estimator builder for NPSE. ``device`` and ``generator`` pass
    through ``kwargs`` to the builder."""

    def build_fn(batch_theta, batch_x):
        from .net_builders.vector_field_nets import build_score_estimator

        return build_score_estimator(
            batch_theta, batch_x, sde_type=sde_type, net=model, z_score_theta=z_score_theta,
            z_score_x=z_score_x, hidden_features=hidden_features, embedding_net=embedding_net,
            **kwargs,
        )

    return build_fn


def posterior_flow_nn(
    model: str = "mlp",
    z_score_theta: Optional[str] = "independent",
    z_score_x: Optional[str] = "independent",
    hidden_features: int = 100,
    embedding_net=None,
    **kwargs,
) -> Callable:
    """Flow-matching builder for FMPE. ``device`` and ``generator`` pass
    through ``kwargs`` to the builder."""

    def build_fn(batch_theta, batch_x):
        from .net_builders.vector_field_nets import build_flow_matching_estimator

        return build_flow_matching_estimator(
            batch_theta, batch_x, net=model, z_score_theta=z_score_theta, z_score_x=z_score_x,
            hidden_features=hidden_features, embedding_net=embedding_net, **kwargs,
        )

    return build_fn
