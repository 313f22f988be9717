"""Typed per-sampler posterior configuration dataclasses.

PyTorch counterpart of ``sbi_tpu/inference/posteriors/posterior_parameters.py``:
validated configurations that ``build_posterior(posterior_parameters=...)``
takes. ``build_posterior_from_parameters`` builds a ``DirectPosterior`` or a
``FilteredDirectPosterior`` (NPE), a ``VectorFieldPosterior`` (FMPE, NPSE),
or an ``MCMCPosterior``, a ``RejectionPosterior``, an
``ImportanceSamplingPosterior`` or a ``VIPosterior`` over the potential of
an NPE, NLE or NRE estimator.
"""

from __future__ import annotations

import warnings
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional, Tuple

_LATER_SLICE = "comes with a later slice of the port"


def check_legacy_sampler_args(
    explicit: Dict[str, Optional[Dict]], methods: Dict[str, Tuple[Any, Any]]
) -> None:
    """Refuse typed ``posterior_parameters`` beside legacy sampler kwargs:
    explicit parameter dicts raise; method names that differ from their
    default only warn (they are ignored)."""
    passed = [k for k, v in explicit.items() if v is not None]
    if passed:
        raise ValueError(
            f"Cannot combine `posterior_parameters` with legacy sampler kwargs "
            f"{passed}. Move these settings into the typed parameters dataclass."
        )
    changed = [k for k, (v, default) in methods.items() if v is not None and v != default]
    if changed:
        warnings.warn(
            f"`posterior_parameters` takes precedence; legacy kwargs {changed} "
            "are ignored.",
            stacklevel=3,
        )


@dataclass
class DirectPosteriorParameters:
    max_sampling_batch_size: int = 10_000
    enable_transform: bool = True

    def __post_init__(self):
        if self.max_sampling_batch_size <= 0:
            raise ValueError("max_sampling_batch_size must be positive.")


@dataclass
class FilteredDirectPosteriorParameters(DirectPosteriorParameters):
    filter_quantile: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        if not (0.0 <= self.filter_quantile < 1.0):
            raise ValueError("filter_quantile must be in [0, 1).")


@dataclass
class MCMCPosteriorParameters:
    method: str = "slice_jax_vectorized"
    thin: int = -1
    warmup_steps: int = 200
    num_chains: int = 20
    init_strategy: str = "resample"
    init_strategy_parameters: Dict = field(default_factory=dict)
    num_workers: int = 1

    def __post_init__(self):
        if self.warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0.")
        if self.num_chains <= 0:
            raise ValueError("num_chains must be positive.")
        if self.thin == 0 or self.thin < -1:
            raise ValueError("thin must be -1 (auto) or positive.")


@dataclass
class RejectionPosteriorParameters:
    max_sampling_batch_size: int = 10_000
    num_samples_to_find_max: int = 10_000
    num_iter_to_find_max: int = 100
    m: float = 1.2

    def __post_init__(self):
        if self.m < 1.0:
            raise ValueError("m must be >= 1.")


@dataclass
class ImportanceSamplingPosteriorParameters:
    method: str = "sir"
    oversampling_factor: int = 32
    max_sampling_batch_size: int = 10_000

    def __post_init__(self):
        if self.method not in ("sir", "importance"):
            raise ValueError("method must be 'sir' or 'importance'.")
        if self.oversampling_factor <= 0:
            raise ValueError("oversampling_factor must be positive.")


@dataclass
class VIPosteriorParameters:
    q: str = "maf"
    vi_method: str = "rKL"

    def __post_init__(self):
        from ...samplers.vi.vi_divergence_optimizers import get_VI_method

        get_VI_method(self.vi_method)  # raises for unknown methods


@dataclass
class VectorFieldPosteriorParameters:
    sample_with: str = "sde"
    max_sampling_batch_size: int = 10_000
    enable_transform: bool = True

    def __post_init__(self):
        if self.sample_with not in ("sde", "ode"):
            raise ValueError("sample_with must be 'sde' or 'ode'.")


def potential_posterior(sample_with: str, potential_fn, theta_transform, prior,
                        mcmc_method: str = "slice_jax_vectorized",
                        mcmc_parameters: Optional[Dict] = None,
                        rejection_sampling_parameters: Optional[Dict] = None,
                        importance_sampling_parameters: Optional[Dict] = None,
                        vi_parameters: Optional[Dict] = None):
    """The posterior of a potential that the trainers' ``build_posterior(
    sample_with=...)`` builds, the prior as proposal: an
    ``MCMCPosterior`` (``"mcmc"``), a ``RejectionPosterior``, an
    ``ImportanceSamplingPosterior`` or a ``VIPosterior`` (``"vi"``)."""
    if sample_with == "mcmc":
        from .mcmc_posterior import MCMCPosterior

        return MCMCPosterior(potential_fn, theta_transform=theta_transform, proposal=prior,
                             method=mcmc_method, **(mcmc_parameters or {}))
    if sample_with == "rejection":
        from .rejection_posterior import RejectionPosterior

        return RejectionPosterior(potential_fn, proposal=prior,
                                  **(rejection_sampling_parameters or {}))
    if sample_with == "importance":
        from .importance_posterior import ImportanceSamplingPosterior

        return ImportanceSamplingPosterior(potential_fn, proposal=prior,
                                           theta_transform=theta_transform,
                                           **(importance_sampling_parameters or {}))
    if sample_with == "vi":
        from .vi_posterior import VIPosterior

        return VIPosterior(potential_fn, prior=prior, theta_transform=theta_transform,
                           **(vi_parameters or {}))
    raise NotImplementedError(f"sample_with='{sample_with}' not supported.")


def build_posterior_from_parameters(parameters, estimator, prior, kind: str = "npe"):
    """The posterior that ``parameters`` describes, over ``estimator`` of a
    trainer of ``kind`` (``"npe"``, ``"nle"``, ``"nre"`` or ``"vf"``). A
    type that does not suit the kind raises ``TypeError``, as in the JAX
    package: a direct posterior over a likelihood would be the wrong
    density."""
    kwargs = asdict(parameters)
    if isinstance(parameters, DirectPosteriorParameters):
        if kind != "npe":
            raise TypeError(
                f"{type(parameters).__name__} requires a posterior estimator "
                f"(NPE trainers); got a '{kind}' trainer. Use MCMC/Rejection/"
                "Importance/VI posterior parameters instead."
            )
        if isinstance(parameters, FilteredDirectPosteriorParameters):
            from .filtered_direct_posterior import FilteredDirectPosterior

            return FilteredDirectPosterior(estimator, prior, **kwargs)
        from .direct_posterior import DirectPosterior

        return DirectPosterior(estimator, prior, **kwargs)
    if isinstance(parameters, VectorFieldPosteriorParameters):
        if kind != "vf":
            raise TypeError(
                f"{type(parameters).__name__} requires a vector-field "
                f"estimator (FMPE/NPSE trainers); got a '{kind}' trainer."
            )
        from .vector_field_posterior import VectorFieldPosterior

        return VectorFieldPosterior(estimator, prior, **kwargs)
    if not isinstance(parameters, (MCMCPosteriorParameters, RejectionPosteriorParameters,
                                   ImportanceSamplingPosteriorParameters, VIPosteriorParameters)):
        raise TypeError(f"Unknown posterior parameters type {type(parameters)}")
    # Potential-based posteriors need the potential of the kind.
    if kind == "nle":
        from ..potentials.likelihood_based_potential import (
            likelihood_estimator_based_potential as make_potential,
        )
    elif kind == "nre":
        from ..potentials.ratio_based_potential import (
            ratio_estimator_based_potential as make_potential,
        )
    elif kind == "npe":
        from ..potentials.posterior_based_potential import (
            posterior_estimator_based_potential as make_potential,
        )
    else:
        raise NotImplementedError(
            f"The posterior of {type(parameters).__name__} over a '{kind}' estimator {_LATER_SLICE}.")
    potential_fn, theta_transform = make_potential(estimator, prior, x_o=None)
    if isinstance(parameters, MCMCPosteriorParameters):
        return potential_posterior("mcmc", potential_fn, theta_transform, prior,
                                   mcmc_method=kwargs.pop("method"), mcmc_parameters=kwargs)
    if isinstance(parameters, RejectionPosteriorParameters):
        return potential_posterior("rejection", potential_fn, theta_transform, prior,
                                   rejection_sampling_parameters=kwargs)
    if isinstance(parameters, VIPosteriorParameters):
        return potential_posterior("vi", potential_fn, theta_transform, prior, vi_parameters=kwargs)
    return potential_posterior("importance", potential_fn, theta_transform, prior,
                               importance_sampling_parameters=kwargs)
