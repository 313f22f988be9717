from .base import ConditionalDensityEstimator, ConditionalEstimator
from .flows import (
    FlowEstimator,
    FlowModule,
    LULinear,
    MADENet,
    MaskedAffineAutoregressive,
    MaskedDense,
    MaskedRQSAutoregressive,
    Permutation,
    RQSCoupling,
    rational_quadratic_spline,
)
from .mdn import MDNModule, MixtureDensityEstimator, MoG, MultivariateGaussianMDN

__all__ = [
    "ConditionalDensityEstimator",
    "ConditionalEstimator",
    "FlowEstimator",
    "FlowModule",
    "LULinear",
    "MDNModule",
    "MADENet",
    "MaskedAffineAutoregressive",
    "MaskedDense",
    "MaskedRQSAutoregressive",
    "MixtureDensityEstimator",
    "MoG",
    "MultivariateGaussianMDN",
    "Permutation",
    "RQSCoupling",
    "rational_quadratic_spline",
]
