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

__all__ = [
    "ConditionalDensityEstimator",
    "ConditionalEstimator",
    "FlowEstimator",
    "FlowModule",
    "LULinear",
    "MADENet",
    "MaskedAffineAutoregressive",
    "MaskedDense",
    "MaskedRQSAutoregressive",
    "Permutation",
    "RQSCoupling",
    "rational_quadratic_spline",
]
