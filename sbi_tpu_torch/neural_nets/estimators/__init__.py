from .base import ConditionalDensityEstimator, ConditionalEstimator, ConditionalVectorFieldEstimator
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
from .flowmatching_estimator import FlowMatchingEstimator
from .mdn import MDNModule, MixtureDensityEstimator, MoG, MultivariateGaussianMDN
from .ratio_estimators import (
    LinearClassifierModule,
    MLPClassifierModule,
    RatioEstimator,
    ResNetClassifierModule,
)
from .score_estimator import (
    ConditionalScoreEstimator,
    SubVPScoreEstimator,
    VEScoreEstimator,
    VPScoreEstimator,
)

__all__ = [
    "ConditionalDensityEstimator",
    "ConditionalEstimator",
    "ConditionalScoreEstimator",
    "ConditionalVectorFieldEstimator",
    "FlowEstimator",
    "FlowMatchingEstimator",
    "FlowModule",
    "LULinear",
    "LinearClassifierModule",
    "MLPClassifierModule",
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
    "RatioEstimator",
    "ResNetClassifierModule",
    "SubVPScoreEstimator",
    "VEScoreEstimator",
    "VPScoreEstimator",
    "rational_quadratic_spline",
]
