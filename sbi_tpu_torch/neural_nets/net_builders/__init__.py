from .classifier import build_linear_classifier, build_mlp_classifier, build_resnet_classifier
from .flow import build_maf, build_nsf
from .mdn import build_mdn
from .vector_field_nets import build_flow_matching_estimator, build_score_estimator

__all__ = ["build_flow_matching_estimator", "build_linear_classifier", "build_maf", "build_mdn",
           "build_mlp_classifier", "build_nsf", "build_resnet_classifier", "build_score_estimator"]
