from .flow import build_maf, build_nsf
from .mdn import build_mdn
from .vector_field_nets import build_flow_matching_estimator, build_score_estimator

__all__ = ["build_flow_matching_estimator", "build_maf", "build_mdn", "build_nsf",
           "build_score_estimator"]
