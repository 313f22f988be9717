from .importance_sampling import (
    gpdfit,
    importance_resampling_weights_ess,
    importance_sample,
    psis_diagnostics,
    sampling_importance_resampling,
)

__all__ = [
    "gpdfit",
    "importance_resampling_weights_ess",
    "importance_sample",
    "psis_diagnostics",
    "sampling_importance_resampling",
]
