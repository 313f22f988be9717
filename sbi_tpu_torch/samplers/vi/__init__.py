"""Variational inference: the divergences and the quality checks.

PyTorch counterpart of ``sbi_tpu/samplers/vi``.
"""

from .vi_divergence_optimizers import (
    forward_kl_loss,
    get_default_VI_method,
    get_VI_method,
    iw_elbo_loss,
    register_VI_method,
    renyi_loss,
    reverse_kl_loss,
)
from .vi_quality_control import proportional_to_joint_diagnostics, psis_diagnostics

__all__ = ["forward_kl_loss", "get_VI_method", "get_default_VI_method", "iw_elbo_loss",
           "proportional_to_joint_diagnostics", "psis_diagnostics", "register_VI_method",
           "renyi_loss", "reverse_kl_loss"]
