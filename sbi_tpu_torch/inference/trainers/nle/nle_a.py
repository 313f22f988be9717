"""NLE_A and its aliases (counterpart of ``sbi_tpu/inference/trainers/nle/nle_a.py``)."""

from .nle_base import NLE, NLE_A, SNL, SNLE, SNLE_A, LikelihoodEstimatorTrainer

__all__ = ["NLE_A", "NLE", "SNLE", "SNLE_A", "SNL", "LikelihoodEstimatorTrainer"]
