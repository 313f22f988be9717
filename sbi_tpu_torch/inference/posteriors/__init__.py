from .base_posterior import NeuralPosterior
from .direct_posterior import DirectPosterior

__all__ = ["NeuralPosterior", "DirectPosterior"]
