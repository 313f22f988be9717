from .base_posterior import NeuralPosterior
from .direct_posterior import DirectPosterior
from .ensemble_posterior import EnsemblePosterior
from .mcmc_posterior import MCMCPosterior

__all__ = ["NeuralPosterior", "DirectPosterior", "EnsemblePosterior", "MCMCPosterior"]
