from .base_posterior import NeuralPosterior
from .direct_posterior import DirectPosterior
from .ensemble_posterior import EnsemblePosterior
from .mcmc_posterior import MCMCPosterior
from .npe_a_posterior import NPE_A_Posterior
from .posterior_parameters import build_posterior_from_parameters
from .vector_field_posterior import VectorFieldPosterior

__all__ = ["NeuralPosterior", "DirectPosterior", "EnsemblePosterior", "MCMCPosterior",
           "NPE_A_Posterior", "VectorFieldPosterior", "build_posterior_from_parameters"]
