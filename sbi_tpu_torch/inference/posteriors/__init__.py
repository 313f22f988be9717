from .base_posterior import NeuralPosterior
from .direct_posterior import DirectPosterior
from .ensemble_posterior import EnsemblePosterior
from .importance_posterior import ImportanceSamplingPosterior
from .mcmc_posterior import MCMCPosterior
from .npe_a_posterior import NPE_A_Posterior
from .posterior_parameters import build_posterior_from_parameters
from .rejection_posterior import RejectionPosterior
from .vector_field_posterior import VectorFieldPosterior

__all__ = ["NeuralPosterior", "DirectPosterior", "EnsemblePosterior", "ImportanceSamplingPosterior",
           "MCMCPosterior", "NPE_A_Posterior", "RejectionPosterior", "VectorFieldPosterior",
           "build_posterior_from_parameters"]
