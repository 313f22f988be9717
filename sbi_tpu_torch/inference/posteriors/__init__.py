from .base_posterior import NeuralPosterior
from .direct_posterior import DirectPosterior
from .ensemble_posterior import EnsemblePosterior
from .filtered_direct_posterior import FilteredDirectPosterior
from .importance_posterior import ImportanceSamplingPosterior
from .mcmc_posterior import MCMCPosterior
from .npe_a_posterior import NPE_A_Posterior
from .posterior_parameters import build_posterior_from_parameters
from .rejection_posterior import RejectionPosterior
from .vector_field_posterior import VectorFieldPosterior
from .vi_posterior import VIPosterior

__all__ = ["NeuralPosterior", "DirectPosterior", "EnsemblePosterior", "FilteredDirectPosterior",
           "ImportanceSamplingPosterior", "MCMCPosterior", "NPE_A_Posterior", "RejectionPosterior",
           "VIPosterior", "VectorFieldPosterior", "build_posterior_from_parameters"]
