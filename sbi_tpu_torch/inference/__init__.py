"""Inference: the NPE trainers, ``infer``, and the direct posterior.

Ported so far: ``NeuralInference``, ``PosteriorEstimatorTrainer``, NPE-C
(``NPE``, ``NPE_C``, ``SNPE``, ``SNPE_C``, ``APT``), ``infer``,
``simulate_for_sbi`` and ``DirectPosterior``. The other names of
``sbi_tpu.inference`` come with later slices and raise
``NotImplementedError`` when asked for.
"""

from ..utils.simulation_utils import simulate_for_sbi
from .posteriors import DirectPosterior, NeuralPosterior
from .potentials.posterior_based_potential import posterior_estimator_based_potential
from .trainers.base import NeuralInference, check_if_proposal_has_default_x, infer
from .trainers.npe.npe_base import PosteriorEstimatorTrainer
from .trainers.npe.npe_c import APT, NPE, NPE_C, SNPE, SNPE_C

METHOD_REGISTRY = {"NPE": NPE, "NPE_C": NPE_C, "SNPE": SNPE, "SNPE_C": SNPE_C, "APT": APT}

_LATER_SLICE_NAMES = frozenset((
    "NLE_A", "NLE", "SNLE", "SNLE_A", "SNL", "MNLE",
    "NRE_A", "SNRE_A", "AALR", "NRE_B", "SNRE_B", "SNRE", "SRE", "NRE", "NRE_C", "SNRE_C",
    "CNRE", "BNRE", "NPE_A", "SNPE_A", "NPE_B", "SNPE_B", "MNPE", "NPE_PFN", "FMPE", "NPSE",
    "VectorFieldTrainer", "MarginalTrainer", "MCABC", "ABC", "SMCABC", "SMC",
    "MCMCPosterior", "RejectionPosterior", "ImportanceSamplingPosterior", "VIPosterior",
    "VectorFieldPosterior", "EnsemblePosterior", "vector_field_estimator_based_potential",
    "LikelihoodBasedPotential", "likelihood_estimator_based_potential",
    "mixed_likelihood_estimator_based_potential", "RatioBasedPotential",
    "ratio_estimator_based_potential",
))


def later_slice_name(name: str) -> bool:
    """Whether ``name`` is a name of ``sbi_tpu.inference`` still to port."""
    return name in _LATER_SLICE_NAMES


def __getattr__(name):
    if name in _LATER_SLICE_NAMES:
        raise NotImplementedError(
            f"sbi_tpu_torch.inference.{name} is not ported yet; it comes with a later slice."
        )
    raise AttributeError(f"module 'sbi_tpu_torch.inference' has no attribute {name!r}")


__all__ = [
    "APT", "DirectPosterior", "METHOD_REGISTRY", "NPE", "NPE_C", "NeuralInference",
    "NeuralPosterior", "PosteriorEstimatorTrainer", "SNPE", "SNPE_C",
    "check_if_proposal_has_default_x", "infer", "posterior_estimator_based_potential",
    "simulate_for_sbi",
]
