"""Inference: the NPE and NLE trainers, ``infer``, and the direct and MCMC
posteriors.

Ported so far: ``NeuralInference``, ``PosteriorEstimatorTrainer``, NPE-C
(``NPE``, ``NPE_C``, ``SNPE``, ``SNPE_C``, ``APT``), NPE-A (``NPE_A``,
``SNPE_A``) with ``NPE_A_Posterior``, NPE-B (``NPE_B``, ``SNPE_B``),
``LikelihoodEstimatorTrainer`` and NLE-A (``NLE``, ``NLE_A``, ``SNLE``,
``SNLE_A``, ``SNL``), ``RatioEstimatorTrainer`` with NRE-A (``NRE_A``,
``SNRE_A``, ``AALR``), NRE-B (``NRE_B``, ``SNRE_B``, ``SNRE``, ``SRE``,
``NRE``), NRE-C (``NRE_C``, ``SNRE_C``, ``CNRE``) and ``BNRE``, the
vector-field trainers (``FMPE``, ``NPSE``, ``VectorFieldTrainer``) with
``VectorFieldPosterior``, ensembles (``train_ensemble``,
``build_ensemble_posterior``), ``infer``, ``simulate_for_sbi``,
``DirectPosterior``, ``FilteredDirectPosterior``, ``MCMCPosterior``
(vectorized slice sampling, HMC, NUTS), ``RejectionPosterior``,
``ImportanceSamplingPosterior``, ``VIPosterior``, ``EnsemblePosterior``,
the typed ``*PosteriorParameters`` and the
posterior, likelihood, ratio and vector-field potentials. The other names of
``sbi_tpu.inference`` come with later slices and raise
``NotImplementedError`` when asked for.
"""

from ..utils.simulation_utils import simulate_for_sbi
from .posteriors import (
    DirectPosterior,
    EnsemblePosterior,
    FilteredDirectPosterior,
    ImportanceSamplingPosterior,
    MCMCPosterior,
    NeuralPosterior,
    RejectionPosterior,
    VectorFieldPosterior,
    VIPosterior,
)
from .posteriors.npe_a_posterior import NPE_A_Posterior
from .posteriors.posterior_parameters import (
    DirectPosteriorParameters,
    FilteredDirectPosteriorParameters,
    ImportanceSamplingPosteriorParameters,
    MCMCPosteriorParameters,
    RejectionPosteriorParameters,
    VectorFieldPosteriorParameters,
    VIPosteriorParameters,
)
from .potentials.likelihood_based_potential import (
    LikelihoodBasedPotential,
    likelihood_estimator_based_potential,
)
from .potentials.posterior_based_potential import posterior_estimator_based_potential
from .potentials.ratio_based_potential import RatioBasedPotential, ratio_estimator_based_potential
from .potentials.vector_field_potential import (
    VectorFieldBasedPotential,
    vector_field_estimator_based_potential,
)
from .trainers.base import NeuralInference, check_if_proposal_has_default_x, infer
from .trainers.nle.nle_a import NLE, NLE_A, SNL, SNLE, SNLE_A, LikelihoodEstimatorTrainer
from .trainers.npe.npe_a import NPE_A, SNPE_A
from .trainers.npe.npe_b import NPE_B, SNPE_B
from .trainers.npe.npe_base import PosteriorEstimatorTrainer
from .trainers.npe.npe_c import APT, NPE, NPE_C, SNPE, SNPE_C
from .trainers.nre.bnre import BNRE
from .trainers.nre.nre_a import AALR, NRE_A, SNRE_A
from .trainers.nre.nre_b import NRE, NRE_B, SNRE, SNRE_B, SRE
from .trainers.nre.nre_base import RatioEstimatorTrainer
from .trainers.nre.nre_c import CNRE, NRE_C, SNRE_C
from .trainers.vfpe.base_vf_inference import VectorFieldTrainer
from .trainers.vfpe.fmpe import FMPE
from .trainers.vfpe.npse import NPSE

METHOD_REGISTRY = {
    "NPE": NPE, "NPE_C": NPE_C, "SNPE": SNPE, "SNPE_C": SNPE_C, "APT": APT,
    "NPE_A": NPE_A, "SNPE_A": SNPE_A, "NPE_B": NPE_B, "SNPE_B": SNPE_B,
    "NLE": NLE, "NLE_A": NLE_A, "SNLE": SNLE, "SNLE_A": SNLE_A, "SNL": SNL,
    "NRE_A": NRE_A, "SNRE_A": SNRE_A, "AALR": AALR, "NRE_B": NRE_B, "SNRE_B": SNRE_B,
    "SNRE": SNRE, "SRE": SRE, "NRE": NRE, "NRE_C": NRE_C, "SNRE_C": SNRE_C, "CNRE": CNRE,
    "BNRE": BNRE, "FMPE": FMPE, "NPSE": NPSE,
}

_LATER_SLICE_NAMES = frozenset((
    "MNLE", "MNPE", "NPE_PFN",
    "MarginalTrainer", "MCABC", "ABC", "SMCABC", "SMC",
    "mixed_likelihood_estimator_based_potential",
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
    "AALR", "APT", "BNRE", "CNRE", "DirectPosterior", "DirectPosteriorParameters",
    "EnsemblePosterior", "FMPE", "FilteredDirectPosterior", "FilteredDirectPosteriorParameters",
    "ImportanceSamplingPosterior", "ImportanceSamplingPosteriorParameters",
    "LikelihoodBasedPotential", "LikelihoodEstimatorTrainer", "MCMCPosterior",
    "MCMCPosteriorParameters", "METHOD_REGISTRY", "NLE", "NLE_A", "NPE", "NPE_A",
    "NPE_A_Posterior", "NPE_B", "NPE_C", "NPSE", "NRE", "NRE_A", "NRE_B", "NRE_C",
    "NeuralInference", "NeuralPosterior", "PosteriorEstimatorTrainer", "RatioBasedPotential",
    "RatioEstimatorTrainer", "RejectionPosterior", "RejectionPosteriorParameters", "SNL",
    "SNLE", "SNLE_A", "SNPE", "SNPE_A", "SNPE_B", "SNPE_C", "SNRE", "SNRE_A", "SNRE_B",
    "SNRE_C", "SRE", "VIPosterior", "VIPosteriorParameters",
    "VectorFieldBasedPotential", "VectorFieldPosterior", "VectorFieldPosteriorParameters",
    "VectorFieldTrainer", "check_if_proposal_has_default_x", "infer", "likelihood_estimator_based_potential",
    "posterior_estimator_based_potential", "ratio_estimator_based_potential", "simulate_for_sbi",
    "vector_field_estimator_based_potential",
]
