"""Inference (this slice: the direct posterior and its potential; the
trainers come with later slices)."""

from .posteriors import DirectPosterior, NeuralPosterior
from .potentials.posterior_based_potential import posterior_estimator_based_potential

__all__ = ["DirectPosterior", "NeuralPosterior", "posterior_estimator_based_potential"]
