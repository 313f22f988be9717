from .factory import likelihood_nn, posterior_nn

__all__ = ["likelihood_nn", "posterior_nn"]
