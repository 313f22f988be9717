from .factory import likelihood_nn, posterior_flow_nn, posterior_nn, posterior_score_nn

__all__ = ["likelihood_nn", "posterior_flow_nn", "posterior_nn", "posterior_score_nn"]
