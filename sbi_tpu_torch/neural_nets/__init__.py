from .factory import classifier_nn, likelihood_nn, posterior_flow_nn, posterior_nn, posterior_score_nn

__all__ = ["classifier_nn", "likelihood_nn", "posterior_flow_nn", "posterior_nn", "posterior_score_nn"]
