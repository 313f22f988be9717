from .factory import posterior_nn

__all__ = ["posterior_nn"]
