from .diffuser import (
    CORRECTORS,
    PREDICTORS,
    Diffuser,
    euler_maruyama_predictor,
    gibbs_corrector,
    langevin_corrector,
    register_corrector,
    register_predictor,
)

__all__ = [
    "CORRECTORS",
    "Diffuser",
    "PREDICTORS",
    "euler_maruyama_predictor",
    "gibbs_corrector",
    "langevin_corrector",
    "register_corrector",
    "register_predictor",
]
