from .linear_gaussian import (
    diagonal_linear_gaussian,
    linear_gaussian,
    true_posterior_linear_gaussian_mvn_prior,
)
from .tasks import Task, get_task, slcp_log_likelihood, slcp_simulator, two_moons_simulator

__all__ = [
    "Task", "diagonal_linear_gaussian", "get_task", "linear_gaussian", "slcp_log_likelihood",
    "slcp_simulator", "true_posterior_linear_gaussian_mvn_prior", "two_moons_simulator",
]
