from .hodgkin_huxley import hh_prior, hodgkin_huxley, summary_statistics
from .linear_gaussian import (
    diagonal_linear_gaussian,
    linear_gaussian,
    true_posterior_linear_gaussian_mvn_prior,
)
from .tasks import Task, get_task, slcp_log_likelihood, slcp_simulator, two_moons_simulator

__all__ = [
    "Task", "diagonal_linear_gaussian", "get_task", "hh_prior", "hodgkin_huxley", "linear_gaussian",
    "slcp_log_likelihood", "slcp_simulator", "summary_statistics",
    "true_posterior_linear_gaussian_mvn_prior", "two_moons_simulator",
]
