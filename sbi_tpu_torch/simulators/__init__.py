from .tasks import Task, get_task, slcp_log_likelihood, slcp_simulator, two_moons_simulator

__all__ = [
    "Task", "get_task", "slcp_log_likelihood", "slcp_simulator", "two_moons_simulator",
]
