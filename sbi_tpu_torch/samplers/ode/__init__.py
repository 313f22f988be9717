from .ode_solvers import NeuralODE, build_neural_ode, odeint_rk4, odeint_with_logdet, rk4_step

__all__ = ["NeuralODE", "build_neural_ode", "odeint_rk4", "odeint_with_logdet", "rk4_step"]
