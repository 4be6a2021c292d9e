from .base import Schedule, make_schedule, init_solver_state, solver_step

__all__ = ["Schedule", "make_schedule", "init_solver_state", "solver_step"]
