"""Routing, scheduling policies, trajectories, execution strategies and the
autotune level of the Hopper tile planner."""
from .autotune import CardProfile, HardwareProfile, use_autotune  # noqa: F401
