"""Routing, scheduling policies, trajectories and execution strategies."""
