"""Serving: the layer-stepped engine and its paged KV state pool."""
from .engine import Engine, QueueFullError, ServeConfig

__all__ = ["Engine", "QueueFullError", "ServeConfig"]
