"""Serving: the engine (fused segments and the eager loop), its paged KV
state pool, the continuous-batching scheduler and Poisson traffic."""
from .engine import Engine, QueueFullError, RequestState, ServeConfig
from .megastep import MegaStep
from .scheduler import (Scheduler, SchedulerConfig, ServingMetrics, Ticket,
                        percentiles)
from .statepool import PoolExhausted, StatePool
from .traffic import (TrafficConfig, TrafficRequest, make_traffic,
                      run_closed_loop)

__all__ = ["Engine", "MegaStep", "PoolExhausted", "QueueFullError",
           "RequestState", "Scheduler", "SchedulerConfig", "ServeConfig",
           "ServingMetrics", "StatePool", "Ticket", "TrafficConfig",
           "TrafficRequest", "make_traffic", "percentiles",
           "run_closed_loop"]
