"""Serving: the engine (fused segments and the eager loop), its paged KV
state pool (prefix cache, preemption handles), the continuous-batching
scheduler and Poisson traffic."""
from .engine import Engine, QueueFullError, RequestState, ServeConfig
from .megastep import MegaStep
from .scheduler import (Scheduler, SchedulerConfig, ServingMetrics, Ticket,
                        percentiles)
from .statepool import (PoolExhausted, PreemptedState, PrefixEntry,
                        StatePool, hash_chain)
from .traffic import (TrafficConfig, TrafficRequest, make_traffic,
                      run_closed_loop, to_sim_requests)

__all__ = ["Engine", "MegaStep", "PoolExhausted", "PreemptedState",
           "PrefixEntry", "QueueFullError", "RequestState", "Scheduler",
           "SchedulerConfig", "ServeConfig", "ServingMetrics", "StatePool",
           "Ticket", "TrafficConfig", "TrafficRequest", "hash_chain",
           "make_traffic", "percentiles", "run_closed_loop",
           "to_sim_requests"]
