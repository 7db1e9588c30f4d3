"""Routing, scheduling policies, trajectories, execution strategies and the
autotune level of the Hopper tile planner."""
from . import autotune, gating, policies, strategy, trajectory  # noqa: F401
from .autotune import (CardProfile, HardwareProfile, Plan,  # noqa: F401
                       plan_moe, use_autotune)
from .strategy import (ExecutionSpec, MoEStrategy,  # noqa: F401
                       StrategyContext, available, execute, get_strategy,
                       plan_family, register)
from .trajectory import LoadTracker, Schedule, build_schedule  # noqa: F401
# deprecated shims (warn once on call): the registry is the API
from .fse_dp import fse_dp_moe_3d  # noqa: F401
from .baselines import ep_moe_3d, tp_moe_3d  # noqa: F401
from .policies import (TokenBufferPolicy, expert_pairs,  # noqa: F401
                       paired_load_order)
