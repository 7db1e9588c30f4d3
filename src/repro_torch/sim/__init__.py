"""The chiplet simulator (port of ``repro.sim``): the Table-I hardware
model, long-tail workloads, the discrete-event layer simulator, the
step-level mode, EP and two-tier simulations with the referee of the
serving engine's modeled clock (``modes.replay_trace``), and the
end-to-end multi-iteration run.  numpy only, as in the reference."""
from .hardware import (HardwareConfig, ModelSpec, NDPConfig, PROTOTYPE_2X2,
                       PROTOTYPE_2X2_NDP, PAPER_SPECS, scaled,
                       spec_from_config, with_ndp)
from .workload import LayerWorkload, Request, iteration_workloads, make_requests, make_layer_workload
from .engine import ChipletSim, LayerResult, simulate_layer, simulate_naive_fsedp
from .e2e import E2EResult, run_e2e
from .modes import ModeResult, rank_modes, simulate_hybrid, simulate_mode
