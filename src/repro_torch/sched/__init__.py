"""repro_torch.sched — the scheduling engine, its policy components,
metrics, cluster events and named scenarios, the chaos narrator, the
session event loop, scenario sweeps (lockstep on a device, or a pool of
host processes), and the legacy entry points ``simulate``,
``DFRSSimulator`` and ``batch_schedule``."""
from .batch import batch_schedule
from .cluster import ClusterEvent, failure_trace
from .engine import Engine, Policy, SimParams, SimResult
from .narrator import Narrator, parse_narrator
from .scenarios import (apply_scenario, apply_scenario_trace,
                        list_scenarios, parse_scenario_chain,
                        register_scenario, run_reactive, scenario_docs)
from .sweep import (Cell, RecordCache, SweepResult, grid, run_batched,
                    run_branches, run_grid)
from .simulator import DFRSSimulator, simulate

__all__ = [
    "Engine", "Policy", "SimParams", "SimResult",
    "DFRSSimulator", "simulate", "batch_schedule",
    "ClusterEvent", "failure_trace",
    "apply_scenario", "apply_scenario_trace", "parse_scenario_chain",
    "list_scenarios", "scenario_docs", "register_scenario", "run_reactive",
    "Narrator", "parse_narrator",
    "Cell", "RecordCache", "SweepResult", "grid", "run_grid", "run_batched",
    "run_branches",
]
