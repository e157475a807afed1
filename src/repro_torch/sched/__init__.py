"""repro_torch.sched — the scheduling engine (DFRS policies and the FCFS /
EASY batch baselines behind one event loop), the composable policy
components and the monolithic seed classes they are held against, metrics,
cluster events and named scenarios, the chaos narrator, the session event
loop, scenario sweeps (lockstep on a device, or a pool of host processes),
and the legacy entry points ``simulate``, ``DFRSSimulator`` and
``batch_schedule``."""
from .engine import (BatchPolicy, DFRSPolicy, Engine, Policy, SimParams,
                     SimResult, make_policy, make_seed_policy)
from .components import (
    ComposedPolicy,
    Component,
    compose,
    compose_from_spec,
    get_component,
    list_components,
    register_component,
    register_policy,
    registered_policies,
    resolve_policy,
)
from .simulator import DFRSSimulator, simulate
from .batch import batch_schedule
from .metrics import (
    bounded_stretch,
    max_bounded_stretch,
    degradation_from_bound,
    normalized_underutilization,
)
from .cluster import ClusterEvent, failure_trace
from .narrator import Narrator, parse_narrator
from .scenarios import (apply_scenario, apply_scenario_trace,
                        list_scenarios, parse_scenario_chain,
                        register_scenario, run_reactive, scenario_docs)
from .sweep import (Cell, RecordCache, SweepResult, grid, run_batched,
                    run_branches, run_grid)

__all__ = [
    "Engine", "Policy", "DFRSPolicy", "BatchPolicy",
    "make_policy", "make_seed_policy",
    "ComposedPolicy", "Component", "compose", "compose_from_spec",
    "get_component", "list_components", "register_component",
    "register_policy", "registered_policies", "resolve_policy",
    "DFRSSimulator", "SimParams", "SimResult", "simulate",
    "batch_schedule",
    "bounded_stretch", "max_bounded_stretch", "degradation_from_bound",
    "normalized_underutilization",
    "ClusterEvent", "failure_trace",
    "apply_scenario", "apply_scenario_trace", "parse_scenario_chain",
    "list_scenarios", "scenario_docs", "register_scenario",
    "Cell", "RecordCache", "SweepResult", "grid", "run_grid",
    # beyond the reference's list: the port's own surface
    "run_reactive", "Narrator", "parse_narrator", "run_batched",
    "run_branches",
]
