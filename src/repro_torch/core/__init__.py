"""repro_torch.core — the paper's contribution, DFRS scheduling algorithms:
the job model, the engine state, the §4.6 yield allocation, greedy
placement, MCB8 packing and MCB8-stretch, EQUIPARTITION on one unit
resource (the Theorem-2/3/4 analysis), the offline max-stretch lower bound
and the policy grammar.  Beside them: the incidence kernels, the batched
torch allocation backend (``alloc_torch``) and the pure-Python allocation
oracle (``alloc_reference``).
"""
from .job import JobSpec, JobState, NodePool, PENDING, RUNNING, PAUSED, COMPLETED
from .state import EngineState, JobView
from .yield_alloc import allocate, maxmin_yields, avg_yields, min_yield
from .greedy import greedy_place, greedy_p, greedy_pm, GreedyAdmission
from .mcb8 import mcb8, mcb8_pack, MCB8Result
from .stretch_opt import mcb8_stretch, improve_max_stretch, improve_avg_stretch, StretchResult
from .equipartition import equipartition_schedule, max_stretch, thm4_instance
from .bound import max_stretch_lower_bound, stretch_feasible
from .policies import (PolicySpec, parse_policy, render_policy,
                       TABLE1_POLICIES, all_paper_policies)

__all__ = [
    "JobSpec", "JobState", "NodePool", "EngineState", "JobView",
    "PENDING", "RUNNING", "PAUSED", "COMPLETED",
    "allocate", "maxmin_yields", "avg_yields", "min_yield",
    "greedy_place", "greedy_p", "greedy_pm", "GreedyAdmission",
    "mcb8", "mcb8_pack", "MCB8Result",
    "mcb8_stretch", "improve_max_stretch", "improve_avg_stretch", "StretchResult",
    "equipartition_schedule", "max_stretch", "thm4_instance",
    "max_stretch_lower_bound", "stretch_feasible",
    "PolicySpec", "parse_policy", "render_policy", "TABLE1_POLICIES",
    "all_paper_policies",
]
