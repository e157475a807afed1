"""Cluster model: node failures and elastic capacity events.

A "fail" is a node loss — every resident job is force-preempted and the
scheduler's node pool shrinks; a "join" restores capacity.  DFRS needs no
special-case logic: failures reuse the pause path and the next scheduling
event re-places work.  "cancel" withdraws jobs and "resize" changes their
task count.  :func:`failure_trace` draws a Poisson failure/repair script.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["ClusterEvent", "failure_trace"]

_KINDS = ("fail", "join", "cancel", "resize")


@dataclass(frozen=True)
class ClusterEvent:
    time: float
    kind: str                        # "fail" | "join" | "cancel" | "resize"
    nodes: Tuple[int, ...] = ()      # fail/join targets
    jids: Tuple[int, ...] = ()       # cancel/resize targets (job ids)
    value: Optional[float] = None    # resize: new n_tasks

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(self.kind)
        if self.kind in ("fail", "join") and not self.nodes:
            raise ValueError(f"{self.kind} event needs nodes")
        if self.kind in ("cancel", "resize") and not self.jids:
            raise ValueError(f"{self.kind} event needs jids")
        if self.kind == "resize" and self.value is None:
            raise ValueError("resize event needs value (new n_tasks)")


def failure_trace(
    n_nodes: int,
    horizon: float,
    mtbf: float,
    repair: float,
    seed: int = 0,
) -> List[ClusterEvent]:
    """Poisson node failures with deterministic repair time.

    ``mtbf`` is the per-cluster mean time between failures (s); each failure
    hits one uniformly random node and is repaired after ``repair`` seconds.
    """
    rng = np.random.default_rng(seed)
    events: List[ClusterEvent] = []
    t = 0.0
    while True:
        t += float(rng.exponential(mtbf))
        if t >= horizon:
            break
        node = int(rng.integers(n_nodes))
        events.append(ClusterEvent(t, "fail", (node,)))
        events.append(ClusterEvent(t + repair, "join", (node,)))
    events.sort(key=lambda e: e.time)
    return events
