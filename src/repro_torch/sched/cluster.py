"""Cluster model: node failures and elastic capacity events.

A "fail" is a node loss — every resident job is force-preempted and the
scheduler's node pool shrinks; a "join" restores capacity.  DFRS needs no
special-case logic: failures reuse the pause path and the next scheduling
event re-places work.  "cancel" withdraws jobs and "resize" changes their
task count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["ClusterEvent"]

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
