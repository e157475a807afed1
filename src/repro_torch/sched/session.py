"""Simulation sessions: the engine's event loop as a resumable driver.

:class:`SimSession` adopts a constructed :class:`~.engine.Engine` (its
not-yet-arrived jobs become the arrival stream) and steps its event loop to
exhaustion.  The loop executes, per event timestamp: job completions,
cluster events, arrivals, the periodic tick, then the policy's
``finalize`` — the order every result in this package is defined by.
"""
from __future__ import annotations

import heapq
import math
import time
from typing import List, Optional, Tuple

from ..core.state import S_COMPLETED, S_NOT_ARRIVED, S_PENDING
from .cluster import ClusterEvent
from .engine import _EPS, Engine, SimResult

__all__ = ["SimSession"]


class SimSession:
    """A resumable simulation over one engine."""

    def __init__(self, engine: Engine):
        self.engine = engine
        st = engine.state
        pol = engine.policy
        self._arrivals: List[Tuple[float, int, int]] = [
            (s.release, s.jid, i) for i, s in enumerate(st.specs)
            if int(st.status[i]) == S_NOT_ARRIVED
        ]
        heapq.heapify(self._arrivals)
        self._cev: List[ClusterEvent] = (
            list(engine.cluster_events) if pol.handles_cluster_events else [])
        self._ci = 0
        self._periodic = pol.periodic_kind is not None
        self._next_tick = math.inf
        if self._periodic and self._arrivals:
            self._next_tick = self._arrivals[0][0] + engine.params.period
        self._exhausted = False
        self._hit_cap = False
        self._wall = 0.0

    @classmethod
    def from_engine(cls, engine: Engine) -> "SimSession":
        """Adopt a constructed engine (the closed-world ``Engine.run()``
        path)."""
        return cls(engine)

    # -- stepping -----------------------------------------------------------
    def _loop(self) -> int:
        """The event loop: process event timestamps until none is left."""
        e = self.engine
        p = e.params
        st = e.state
        pol = e.policy
        cev = self._cev
        heap = self._arrivals
        periodic = self._periodic
        steps = 0
        t0 = time.perf_counter()
        try:
            while not self._exhausted:
                t_arr = heap[0][0] if heap else math.inf
                t_cev = cev[self._ci].time if self._ci < len(cev) else math.inf
                t_done = st.next_completion_time()
                armed = st.any_in_system() or heap
                t_tick = (self._next_tick
                          if (periodic and armed) else math.inf)
                t_next = min(t_arr, t_done, t_tick, t_cev)
                e._events += 1
                if e._events > p.max_events:
                    e._events = p.max_events
                    if p.on_max_events == "truncate":
                        self._hit_cap = True
                        self._exhausted = True
                        break
                    n_done = int((st.status == S_COMPLETED).sum())
                    raise RuntimeError(
                        f"event budget exceeded: max_events={p.max_events} at "
                        f"t={st.now:.6g}s with {n_done}/{st.n_total} jobs "
                        f"completed (policy {pol.__class__.__name__}); raise "
                        f"SimParams.max_events or set on_max_events='truncate' "
                        f"for a partial SimResult")
                if math.isinf(t_next):
                    self._exhausted = True
                    break
                st.advance(t_next)
                steps += 1

                acted = False
                # 1) completions
                while True:
                    fin = st.finished_running_indices()
                    if fin.size == 0:
                        break
                    for i in fin:
                        js = st.views[i]
                        pol.on_job_completed(js)   # mapping still set here
                        e.complete(js)
                    pol.on_complete()
                    acted = True
                # 2) cluster events
                while self._ci < len(cev) and cev[self._ci].time <= st.now + _EPS:
                    e._apply_cluster_event(cev[self._ci])
                    self._ci += 1
                    acted = True
                # 3) arrivals
                while heap and heap[0][0] <= st.now + _EPS:
                    _, _, i = heapq.heappop(heap)
                    if int(st.status[i]) != S_NOT_ARRIVED:
                        continue        # cancelled before it ever arrived
                    st.set_status(i, S_PENDING)
                    pol.on_submit(st.views[i])
                    acted = True
                # 4) periodic tick
                if periodic and st.now + _EPS >= self._next_tick:
                    pol.on_tick()
                    self._next_tick += p.period
                    acted = True
                pol.finalize(acted)
        finally:
            self._wall += time.perf_counter() - t0
        return steps

    def run_to_exhaustion(self) -> "SimSession":
        """Step until no future event exists."""
        self._loop()
        return self

    def run(self) -> SimResult:
        """Step to exhaustion and finalize (the ``Engine.run()`` contract)."""
        self.run_to_exhaustion()
        return self.result()

    # -- finalization -------------------------------------------------------
    def result(self, partial: Optional[bool] = None) -> SimResult:
        """Finalize metrics.  Defaults to a *partial* result (covering the
        completed jobs only) while events remain, and to the strict
        closed-world result once exhausted."""
        if partial is None:
            partial = not self._exhausted
        return self.engine._result(hit_cap=self._hit_cap, partial=partial,
                                   sim_wall_s=self._wall)
