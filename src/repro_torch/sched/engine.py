"""Unified scheduling engine: one event loop for DFRS *and* batch baselines.

The engine owns the simulation clock, the structure-of-arrays job state
(``repro_torch.core.state.EngineState``), the node pool, cluster events and
all accounting (penalties, bandwidth, utilization integrals, metrics).
Scheduling behaviour is a pluggable :class:`Policy`, assembled from
components by :mod:`repro_torch.sched.components`.

Fluid model (§5.1): between events every running job j progresses at its
yield (vt += y_j·dt) and completes when vt reaches p_j; preemption-resumes
and migrations cost a rescheduling penalty of zero progress; pauses/
resumes/migrations move memory images and are charged to the bandwidth
tally.

The §4.6 reallocation (:func:`_reallocate_yields`) runs on the host numpy
kernels, or on any ``alloc_backend`` with the same ``allocate`` protocol —
the device path is ``repro_torch.core.alloc_torch.TorchAllocBackend`` or a
lockstep lane of a batched sweep.  Under
:func:`~repro_torch.core.alloc_kernels.reference_kernels` it runs the
pure-Python oracle instead, ahead of any backend.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.greedy import greedy_place
from ..core.job import COMPLETED, PAUSED, PENDING, RUNNING, JobSpec
from ..core.policies import PolicySpec, parse_policy
from ..core.state import (
    S_CANCELLED,
    S_COMPLETED,
    S_NOT_ARRIVED,
    S_RUNNING,
    EngineState,
    JobView,
)
from ..core import alloc_kernels
from ..core.yield_alloc import allocate, allocate_incidence
from ..workloads.trace import Trace
from .cluster import ClusterEvent

__all__ = ["SimParams", "SimResult", "Engine", "Policy", "make_policy",
           "resolve_policy_arg"]

_EPS = 1e-9


@dataclass
class SimParams:
    n_nodes: int = 128
    penalty: float = 300.0          # rescheduling penalty (s), §5.1
    period: float = 600.0           # periodic MCB8 period (default 2x penalty)
    node_mem_gb: float = 8.0        # bandwidth accounting only
    stretch_tau: float = 10.0       # bounded-stretch threshold (s)
    max_events: int = 20_000_000    # hard event-loop bound
    on_max_events: str = "raise"    # "raise" | "truncate"
    # compact COMPLETED/CANCELLED rows out of the SoA state whenever at
    # least this many are evictable (0 = never; results are bit-identical
    # either way — see EngineState.compact / RetiredLog)
    compact_interval: int = 0

    def __post_init__(self) -> None:
        if self.max_events < 1:
            raise ValueError("max_events must be >= 1")
        if self.on_max_events not in ("raise", "truncate"):
            raise ValueError(f"on_max_events must be 'raise' or 'truncate', "
                             f"got {self.on_max_events!r}")
        if self.compact_interval < 0:
            raise ValueError("compact_interval must be >= 0")


@dataclass
class SimResult:
    policy: str
    completions: Dict[int, float]
    stretches: Dict[int, float]
    max_stretch: float
    mean_stretch: float
    n_pmtn: int
    n_mig: int
    pmtn_per_job: float
    mig_per_job: float
    pmtn_per_hour: float
    mig_per_hour: float
    bytes_moved_gb: float
    bandwidth_gbps: float
    underutilization: float         # normalized (§6.4)
    makespan: float
    events: int
    hit_max_events: bool = False    # True only with on_max_events="truncate"
    n_cancelled: int = 0            # jobs withdrawn mid-run (never in metrics)
    # final simulation clock and the engine-loop wall time.  ``sim_wall_s``
    # is a measurement, not a simulation outcome, so it is excluded from
    # equality (bit-identity comparisons stay meaningful).
    final_time: float = 0.0
    sim_wall_s: float = field(default=0.0, compare=False)

    @property
    def n_events(self) -> int:
        """Alias of ``events`` (the sweep-record spelling)."""
        return self.events


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------
class Policy:
    """Scheduling behaviour plugged into the engine's event loop.

    Hook order per event timestamp: job completions (``on_job_completed``
    per job, then ``on_complete`` per batch), cluster events, arrivals
    (``on_submit``), periodic tick (``on_tick``), then ``finalize(acted)``.
    """

    #: does the policy react to node failures / elastic capacity events?
    handles_cluster_events = False
    #: non-None enables the periodic tick
    periodic_kind: Optional[str] = None

    def bind(self, engine: "Engine") -> None:
        self.e = engine

    def validate(self, specs: Sequence[JobSpec], params: SimParams) -> None:
        pass

    def on_submit(self, js: JobView) -> None:
        pass

    def on_job_completed(self, js: JobView) -> None:
        pass

    def on_job_cancelled(self, js: JobView) -> None:
        """Called just before the engine drops a cancelled job (mapping and
        pool space still intact) so queue-holding policies can forget it."""
        pass

    def on_complete(self) -> None:
        pass

    def on_tick(self) -> None:
        pass

    def finalize(self, acted: bool) -> None:
        pass


def _reallocate_yields(e: "Engine", opt: str) -> None:
    """The §4.6 yield recomputation for every running job (run by the
    ``opt`` policy components)."""
    st = e.state
    run = st.running_indices()
    if alloc_kernels.reference_kernels_active():
        views = [st.views[i] for i in run]
        ylds = allocate([js.spec for js in views],
                        [js.mapping for js in views],
                        e.params.n_nodes, opt=opt)
    elif e.alloc_backend is not None:
        # pluggable backend (bit-identical contract): the torch allocator,
        # or a lockstep lane of a batched sweep
        ylds = e.alloc_backend.allocate(st.inc.csr(), run, opt)
    else:
        # host path: the incrementally maintained incidence matrix already
        # holds every running task — no mapping rescan, no table rebuild
        ylds = allocate_incidence(st.inc.csr(), run, opt=opt)
    st.yld[run] = ylds


def make_policy(spec: PolicySpec) -> Policy:
    """The engine's policy for a spec: the canonical component composition
    (``repro_torch.sched.components``)."""
    from .components import compose_from_spec
    return compose_from_spec(spec)


def resolve_policy_arg(
    policy: "PolicySpec | str | Policy",
) -> Tuple[Optional[PolicySpec], Policy, Optional[str]]:
    """Resolve any policy argument to ``(spec, policy_object, ref)``.

    ``ref`` is a string that rebuilds an equivalent fresh policy later (the
    canonical grammar spelling or a registered composition name) — it is
    what session snapshots persist.  Raw :class:`Policy` instances resolve
    to ``ref=None`` unless their ``.name`` is a registered composition.
    """
    if isinstance(policy, Policy):
        from .components import registered_policies
        name = getattr(policy, "name", None)
        ref = name if name in registered_policies() else None
        return None, policy, ref
    if isinstance(policy, str):
        from .components import resolve_policy
        named = resolve_policy(policy)
        if named is not None:
            return None, named, policy
    spec = parse_policy(policy) if isinstance(policy, str) else policy
    return spec, make_policy(spec), spec.name


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class Engine:
    """Event-driven simulation of one (trace, policy, cluster-script) cell."""

    def __init__(
        self,
        specs: Sequence[JobSpec] | Trace,
        policy: PolicySpec | str | Policy,
        params: Optional[SimParams] = None,
        cluster_events: Sequence[ClusterEvent] = (),
        alloc_backend: Optional[object] = None,
    ):
        self.params = params or SimParams()
        # optional backend for the §4.6 reallocation: any object with
        # ``allocate(inc: CSRIncidence, cols, opt) -> yields``.  None = the
        # host numpy path.
        self.alloc_backend = alloc_backend
        self.policy_spec, self.policy, self.policy_ref = resolve_policy_arg(
            policy)
        if isinstance(specs, Trace):
            # array-native ingest: columns feed the SoA state directly
            self.state = EngineState.from_trace(specs, self.params.n_nodes)
        else:
            self.state = EngineState(
                sorted(specs, key=lambda s: (s.release, s.jid)),
                self.params.n_nodes,
            )
        self.cluster_events = sorted(cluster_events, key=lambda e: e.time)
        self.bytes_moved_gb = 0.0
        self.n_pmtn = 0
        self.n_mig = 0
        self._events = 0
        self.policy.validate(self.state.specs, self.params)
        self.policy.bind(self)

    # ------------------------------------------------------------------ #
    # state transitions (shared accounting)                               #
    # ------------------------------------------------------------------ #
    def _job_mem_gb(self, spec: JobSpec, n_tasks: Optional[int] = None) -> float:
        k = spec.n_tasks if n_tasks is None else n_tasks
        return k * spec.mem_req * self.params.node_mem_gb

    def pause(self, js: JobView) -> None:
        assert js.status == RUNNING
        self.state.pool.remove(js.spec, js.mapping)
        self.state.inc.remove(js.i, js.mapping)
        js.status = PAUSED
        js.mapping = None
        js.yld = 0.0
        js.n_pmtn += 1
        self.n_pmtn += 1
        self.bytes_moved_gb += self._job_mem_gb(js.spec)  # save image

    def start(self, js: JobView, mapping: List[int]) -> bool:
        assert js.status in (PENDING, PAUSED)
        st = self.state
        if not st.alive.all() and not all(st.alive[n] for n in mapping):
            # a target node died under the policy's feet: re-place on the
            # survivors instead of oversubscribing a dead node's zeroed
            # memory.  If nothing fits the job stays pending/paused and the
            # next scheduling event retries.
            mapping = greedy_place(st.pool.copy(), js.spec)
            if mapping is None:
                return False
        resume = js.status == PAUSED
        st.pool.place(js.spec, mapping)
        st.inc.place(js.i, mapping)
        js.status = RUNNING
        js.mapping = list(mapping)
        if resume:
            js.penalty_until = st.now + self.params.penalty
            self.bytes_moved_gb += self._job_mem_gb(js.spec)  # restore image
        return True

    def migrate_many(self, pairs: Sequence[Tuple[JobView, List[int]]]) -> None:
        """Transactionally migrate several running jobs: the new mappings are
        feasible *as a set* (computed against a pool copy), so all removals
        must happen before any placement."""
        moves = []
        degraded = not self.state.alive.all()
        for js, new_mapping in pairs:
            assert js.status == RUNNING
            if degraded and not all(self.state.alive[n] for n in new_mapping):
                continue    # target died mid-allocation: keep the old placement
            old = _node_multiset(js.mapping)
            new = _node_multiset(new_mapping)
            moved = js.spec.n_tasks - sum(
                min(old.get(n, 0), new.get(n, 0)) for n in old)
            moves.append((js, new_mapping, moved))
        for js, _, _ in moves:
            self.state.pool.remove(js.spec, js.mapping)
            self.state.inc.remove(js.i, js.mapping)
        for js, new_mapping, moved in moves:
            self.state.pool.place(js.spec, new_mapping)
            self.state.inc.place(js.i, new_mapping)
            js.mapping = list(new_mapping)
            if moved == 0:
                continue
            js.n_mig += 1
            self.n_mig += 1
            js.penalty_until = self.state.now + self.params.penalty
            self.bytes_moved_gb += 2.0 * self._job_mem_gb(js.spec, moved)

    def complete(self, js: JobView) -> None:
        self.state.pool.remove(js.spec, js.mapping)
        self.state.inc.remove(js.i, js.mapping)
        js.status = COMPLETED
        js.mapping = None
        js.yld = 0.0
        js.completed_at = self.state.now

    def cancel(self, js: JobView) -> None:
        """Withdraw a job at the current time.  Frees its nodes and drops it
        from every in-system mask (``S_CANCELLED > S_COMPLETED``); the job
        keeps ``completed_at = None`` and is excluded from all metrics."""
        st = self.state
        code = int(st.status[js.i])
        if code in (S_COMPLETED, S_CANCELLED):
            return
        if code != S_NOT_ARRIVED:
            self.policy.on_job_cancelled(js)
        if code == S_RUNNING:
            st.pool.remove(js.spec, js.mapping)
            st.inc.remove(js.i, js.mapping)
        st.set_status(js.i, S_CANCELLED)
        js.mapping = None
        js.yld = 0.0

    def resize(self, js: JobView, n_tasks: int) -> None:
        """Malleable grow/shrink of a job's task count.  A running job is
        preempted and re-placed at the new width by the next scheduling
        event.  Specs are memoized per trace and shared across engines, so
        the resized spec is a fresh object swapped into this state only."""
        st = self.state
        code = int(st.status[js.i])
        if code in (S_COMPLETED, S_CANCELLED):
            return
        n_tasks = max(1, min(int(n_tasks), self.params.n_nodes))
        if n_tasks == js.spec.n_tasks:
            return
        if code == S_RUNNING:
            self.pause(js)
        spec = dc_replace(js.spec, n_tasks=n_tasks)
        st.specs[js.i] = spec
        js.spec = spec
        st.set_demand(js.i, spec.n_tasks * spec.cpu_need)

    # ------------------------------------------------------------------ #
    # cluster (failure / elastic) events                                  #
    # ------------------------------------------------------------------ #
    def _apply_cluster_event(self, ev: ClusterEvent) -> None:
        st = self.state
        if ev.kind == "fail":
            for node in ev.nodes:
                if not st.alive[node]:
                    continue
                st.alive[node] = False
                # force-preempt every job with a task on the node
                for js in list(st.running()):
                    if node in (js.mapping or ()):
                        self.pause(js)
                # node can no longer host anything (0.0, not a negative
                # sentinel: NodePool.place validates global non-negativity)
                st.pool.mem_free[node] = 0.0
                st.pool.load[node] = np.inf
        elif ev.kind == "join":
            for node in ev.nodes:
                if st.alive[node]:
                    continue
                st.alive[node] = True
                st.pool.mem_free[node] = 1.0
                st.pool.load[node] = 0.0
        elif ev.kind in ("cancel", "resize"):
            jid_to_i = {s.jid: i for i, s in enumerate(st.specs)}
            for jid in ev.jids:
                i = jid_to_i.get(int(jid))
                if i is None:
                    continue    # unknown jid: tolerant, like dup fail/join
                if ev.kind == "cancel":
                    self.cancel(st.views[i])
                else:
                    self.resize(st.views[i], int(ev.value))
        else:
            raise ValueError(ev.kind)

    # ------------------------------------------------------------------ #
    # main loop                                                           #
    # ------------------------------------------------------------------ #
    def run(self) -> SimResult:
        """Open a :class:`repro_torch.sched.session.SimSession` on this
        engine, step it to exhaustion, finalize."""
        from .session import SimSession
        return SimSession.from_engine(self).run()

    # ------------------------------------------------------------------ #
    def _result(self, hit_cap: bool = False, partial: bool = False,
                sim_wall_s: float = 0.0, light: bool = False) -> SimResult:
        """Metrics over the completed jobs.  ``partial`` permits uncompleted
        jobs (a mid-run session result); a finished run still treats them as
        a deadlock unless the event cap truncated it.

        Under compaction the evicted rows live in ``st.retired``; the two
        populations are merged back in global-arrival (``gidx``) order, so
        every float accumulation below performs the identical operation
        sequence as the uncompacted single loop — bit-identical results.
        ``light`` skips materializing the O(jobs) per-job dicts (aggregates
        only, computed by the same ops) for bounded-memory long runs.
        """
        from .metrics import bounded_stretch

        p = self.params
        st = self.state
        completions: Dict[int, float] = {}
        stretches: Dict[int, float] = {}
        ret = st.retired
        if len(ret):
            order = np.argsort(ret.col("gidx"), kind="stable")
            r_gidx = ret.col("gidx")[order].tolist()
            r_jid = ret.col("jid")[order].tolist()
            r_rel = ret.col("release")[order].tolist()
            r_done = ret.col("completed_at")[order].tolist()
            r_pt = ret.col("proc_truth")[order].tolist()
            r_work = ret.col("work")[order].tolist()
        else:
            r_gidx = r_jid = r_rel = r_done = r_pt = r_work = []
        n_ret = len(r_gidx)
        specs = st.specs
        status = st.status
        pt_arr = st.proc_truth
        cat = st.completed_at
        live_gidx = st.gidx.tolist()
        svals: List[float] = []
        last = -np.inf                  # running max over completion times
        total_work = 0                  # int start, exactly like sum(genexp)
        ri = 0
        for i, s in enumerate(specs):
            g = live_gidx[i]
            while ri < n_ret and r_gidx[ri] < g:
                done = r_done[ri]
                if done == done:        # NaN marks cancelled (no metrics)
                    # stretch normalizes by the *executed* time
                    sv = bounded_stretch(done - r_rel[ri], r_pt[ri],
                                         p.stretch_tau)
                    if not light:
                        completions[r_jid[ri]] = done
                        stretches[r_jid[ri]] = sv
                    svals.append(sv)
                    if done > last:
                        last = done
                    total_work = total_work + r_work[ri]
                ri += 1
            if int(status[i]) == S_CANCELLED:
                continue                # withdrawn: never in the metrics
            c = cat[i]
            if np.isnan(c):
                if not (hit_cap or partial):
                    raise RuntimeError(
                        f"job {s.jid} never completed (deadlock?)")
                # partial run: report finished jobs, but the uncompleted
                # ones still carry executed work
                total_work = total_work + (
                    s.n_tasks * float(pt_arr[i]) * s.cpu_need)
                continue
            c = float(c)
            sv = bounded_stretch(c - s.release, float(pt_arr[i]),
                                 p.stretch_tau)
            if not light:
                completions[s.jid] = c
                stretches[s.jid] = sv
            svals.append(sv)
            if c > last:
                last = c
            # executed CPU-seconds — the same multiply order as
            # JobSpec.total_work
            total_work = total_work + s.n_tasks * float(pt_arr[i]) * s.cpu_need
        while ri < n_ret:
            done = r_done[ri]
            if done == done:
                sv = bounded_stretch(done - r_rel[ri], r_pt[ri], p.stretch_tau)
                if not light:
                    completions[r_jid[ri]] = done
                    stretches[r_jid[ri]] = sv
                svals.append(sv)
                if done > last:
                    last = done
                total_work = total_work + r_work[ri]
            ri += 1
        first = st.first_release if st.n_total else 0.0
        last = last if svals else 0.0
        makespan = max(0.0, last - first)
        hours = max(makespan / 3600.0, 1e-9)
        if not total_work:
            total_work = 1.0
        if self.policy_spec is not None:
            name = self.policy_spec.name
        else:
            name = (getattr(self.policy, "name", None)
                    or self.policy.__class__.__name__)
        return SimResult(
            policy=name,
            completions=completions,
            stretches=stretches,
            max_stretch=max(svals) if svals else 0.0,
            mean_stretch=float(np.mean(svals)) if svals else 0.0,
            n_pmtn=self.n_pmtn,
            n_mig=self.n_mig,
            pmtn_per_job=self.n_pmtn / max(1, st.n_total),
            mig_per_job=self.n_mig / max(1, st.n_total),
            pmtn_per_hour=self.n_pmtn / hours,
            mig_per_hour=self.n_mig / hours,
            bytes_moved_gb=self.bytes_moved_gb,
            bandwidth_gbps=self.bytes_moved_gb / max(makespan, 1e-9),
            underutilization=(st.demand_integral - st.util_integral) / total_work,
            makespan=makespan,
            events=self._events,
            hit_max_events=hit_cap,
            n_cancelled=int((st.status == S_CANCELLED).sum()) + ret.n_cancelled,
            final_time=st.now,
            sim_wall_s=sim_wall_s,
        )


def _node_multiset(mapping: Sequence[int]) -> Counter:
    return Counter(mapping)
