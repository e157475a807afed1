"""Streaming simulation sessions: the open step/ingest API.

The paper's premise is *online, non-clairvoyant* scheduling.
:class:`SimSession` exposes the engine's event loop as a resumable
session:

* :meth:`SimSession.submit` — true online arrivals: feed jobs (a
  ``Trace``, ``JobSpec`` list or declarative ``WorkloadSpec``) at any sim
  time, in any number of batches;
* :meth:`SimSession.stream` — feed an iterator of release-windowed chunks
  (``Trace.iter_chunks`` or the ``swf-stream`` kind), stepping between
  them; with ``SimParams.compact_interval`` set the engine state stays
  O(active);
* :meth:`SimSession.step_until` / :meth:`SimSession.step` — advance the
  simulation to a time bound or by an event count, observing live state
  between steps;
* :meth:`SimSession.inject` — live perturbations (node fail/join, cancel,
  resize, period changes) conditioned on *observed* session state;
* :meth:`SimSession.snapshot` / :meth:`SimSession.restore` — a
  serializable, fingerprinted :class:`SessionState` (the full SoA
  ``EngineState`` including the CSR incidence, the policy's internal
  state, and the session's own loop cursor) that resumes *bit-identically*
  in the same or a fresh process — and in either package: the payload and
  its fingerprint are those of the JAX package's sessions at the same
  event boundary;
* :meth:`SimSession.fork` — what-if branching: clone the live state
  mid-run, optionally under a *different* policy;
* :meth:`SimSession.result` — finalize partial or complete metrics.

Device: a session's §4.6 reallocations run on the card.  The entry points
(:func:`open_session`, :meth:`SimSession.restore`, :meth:`SimSession.fork`)
take ``device="cuda"`` unless the caller asks for ``"cpu"`` (the kernels'
plain versions); with no CUDA device the default raises.  An explicit
``alloc_backend=`` replaces the device backend — a lockstep lane of
``sweep.run_branches``, or ``"numpy"`` for the host numpy path.  The
backend is process-local plumbing, never snapshot state: the kernels are
bit-exact, so it does not change a result.

Bit-identity contract: ``step_until(t)`` never advances the engine clock
to ``t`` itself — it only processes the event timestamps ``<= t`` — so the
fluid-progress integrals see the identical sequence of ``advance()``
windows no matter where step boundaries fall, and ``Engine.run()`` (open →
step to exhaustion → result) gives the same result as any partition.

A chaos :class:`~repro_torch.sched.narrator.Narrator`
(:meth:`SimSession.attach_narrator`) and an online autotuner
(:meth:`SimSession.attach_autotuner`, :mod:`repro_torch.tune`) fire lazily
from the loop at the same partition-invariant boundary, and their state
rides snapshots under the optional ``narrator`` / ``autotune`` keys.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import math
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.alloc_torch import TorchAllocBackend
from ..core.job import JobSpec
from ..core.state import (S_CANCELLED, S_COMPLETED, S_NOT_ARRIVED, S_PAUSED,
                          S_PENDING, EngineState, RetiredLog)
from ..workloads.trace import Trace, as_trace
from .cluster import ClusterEvent
from .engine import (_EPS, BatchPolicy, DFRSPolicy, Engine, Policy,
                     SimParams, SimResult, resolve_policy_arg)
from .narrator import Narrator

__all__ = ["SimSession", "SessionState", "open_session", "SCHEMA",
           "SNAPSHOT_VERSION", "HOST_NUMPY"]

SCHEMA = "repro.session/v1"

#: payload-shape version within the schema (the JAX package's numbering).
#: Version 3 carries the compaction keys (``gidx``/``n_total``/
#: ``first_release``/``retired``); v1/v2 snapshots restore with an empty
#: retired log and ``gidx = arange(n)`` (their state was never compacted).
SNAPSHOT_VERSION = 3
_SUPPORTED_VERSIONS = (1, 2, 3)

#: keys every supported payload version carries
_REQUIRED_KEYS = frozenset({
    "params", "policy", "jobs", "vt", "yld", "penalty_until",
    "completed_at", "status", "job_pmtn", "job_mig", "mappings",
    "pool_load", "pool_mem_free", "alive", "now", "util_integral",
    "demand_integral", "bytes_moved_gb", "n_pmtn", "n_mig", "events",
    "arrivals", "cluster_events", "next_tick", "tick_armed", "horizon",
    "exhausted", "hit_cap", "wall_s", "policy_state",
})

_JOB_COLS = ("jid", "release", "proc_time", "n_tasks", "cpu_need", "mem_req")

#: ``alloc_backend`` value selecting the host numpy allocation path
HOST_NUMPY = "numpy"

def _engine_backend(device, alloc_backend):
    """The engine's §4.6 backend: ``alloc_backend`` when given (``"numpy"``
    = the host numpy path), else a :class:`TorchAllocBackend` on
    ``device`` (which raises for ``"cuda"`` without a card)."""
    if alloc_backend is None:
        return TorchAllocBackend(device=device)
    if isinstance(alloc_backend, str):
        if alloc_backend != HOST_NUMPY:
            raise ValueError(f"unknown alloc_backend {alloc_backend!r}; "
                             f"pass an allocator or {HOST_NUMPY!r}")
        return None
    return alloc_backend


# --------------------------------------------------------------------------- #
# snapshots                                                                    #
# --------------------------------------------------------------------------- #
class SessionState:
    """Serializable snapshot of a :class:`SimSession` at one event boundary.

    Wraps a JSON-able payload (exact float round-trips via ``repr``;
    ``Infinity``/``NaN`` use the ``json`` module's standard extensions).
    ``fingerprint`` is a SHA-256 over the canonical payload text — two
    snapshots with equal fingerprints resume into bit-identical sessions.
    """

    __slots__ = ("payload", "_fingerprint")

    def __init__(self, payload: Dict[str, Any]):
        if payload.get("schema") != SCHEMA:
            raise ValueError(f"not a {SCHEMA} snapshot "
                             f"(schema: {payload.get('schema')!r})")
        self.payload = payload
        self._fingerprint: Optional[str] = None

    @property
    def fingerprint(self) -> str:
        fp = self._fingerprint
        if fp is None:
            canon = json.dumps(self.payload, sort_keys=True)
            fp = hashlib.sha256(canon.encode()).hexdigest()
            self._fingerprint = fp
        return fp

    @property
    def time(self) -> float:
        """Engine clock at snapshot time."""
        return float(self.payload["now"])

    @property
    def policy(self) -> Optional[str]:
        """Rebuildable policy reference (grammar/registered spelling)."""
        return self.payload["policy"]

    @property
    def n_jobs(self) -> int:
        return len(self.payload["jobs"]["jid"])

    def __repr__(self) -> str:
        return (f"SessionState(t={self.time:.6g}, n_jobs={self.n_jobs}, "
                f"policy={self.policy!r}, fingerprint={self.fingerprint[:12]}…)")

    def to_json_dict(self) -> Dict[str, Any]:
        return {"fingerprint": self.fingerprint, **self.payload}

    @classmethod
    def from_json_dict(cls, payload: Dict[str, Any]) -> "SessionState":
        payload = dict(payload)
        want = payload.pop("fingerprint", None)
        snap = cls(payload)
        if want is not None and want != snap.fingerprint:
            raise ValueError("session snapshot fingerprint mismatch after "
                             "round-trip (corrupted payload?)")
        return snap

    def save(self, path: str) -> str:
        from ..core.ioutil import atomic_write_json
        return atomic_write_json(path, self.to_json_dict(), indent=None)

    @classmethod
    def load(cls, path: str) -> "SessionState":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))


# --------------------------------------------------------------------------- #
# policy-state capture                                                         #
#                                                                              #
# Policies keep private scheduling state (the batch FIFO queue / free-node     #
# heap, the stretch-pass yield flag).  Snapshots persist it exactly; what-if   #
# forks that *switch* policy instead rebuild a fresh state from the live       #
# engine.  Custom policies/components opt in via snapshot_state() /            #
# restore_state(payload, engine) (and adopt_state(engine) for switches).       #
# --------------------------------------------------------------------------- #
def _snapshot_policy_state(pol: Policy) -> Dict[str, Any]:
    from .components import ComposedPolicy, _BatchState, batch_state_payload

    if hasattr(pol, "snapshot_state"):
        return {"kind": "custom", "payload": pol.snapshot_state()}
    if isinstance(pol, ComposedPolicy):
        shared: Dict[str, Any] = {}
        for k, v in pol.shared.items():
            if isinstance(v, _BatchState):
                shared[k] = {"__batch__": batch_state_payload(v)}
            elif v is None or isinstance(v, (bool, int, float, str)):
                shared[k] = v
            else:
                raise TypeError(
                    f"policy shared state {k!r} ({type(v).__name__}) is not "
                    f"snapshottable; give the owning component "
                    f"snapshot_state()/restore_state()")
        comps: Dict[str, Any] = {}
        for idx, c in enumerate(pol.components):
            if hasattr(c, "snapshot_state"):
                comps[str(idx)] = c.snapshot_state()
        return {"kind": "composed", "shared": shared, "components": comps}
    if isinstance(pol, BatchPolicy):
        return {
            "kind": "batch-seed",
            "queue": [js.i for js in pol.queue],
            "free": list(pol.free),
            "running": [list(r) for r in pol.running],
            "dirty": pol._dirty,
        }
    if isinstance(pol, DFRSPolicy):
        return {"kind": "dfrs-seed",
                "stretch_yields_set": pol._stretch_yields_set}
    raise TypeError(
        f"policy {pol!r} is not snapshottable; implement "
        f"snapshot_state()/restore_state(payload, engine)")


def _restore_policy_state(pol: Policy, payload: Dict[str, Any],
                          engine: Engine) -> None:
    from .components import ComposedPolicy, batch_state_from_payload

    kind = payload["kind"]
    st = engine.state
    if kind == "custom":
        pol.restore_state(payload["payload"], engine)
        return
    if kind == "composed":
        assert isinstance(pol, ComposedPolicy)
        for k, v in payload["shared"].items():
            if isinstance(v, dict) and "__batch__" in v:
                pol.shared[k] = batch_state_from_payload(
                    v["__batch__"], st.views, engine.params.n_nodes)
            else:
                pol.shared[k] = v
        for idx, cp in payload["components"].items():
            pol.components[int(idx)].restore_state(cp, engine)
        return
    if kind in ("batch-seed", "dfrs-seed"):
        # (the reference asserts here; a composed policy is a caller's
        # error worth a message)
        seed_cls = BatchPolicy if kind == "batch-seed" else DFRSPolicy
        if not isinstance(pol, seed_cls):
            raise ValueError(
                f"the snapshot's policy state is a monolithic seed "
                f"policy's ({kind!r}), which only a {seed_cls.__name__} "
                f"takes; fork it with policy= set to the composed spelling")
    if kind == "batch-seed":
        pol.queue = deque(st.views[int(i)] for i in payload["queue"])
        pol.free = [int(n) for n in payload["free"]]
        pol.running = [(float(e), int(j), int(n))
                       for e, j, n in payload["running"]]
        pol._dirty = bool(payload["dirty"])
        return
    if kind == "dfrs-seed":
        pol._stretch_yields_set = bool(payload["stretch_yields_set"])
        return
    raise ValueError(f"unknown policy-state kind {kind!r}")


def _adopt_policy_state(pol: Policy, engine: Engine) -> None:
    """Rebuild a freshly-bound policy's internal state from the *live*
    engine state — the what-if fork path, where the restored session runs a
    different policy than the one that produced the snapshot.

    §4 DFRS compositions are stateless between events, so nothing needs
    rebuilding.  Batch-queue compositions get a reconstructed queue state:
    waiting (pending/paused) jobs queue FIFO by ``(release, jid)``; running
    jobs that hold whole nodes exclusively are adopted as batch-started
    (yield pinned to 1, completion estimated at ``now + remaining_vt``);
    co-located fractional jobs go through the fractional-backfill
    bookkeeping, so their nodes return to the free pool only when they
    drain.
    """
    from .components import ComposedPolicy, _BatchState

    if hasattr(pol, "adopt_state"):
        pol.adopt_state(engine)
        return
    if isinstance(pol, DFRSPolicy):
        return
    if isinstance(pol, ComposedPolicy):
        if not any(c.kind == "submit" and c.component_name == "fcfs-queue"
                   for c in pol.components):
            return                      # DFRS composition: event-driven only
        st = engine.state
        n_nodes = engine.params.n_nodes
        bs = _BatchState(n_nodes)
        waiting = sorted(
            (st.views[i] for i in st.in_system_indices()
             if int(st.status[i]) in (S_PENDING, S_PAUSED)),
            key=lambda js: (js.spec.release, js.spec.jid))
        bs.queue = deque(waiting)
        occupied = {n for n in range(n_nodes) if st.inc.rows[n]}
        bs.free = [n for n in range(n_nodes)
                   if n not in occupied and st.alive[n]]
        heapq.heapify(bs.free)
        now = st.now
        for js in st.running():
            nodes = set(js.mapping)
            exclusive = (len(nodes) == js.spec.n_tasks
                         and all(len(st.inc.rows[n]) == 1 for n in nodes))
            if exclusive:
                bs.running.append((now + max(js.remaining_vt(), 0.0),
                                   js.spec.jid, js.spec.n_tasks))
                for n in nodes:
                    bs.excl_owner[n] = js.spec.jid
                js.yld = 1.0            # batch semantics: dedicated nodes
            else:
                bs.frac_jobs[js.spec.jid] = list(js.mapping)
                for n in js.mapping:
                    bs.frac_count[n] += 1
        bs.dirty = True                 # drain the queue at the next event
        pol.shared["batch"] = bs
        return
    raise TypeError(
        f"cannot adopt live state into policy {pol!r}; implement "
        f"adopt_state(engine) (seed BatchPolicy is oracle-only — fork onto "
        f"the composed spelling instead)")


# --------------------------------------------------------------------------- #
# the session                                                                  #
# --------------------------------------------------------------------------- #
class SimSession:
    """A resumable simulation: the engine's event loop as an open API.

    Build one with :func:`open_session` (empty cluster, submit jobs
    online) or :meth:`from_engine` (adopt a fully-constructed
    :class:`Engine` — what ``Engine.run()`` does).  All stepping entry
    points share one loop implementation, so results never depend on how
    the run was partitioned.
    """

    # -- construction -------------------------------------------------------
    def __init__(
        self,
        policy,
        params: Optional[SimParams] = None,
        *,
        cluster_events: Sequence[ClusterEvent] = (),
        device="cuda",
        alloc_backend=None,
        **param_overrides: Any,
    ):
        backend = _engine_backend(device, alloc_backend)
        if params is None:
            params = SimParams(**param_overrides)
        else:
            params = dataclasses.replace(params, **param_overrides)
        self._init_from_engine(Engine((), policy, params, cluster_events,
                                      alloc_backend=backend))

    @classmethod
    def from_engine(cls, engine: Engine) -> "SimSession":
        """Adopt a constructed engine (its not-yet-arrived jobs become the
        session's arrival stream; the closed-world ``Engine.run()`` path)."""
        ses = cls.__new__(cls)
        ses._init_from_engine(engine)
        return ses

    def _init_from_engine(self, engine: Engine) -> None:
        self.engine = engine
        st = engine.state
        pol = engine.policy
        self._arrivals: List[Tuple[float, int, int]] = [
            (s.release, s.jid, i) for i, s in enumerate(st.specs)
            if int(st.status[i]) == S_NOT_ARRIVED
        ]
        heapq.heapify(self._arrivals)
        self._jids = {s.jid for s in st.specs}
        self._cev: List[ClusterEvent] = (
            list(engine.cluster_events) if pol.handles_cluster_events else [])
        self._ci = 0
        self._periodic = pol.periodic_kind is not None
        self._next_tick = math.inf
        self._tick_armed = False
        if self._periodic and self._arrivals:
            self._next_tick = self._arrivals[0][0] + engine.params.period
            self._tick_armed = True
        self._exhausted = False
        self._hit_cap = False
        self._horizon = st.now
        self._wall = 0.0
        #: True while a stream() call still holds future chunks: the tick
        #: train and narrator stay armed through inter-chunk gaps exactly as
        #: they would with the whole trace submitted upfront
        self._stream_pending = False
        self._narrator: Optional[Narrator] = None
        #: optional repro_torch.tune.AutoTuner driven from the stepping loop
        self._tuner = None
        self._closed = False
        self._close_hooks: List[Any] = []
        #: ephemeral caller scratchpad; deliberately NOT part of snapshots
        self.scratch: Dict[str, Any] = {}

    # -- lifecycle ----------------------------------------------------------
    @property
    def closed(self) -> bool:
        """True once :meth:`close` has run; mutating entry points then
        raise, read-only ones (``observe``/``result``) keep working."""
        return self._closed

    def add_close_hook(self, callback) -> None:
        """Register ``callback(session)`` to run exactly once at
        :meth:`close` (hooks registered after close run immediately)."""
        if self._closed:
            callback(self)
            return
        self._close_hooks.append(callback)

    def close(self) -> None:
        """Idempotent close: mark the session finished and run the close
        hooks (each exactly once).  Further ``submit``/``step``/``inject``/
        ``snapshot`` calls raise ``ValueError``; ``observe()`` and
        ``result()`` stay readable."""
        if self._closed:
            return
        self._closed = True
        hooks, self._close_hooks = self._close_hooks, []
        first_err: Optional[BaseException] = None
        for cb in hooks:            # run every hook even if one raises
            try:
                cb(self)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                if first_err is None:
                    first_err = exc
        if first_err is not None:
            raise first_err

    def __enter__(self) -> "SimSession":
        self._require_open("enter a context with")
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def _require_open(self, what: str) -> None:
        if self._closed:
            raise ValueError(f"session is closed; cannot {what} it")

    # -- introspection ------------------------------------------------------
    @property
    def now(self) -> float:
        """Session clock: the engine clock or the last ``step_until``
        target, whichever is later."""
        return max(self.engine.state.now, self._horizon)

    @property
    def n_events(self) -> int:
        return self.engine._events

    @property
    def exhausted(self) -> bool:
        """No future event exists (until new jobs/events are submitted)."""
        return self._exhausted

    @property
    def handles_cluster_events(self) -> bool:
        return self.engine.policy.handles_cluster_events

    @property
    def policy_name(self) -> str:
        e = self.engine
        if e.policy_spec is not None:
            return e.policy_spec.name
        return (getattr(e.policy, "name", None)
                or e.policy.__class__.__name__)

    def next_event_time(self) -> float:
        """Peek the next event timestamp (``inf`` when nothing is left).
        Pure: a peek is not an engine event and never perturbs the run."""
        st = self.engine.state
        t_arr = self._arrivals[0][0] if self._arrivals else math.inf
        t_cev = (self._cev[self._ci].time
                 if self._ci < len(self._cev) else math.inf)
        t_tick = (self._next_tick
                  if (self._periodic
                      and (st.any_in_system() or self._arrivals
                           or self._stream_pending))
                  else math.inf)
        return min(t_arr, st.next_completion_time(), t_tick, t_cev)

    def observe(self) -> Dict[str, Any]:
        """Scheduler-visible live state (what reactive callers see between
        steps)."""
        st = self.engine.state
        status = st.status
        ret = st.retired
        run = st.running_indices()
        alive = float(st.alive.sum())
        util = float((st.yld[run] * st.demand[run]).sum())
        return {
            "t": self.now,
            "engine_t": st.now,
            "events": self.engine._events,
            "n_future": len(self._arrivals),
            "n_pending": int((status == S_PENDING).sum()),
            "n_running": int(run.size),
            "n_paused": int((status == S_PAUSED).sum()),
            "n_completed": int((status == S_COMPLETED).sum())
                           + ret.n_completed,
            "queue_depth": int(((status == S_PENDING)
                                | (status == S_PAUSED)).sum()),
            "n_cancelled": int((status == S_CANCELLED).sum())
                           + ret.n_cancelled,
            # jobs whose executed (truth) time diverges from the estimate
            # policies observe
            "n_noisy": int((st.proc_truth != st.proc_time).sum())
                       + ret.n_noisy,
            "alive_nodes": int(alive),
            "utilization": util / max(alive, 1e-9),
            "n_pmtn": self.engine.n_pmtn,
            "n_mig": self.engine.n_mig,
            "bytes_moved_gb": self.engine.bytes_moved_gb,
            "exhausted": self._exhausted,
        }

    # -- online ingest ------------------------------------------------------
    def submit(self, jobs: Union[Trace, Sequence[JobSpec], Any],
               *, shift: Union[None, float, str] = None) -> List[int]:
        """Feed jobs into the running simulation (true online arrivals).

        ``jobs`` is a :class:`Trace`, a ``JobSpec`` sequence, or a
        declarative ``WorkloadSpec`` (materialized via the registry).
        ``shift`` offsets every release time: a float adds seconds,
        ``"now"`` aligns the batch's first release with the session clock.
        Releases must not predate the engine clock (history is immutable);
        job ids must be globally unique within the session.  Returns the
        dense engine indices assigned to the new jobs.
        """
        self._require_open("submit jobs into")
        from ..workloads.registry import WorkloadSpec, make_trace_ir
        if isinstance(jobs, WorkloadSpec):
            trace = make_trace_ir(jobs)
        else:
            trace = as_trace(jobs)
        if len(trace) and shift is not None:
            if shift == "now":
                delta = self.now - float(trace.release.min())
            else:
                delta = float(shift)
            trace = trace.replace(release=trace.release + delta)
        specs = trace.sorted_by_release().to_specs()
        if not specs:
            return []
        st = self.engine.state
        if specs[0].release < st.now - _EPS:
            raise ValueError(
                f"job {specs[0].jid} released at t={specs[0].release:.6g} "
                f"but the engine clock is already at {st.now:.6g}; pass "
                f"shift='now' (or a float offset) to submit live")
        jids = [s.jid for s in specs]
        # live jids are a set; compacted-away jids live in the retired log
        # (sorted array + searchsorted), so the dup check stays O(batch)
        dup = self._jids.intersection(jids)
        if not dup:
            dup = set(st.retired.contains(jids))
        if dup or len(set(jids)) != len(jids):
            dup = sorted(dup) or "within the batch"
            raise ValueError(f"duplicate job ids {dup}; session job ids "
                             f"must be unique")
        self.engine.policy.validate(specs, self.engine.params)
        idx = st.extend(specs)
        for i, s in zip(idx, specs):
            heapq.heappush(self._arrivals, (s.release, s.jid, i))
            self._jids.add(s.jid)
        if self._periodic and not self._tick_armed:
            # mirror the closed-world loop: the tick train starts one
            # period after the first release the session ever saw
            self._next_tick = specs[0].release + self.engine.params.period
            self._tick_armed = True
        if self._narrator is not None:
            self._narrator.on_submitted(self, idx)
        self._exhausted = False         # new future work re-arms the loop
        return idx

    def inject(self, event: Union[ClusterEvent, Dict[str, Any]]) -> None:
        """Schedule a live perturbation.

        ``event`` is a :class:`ClusterEvent` (or a dict like
        ``{"kind": "fail", "t": 1200, "nodes": [0, 1]}``); ``kind``
        ``"period"`` with a ``"period"`` value changes the periodic-pass
        period immediately instead.  Fail/join/cancel/resize events are
        processed by the stepping loop at their timestamp (which must not
        predate the engine clock) exactly like a pre-scripted event.
        """
        self._require_open("inject events into")
        if isinstance(event, dict):
            kind = event.get("kind")
            if kind == "period":
                self.set_period(event["period"])
                return
            jids = event.get("jids")
            if jids is None:
                jids = [event["jid"]] if "jid" in event else ()
            value = event.get("value", event.get("n_tasks"))
            event = ClusterEvent(
                time=float(event.get("t", event.get("time", self.now))),
                kind=kind,
                nodes=tuple(int(n) for n in event.get("nodes", ())),
                jids=tuple(int(j) for j in jids),
                value=None if value is None else float(value),
            )
        if not self.engine.policy.handles_cluster_events:
            raise ValueError(
                f"policy {self.policy_name!r} does not handle cluster "
                f"events (batch baselines do not model failures)")
        st = self.engine.state
        if event.time < st.now - _EPS:
            raise ValueError(
                f"cannot inject an event at t={event.time:.6g}: the engine "
                f"clock is already at {st.now:.6g}")
        bad = [n for n in event.nodes
               if not (0 <= n < self.engine.params.n_nodes)]
        if bad:
            raise ValueError(f"nodes {bad} outside the "
                             f"{self.engine.params.n_nodes}-node cluster")
        # contradiction checks against the *projected* state (everything
        # already pending at event.time applied): a duplicate fail/join or
        # a double cancel would silently corrupt incidence/pool accounting
        if event.kind in ("fail", "join"):
            alive = self._projected_alive(event.time)
            for n in event.nodes:
                if event.kind == "fail" and not alive[n]:
                    raise ValueError(
                        f"node {n} is already dead at t={event.time:.6g}; "
                        f"injecting a duplicate 'fail' would corrupt "
                        f"incidence state")
                if event.kind == "join" and alive[n]:
                    raise ValueError(
                        f"node {n} is already alive at t={event.time:.6g}; "
                        f"injecting a duplicate 'join' would corrupt "
                        f"incidence state")
                alive[n] = event.kind == "join"     # within-event dups too
        elif event.kind in ("cancel", "resize"):
            jid_to_i = {s.jid: i for i, s in enumerate(st.specs)}
            pending = self._pending_cancels(event.time)
            for jid in event.jids:
                i = jid_to_i.get(int(jid))
                if i is None:
                    raise ValueError(
                        f"unknown job id {jid} at t={event.time:.6g}; "
                        f"known jobs only can be {event.kind}ed")
                code = int(st.status[i])
                if code == S_COMPLETED:
                    raise ValueError(
                        f"job {jid} already completed; cannot {event.kind} "
                        f"it at t={event.time:.6g}")
                if code == S_CANCELLED or int(jid) in pending:
                    raise ValueError(
                        f"job {jid} is already cancelled at "
                        f"t={event.time:.6g}; duplicate '{event.kind}' "
                        f"rejected")
        # keep the pending suffix time-sorted (stable after equal times)
        pos = self._ci
        while pos < len(self._cev) and self._cev[pos].time <= event.time:
            pos += 1
        self._cev.insert(pos, event)
        self._exhausted = False

    def set_period(self, period: float) -> None:
        """Change the periodic-pass period live (takes effect from the next
        tick; no-op for compositions without a periodic component).

        The engine's ``SimParams`` is *replaced*, never mutated in place,
        so a params object shared with other engines never sees the change
        and a snapshot carries exactly the period this session runs.
        """
        self._require_open("change the period of")
        period = float(period)
        if period <= 0:
            raise ValueError("period must be > 0")
        self.engine.params = dataclasses.replace(self.engine.params,
                                                 period=period)

    def attach_narrator(self, narrator: Narrator) -> None:
        """Attach a chaos :class:`~repro_torch.sched.narrator.Narrator`: its
        streams fire lazily as the loop advances and ride along in
        snapshots (bit-exact RNG round-trip).  Attach before submitting so
        truth-noise streams see every job."""
        self._require_open("attach a narrator to")
        if (narrator.needs_cluster_events()
                and not self.engine.policy.handles_cluster_events):
            raise ValueError(
                f"policy {self.policy_name!r} does not handle cluster "
                f"events; only truth-noise narrator streams work under "
                f"batch baselines")
        self._narrator = narrator
        self._exhausted = False         # a new event source re-arms the loop

    @property
    def narrator(self) -> Optional[Narrator]:
        return self._narrator

    def switch_policy(self, policy) -> None:
        """Hot-swap the scheduling policy in place, mid-run.

        The live engine state is untouched; the new policy rebuilds its
        private state from it exactly like a what-if fork
        (``restore(snap, policy=...)``) would — the promotion primitive of
        :mod:`repro_torch.tune`.  Refused for policies that do not handle
        cluster events while the session still needs them (an attached
        chaos narrator, pending injected events, or dead nodes).
        """
        self._require_open("switch the policy of")
        e = self.engine
        st = e.state
        spec, pol, ref = resolve_policy_arg(policy)
        if not pol.handles_cluster_events:
            if (self._narrator is not None
                    and self._narrator.needs_cluster_events()):
                raise ValueError(
                    f"cannot switch to {policy!r}: it does not handle "
                    f"cluster events but the attached narrator injects them")
            if self._ci < len(self._cev):
                raise ValueError(
                    f"cannot switch to {policy!r}: it does not handle "
                    f"cluster events and "
                    f"{len(self._cev) - self._ci} are still pending")
            if not bool(st.alive.all()):
                raise ValueError(
                    f"cannot switch to {policy!r}: it does not handle "
                    f"cluster events and the cluster has dead nodes")
            self._cev = []
            self._ci = 0
        pol.validate(st.specs, e.params)
        e.policy_spec, e.policy, e.policy_ref = spec, pol, ref
        pol.bind(e)
        _adopt_policy_state(pol, e)
        self._periodic = pol.periodic_kind is not None
        if not self._periodic:
            self._next_tick = math.inf
        elif math.isinf(self._next_tick):
            # the swap introduced a periodic pass mid-run: base its tick
            # train at the live clock (the fork path does the same)
            self._next_tick = st.now + e.params.period
            self._tick_armed = True
        self._exhausted = False         # the new policy may act again

    def attach_autotuner(self, tuner) -> None:
        """Attach a :class:`repro_torch.tune.AutoTuner`: it fires lazily
        from the stepping loop like the narrator — fork, race, maybe
        promote — and its full state (RNG, schedule, decision log) rides
        along in snapshots bit-exactly.  Its races run where this session
        allocates (see :class:`~repro_torch.tune.TuneConfig`)."""
        self._require_open("attach an autotuner to")
        if self.engine.policy_ref is None:
            raise ValueError(
                "session policy has no rebuildable reference (ad-hoc "
                "Policy instance); the tuner could not race or restore it")
        self._tuner = tuner
        self._exhausted = False         # tuner peeks re-arm the loop

    @property
    def autotuner(self):
        return self._tuner

    # -- projected state (pending injections applied) -----------------------
    def _projected_alive(self, t: Optional[float] = None) -> np.ndarray:
        """Node liveness once the pending event suffix up to ``t`` (engine
        clock order; ``None`` = all pending) has been applied."""
        alive = self.engine.state.alive.copy()
        for ev in self._cev[self._ci:]:
            if t is not None and ev.time > t + _EPS:
                break
            if ev.kind == "fail":
                alive[list(ev.nodes)] = False
            elif ev.kind == "join":
                alive[list(ev.nodes)] = True
        return alive

    def _pending_cancels(self, t: Optional[float] = None) -> set:
        """Job ids with a cancellation pending in the event suffix."""
        out: set = set()
        for ev in self._cev[self._ci:]:
            if t is not None and ev.time > t + _EPS:
                break
            if ev.kind == "cancel":
                out.update(int(j) for j in ev.jids)
        return out

    # -- stepping -----------------------------------------------------------
    def _loop(self, until: float = math.inf,
              max_steps: Optional[int] = None,
              exclusive: bool = False) -> int:
        """The one event loop behind every stepping entry point.

        Processes event timestamps while they are ``<= until`` (boundary
        peeks are side-effect-free: they do not count as engine events) and
        while fewer than ``max_steps`` timestamps have been handled.  Per
        timestamp: job completions, cluster events, arrivals, the periodic
        tick, then the policy's ``finalize`` — the order every result in
        this package is defined by.

        ``exclusive`` processes timestamps strictly ``< until`` — the
        stream() call's bound: the timestamp at a chunk's first release
        must be handled in ONE iteration *after* that chunk is submitted,
        exactly as it would be with the whole trace submitted upfront.  An
        ``inf`` horizon is then also a boundary peek (more chunks are
        coming), never exhaustion.
        """
        e = self.engine
        p = e.params
        st = e.state
        pol = e.policy
        cev = self._cev
        periodic = self._periodic
        compact_every = p.compact_interval
        steps = 0
        t0 = time.perf_counter()
        try:
            while not self._exhausted:
                if max_steps is not None and steps >= max_steps:
                    break
                heap = self._arrivals       # compaction rebuilds the list
                t_arr = heap[0][0] if heap else math.inf
                t_cev = cev[self._ci].time if self._ci < len(cev) else math.inf
                t_done = st.next_completion_time()
                live = st.any_in_system()
                armed = live or heap or self._stream_pending
                t_tick = (self._next_tick
                          if (periodic and armed) else math.inf)
                t_next = min(t_arr, t_done, t_tick, t_cev)
                # narrator streams fire lazily, never past the next engine
                # event or the step bound (a fire injects into the pending
                # suffix, so the injected timestamps process right below);
                # gated on (live or heap) like the tick so a drained
                # session still exhausts
                nar = self._narrator
                if nar is not None and armed:
                    while True:
                        t_nar = nar.peek(self)
                        if not (t_nar <= t_next
                                and (t_nar < until if exclusive
                                     else t_nar <= until)):
                            break
                        nar.fire(self)
                        t_cev = (cev[self._ci].time
                                 if self._ci < len(cev) else math.inf)
                        t_next = min(t_next, t_cev)
                    if math.isinf(t_next) and math.isfinite(nar.peek(self)):
                        break           # chaos pending beyond the step
                                        # bound — a peek, not an event
                # the autotuner fires at the same lazy boundary: when its
                # scheduled time is due before the next engine event AND
                # inside the step bound — so the fire point (and therefore
                # the race snapshot and the decision log) is identical no
                # matter how the run is partitioned into step() calls.  A
                # fire is not an engine event; a promotion invalidates the
                # cached loop locals, so restart the iteration.
                tun = self._tuner
                if tun is not None and armed and not math.isinf(t_next):
                    swapped = False
                    while True:
                        t_tun = tun.peek(self)
                        if not (t_tun <= t_next
                                and (t_tun < until if exclusive
                                     else t_tun <= until)):
                            break
                        if tun.fire(self):
                            swapped = True
                            break
                    if swapped:
                        pol = e.policy
                        p = e.params
                        periodic = self._periodic
                        cev = self._cev
                        compact_every = p.compact_interval
                        continue
                if exclusive and (math.isinf(t_next) or t_next >= until):
                    break               # stream-window boundary peek — the
                                        # next chunk arrives before t_next
                if t_next > until and not math.isinf(t_next):
                    break               # boundary peek — not an engine event
                e._events += 1
                if e._events > p.max_events:
                    e._events = p.max_events
                    if p.on_max_events == "truncate":
                        self._hit_cap = True
                        self._exhausted = True
                        break
                    n_done = (int((st.status == S_COMPLETED).sum())
                              + st.retired.n_completed)
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
                if compact_every and st.n_retired_rows >= compact_every:
                    self._compact()
        finally:
            self._wall += time.perf_counter() - t0
        return steps

    def step_until(self, t: float) -> float:
        """Process every event timestamp ``<= t`` (inclusive); the session
        clock then reads ``t``.  Returns the new session clock."""
        self._require_open("step")
        t = float(t)
        self._loop(until=t)
        self._horizon = max(self._horizon, t, self.engine.state.now)
        return self.now

    def step(self, n_events: int = 1, *, until: float = math.inf) -> int:
        """Process up to ``n_events`` event timestamps; returns how many
        were actually processed (0 when the run is exhausted).  ``until``
        additionally bounds the processed timestamps (inclusive, like
        :meth:`step_until`)."""
        self._require_open("step")
        if n_events < 1:
            raise ValueError("n_events must be >= 1")
        steps = self._loop(until=float(until), max_steps=int(n_events))
        self._horizon = max(self._horizon, self.engine.state.now)
        return steps

    def run_to_exhaustion(self) -> "SimSession":
        """Step until no future event exists.  With
        ``SimParams.compact_interval`` set, a trailing compaction evicts
        the finished rows left since the last trigger."""
        self._require_open("step")
        self._loop()
        self._horizon = max(self._horizon, self.engine.state.now)
        if self.engine.params.compact_interval and self.engine.state.n_retired_rows:
            self._compact()
        return self

    def run(self) -> SimResult:
        """Step to exhaustion and finalize (the ``Engine.run()`` contract)."""
        self.run_to_exhaustion()
        return self.result()

    # -- streaming ingest ---------------------------------------------------
    def stream(self, chunks, *, run_to_exhaustion: bool = True
               ) -> "SimSession":
        """Feed an iterator of release-windowed :class:`Trace` chunks as
        true online arrivals, stepping the simulation between windows.

        At most one future window is materialized at any time, and with
        ``SimParams.compact_interval`` set the engine state stays O(active)
        too.  Chunks must be release-disjoint and non-decreasing (every
        release in chunk k+1 is ``>=`` every release in chunk k), which any
        ``iter_chunks`` window partition satisfies.

        Bit-identity: between submits the loop runs with an *exclusive*
        bound at the next chunk's first release, so that timestamp is
        processed in one event iteration after its chunk is submitted —
        the run is indistinguishable from submitting the whole trace
        upfront, event count included.
        """
        self._require_open("stream into")
        it = iter(chunks)
        cur: Optional[Trace] = None
        try:
            for nxt in it:
                if not len(nxt):
                    continue
                if cur is None:
                    cur = nxt
                    continue
                self._stream_pending = True
                self.submit(cur)
                bound = float(nxt.release.min())
                self._loop(until=bound, exclusive=True)
                self._horizon = max(self._horizon, self.engine.state.now)
                cur = nxt
        finally:
            self._stream_pending = False
        if cur is not None:
            self.submit(cur)
        if run_to_exhaustion:
            self.run_to_exhaustion()
        return self

    # -- compaction ---------------------------------------------------------
    def compact(self) -> int:
        """Evict COMPLETED/CANCELLED rows from the engine state now (see
        ``EngineState.compact``); with ``SimParams.compact_interval`` set
        the loop does this automatically.  Returns rows evicted."""
        self._require_open("compact")
        return self._compact()

    def _compact(self) -> int:
        st = self.engine.state
        # rows with a pending arrival-heap entry must survive: a job
        # cancelled before it ever arrived still produces its (skipped)
        # arrival event, and dropping it would change the event count
        protect = [i for (_, _, i) in self._arrivals]
        n0 = len(st.retired)
        new_of_old = st.compact(protect=protect)
        if new_of_old is None:
            return 0
        # remap the arrival heap in place: (release, jid) keys are unique
        # per session, so the index never participates in heap ordering
        self._arrivals = [(r, j, int(new_of_old[i]))
                          for (r, j, i) in self._arrivals]
        evicted = st.retired.col("jid")[n0:]
        self._jids.difference_update(int(j) for j in evicted)
        return int(evicted.shape[0])

    # -- finalization -------------------------------------------------------
    def result(self, partial: Optional[bool] = None,
               light: bool = False) -> SimResult:
        """Finalize metrics.  Defaults to a *partial* result (covering the
        completed jobs only) while events remain, and to the strict
        closed-world result once exhausted.  ``light`` skips the O(jobs)
        per-job completion/stretch dicts (aggregates only, computed by the
        identical float ops)."""
        if partial is None:
            partial = not self._exhausted
        return self.engine._result(hit_cap=self._hit_cap, partial=partial,
                                   sim_wall_s=self._wall, light=light)

    # -- snapshot / restore / fork ------------------------------------------
    def snapshot(self) -> SessionState:
        """Capture the full session — SoA engine state (the CSR incidence
        is reconstructed exactly from the serialized mappings), node pool
        accumulators, policy-internal state, and the session's loop cursor
        — as a fingerprinted, JSON-serializable :class:`SessionState`."""
        self._require_open("snapshot")
        e = self.engine
        st = e.state
        cols = {
            "jid": [s.jid for s in st.specs],
            "release": [s.release for s in st.specs],
            "proc_time": [s.proc_time for s in st.specs],
            "n_tasks": [s.n_tasks for s in st.specs],
            "cpu_need": [s.cpu_need for s in st.specs],
            "mem_req": [s.mem_req for s in st.specs],
        }
        payload: Dict[str, Any] = {
            "schema": SCHEMA,
            "version": SNAPSHOT_VERSION,
            "params": dataclasses.asdict(e.params),
            "policy": e.policy_ref,
            "jobs": cols,
            "proc_truth": st.proc_truth.tolist(),
            "vt": st.vt.tolist(),
            "yld": st.yld.tolist(),
            "penalty_until": st.penalty_until.tolist(),
            "completed_at": st.completed_at.tolist(),
            "status": st.status.tolist(),
            "job_pmtn": st.n_pmtn.tolist(),
            "job_mig": st.n_mig.tolist(),
            "mappings": [None if m is None else list(m)
                         for m in st.mappings],
            "pool_load": st.pool.load.tolist(),
            "pool_mem_free": st.pool.mem_free.tolist(),
            "alive": st.alive.tolist(),
            "now": st.now,
            "util_integral": st.util_integral,
            "demand_integral": st.demand_integral,
            "bytes_moved_gb": e.bytes_moved_gb,
            "n_pmtn": e.n_pmtn,
            "n_mig": e.n_mig,
            "events": e._events,
            "arrivals": [list(a) for a in self._arrivals],
            "cluster_events": [[ev.time, ev.kind, list(ev.nodes),
                                list(ev.jids), ev.value]
                               for ev in self._cev[self._ci:]],
            "next_tick": self._next_tick,
            "tick_armed": self._tick_armed,
            "horizon": self._horizon,
            "exhausted": self._exhausted,
            "hit_cap": self._hit_cap,
            "wall_s": self._wall,
            "policy_state": _snapshot_policy_state(e.policy),
            # v3: compaction state — global arrival indices of the live
            # rows, lifetime counters, and the retired-row accumulators
            "gidx": st.gidx.tolist(),
            "n_total": st.n_total,
            "first_release": st.first_release,
            "retired": st.retired.payload(),
        }
        if self._narrator is not None:
            # optional key: narrator-free snapshots keep the legacy shape
            payload["narrator"] = self._narrator.state()
        if self._tuner is not None:
            # optional key: tuner RNG + schedule + decision log ride along
            payload["autotune"] = self._tuner.state()
        return SessionState(payload)

    @classmethod
    def restore(cls, snap: Union[SessionState, Dict[str, Any], str],
                policy=None, *, device="cuda",
                alloc_backend=None) -> "SimSession":
        """Resume a session from a snapshot (same or a fresh process, this
        package's or the JAX package's).

        Without ``policy`` the snapshot's own policy reference is rebuilt
        and its internal state restored verbatim — the continuation is
        bit-identical to never having snapshotted.  With ``policy`` the
        restored engine state is handed to a *different* policy (the
        what-if fork path): the new policy starts from the identical live
        cluster but rebuilds its private state from it.

        The restored engine allocates on ``device`` (or through
        ``alloc_backend``: a lockstep lane, or ``"numpy"`` for the host
        path), attached before anything can allocate.
        """
        backend = _engine_backend(device, alloc_backend)
        if isinstance(snap, str):
            snap = SessionState.load(snap)
        elif isinstance(snap, dict):
            snap = SessionState.from_json_dict(snap)
        pl = snap.payload
        version = int(pl.get("version", 1))
        if version not in _SUPPORTED_VERSIONS:
            raise ValueError(
                f"session snapshot version {version} is not supported "
                f"(supported: {list(_SUPPORTED_VERSIONS)}); re-create it or "
                f"restore with the version that wrote it")
        missing = _REQUIRED_KEYS - pl.keys()
        if missing:
            raise ValueError(
                f"session snapshot is missing required keys "
                f"{sorted(missing)} (stale, truncated, or foreign "
                f"snapshot?); cannot restore")
        params = SimParams(**pl["params"])
        switched = policy is not None
        if policy is None:
            policy = pl["policy"]
            if policy is None:
                raise ValueError(
                    "snapshot carries no rebuildable policy reference (the "
                    "session ran an ad-hoc Policy instance); pass policy=")
        cols = pl["jobs"]
        specs = [
            JobSpec(jid=int(j), release=float(r), proc_time=float(p),
                    n_tasks=int(t), cpu_need=float(c), mem_req=float(m))
            for j, r, p, t, c, m in zip(*(cols[k] for k in _JOB_COLS))
        ]
        e = Engine.__new__(Engine)
        e.params = params
        e.policy_spec, e.policy, e.policy_ref = resolve_policy_arg(policy)
        e.alloc_backend = backend
        e.state = EngineState(specs, params.n_nodes)
        e.cluster_events = [
            ClusterEvent(
                float(row[0]), row[1], tuple(int(n) for n in row[2]),
                jids=tuple(int(j) for j in row[3]) if len(row) > 3 else (),
                value=(float(row[4]) if len(row) > 4 and row[4] is not None
                       else None))
            for row in pl["cluster_events"]]
        e.bytes_moved_gb = float(pl["bytes_moved_gb"])
        e.n_pmtn = int(pl["n_pmtn"])
        e.n_mig = int(pl["n_mig"])
        e._events = int(pl["events"])
        st = e.state
        if "proc_truth" in pl:          # pre-truth-split snapshots lack it
            st.proc_truth[:] = pl["proc_truth"]
        st.vt[:] = pl["vt"]
        st.yld[:] = pl["yld"]
        st.penalty_until[:] = pl["penalty_until"]
        st.completed_at[:] = pl["completed_at"]
        st.status[:] = pl["status"]
        st.n_pmtn[:] = pl["job_pmtn"]
        st.n_mig[:] = pl["job_mig"]
        if version >= 3:
            st.gidx[:] = pl["gidx"]
            st.n_total = int(pl["n_total"])
            st.first_release = float(pl["first_release"])
            st.retired = RetiredLog.from_payload(pl["retired"])
        # (v1/v2: the fresh EngineState already has gidx = arange(n),
        # n_total = n, first_release = min(releases), empty retired log —
        # those snapshots predate compaction.)
        st.rebuild_index_sets()         # status was written wholesale
        st.mappings = [None if m is None else [int(x) for x in m]
                       for m in pl["mappings"]]
        st.pool.load[:] = pl["pool_load"]
        st.pool.mem_free[:] = pl["pool_mem_free"]
        st.alive[:] = pl["alive"]
        st.now = float(pl["now"])
        st.util_integral = float(pl["util_integral"])
        st.demand_integral = float(pl["demand_integral"])
        for i in st.running_indices():
            st.inc.place(int(i), st.mappings[int(i)])
        e.policy.validate(st.specs, params)
        e.policy.bind(e)

        ses = cls.__new__(cls)
        ses.engine = e
        ses._arrivals = [(float(r), int(j), int(i))
                         for r, j, i in pl["arrivals"]]
        ses._jids = {s.jid for s in specs}
        ses._cev = e.cluster_events if e.policy.handles_cluster_events else []
        ses._ci = 0
        ses._periodic = e.policy.periodic_kind is not None
        ses._next_tick = float(pl["next_tick"])
        ses._tick_armed = bool(pl["tick_armed"])
        ses._horizon = float(pl["horizon"])
        ses._exhausted = bool(pl["exhausted"])
        ses._hit_cap = bool(pl["hit_cap"])
        ses._wall = float(pl["wall_s"])
        # a stream() call's chunks are a live Python iterator, not snapshot
        # state: restored sessions resume with whatever was submitted
        ses._stream_pending = False
        ses._closed = False
        ses._close_hooks = []
        ses.scratch = {}
        nar_pl = pl.get("narrator")
        ses._narrator = Narrator.from_state(nar_pl) if nar_pl else None
        if (ses._narrator is not None and switched
                and ses._narrator.needs_cluster_events()
                and not e.policy.handles_cluster_events):
            # fork onto a batch baseline: the cluster script is dropped, so
            # the chaos streams that feed it go too (noise-only survives)
            ses._narrator = None
        tun_pl = pl.get("autotune")
        if tun_pl and not switched:
            from ..tune.controller import AutoTuner
            ses._tuner = AutoTuner.from_state(tun_pl)
        else:
            # policy-switching forks are what-if branches: they race under
            # the tuner, they never recursively run one
            ses._tuner = None
        if switched:
            if not e.policy.handles_cluster_events:
                # batch baselines do not model failures: the fork drops the
                # pending cluster script, so dead nodes must come back too
                # or a wide job could never start again.  Failed nodes host
                # nothing (failure force-preempts), so revival is exactly
                # the "join" transition.
                dead = np.nonzero(~st.alive)[0]
                st.alive[dead] = True
                st.pool.mem_free[dead] = 1.0
                st.pool.load[dead] = 0.0
            _adopt_policy_state(e.policy, e)
            if ses._periodic and math.isinf(ses._next_tick):
                # the fork introduced a periodic pass mid-run: base its
                # tick train at the live clock
                ses._next_tick = st.now + params.period
                ses._tick_armed = True
            ses._exhausted = False      # the new policy may act again
        else:
            _restore_policy_state(e.policy, pl["policy_state"], e)
        return ses

    def fork(self, policy=None, *, device="cuda",
             alloc_backend=None) -> "SimSession":
        """Clone the live session (optionally under a different policy):
        what-if branching from an identical mid-run state."""
        return SimSession.restore(self.snapshot(), policy=policy,
                                  device=device, alloc_backend=alloc_backend)


def open_session(
    cluster: Union[int, SimParams],
    policy,
    params: Optional[SimParams] = None,
    *,
    cluster_events: Sequence[ClusterEvent] = (),
    device="cuda",
    alloc_backend=None,
    **param_overrides: Any,
) -> SimSession:
    """Open a streaming simulation session on an (initially idle) cluster.

    ``cluster`` is a node count (combined with ``params``/keyword
    overrides) or a full :class:`SimParams`.  Submit jobs with
    :meth:`SimSession.submit` or :meth:`SimSession.stream`, advance with
    ``step_until``/``step``, perturb with ``inject``, checkpoint with
    ``snapshot``.  The §4.6 reallocations run on ``device`` (``"cuda"``
    unless the caller asks for ``"cpu"``), or through ``alloc_backend``.
    """
    if isinstance(cluster, SimParams):
        if params is not None:
            raise ValueError("pass either a SimParams cluster or params=, "
                             "not both")
        params = dataclasses.replace(cluster, **param_overrides)
    else:
        base = params if params is not None else SimParams()
        params = dataclasses.replace(base, n_nodes=int(cluster),
                                     **param_overrides)
    return SimSession(policy, params, cluster_events=cluster_events,
                      device=device, alloc_backend=alloc_backend)
