"""Composable policy components: the open policy API behind the engine.

A generic :class:`ComposedPolicy` assembles registered components and the
:class:`~.engine.Engine` drives it through one narrow hook protocol
(``on_submit`` / ``on_job_completed`` / ``on_complete`` / ``on_tick`` /
``finalize``):

* **SubmitAction** — reaction to a job arrival: ``greedy`` / ``greedyP`` /
  ``greedyPM`` / ``mcb8`` (§4.2) or ``fcfs-queue`` (batch FIFO admission).
* **CompletionAction** — reaction to job completions: ``greedy`` /
  ``mcb8`` opportunistic passes (§4.2), batch ``reclaim`` + ``fcfs-start``
  / ``easy-backfill`` / ``easy-frac-backfill`` restarts (§5.2).
* **PeriodicPass** — the period-``T`` tick: ``mcb8`` / ``mcb8-stretch``
  (§4.3/§4.7) or ``backfill`` (batch queue drained only on the tick).
* **OptPass** — the per-event resource-allocation post-pass (§4.6):
  ``MIN`` / ``AVG`` / ``MAX`` (``MAX`` delegates its per-event reallocation
  to ``MIN``, as the stretch-periodic policies do).

Every component is registered under ``(kind, name)`` via
:func:`register_component`; :func:`compose_from_spec` assembles the
canonical composition for a :class:`~repro_torch.core.policies.PolicySpec`.
Whole compositions the string grammar cannot express are registered by
*name* via :func:`register_policy`; the built-in one is ``"EASY+OPT=MIN"``
— EASY backfilling whose backfill step may *fractionally* co-locate a
candidate onto occupied nodes, with an OPT=MIN yield post-pass arbitrating
the sharing (see :class:`BatchStartPass`).
"""
from __future__ import annotations

import heapq
import math
from collections import Counter, deque
from itertools import islice
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.greedy import greedy_p, greedy_place, greedy_pm
from ..core.job import PAUSED, PENDING, RUNNING, JobSpec
from ..core.mcb8 import mcb8
from ..core.policies import PolicySpec, parse_policy
from ..core.state import JobView
from ..core.stretch_opt import improve_avg_stretch, improve_max_stretch, mcb8_stretch
from .engine import Policy, SimParams, _node_multiset, _reallocate_yields

__all__ = [
    "Component",
    "ComposedPolicy",
    "COMPONENT_KINDS",
    "register_component",
    "get_component",
    "list_components",
    "compose",
    "compose_from_spec",
    "register_policy",
    "registered_policies",
    "resolve_policy",
    "batch_state_payload",
    "batch_state_from_payload",
]


# --------------------------------------------------------------------------- #
# component protocol + registry                                                #
# --------------------------------------------------------------------------- #
class Component:
    """One pluggable piece of scheduling behaviour.

    A component implements any subset of the engine's hook protocol; the
    :class:`ComposedPolicy` fans each hook only to the components that
    override it.  ``bind`` is the per-run reset — coordination state lives
    in ``self.p.shared``, which the policy clears on every bind.
    """

    #: registry coordinates, filled in by :func:`register_component`
    kind: str = ""
    component_name: str = ""
    #: does the component tolerate cluster (failure/elastic) events?  The
    #: composition handles them only if *every* component does.
    handles_cluster_events = True
    #: non-None enables the engine's periodic tick for the composition
    periodic_kind: Optional[str] = None

    def __init__(self, spec: Optional[PolicySpec] = None):
        self.spec = spec

    def bind(self, policy: "ComposedPolicy") -> None:
        self.p = policy

    def validate(self, specs: Sequence[JobSpec], params: SimParams) -> None:
        pass

    def on_submit(self, js: JobView) -> None:
        pass

    def on_job_completed(self, js: JobView) -> None:
        pass

    def on_job_cancelled(self, js: JobView) -> None:
        pass

    def on_complete(self) -> None:
        pass

    def on_tick(self) -> None:
        pass

    def finalize(self, acted: bool) -> None:
        pass

    def __repr__(self) -> str:
        tag = f"{self.kind}/{self.component_name}" if self.kind else "unregistered"
        return f"<{self.__class__.__name__} {tag}>"


COMPONENT_KINDS = ("submit", "complete", "periodic", "opt")

_COMPONENTS: Dict[Tuple[str, str], type] = {}


def register_component(kind: str, name: str) -> Callable[[type], type]:
    """Class decorator: register a :class:`Component` under ``(kind, name)``."""
    if kind not in COMPONENT_KINDS:
        raise ValueError(f"unknown component kind {kind!r}; "
                         f"expected one of {COMPONENT_KINDS}")

    def deco(cls: type) -> type:
        key = (kind, name)
        if key in _COMPONENTS:
            raise ValueError(f"component {kind}/{name} already registered")
        cls.kind, cls.component_name = kind, name
        _COMPONENTS[key] = cls
        return cls

    return deco


def get_component(kind: str, name: str) -> type:
    try:
        return _COMPONENTS[(kind, name)]
    except KeyError:
        known = sorted(n for k, n in _COMPONENTS if k == kind)
        raise KeyError(f"unknown {kind} component {name!r}; known: {known}")


def list_components(kind: Optional[str] = None) -> Dict[str, List[str]]:
    """``{kind: [names...]}`` for one kind or all of them."""
    kinds = (kind,) if kind else COMPONENT_KINDS
    return {k: sorted(n for kk, n in _COMPONENTS if kk == k) for k in kinds}


# --------------------------------------------------------------------------- #
# the generic composed policy                                                  #
# --------------------------------------------------------------------------- #
class ComposedPolicy(Policy):
    """A :class:`~.engine.Policy` assembled from registry components.

    Hooks fan out to components in composition order; ``shared`` is a
    per-run scratch namespace for cross-component coordination (the batch
    queue state, the stretch-pass yield flag) cleared on every bind.
    """

    def __init__(
        self,
        components: Sequence[Component],
        name: str = "composed",
        spec: Optional[PolicySpec] = None,
    ):
        self.components = list(components)
        self.name = name
        self.spec = spec
        self.shared: Dict[str, object] = {}
        self.handles_cluster_events = all(
            c.handles_cluster_events for c in self.components)
        ticks = [c.periodic_kind for c in self.components if c.periodic_kind]
        if len(ticks) > 1:
            raise ValueError(
                f"at most one periodic component per composition, got {ticks}")
        self.periodic_kind = ticks[0] if ticks else None
        base = Component
        by_hook = lambda h: [c for c in self.components
                             if getattr(type(c), h) is not getattr(base, h)]
        self._submit_chain = by_hook("on_submit")
        self._job_completed_chain = by_hook("on_job_completed")
        self._cancel_chain = by_hook("on_job_cancelled")
        self._complete_chain = by_hook("on_complete")
        self._tick_chain = by_hook("on_tick")
        self._finalize_chain = by_hook("finalize")

    # ---- hook fan-out ---------------------------------------------------
    def bind(self, engine) -> None:
        super().bind(engine)
        self.shared = {}
        for c in self.components:
            c.bind(self)

    def validate(self, specs: Sequence[JobSpec], params: SimParams) -> None:
        for c in self.components:
            c.validate(specs, params)

    def on_submit(self, js: JobView) -> None:
        for c in self._submit_chain:
            c.on_submit(js)

    def on_job_completed(self, js: JobView) -> None:
        for c in self._job_completed_chain:
            c.on_job_completed(js)

    def on_job_cancelled(self, js: JobView) -> None:
        for c in self._cancel_chain:
            c.on_job_cancelled(js)

    def on_complete(self) -> None:
        for c in self._complete_chain:
            c.on_complete()

    def on_tick(self) -> None:
        for c in self._tick_chain:
            c.on_tick()

    def finalize(self, acted: bool) -> None:
        for c in self._finalize_chain:
            c.finalize(acted)

    def __repr__(self) -> str:
        return f"<ComposedPolicy {self.name!r} {self.components}>"


def compose(name: str, *components: Component,
            spec: Optional[PolicySpec] = None) -> ComposedPolicy:
    """Sugar: ``compose("my-policy", SubmitGreedy(), OptMin())``."""
    return ComposedPolicy(components, name=name, spec=spec)


def compose_from_spec(spec: PolicySpec | str) -> ComposedPolicy:
    """The canonical composition for a (parsed) policy-grammar spec."""
    if isinstance(spec, str):
        spec = parse_policy(spec)
    if spec.is_batch:
        start = "fcfs-start" if spec.name == "FCFS" else "easy-backfill"
        comps = [
            get_component("submit", "fcfs-queue")(spec),
            get_component("complete", "reclaim")(spec),
            get_component("complete", start)(spec),
        ]
    else:
        comps = []
        if spec.on_submit is not None:
            comps.append(get_component("submit", spec.on_submit)(spec))
        if spec.on_complete is not None:
            comps.append(get_component("complete", spec.on_complete)(spec))
        if spec.periodic is not None:
            comps.append(get_component("periodic", spec.periodic)(spec))
        comps.append(get_component("opt", spec.opt)(spec))
    return ComposedPolicy(comps, name=spec.name, spec=spec)


# --------------------------------------------------------------------------- #
# named whole-policy registry (compositions beyond the grammar)                #
# --------------------------------------------------------------------------- #
_POLICIES: Dict[str, Tuple[Callable[[], Policy], str]] = {}


def register_policy(name: str, factory: Optional[Callable[[], Policy]] = None,
                    *, description: str = ""):
    """Register a factory of a named policy composition the string grammar
    cannot spell (``register_policy(name, factory)``, or as a decorator).

    The factory must build a *fresh* policy instance per call (policies are
    stateful).  The name then works everywhere a policy string does.  Names
    that parse under the grammar are rejected.  ``description`` (default:
    the factory's docstring) is what :func:`registered_policies` lists.
    """
    def _register(fac: Callable[[], Policy]):
        try:
            parse_policy(name)
        except ValueError:
            pass
        else:
            raise ValueError(
                f"{name!r} is a policy-grammar spelling; registered names "
                f"must not shadow the grammar")
        if name in _POLICIES:
            raise ValueError(f"policy {name!r} already registered")
        _POLICIES[name] = (fac, description or (fac.__doc__ or "").strip())
        return fac

    if factory is None:
        return _register           # decorator form
    return _register(factory)


def registered_policies() -> Dict[str, str]:
    """``{name: description}`` of every registered composition."""
    return {name: desc for name, (_, desc) in sorted(_POLICIES.items())}


def resolve_policy(name: str) -> Optional[Policy]:
    """A fresh policy instance for a registered name, else None."""
    entry = _POLICIES.get(name)
    return entry[0]() if entry is not None else None


# --------------------------------------------------------------------------- #
# DFRS helpers (shared by the §4 components)                                   #
# --------------------------------------------------------------------------- #
def _pinned(e, spec: Optional[PolicySpec]) -> Dict[int, List[int]]:
    """Jobs protected from remapping by MINVT/MINFT (§4.3)."""
    pins: Dict[int, List[int]] = {}
    if spec is None or (spec.minvt is None and spec.minft is None):
        return pins
    now = e.state.now
    for js in e.state.running():
        if spec.minvt is not None and js.vt < spec.minvt:
            pins[js.spec.jid] = list(js.mapping)
        elif spec.minft is not None and js.flow_time(now) < spec.minft:
            pins[js.spec.jid] = list(js.mapping)
    return pins


def _apply_global_mapping(e, mappings: Dict[int, List[int]],
                          cands: Sequence[JobView]) -> None:
    """Apply a from-scratch MCB8 mapping transactionally: the mapping is
    feasible as a whole, so all removals happen before any placement."""
    migrations: List[Tuple[JobView, List[int]]] = []
    starts: List[Tuple[JobView, List[int]]] = []
    for js in cands:
        new_map = mappings.get(js.spec.jid)
        if js.status == RUNNING:
            if new_map is None:
                e.pause(js)
            elif _node_multiset(js.mapping) != _node_multiset(new_map):
                migrations.append((js, new_map))
        elif new_map is not None:
            starts.append((js, new_map))
    e.migrate_many(migrations)
    for js, new_map in starts:
        e.start(js, new_map)


def _apply_mcb8(e, spec: Optional[PolicySpec]) -> None:
    cands = e.state.uncompleted()
    if not cands:
        return
    res = mcb8(
        cands, e.params.n_nodes, e.state.now,
        pinned=_pinned(e, spec), alive=e.state.alive,
    )
    _apply_global_mapping(e, res.mappings, cands)


# --------------------------------------------------------------------------- #
# §4 DFRS components                                                           #
# --------------------------------------------------------------------------- #
@register_component("submit", "greedy")
class SubmitGreedy(Component):
    """Place the arriving job on the least-loaded feasible nodes (§4.2)."""

    def on_submit(self, js: JobView) -> None:
        e = self.p.e
        mapping = greedy_place(e.state.pool.copy(), js.spec)
        if mapping is not None:
            e.start(js, mapping)


class _SubmitPreempting(Component):
    """GreedyP/GreedyPM admission: pause (and move) lower-priority work."""

    _fn = None                      # greedy_p | greedy_pm

    def on_submit(self, js: JobView) -> None:
        e = self.p.e
        running = e.state.running()
        adm = type(self)._fn(e.state.pool.copy(), js.spec, running,
                             e.state.now)
        if adm.mapping is None:
            return
        by_jid = {j.spec.jid: j for j in running}
        for jid in adm.paused:
            e.pause(by_jid[jid])
        e.migrate_many(
            [(by_jid[jid], new_map) for jid, new_map in adm.moved.items()])
        e.start(js, adm.mapping)


@register_component("submit", "greedyP")
class SubmitGreedyP(_SubmitPreempting):
    _fn = staticmethod(greedy_p)


@register_component("submit", "greedyPM")
class SubmitGreedyPM(_SubmitPreempting):
    _fn = staticmethod(greedy_pm)


@register_component("submit", "mcb8")
class SubmitMCB8(Component):
    """Re-pack the whole cluster with MCB8 on every arrival (§4.2)."""

    def on_submit(self, js: JobView) -> None:
        _apply_mcb8(self.p.e, self.spec)


@register_component("complete", "greedy")
class CompleteGreedy(Component):
    """Opportunistically greedy-start waiting jobs by §4.1 priority."""

    def on_complete(self) -> None:
        e = self.p.e
        waiting = sorted(
            (j for j in e.state.uncompleted() if j.status in (PENDING, PAUSED)),
            key=lambda j: j.priority_key(e.state.now),
            reverse=True,
        )
        for js in waiting:
            mapping = greedy_place(e.state.pool.copy(), js.spec)
            if mapping is not None:
                e.start(js, mapping)


@register_component("complete", "mcb8")
class CompleteMCB8(Component):
    """Re-pack the whole cluster with MCB8 on completions."""

    def on_complete(self) -> None:
        _apply_mcb8(self.p.e, self.spec)


@register_component("periodic", "mcb8")
class PeriodicMCB8(Component):
    """The /per pass: MCB8 from scratch every period (§4.3)."""

    periodic_kind = "mcb8"

    def on_tick(self) -> None:
        _apply_mcb8(self.p.e, self.spec)


@register_component("periodic", "mcb8-stretch")
class PeriodicStretch(Component):
    """The /stretch-per pass (§4.7): MCB8-stretch mapping plus an explicit
    max- or average-stretch yield optimization, which preempts the per-event
    OPT pass for this timestamp (via the shared ``stretch_yields_set`` flag).
    """

    periodic_kind = "mcb8-stretch"

    def on_tick(self) -> None:
        e = self.p.e
        cands = e.state.uncompleted()
        if not cands:
            return
        res = mcb8_stretch(
            cands, e.params.n_nodes, e.state.now, e.params.period,
            pinned=_pinned(e, self.spec), alive=e.state.alive,
        )
        _apply_global_mapping(e, res.mappings, cands)
        running = e.state.running()
        mappings = {js.spec.jid: js.mapping for js in running}
        ylds = {js.spec.jid: res.yields.get(js.spec.jid, 0.0) for js in running}
        if self.spec is not None and self.spec.opt == "MAX":
            ylds = improve_max_stretch(
                running, mappings, ylds, e.params.n_nodes, e.state.now,
                e.params.period,
            )
        else:
            ylds = improve_avg_stretch(
                running, mappings, ylds, e.params.n_nodes, e.state.now,
                e.params.period,
            )
        for js in running:
            js.yld = float(min(1.0, ylds.get(js.spec.jid, 0.0)))
        self.p.shared["stretch_yields_set"] = True


class _OptPass(Component):
    """Per-event §4.6 yield reallocation for all running jobs."""

    _opt = "MIN"

    def finalize(self, acted: bool) -> None:
        if not acted:
            return
        if self.p.shared.pop("stretch_yields_set", False):
            return                 # /stretch-per just set yields explicitly
        _reallocate_yields(self.p.e, type(self)._opt)


@register_component("opt", "MIN")
class OptMin(_OptPass):
    _opt = "MIN"


@register_component("opt", "AVG")
class OptAvg(_OptPass):
    _opt = "AVG"


@register_component("opt", "MAX")
class OptMax(_OptPass):
    # OPT=MAX is the stretch-periodic target; its per-event pass is MIN
    _opt = "MIN"


# --------------------------------------------------------------------------- #
# §5.2 batch components (queue state shared via policy.shared["batch"])        #
# --------------------------------------------------------------------------- #
class _BatchState:
    """FIFO queue + free-node heap + running list, shared by the batch
    components of one composition.  The ``excl_owner`` / ``frac_*`` maps
    only fill up under fractional backfilling (:class:`BatchStartPass` with
    ``frac=True``); canonical FCFS/EASY never touch them."""

    def __init__(self, n_nodes: int):
        self.queue: deque = deque()                     # FIFO: O(1) head pops
        self.free: List[int] = list(range(n_nodes))     # free node ids (heap)
        heapq.heapify(self.free)
        self.running: List[Tuple[float, int, int]] = [] # (end, jid, n_tasks)
        self.dirty = False
        self.excl_owner: Dict[int, int] = {}            # node -> exclusive jid
        self.frac_jobs: Dict[int, List[int]] = {}       # jid -> mapping
        self.frac_count: Counter = Counter()            # node -> frac tasks


def _batch_state(p: ComposedPolicy) -> _BatchState:
    st = p.shared.get("batch")
    if st is None:
        st = p.shared["batch"] = _BatchState(p.e.params.n_nodes)
    return st


def batch_state_payload(bs: _BatchState) -> Dict[str, object]:
    """JSON-able form of a :class:`_BatchState` for session snapshots.

    Queued jobs are referenced by their dense engine index; ``free`` is
    stored in its live heap layout verbatim, so a restored state pops nodes
    in the identical order.
    """
    return {
        "queue": [js.i for js in bs.queue],
        "free": list(bs.free),
        "running": [list(r) for r in bs.running],
        "dirty": bs.dirty,
        "excl_owner": sorted(bs.excl_owner.items()),
        "frac_jobs": sorted((jid, list(m)) for jid, m in bs.frac_jobs.items()),
        "frac_count": sorted((n, c) for n, c in bs.frac_count.items() if c),
    }


def batch_state_from_payload(payload: Dict[str, object], views,
                             n_nodes: int) -> _BatchState:
    """Inverse of :func:`batch_state_payload` against a restored engine's
    ``state.views``."""
    bs = _BatchState(n_nodes)
    bs.queue = deque(views[int(i)] for i in payload["queue"])
    bs.free = [int(n) for n in payload["free"]]
    bs.running = [(float(e), int(j), int(n)) for e, j, n in payload["running"]]
    bs.dirty = bool(payload["dirty"])
    bs.excl_owner = {int(n): int(j) for n, j in payload["excl_owner"]}
    bs.frac_jobs = {int(j): [int(x) for x in m]
                    for j, m in payload["frac_jobs"]}
    bs.frac_count = Counter({int(n): int(c)
                             for n, c in payload["frac_count"]})
    return bs


@register_component("submit", "fcfs-queue")
class QueueSubmit(Component):
    """Batch admission: enqueue arrivals FIFO; a start pass drains the
    queue (``fcfs-start`` / ``easy-backfill`` on events, ``backfill`` on
    the periodic tick)."""

    handles_cluster_events = False  # batch does not model failures

    def validate(self, specs: Sequence[JobSpec], params: SimParams) -> None:
        for s in specs:
            if s.n_tasks > params.n_nodes:
                raise ValueError(
                    f"job {s.jid} needs {s.n_tasks} > {params.n_nodes} nodes")

    def on_submit(self, js: JobView) -> None:
        st = _batch_state(self.p)
        st.queue.append(js)
        st.dirty = True


@register_component("complete", "reclaim")
class ReclaimNodes(Component):
    """Return a finished job's nodes to the free heap (called before the
    engine clears the mapping).  Under fractional backfilling a node goes
    back only once its last occupant — exclusive owner *and* co-located
    fractional tasks — has left."""

    handles_cluster_events = False

    def on_job_completed(self, js: JobView) -> None:
        st = _batch_state(self.p)
        jid = js.spec.jid
        if jid in st.frac_jobs:                 # fractionally placed job
            del st.frac_jobs[jid]
            for node in js.mapping:
                st.frac_count[node] -= 1
                if st.frac_count[node] == 0 and node not in st.excl_owner:
                    heapq.heappush(st.free, node)
            st.dirty = True
            return
        st.running = [r for r in st.running if r[1] != jid]
        for node in js.mapping:
            st.excl_owner.pop(node, None)
            if st.frac_count[node] == 0:
                heapq.heappush(st.free, node)
        st.dirty = True


class BatchStartPass(Component):
    """FCFS head starts + optional EASY backfilling (§5.2) over the shared
    batch queue state.

    Nodes are allocated integrally and exclusively: job j occupies n_j whole
    nodes at yield 1 for exactly p_j seconds.  EASY gives the queue head a
    reservation at the earliest time it could start under FCFS and backfills
    any job that does not interfere with it; as in the paper, EASY is given
    *perfect* processing-time estimates (a best case for the baseline).

    With ``frac=True`` (the hybrid composition) a backfill candidate that
    does not fit on whole free nodes may instead be placed *fractionally*
    with greedy least-loaded placement restricted to already-occupied nodes
    (free nodes stay untouched), provided its optimistic yield-1 completion
    fits before the head's shadow time.  An ``opt`` component composed after
    this pass arbitrates the sharing.  Unlike strict EASY, fractional
    co-location *can* delay the queue head.
    """

    handles_cluster_events = False
    _algo = "FCFS"                  # FCFS | EASY
    _frac = False                   # fractional backfill extension
    _on_tick = False                # drain the queue on the periodic tick

    def finalize(self, acted: bool) -> None:
        if self._on_tick:
            return
        st = _batch_state(self.p)
        if st.dirty:
            self._try_start(st)
            st.dirty = False

    def on_tick(self) -> None:
        if not self._on_tick:
            return
        st = _batch_state(self.p)
        self._try_start(st)
        st.dirty = False

    # ---- allocation -----------------------------------------------------
    def _start_job(self, st: _BatchState, js: JobView) -> None:
        nodes = [heapq.heappop(st.free) for _ in range(js.spec.n_tasks)]
        now = self.p.e.state.now
        st.running.append((now + js.spec.proc_time, js.spec.jid,
                           js.spec.n_tasks))
        for node in nodes:
            st.excl_owner[node] = js.spec.jid
        self.p.e.start(js, nodes)
        js.yld = 1.0            # dedicated nodes, full speed

    def _start_frac(self, st: _BatchState, js: JobView) -> bool:
        """Fractionally co-locate ``js`` on occupied nodes, if it fits."""
        e = self.p.e
        pool = e.state.pool.copy()
        for node in st.free:
            pool.mem_free[node] = 0.0       # free nodes are off limits
        mapping = greedy_place(pool, js.spec)
        if mapping is None:
            return False
        st.frac_jobs[js.spec.jid] = list(mapping)
        for node in mapping:
            st.frac_count[node] += 1
        e.start(js, mapping)
        js.yld = 1.0            # provisional; the opt pass arbitrates
        return True

    def _try_start(self, st: _BatchState) -> None:
        now = self.p.e.state.now
        q = st.queue
        # FCFS part: start queue head(s) while they fit.
        while q and q[0].spec.n_tasks <= len(st.free):
            self._start_job(st, q.popleft())
        if self._algo == "FCFS" or not q:
            return
        # EASY backfilling against the head's reservation.
        changed = True
        while changed:
            changed = False
            head = q[0]
            ends = sorted(st.running)
            avail = len(st.free)
            shadow, extra = math.inf, 0
            for end, _, n in ends:
                avail += n
                if avail >= head.spec.n_tasks:
                    shadow = end
                    extra = avail - head.spec.n_tasks
                    break
            if math.isinf(shadow):
                # the head's reservation is uncomputable (nodes withheld for
                # fractional occupants): allow no backfill until they drain,
                # so EASY's reservation protection holds
                break
            for i, js in enumerate(islice(q, 1, None), start=1):
                free = len(st.free)
                fits_before_shadow = now + js.spec.proc_time <= shadow + 1e-9
                if js.spec.n_tasks <= free and (
                    fits_before_shadow
                    or js.spec.n_tasks <= min(free, extra)
                ):
                    del q[i]
                    self._start_job(st, js)
                    changed = True
                    break   # recompute the reservation after each backfill
                if (self._frac and fits_before_shadow
                        and self._start_frac(st, js)):
                    del q[i]
                    changed = True
                    break


@register_component("complete", "fcfs-start")
class FCFSStart(BatchStartPass):
    _algo = "FCFS"


@register_component("complete", "easy-backfill")
class EasyBackfill(BatchStartPass):
    _algo = "EASY"


@register_component("complete", "easy-frac-backfill")
class EasyFracBackfill(BatchStartPass):
    _algo = "EASY"
    _frac = True


@register_component("periodic", "backfill")
class PeriodicBackfill(BatchStartPass):
    """Drain the batch queue only on the periodic tick (delayed batch
    scheduling — a composition the paper's grammar cannot express)."""

    _algo = "EASY"
    _on_tick = True
    periodic_kind = "backfill"


# --------------------------------------------------------------------------- #
# built-in named compositions                                                  #
# --------------------------------------------------------------------------- #
@register_policy("EASY+OPT=MIN", description=(
    "EASY backfilling whose backfill step may fractionally co-locate jobs "
    "on occupied nodes, with an OPT=MIN water-filling post-pass arbitrating "
    "the sharing (hybrid batch+DFRS; not expressible in the §4.5 grammar)"))
def _easy_opt_min() -> ComposedPolicy:
    return compose(
        "EASY+OPT=MIN",
        QueueSubmit(),
        ReclaimNodes(),
        EasyFracBackfill(),
        OptMin(),
    )
