"""Named cluster-scenario transforms for sweeps, benchmarks and examples.

A *scenario* perturbs one simulation cell deterministically (given a seed).
A builder is a **vectorized transform over the columnar trace**:
``(Trace, n_nodes, rng) -> (Trace, [ClusterEvent])`` — it may inject :class:`ClusterEvent` scripts (node failures, elastic capacity
changes) and/or rewrite whole trace columns (arrival bursts, memory
pressure) without any per-job Python loop.  Benchmarks and examples refer
to scenarios by name instead of hand-rolling ``ClusterEvent`` lists, and
sweep cells carry just the name.

Scenario names **compose with the ``+`` chain grammar**: the cell name
``"rack_failure+arrival_burst"`` applies ``rack_failure`` to the workload
trace, then ``arrival_burst`` to the result, concatenating the cluster
scripts.  Each link draws from its own name-salted RNG stream, so a link
produces the same perturbation whether it runs alone or inside a chain,
and every timing is relative to the span of the trace the link *receives*
(later links see earlier links' rewrites).

Built-ins (all timed relative to the trace's release span, so they scale
with any workload):

* ``baseline``          — unperturbed cell.
* ``rack_failure``      — a contiguous quarter of the nodes dies at the
                          median release and rejoins after 10 % of the span.
* ``rolling_failures``  — Poisson single-node failures (≈6 over the span)
                          with deterministic repair (§ fault-tolerance
                          adaptation: failures reuse the preemption path).
* ``elastic``           — elastic capacity: a third of the cluster is
                          reclaimed at 30 % of the span and returned at 70 %
                          (shrink uses the failure path: force-preempt).
* ``arrival_burst``     — the middle half of the arrivals is compressed
                          into a 10×-narrower window (flash crowd).
* ``mem_pressure``      — a random half of the jobs needs 1.5× memory
                          (capped at a full node), stressing the packer.
* ``ptime_noise``       — lognormal noise on the *executed* processing time
                          (``proc_truth``); policies keep seeing the clean
                          estimate (non-clairvoyant truth split).

A builder returns new columns (``Trace.replace``) and never writes into
the trace it receives: that trace is the registry's memoized base, shared
by every cell of a sweep and every lane thread of ``run_batched``.

Use :func:`apply_scenario_trace` (columnar) or :func:`apply_scenario`
(``JobSpec``-list compatibility wrapper) to materialize a cell, and
:func:`register_scenario` to add project-specific transforms.

**Reactive scenarios** are the second, session-native layer: where a Trace
transform perturbs a cell *before* the run, a reactive rule is a callback
over a live :class:`repro_torch.sched.session.SimSession` — it observes the
actual queue/cluster state between steps and injects events or submits
jobs in response (closed-loop perturbations the Trace grammar cannot
express, e.g. a load spike triggered by the queue draining).  A rule has
signature ``(session, observation, rng) -> None`` and is driven by
:func:`run_reactive`, which steps the session one interval at a time and
calls the rule after each chunk.  Register project rules with
:func:`register_reactive`; built-ins:

* ``surge_submit``    — flash crowd on drain: each time the observed queue
                        empties mid-run, submit a burst of short jobs
                        (at most 3 bursts).
* ``elastic_reserve`` — hold a quarter of the nodes in reserve; join them
                        when the observed queue exceeds half the live
                        cluster, reclaim them once the queue drains and
                        the reserve is idle.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.job import JobSpec
from ..workloads.trace import Trace
from .cluster import ClusterEvent, failure_trace

__all__ = [
    "SCENARIOS",
    "REACTIVE",
    "apply_scenario",
    "apply_scenario_trace",
    "parse_scenario_chain",
    "register_scenario",
    "list_scenarios",
    "scenario_docs",
    "register_reactive",
    "list_reactive",
    "reactive_docs",
    "run_reactive",
]

# a scenario builder: (trace, n_nodes, rng) -> (trace, cluster_events)
Builder = Callable[
    [Trace, int, np.random.Generator],
    Tuple[Trace, List[ClusterEvent]],
]

SCENARIOS: Dict[str, Builder] = {}


def register_scenario(name: str):
    if "+" in name:
        raise ValueError(f"scenario names must not contain '+' (reserved "
                         f"for the chain grammar): {name!r}")

    def deco(fn: Builder) -> Builder:
        if name in SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        SCENARIOS[name] = fn
        return fn
    return deco


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def scenario_docs() -> Dict[str, str]:
    """name -> first docstring line of the registered builder."""
    return {name: (fn.__doc__ or "").strip().split("\n")[0]
            for name, fn in sorted(SCENARIOS.items())}


def parse_scenario_chain(name: str) -> List[str]:
    """Split a ``"a+b+c"`` chain and validate every link is registered."""
    links = [part.strip() for part in name.split("+")]
    if not links or any(not p for p in links):
        raise KeyError(f"malformed scenario chain {name!r}")
    for link in links:
        if link not in SCENARIOS:
            raise KeyError(
                f"unknown scenario {link!r}; known: {list_scenarios()}")
    return links


def apply_scenario_trace(
    name: str,
    trace: Trace,
    n_nodes: int,
    seed: int = 0,
) -> Tuple[Trace, List[ClusterEvent]]:
    """Materialize scenario chain ``name`` for one cell, deterministically.

    Each link of the ``+`` chain gets its own ``[seed, salt(link)]`` RNG
    stream (repeated links are further salted by occurrence), so a link's
    perturbation does not depend on its chain position; cluster scripts
    concatenate and are returned time-sorted.
    """
    links = parse_scenario_chain(name)
    events: List[ClusterEvent] = []
    seen: Dict[str, int] = {}
    for link in links:
        k = seen.get(link, 0)
        seen[link] = k + 1
        words = [seed, _code(link)] + ([k] if k else [])
        rng = np.random.default_rng(np.random.SeedSequence(words))
        trace, evs = SCENARIOS[link](trace, n_nodes, rng)
        events.extend(evs)
    if len(links) > 1:
        events.sort(key=lambda e: e.time)
    return trace, events


def apply_scenario(
    name: str,
    specs: Sequence[JobSpec],
    n_nodes: int,
    seed: int = 0,
) -> Tuple[List[JobSpec], List[ClusterEvent]]:
    """``JobSpec``-list wrapper around :func:`apply_scenario_trace`."""
    trace, events = apply_scenario_trace(
        name, Trace.from_specs(specs), n_nodes, seed=seed)
    return trace.to_specs(), events


def _code(name: str) -> int:
    # stable (non-PYTHONHASHSEED) scenario salt for the seed sequence
    return sum((i + 1) * ord(c) for i, c in enumerate(name)) % (2**31)


# --------------------------------------------------------------------------- #
# built-ins                                                                    #
# --------------------------------------------------------------------------- #
@register_scenario("baseline")
def _baseline(trace, n_nodes, rng):
    """Unperturbed cell: the workload trace as generated, no cluster script."""
    return trace, []


@register_scenario("rack_failure")
def _rack_failure(trace, n_nodes, rng):
    """A contiguous quarter of the nodes fails mid-span, rejoins after 10%."""
    lo, span = trace.span()
    k = max(1, n_nodes // 4)
    first = int(rng.integers(0, max(1, n_nodes - k + 1)))
    rack = tuple(range(first, first + k))
    t_fail = lo + 0.5 * span
    return trace, [
        ClusterEvent(time=t_fail, kind="fail", nodes=rack),
        ClusterEvent(time=t_fail + 0.1 * span, kind="join", nodes=rack),
    ]


@register_scenario("rolling_failures")
def _rolling_failures(trace, n_nodes, rng):
    """Poisson single-node failures (~6 over the span), deterministic repair."""
    lo, span = trace.span()
    events = failure_trace(
        n_nodes,
        horizon=span,
        mtbf=span / 6.0,
        repair=span / 30.0,
        seed=int(rng.integers(2**31)),
    )
    # failure_trace generates on [0, horizon); shift onto the release span
    shifted = [ClusterEvent(ev.time + lo, ev.kind, ev.nodes) for ev in events]
    return trace, shifted


@register_scenario("elastic")
def _elastic(trace, n_nodes, rng):
    """A third of the cluster is reclaimed at 30% of the span, back at 70%."""
    lo, span = trace.span()
    k = max(1, n_nodes // 3)
    block = tuple(range(n_nodes - k, n_nodes))
    return trace, [
        ClusterEvent(time=lo + 0.3 * span, kind="fail", nodes=block),
        ClusterEvent(time=lo + 0.7 * span, kind="join", nodes=block),
    ]


@register_scenario("arrival_burst")
def _arrival_burst(trace, n_nodes, rng):
    """The middle half of the arrivals compresses into a 10x-narrower window."""
    lo, span = trace.span()
    a, b = lo + 0.25 * span, lo + 0.75 * span
    rel = trace.release
    hit = (rel >= a) & (rel <= b)
    return trace.replace(
        release=np.where(hit, a + (rel - a) / 10.0, rel)), []


@register_scenario("mem_pressure")
def _mem_pressure(trace, n_nodes, rng):
    """A random half of the jobs needs 1.5x memory (capped at a full node)."""
    hit = rng.random(len(trace)) < 0.5
    return trace.replace(
        mem_req=np.where(hit, np.minimum(1.0, 1.5 * trace.mem_req),
                         trace.mem_req)), []


@register_scenario("ptime_noise")
def _ptime_noise(trace, n_nodes, rng):
    """Lognormal truth noise: the engine executes proc_time x LogN(sigma=0.35)
    while policies keep observing the unperturbed estimate (non-clairvoyant
    split).  Mean-preserving (mu = -sigma^2/2); composes with any chain link
    by multiplying whatever truth column the incoming trace already has."""
    sigma = 0.35
    base = trace.proc_truth if trace.proc_truth is not None else trace.proc_time
    noise = rng.lognormal(mean=-0.5 * sigma * sigma, sigma=sigma,
                          size=len(trace))
    return trace.replace(proc_truth=base * noise), []


# --------------------------------------------------------------------------- #
# reactive scenarios: callbacks over live session state                        #
# --------------------------------------------------------------------------- #
# a reactive rule: (session, observation, rng) -> None; it may call
# session.inject(...) / session.submit(...) based on what it observes
REACTIVE: Dict[str, Callable] = {}


def register_reactive(name: str):
    """Decorator: register a reactive rule ``(session, obs, rng) -> None``."""

    def deco(fn: Callable) -> Callable:
        if name in REACTIVE:
            raise ValueError(f"reactive scenario {name!r} already registered")
        REACTIVE[name] = fn
        return fn
    return deco


def list_reactive() -> List[str]:
    return sorted(REACTIVE)


def reactive_docs() -> Dict[str, str]:
    """name -> first docstring line of the registered rule."""
    return {name: (fn.__doc__ or "").strip().split("\n")[0]
            for name, fn in sorted(REACTIVE.items())}


def run_reactive(
    session,
    rule,
    seed: int = 0,
    interval: Optional[float] = None,
    max_rounds: int = 100_000,
):
    """Drive ``session`` to exhaustion under a reactive rule.

    Steps the session roughly one ``interval`` (default: the session's
    periodic-pass period) past its next event at a time; after every chunk
    the rule sees the fresh observation and may inject events or submit
    jobs — including re-arming an exhausted session (the loop then
    continues).  The rule's RNG stream is salted by its name, mirroring
    the Trace-transform chain semantics.  Returns the final
    :class:`~repro_torch.sched.engine.SimResult`.
    """
    import math

    if isinstance(rule, str):
        name = rule
        try:
            rule = REACTIVE[rule]
        except KeyError:
            raise KeyError(f"unknown reactive scenario {name!r}; "
                           f"known: {list_reactive()}") from None
    else:
        # salt by the *registered* name when the callable is registered, so
        # run_reactive(ses, "x") and run_reactive(ses, REACTIVE["x"]) draw
        # the same stream; ad-hoc rules fall back to their __name__
        name = next((n for n, f in REACTIVE.items() if f is rule),
                    getattr(rule, "__name__", "reactive"))
    rng = np.random.default_rng(np.random.SeedSequence([seed, _code(name)]))
    if interval is None:
        interval = session.engine.params.period
    interval = float(interval)
    if interval <= 0:
        raise ValueError("interval must be > 0")
    for _ in range(max_rounds):
        nxt = session.next_event_time()
        if math.isinf(nxt):
            session.run_to_exhaustion()     # final probe marks exhaustion
        else:
            session.step_until(max(session.now, nxt) + interval)
        rule(session, session.observe(), rng)
        if session.exhausted:
            return session.result()
    raise RuntimeError(
        f"reactive scenario {name!r} did not converge within "
        f"{max_rounds} rounds (interval={interval:.6g}s)")


@register_reactive("surge_submit")
def _surge_submit(session, obs, rng):
    """Flash crowd on drain: when the observed queue empties mid-run, submit a burst of short single-task jobs (at most 3 bursts)."""
    st = session.scratch.setdefault("surge_submit", {"bursts": 0})
    in_flight = obs["n_running"] + obs["n_future"]
    if st["bursts"] >= 3 or obs["queue_depth"] > 0 or in_flight == 0:
        return
    st["bursts"] += 1
    k = 8
    base = max(session._jids, default=0) + 1
    now = session.now
    burst = [
        JobSpec(jid=base + i,
                release=now + float(rng.uniform(1.0, 30.0)),
                proc_time=float(rng.uniform(60.0, 600.0)),
                n_tasks=1,
                cpu_need=float(rng.uniform(0.2, 1.0)),
                mem_req=float(rng.uniform(0.1, 0.4)))
        for i in range(k)
    ]
    session.submit(burst)


@register_reactive("elastic_reserve")
def _elastic_reserve(session, obs, rng):
    """Elastic capacity: hold 1/4 of the nodes in reserve; join them when the queue exceeds half the live cluster, reclaim them once idle."""
    if not session.handles_cluster_events:
        raise ValueError("elastic_reserve needs a policy that handles "
                         "cluster events (batch baselines do not)")
    n = session.engine.params.n_nodes
    k = max(1, n // 4)
    reserve = tuple(range(n - k, n))
    st = session.scratch.setdefault("elastic_reserve",
                                    {"out": False, "init": False})
    state = session.engine.state
    if not st["init"]:
        st["init"] = True
        # reclaim the reserve up front (attach the rule from the start:
        # a fail force-preempts any resident jobs)
        session.inject(ClusterEvent(time=session.now, kind="fail",
                                    nodes=reserve))
        return
    if not st["out"] and obs["queue_depth"] > obs["alive_nodes"] // 2:
        session.inject(ClusterEvent(time=session.now, kind="join",
                                    nodes=reserve))
        st["out"] = True
        return
    reserve_idle = all(not state.inc.rows[node] for node in reserve)
    if st["out"] and obs["queue_depth"] == 0 and reserve_idle:
        session.inject(ClusterEvent(time=session.now, kind="fail",
                                    nodes=reserve))
        st["out"] = False
