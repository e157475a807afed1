"""Credit-based admission control + weighted-DRF fair queueing.

Every tenant carries a **credit score**

    credit_t = clamp(1 − α·budget_used − β·violations − γ·tail_latency,
                     min_credit, 1)

whose three pressure terms are normalized to [0, 1]:

* ``budget_used`` — the tenant's consumed cost units (ops weighted by
  engine events advanced and wall time) over its per-window budget, with
  exponential decay so bursts are forgiven over ``window_s``;
* ``violations`` — a decayed count of misbehaviour (ops that error out,
  queue-overflow spam);
* ``tail_latency`` — the tenant's own recent p99 service latency over the
  target (a tenant whose ops hog the dispatcher sees its credit fall).

The credit is the tenant's **weight in a weighted-DRF queue**: the
dispatcher always services the pending tenant with the smallest
``dominant_share / credit``, where the dominant share is the classic DRF
max-over-resources of the tenant's (decayed) usage against the whole
server's usage.  A hot tenant's share grows and its credit falls, so its
effective priority collapses quadratically while an idle tenant's first
op is serviced almost immediately — starvation-free without hard
partitioning.  ``min_credit > 0`` guarantees even a fully misbehaving
tenant eventually drains.

Admission control proper happens *before* enqueue: a tenant over its
pending-queue cap or out of budget is refused with a typed error
(``admission-denied`` / ``over-budget``) instead of being queued, so a
misbehaving tenant cannot occupy dispatcher memory.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .protocol import E_ADMISSION, E_OVER_BUDGET, ProtocolError

__all__ = ["CreditParams", "TenantState", "FairQueue"]

_DIMS = ("ops", "events", "wall")
_EPS = 1e-12


@dataclass
class CreditParams:
    """Knobs of the credit model (defaults match the docs above)."""

    alpha: float = 0.5              # weight of budget pressure
    beta: float = 0.3               # weight of violation pressure
    gamma: float = 0.2              # weight of tail-latency pressure
    budget: float = 500.0           # cost units per decay window
    window_s: float = 30.0          # exponential-decay horizon (wall s)
    target_latency_s: float = 0.05  # p99 target for the tail term
    min_credit: float = 0.05        # starvation-free floor
    max_pending: int = 64           # per-tenant dispatcher queue cap
    max_sessions: int = 100000      # per-tenant session cap
    latency_window: int = 128       # samples for the p99 estimate


def _clamp01(x: float) -> float:
    return 0.0 if x < 0.0 else (1.0 if x > 1.0 else x)


class TenantState:
    """Per-tenant accounting: decayed usage, violations, latency tail,
    pending ops, and the derived credit."""

    def __init__(self, name: str, params: CreditParams,
                 clock: Callable[[], float]):
        self.name = name
        self.params = params
        self._clock = clock
        self._stamp = clock()
        self.usage: Dict[str, float] = {d: 0.0 for d in _DIMS}
        self.cost_used = 0.0        # decayed cost units this window
        self.violations = 0.0       # decayed misbehaviour count
        self.latencies: Deque[float] = deque(maxlen=params.latency_window)
        self.pending: Deque[Any] = deque()
        self.sessions: set = set()
        # lifetime counters (stats only, never decayed)
        self.n_ops = 0
        self.n_rejected = 0
        self.n_errors = 0

    # -- decay --------------------------------------------------------------
    def _decay(self) -> None:
        now = self._clock()
        dt = now - self._stamp
        if dt <= 0:
            return
        self._stamp = now
        k = math.exp(-dt / max(self.params.window_s, _EPS))
        self.cost_used *= k
        self.violations *= k
        for d in _DIMS:
            self.usage[d] *= k

    # -- the three pressure terms -------------------------------------------
    def budget_used(self) -> float:
        self._decay()
        return _clamp01(self.cost_used / max(self.params.budget, _EPS))

    def violations_norm(self) -> float:
        self._decay()
        return _clamp01(self.violations / 10.0)

    def tail_latency_norm(self) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
        return _clamp01(p99 / max(self.params.target_latency_s, _EPS))

    def credit(self) -> float:
        p = self.params
        raw = (1.0 - p.alpha * self.budget_used()
               - p.beta * self.violations_norm()
               - p.gamma * self.tail_latency_norm())
        return max(p.min_credit, min(1.0, raw))

    # -- charging -----------------------------------------------------------
    def charge(self, *, ops: float = 1.0, events: float = 0.0,
               wall: float = 0.0) -> None:
        """Account one serviced op: cost units against the budget, the DRF
        usage vector, and the latency tail."""
        self._decay()
        self.n_ops += 1
        self.usage["ops"] += ops
        self.usage["events"] += events
        self.usage["wall"] += wall
        # cost units: an op is 1, plus its simulation and wall footprint
        self.cost_used += ops + events / 1000.0 + wall * 10.0
        self.latencies.append(wall)

    def violation(self, n: float = 1.0) -> None:
        self._decay()
        self.violations += n

    def snapshot(self) -> Dict[str, Any]:
        return {
            "credit": self.credit(),
            "budget_used": self.budget_used(),
            "violations": self.violations_norm(),
            "tail_latency": self.tail_latency_norm(),
            "pending": len(self.pending),
            "sessions": len(self.sessions),
            "n_ops": self.n_ops,
            "n_rejected": self.n_rejected,
            "n_errors": self.n_errors,
        }


class FairQueue:
    """Weighted-DRF dispatcher queue over per-tenant pending deques."""

    def __init__(self, params: Optional[CreditParams] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.params = params or CreditParams()
        self._clock = clock
        self.tenants: Dict[str, TenantState] = {}

    def tenant(self, name: str) -> TenantState:
        t = self.tenants.get(name)
        if t is None:
            t = self.tenants[name] = TenantState(name, self.params,
                                                 self._clock)
        return t

    # -- admission ----------------------------------------------------------
    def admit(self, name: str, item: Any) -> TenantState:
        """Admit one op into ``name``'s pending queue or refuse with a
        typed :class:`ProtocolError` (refusals never occupy queue space)."""
        t = self.tenant(name)
        if len(t.pending) >= self.params.max_pending:
            t.n_rejected += 1
            t.violation()           # queue-overflow spam is misbehaviour
            raise ProtocolError(
                E_ADMISSION,
                f"tenant {name!r} has {len(t.pending)} ops pending "
                f"(max_pending={self.params.max_pending}); drain before "
                f"submitting more")
        if t.budget_used() >= 1.0:
            t.n_rejected += 1       # throttling, not misbehaviour
            raise ProtocolError(
                E_OVER_BUDGET,
                f"tenant {name!r} exhausted its credit budget "
                f"({self.params.budget:g} cost units / "
                f"{self.params.window_s:g}s window); retry after backoff")
        t.pending.append(item)
        return t

    # -- scheduling ---------------------------------------------------------
    def _dominant_share(self, t: TenantState,
                        totals: Dict[str, float]) -> float:
        return max(t.usage[d] / (totals[d] + _EPS) for d in _DIMS)

    def pick(self) -> Optional[Tuple[TenantState, Any]]:
        """Pop the next op to service: the pending tenant minimizing
        ``dominant_share / credit`` (deterministic name tie-break)."""
        ready = [t for t in self.tenants.values() if t.pending]
        if not ready:
            return None
        totals = {d: sum(t.usage[d] for t in self.tenants.values())
                  for d in _DIMS}
        best = min(ready, key=lambda t: (
            self._dominant_share(t, totals) / t.credit(), t.name))
        return best, best.pending.popleft()

    def backlog(self) -> int:
        return sum(len(t.pending) for t in self.tenants.values())

    def stats(self) -> Dict[str, Any]:
        return {name: t.snapshot() for name, t in sorted(self.tenants.items())}
