"""Successive-halving races over a live session snapshot.

One race takes a mid-run :class:`~repro_torch.sched.session.SessionState`,
a portfolio of policy/period variants, and an objective, and answers
"which variant digs out of *this exact situation* best?" under a bounded
sim-time budget:

* **rung r** runs every surviving variant from the snapshot over horizon
  ``base_horizon * 2**r`` (``sweep.run_branches`` with ``horizon_s``) and
  scores the partial results;
* between rungs the worst half of the *challengers* is eliminated — the
  incumbent is exempt, so the final rung always compares champion and
  challenger at the same (largest) budget;
* a crashing or hung variant is quarantined by the branch driver and
  scores ``inf`` — it loses the race, it cannot kill it.

Branches race *oracle-free*: the snapshot's chaos narrator is reseeded
with one common ``branch_seed`` across all branches of a rung (common
random numbers — fair comparison, decorrelated from the future the live
session will actually see), and an attached autotuner never recurses into
its own race branches (the snapshot is stripped of tuner state first).

A rung's branches run through ``run_branches``: in lockstep on a device
(``backend="torch"``, on ``device``) or on the host numpy path
(``backend="numpy"``); the records, and so the race, are equal either way.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..sched.sweep import _canonical_policy, run_branches
from .score import Objective, parse_objective

__all__ = ["Variant", "RaceResult", "race"]


@dataclass(frozen=True)
class Variant:
    """One portfolio entry: a policy string plus an optional period
    override (``None`` = keep the snapshot's period)."""

    policy: str
    period: Optional[float] = None

    @property
    def label(self) -> str:
        if self.period is None:
            return self.policy
        return f"{self.policy} @period={self.period:g}"

    def key(self) -> Tuple[str, Optional[float]]:
        return (_canonical_policy(self.policy), self.period)

    def to_branch(self) -> Dict[str, Any]:
        return {"policy": self.policy, "period": self.period}


@dataclass
class RaceResult:
    """Outcome of one fork-race: the winner at full budget, the incumbent
    it was judged against, and the per-rung elimination history."""

    winner: Variant
    winner_score: float
    incumbent: Variant
    incumbent_score: float
    objective: str
    horizon_s: float                    # final-rung horizon
    branch_seed: Optional[int]
    rungs: List[Dict[str, Any]] = field(default_factory=list)
    records: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def promoted(self) -> bool:
        return self.winner.key() != self.incumbent.key()


def _strip_tuner(snapshot):
    """A copy of the snapshot without the ``autotune`` key: race branches
    run under the tuner, they must never recursively run one (and the
    branch fingerprint should identify the *cluster* state being raced,
    not the racer)."""
    from ..sched.session import SessionState

    if "autotune" not in snapshot.payload:
        return snapshot
    payload = dict(snapshot.payload)
    payload.pop("autotune")
    return SessionState(payload)


def race(
    snapshot,
    variants: Sequence[Variant],
    incumbent: Variant,
    *,
    objective="max_stretch",
    base_horizon: float,
    rungs: int = 2,
    branch_seed: Optional[int] = None,
    timeout_s: Optional[float] = None,
    retries: int = 0,
    backend: str = "torch",
    n_workers: int = 1,
    device="cuda",
) -> RaceResult:
    """Race ``variants`` (plus ``incumbent``) from ``snapshot`` and return
    the full-budget winner.

    Each rung's branches run in lockstep on ``device`` (``backend="torch"``,
    ``"cuda"`` unless the caller asks for ``"cpu"``) or on the host numpy
    path (``backend="numpy"``).  ``timeout_s``/``retries`` supervise each
    branch (worker processes on the host path) — robust against hangs but
    wall-clock-dependent; without them the race is fully deterministic
    (crashes still quarantine, via ``run_branches(quarantine=True)``).
    """
    obj: Objective = parse_objective(objective)
    if rungs < 1:
        raise ValueError("race needs at least one rung")
    if base_horizon <= 0:
        raise ValueError("race base_horizon must be > 0")
    snap = _strip_tuner(snapshot)

    alive: List[Variant] = [incumbent]
    seen = {incumbent.key()}
    for v in variants:
        if v.key() not in seen:
            seen.add(v.key())
            alive.append(v)

    result = RaceResult(
        winner=incumbent, winner_score=math.inf,
        incumbent=incumbent, incumbent_score=math.inf,
        objective=obj.name,
        horizon_s=float(base_horizon) * 2 ** (rungs - 1),
        branch_seed=branch_seed)
    cutoff: Optional[float] = None
    records: List[Dict[str, Any]] = []
    scores: List[float] = []
    for r in range(rungs):
        horizon = float(base_horizon) * 2 ** r
        final = r == rungs - 1
        # prune a mid-rung challenger already past the survivors' worst
        # score — only when the objective makes that monotonically final,
        # and never on the final rung (true equal-budget scores decide)
        early = None
        if (cutoff is not None and not final and math.isfinite(cutoff)
                and obj.prunable_by_max_stretch):
            early = {"max_stretch_above": cutoff}
        res = run_branches(
            snap, [v.to_branch() for v in alive],
            horizon_s=horizon, early_stop=early, branch_seed=branch_seed,
            timeout_s=timeout_s, retries=retries, quarantine=True,
            backend=backend, n_workers=n_workers, device=device)
        records = res.records
        scores = [obj.score(rec) for rec in records]
        survivors = alive
        if not final:
            challengers = sorted(
                range(1, len(alive)), key=lambda i: (scores[i], i))
            keep = challengers[:max(1, math.ceil(len(challengers) / 2))]
            survivors = [alive[0]] + [alive[i] for i in sorted(keep)]
            kept_scores = [scores[0]] + [scores[i] for i in sorted(keep)]
            finite = [s for s in kept_scores if math.isfinite(s)]
            cutoff = max(finite) if finite else None
        result.rungs.append({
            "rung": r,
            "horizon_s": horizon,
            "variants": [v.label for v in alive],
            "scores": scores,
            "eliminated": [v.label for v in alive if v not in survivors],
        })
        alive = survivors
    result.records = records
    result.incumbent_score = scores[0]
    best = min(range(len(alive)), key=lambda i: (scores[i], i != 0, i))
    result.winner = alive[best]
    result.winner_score = scores[best]
    return result
