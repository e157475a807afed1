"""The AutoTuner: fork-race-promote driven from the session loop.

An :class:`AutoTuner` attaches to a live
:class:`~repro_torch.sched.session.SimSession` exactly like the chaos
narrator:
the stepping loop peeks its next scheduled time and fires it lazily at
the same partition-invariant boundary (due before the next engine event
and inside the step bound), so the fire points — and therefore the race
snapshots and the decision log — are identical no matter how the run is
chunked into ``step()``/``step_until()`` calls.

One firing:

1. **fork** — snapshot the live session (tuner state stripped from the
   race copies);
2. **race** — successive halving over the configured policy × period
   portfolio (:func:`repro_torch.tune.race.race`), chaos reseeded with a
   deterministic per-decision ``branch_seed`` (oracle-free: the tuner
   knows the chaos *distribution*, never the live realization);
3. **promote** — hot-swap the winner (``switch_policy`` + ``set_period``)
   only if it beat the incumbent by the configured relative ``margin``
   AND at least ``dwell`` sim-seconds passed since the last swap
   (hysteresis: no flip-flopping on noise);
4. **log** — append one wall-clock-free decision record to the in-memory
   log (and an optional JSONL sink).

Tuner RNG, schedule, and decision log ride ``SimSession.snapshot()``
bit-exactly under the optional ``autotune`` payload key, so a restored
session re-fires, re-decides and re-logs identically — in the same or a
fresh process, and in either package.

Where a race runs is process-local plumbing, like a session's allocation
backend: the tuner races on the device of the session it is attached to
(lockstep ``run_branches`` on the session's ``TorchAllocBackend`` device),
or on the host numpy path when the session allocates on the host or
``TuneConfig.backend`` is ``"numpy"``.  The decisions are equal either way.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.alloc_torch import TorchBatchedAllocator
from .race import RaceResult, Variant, race
from .score import parse_objective

__all__ = ["AutoTuner", "TuneConfig", "parse_tune"]


@dataclass(frozen=True)
class TuneConfig:
    """Static autotuner configuration (travels in snapshots verbatim)."""

    #: sim-seconds between scheduled races
    every: float = 7200.0
    #: first-rung race horizon (sim-seconds); rung r doubles it r times.
    #: None = every / 2.
    horizon: Optional[float] = None
    #: successive-halving rungs per race
    rungs: int = 2
    #: race objective (name or w*key+... blend, see tune.score)
    objective: str = "max_stretch"
    #: hysteresis: promote only when winner <= (1 - margin) * incumbent
    margin: float = 0.05
    #: min sim-seconds between promotions. None = 2 * every.
    dwell: Optional[float] = None
    #: portfolio policy strings (the incumbent is always raced too)
    policies: Tuple[str, ...] = ()
    #: portfolio period values crossed with the policies (() = keep each
    #: variant at the live period)
    periods: Tuple[float, ...] = ()
    #: per-branch wall-clock budget (supervised worker processes).
    #: Wall-clock supervision is nondeterministic — leave None where
    #: bit-identical replay matters (the default race is deterministic).
    timeout: Optional[float] = None
    #: supervised retries per branch (with timeout)
    retries: int = 0
    #: race branch backend, in the JAX package's values so that tuner
    #: state fingerprints the same in both packages: "numpy" races on the
    #: host; None, "jax" and "pallas" race where the session allocates
    backend: Optional[str] = None

    def __post_init__(self):
        if self.every <= 0:
            raise ValueError("tune: every must be > 0")
        if self.horizon is not None and self.horizon <= 0:
            raise ValueError("tune: horizon must be > 0")
        if self.rungs < 1:
            raise ValueError("tune: rungs must be >= 1")
        if not 0.0 <= self.margin < 1.0:
            raise ValueError("tune: margin must be in [0, 1)")
        if self.dwell is not None and self.dwell < 0:
            raise ValueError("tune: dwell must be >= 0")
        parse_objective(self.objective)     # fail fast

    @property
    def base_horizon(self) -> float:
        return self.horizon if self.horizon is not None else self.every / 2.0

    @property
    def min_dwell(self) -> float:
        return self.dwell if self.dwell is not None else 2.0 * self.every


_LIST_KEYS = {"policies", "periods"}


def parse_tune(spec: str) -> TuneConfig:
    """Build a :class:`TuneConfig` from the ``;``-separated spec grammar::

        every=5000;horizon=2500;rungs=2;objective=max_stretch;
        margin=0.05;dwell=10000;policies=GreedyP */OPT=MIN|EASY;
        periods=600,1200;timeout=30;retries=1;backend=numpy

    ``policies`` is ``|``-separated (policy strings contain neither ``;``
    nor ``|``); ``periods`` is comma-separated floats.
    """
    kwargs: Dict[str, Any] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if not eq or not key:
            raise ValueError(f"tune spec token {part!r} must be key=value")
        if key in ("every", "horizon", "margin", "dwell", "timeout"):
            kwargs[key] = float(val)
        elif key in ("rungs", "retries"):
            kwargs[key] = int(val)
        elif key == "policies":
            kwargs[key] = tuple(p.strip() for p in val.split("|")
                                if p.strip())
        elif key == "periods":
            kwargs[key] = tuple(float(p) for p in val.split(",") if p.strip())
        elif key in ("objective", "backend"):
            kwargs[key] = val
        else:
            raise ValueError(
                f"unknown tune spec key {key!r}; known: every, horizon, "
                f"rungs, objective, margin, dwell, policies, periods, "
                f"timeout, retries, backend")
    return TuneConfig(**kwargs)


class AutoTuner:
    """Fork-race-promote controller for one live session.

    Attach with :meth:`SimSession.attach_autotuner`; the stepping loop
    drives :meth:`peek`/:meth:`fire`.  ``state()``/``from_state``
    round-trip everything that determines future decisions (config, RNG,
    schedule, decision log) — the JSONL sink path is process-local and
    deliberately not part of snapshots, like the session's metrics sinks.
    """

    def __init__(self, config: Optional[TuneConfig] = None, *,
                 seed: int = 0, log_path: Optional[str] = None):
        if isinstance(config, str):
            config = parse_tune(config)
        self.config = config or TuneConfig()
        self.seed = int(seed)
        self._rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0x7E5E]))
        self._next_t: Optional[float] = None
        self._last_swap_t: Optional[float] = None
        self._n_fired = 0
        self.decisions: List[Dict[str, Any]] = []
        self.log_path = log_path
        #: last full RaceResult (ephemeral diagnostics, not snapshot state)
        self.last_race: Optional[RaceResult] = None

    # ---- the session-facing surface (narrator-shaped) -------------------- #
    def peek(self, session) -> float:
        """Next scheduled race time; primed lazily at the engine clock so
        a tuner attached mid-run starts counting from 'now'."""
        if self._next_t is None:
            self._next_t = session.engine.state.now + self.config.every
        return self._next_t

    def fire(self, session, *, now: bool = False) -> bool:
        """Run one fork-race-promote cycle; returns True when a variant
        was promoted (the session's policy/period changed in place).

        ``now=True`` is the manual trigger (the ``tune`` op): the race
        runs at the current engine clock and the periodic schedule
        restarts from it.  The next scheduled time always advances
        *before* racing, so a crashing race cannot wedge the schedule.
        """
        cfg = self.config
        st = session.engine.state
        t = float(st.now) if now else self.peek(session)
        self._next_t = t + cfg.every
        self._n_fired += 1
        # one deterministic seed per decision, drawn from the tuner RNG
        # (which rides snapshots): every branch of this race sees the same
        # reseeded chaos, and a restored session re-draws the same seed
        branch_seed = int(self._rng.integers(0, 2**31 - 1))
        incumbent = Variant(session.engine.policy_ref,
                            float(session.engine.params.period))
        variants, skipped = self._portfolio(session)
        decision: Dict[str, Any] = {
            "i": len(self.decisions),
            "t": t,
            "now": float(st.now),
            "incumbent": dataclasses.asdict(incumbent),
            "objective": cfg.objective,
            "branch_seed": branch_seed,
            "n_variants": len(variants) + 1,
            "skipped_variants": skipped,
        }
        swapped = False
        try:
            rr = race(
                session.snapshot(), variants, incumbent,
                objective=cfg.objective, base_horizon=cfg.base_horizon,
                rungs=cfg.rungs, branch_seed=branch_seed,
                timeout_s=cfg.timeout, retries=cfg.retries,
                **self._race_target(session))
        except Exception as exc:  # noqa: BLE001 — a broken race loses, only
            self.last_race = None  # the decision record remembers it
            decision.update(swapped=False, reason="race-error",
                            error=f"{type(exc).__name__}: {exc}")
        else:
            self.last_race = rr
            swapped, reason = self._decide(rr, t)
            if swapped:
                session.switch_policy(rr.winner.policy)
                if (rr.winner.period is not None
                        and rr.winner.period != session.engine.params.period):
                    session.set_period(rr.winner.period)
                self._last_swap_t = t
            decision.update(
                swapped=swapped, reason=reason,
                winner=dataclasses.asdict(rr.winner),
                winner_score=rr.winner_score,
                incumbent_score=rr.incumbent_score,
                horizon_s=rr.horizon_s,
                rungs=rr.rungs)
        self.decisions.append(decision)
        if self.log_path is not None:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(decision) + "\n")
        return swapped

    # ---- internals -------------------------------------------------------- #
    def _race_target(self, session) -> Dict[str, Any]:
        """Where this firing's race runs: in lockstep on the device of the
        session's ``TorchAllocBackend``, else on the host numpy path."""
        backend = self.config.backend
        if backend not in (None, "jax", "pallas", "numpy"):
            raise ValueError(f"unknown race backend {backend!r}")
        alloc = session.engine.alloc_backend
        if backend == "numpy" or not isinstance(alloc, TorchBatchedAllocator):
            return {"backend": "numpy"}
        return {"backend": "torch", "device": alloc.device}

    def _portfolio(self, session) -> Tuple[List[Variant], List[str]]:
        """The promotable variants for this session right now: the
        configured policy × period cross product, minus variants that
        could not be hot-swapped in (batch baselines while the session
        still needs cluster events)."""
        from ..sched.engine import resolve_policy_arg

        cfg = self.config
        st = session.engine.state
        needs_cev = (
            (session.narrator is not None
             and session.narrator.needs_cluster_events())
            or session._ci < len(session._cev)
            or not bool(st.alive.all()))
        policies = list(cfg.policies) or [session.engine.policy_ref]
        periods: List[Optional[float]] = list(cfg.periods) or [None]
        out: List[Variant] = []
        skipped: List[str] = []
        for pol in policies:
            if needs_cev:
                try:
                    handles = resolve_policy_arg(pol)[1].handles_cluster_events
                except ValueError as exc:
                    skipped.append(f"{pol}: {exc}")
                    continue
                if not handles:
                    skipped.append(f"{pol}: needs cluster-event support")
                    continue
            for per in periods:
                out.append(Variant(pol, per))
        return out, skipped

    def _decide(self, rr: RaceResult, t: float) -> Tuple[bool, str]:
        cfg = self.config
        if not rr.promoted:
            return False, "incumbent-best"
        win, inc = rr.winner_score, rr.incumbent_score
        if not (win <= (1.0 - cfg.margin) * inc):
            return False, "margin"
        if (self._last_swap_t is not None
                and t - self._last_swap_t < cfg.min_dwell):
            return False, "dwell"
        if math.isinf(win):
            return False, "no-finite-score"
        return True, "promoted"

    # ---- snapshot round-trip ---------------------------------------------- #
    def state(self) -> Dict[str, Any]:
        return {
            "config": dataclasses.asdict(self.config),
            "seed": self.seed,
            "rng": self._rng.bit_generator.state,
            "next_t": self._next_t,
            "last_swap_t": self._last_swap_t,
            "n_fired": self._n_fired,
            "decisions": self.decisions,
        }

    @classmethod
    def from_state(cls, payload: Dict[str, Any]) -> "AutoTuner":
        cfg_pl = dict(payload["config"])
        cfg_pl["policies"] = tuple(cfg_pl.get("policies") or ())
        cfg_pl["periods"] = tuple(float(p)
                                  for p in cfg_pl.get("periods") or ())
        tun = cls(TuneConfig(**cfg_pl), seed=int(payload["seed"]))
        tun._rng.bit_generator.state = payload["rng"]
        nt = payload["next_t"]
        tun._next_t = None if nt is None else float(nt)
        ls = payload["last_swap_t"]
        tun._last_swap_t = None if ls is None else float(ls)
        tun._n_fired = int(payload["n_fired"])
        tun.decisions = [dict(d) for d in payload["decisions"]]
        return tun

    def __repr__(self) -> str:
        return (f"AutoTuner(every={self.config.every:g}, "
                f"portfolio={len(self.config.policies) or 1}, "
                f"decisions={len(self.decisions)}, seed={self.seed})")
