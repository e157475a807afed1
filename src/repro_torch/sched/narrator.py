"""Chaos narrator: seeded stochastic fault/perturbation event streams.

The paper's setting is *online and non-clairvoyant*, but scripted scenarios
only perturb a cell where the script says so.  A :class:`Narrator` is the
generative counterpart: a composition of seeded stochastic *streams*
(exponential node breakdown/repair, Poisson job cancellation, lognormal
processing-time noise, malleable grow/shrink of ``n_tasks``) that emit
events into a live :class:`repro_torch.sched.session.SimSession` lazily as the
simulation clock advances.

Design contract (mirrors the session's bit-identity rules):

* **lazy + boundary-safe** — a stream holds exactly one pre-drawn firing
  time (``next_t``); the session's loop fires streams only for times
  ``<= min(next event, step bound)``, so where step boundaries fall never
  changes what the narrator does.
* **snapshot round-trip** — ``Narrator.state()`` serializes every stream's
  RNG (``bit_generator.state``, a JSON-able dict) plus its pending firing
  time; :meth:`Narrator.from_state` rebuilds the narrator bit-exactly, so a
  session restored mid-chaos replays the identical future.
* **compose, never corrupt** — streams pick victims from the session's
  *projected* state (pending injections included) and skip a firing rather
  than inject a contradictory event, so narrator streams stack safely with
  scripted scenarios and reactive rules.

Streams are registered by kind (:func:`register_stream`) and composable
through the same ``+`` grammar as scenarios::

    nar = parse_narrator(
        "breakdown(mtbf=2e4,repair=2e3)+cancel(rate=1e-4)+noise(sigma=0.3)",
        seed=7)
    session.attach_narrator(nar)

Each stream draws from its own ``SeedSequence([seed, salt(kind), k])``
stream (``k`` = position in the composition), so adding a stream never
re-times the others.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .cluster import ClusterEvent

__all__ = [
    "Narrator",
    "Stream",
    "parse_narrator",
    "register_stream",
    "list_streams",
    "narrator_docs",
]

#: guaranteed minimum inter-firing gap: keeps the lazy loop strictly
#: progressing even on a pathological zero draw from the RNG
_MIN_DT = 1e-6

_STREAMS: Dict[str, type] = {}


def _code(name: str) -> int:
    # stable (non-PYTHONHASHSEED) stream salt, same scheme as scenarios
    return sum((i + 1) * ord(c) for i, c in enumerate(name)) % (2**31)


def register_stream(kind: str):
    """Decorator: register a :class:`Stream` subclass under ``kind``."""
    def deco(cls):
        if kind in _STREAMS:
            raise ValueError(f"narrator stream {kind!r} already registered")
        cls.kind = kind
        _STREAMS[kind] = cls
        return cls
    return deco


def list_streams() -> List[str]:
    return sorted(_STREAMS)


def narrator_docs() -> Dict[str, str]:
    """kind -> first docstring line of the registered stream class."""
    return {k: (cls.__doc__ or "").strip().split("\n")[0]
            for k, cls in sorted(_STREAMS.items())}


# --------------------------------------------------------------------------- #
# stream protocol                                                              #
# --------------------------------------------------------------------------- #
class Stream:
    """One stochastic event process.

    Subclasses implement ``_draw_dt(rng)`` (inter-firing gap) and
    ``_emit(session, t)`` (materialize injections at firing time ``t``);
    purely submission-driven streams (``noise``) override
    :meth:`on_submitted` instead and keep ``next_t = inf``.
    """

    kind = "?"
    #: does the stream inject cluster events (breakdown/cancel/malleable)?
    #: noise only rewrites the truth column and works under batch policies.
    needs_cluster_events = True

    def __init__(self, **params: float):
        self.params = {k: float(v) for k, v in params.items()}
        self.rng: Optional[np.random.Generator] = None
        self.next_t: Optional[float] = None     # None until primed

    def seed(self, seed: int, k: int) -> None:
        self.rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), _code(self.kind), int(k)]))

    # ---- the lazy clock ------------------------------------------------- #
    def peek(self, session) -> float:
        """Next firing time; primed lazily at the session clock so a
        narrator attached mid-run starts counting from 'now'."""
        if self.next_t is None:
            self.next_t = session.now + max(self._draw_dt(self.rng), _MIN_DT)
        return self.next_t

    def fire(self, session) -> None:
        """Materialize this firing's injections, then pre-draw the next."""
        t = self.next_t
        self._emit(session, t)
        self.next_t = t + max(self._draw_dt(self.rng), _MIN_DT)

    def _draw_dt(self, rng: np.random.Generator) -> float:
        return math.inf

    def _emit(self, session, t: float) -> None:
        pass

    def on_submitted(self, session, idx: Sequence[int]) -> None:
        """Hook: jobs were just submitted at dense indices ``idx``."""
        pass

    # ---- snapshot round-trip -------------------------------------------- #
    def state(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "params": dict(self.params),
            "rng": self.rng.bit_generator.state,
            "next_t": self.next_t,
        }

    def load_state(self, payload: Dict[str, Any]) -> None:
        self.rng.bit_generator.state = payload["rng"]
        t = payload["next_t"]
        self.next_t = None if t is None else float(t)

    def __repr__(self) -> str:
        args = ",".join(f"{k}={v:g}" for k, v in sorted(self.params.items()))
        return f"{self.kind}({args})"

    # shared helper: inject tolerantly (a scripted event may already cover
    # the transition — skipping beats corrupting, and stays deterministic
    # because the RNG draws happened before the attempt)
    @staticmethod
    def _inject(session, event: ClusterEvent) -> bool:
        try:
            session.inject(event)
            return True
        except ValueError:
            return False


# --------------------------------------------------------------------------- #
# built-in streams                                                             #
# --------------------------------------------------------------------------- #
@register_stream("breakdown")
class BreakdownStream(Stream):
    """Exponential node breakdown with exponential repair.

    ``mtbf`` is the cluster-wide mean time between failures; each firing
    kills one uniformly random *projected-alive* node and schedules its
    repair ``Exp(repair)`` seconds later.
    """

    def __init__(self, mtbf: float = 20_000.0, repair: float = 2_000.0):
        if mtbf <= 0 or repair <= 0:
            raise ValueError("breakdown needs mtbf > 0 and repair > 0")
        super().__init__(mtbf=mtbf, repair=repair)

    def _draw_dt(self, rng):
        return float(rng.exponential(self.params["mtbf"]))

    def _emit(self, session, t):
        # draw order is fixed (victim, then repair) so the stream stays
        # deterministic even when the injection is skipped
        alive = session._projected_alive(t)
        candidates = np.nonzero(alive)[0]
        pick = int(self.rng.integers(len(candidates))) if len(candidates) else 0
        dt_repair = float(self.rng.exponential(self.params["repair"]))
        if not len(candidates):
            return                      # whole cluster already down: skip
        node = int(candidates[pick])
        if self._inject(session, ClusterEvent(t, "fail", (node,))):
            self._inject(session, ClusterEvent(
                t + max(dt_repair, _MIN_DT), "join", (node,)))


@register_stream("cancel")
class CancelStream(Stream):
    """Poisson job cancellation: in-system victims withdraw mid-run.

    ``rate`` is cancellations per second of simulated time; each firing
    cancels one uniformly random job among those currently in the system
    (pending cancellations excluded).
    """

    def __init__(self, rate: float = 1e-4):
        if rate <= 0:
            raise ValueError("cancel needs rate > 0")
        super().__init__(rate=rate)

    def _draw_dt(self, rng):
        return float(rng.exponential(1.0 / self.params["rate"]))

    def _emit(self, session, t):
        st = session.engine.state
        pending = session._pending_cancels()
        ins = [i for i in st.in_system_indices()
               if st.specs[i].jid not in pending]
        pick = int(self.rng.integers(len(ins))) if ins else 0
        if not ins:
            return                      # nothing to withdraw: skip
        jid = st.specs[ins[pick]].jid
        self._inject(session, ClusterEvent(t, "cancel", jids=(int(jid),)))


@register_stream("malleable")
class MalleableStream(Stream):
    """Poisson malleable grow/shrink: a running/waiting job changes width.

    ``rate`` is resizes per second; each firing picks a uniformly random
    in-system job and redraws its ``n_tasks`` uniformly in
    ``[1, 2 * current]`` (clamped to the cluster size by the engine).
    """

    def __init__(self, rate: float = 5e-5):
        if rate <= 0:
            raise ValueError("malleable needs rate > 0")
        super().__init__(rate=rate)

    def _draw_dt(self, rng):
        return float(rng.exponential(1.0 / self.params["rate"]))

    def _emit(self, session, t):
        st = session.engine.state
        pending = session._pending_cancels()
        ins = [i for i in st.in_system_indices()
               if st.specs[i].jid not in pending]
        pick = int(self.rng.integers(len(ins))) if ins else 0
        hi = 2 * (st.specs[ins[pick]].n_tasks if ins else 1)
        new_n = int(self.rng.integers(1, hi + 1))
        if not ins:
            return
        jid = st.specs[ins[pick]].jid
        self._inject(session, ClusterEvent(
            t, "resize", jids=(int(jid),), value=float(new_n)))


@register_stream("noise")
class NoiseStream(Stream):
    """Lognormal processing-time noise: estimate vs truth divergence.

    Not clock-driven: on every :meth:`SimSession.submit` the stream rewrites
    the new jobs' *truth* column ``proc_truth = proc_time * LogN(sigma)``
    (mean-preserving, ``mu = -sigma^2/2``) while policies keep observing the
    clean ``proc_time`` estimate.  Works under batch policies too (no
    cluster events involved).
    """

    needs_cluster_events = False

    def __init__(self, sigma: float = 0.35):
        if sigma <= 0:
            raise ValueError("noise needs sigma > 0")
        super().__init__(sigma=sigma)

    def on_submitted(self, session, idx):
        st = session.engine.state
        sigma = self.params["sigma"]
        for i in idx:                   # index order: deterministic
            st.proc_truth[i] = st.proc_time[i] * float(
                self.rng.lognormal(mean=-0.5 * sigma * sigma, sigma=sigma))


# --------------------------------------------------------------------------- #
# the narrator                                                                 #
# --------------------------------------------------------------------------- #
class Narrator:
    """A seeded composition of event streams driving one session.

    Attach with :meth:`SimSession.attach_narrator`; the session's loop
    peeks/fires it between events.  ``state()``/``from_state`` round-trip
    the full RNG state bit-exactly through session snapshots.
    """

    def __init__(self, streams: Sequence[Stream], seed: int = 0):
        self.seed = int(seed)
        self.streams = list(streams)
        if not self.streams:
            raise ValueError("narrator needs at least one stream")
        for k, s in enumerate(self.streams):
            s.seed(self.seed, k)

    def needs_cluster_events(self) -> bool:
        return any(s.needs_cluster_events for s in self.streams)

    # ---- the session-facing surface -------------------------------------- #
    def peek(self, session) -> float:
        """Earliest pending firing time across the streams."""
        return min((s.peek(session) for s in self.streams),
                   default=math.inf)

    def fire(self, session) -> None:
        """Fire the single earliest stream (ties: composition order)."""
        best, t = None, math.inf
        for s in self.streams:
            ts = s.peek(session)
            if ts < t:
                best, t = s, ts
        if best is not None and math.isfinite(t):
            best.fire(session)

    def on_submitted(self, session, idx: Sequence[int]) -> None:
        for s in self.streams:
            s.on_submitted(session, idx)

    def reseed(self, seed: int) -> None:
        """Re-derive every stream's RNG from a fresh seed and drop the
        pending firing times (they re-prime lazily at the session clock).

        This is how what-if branches race *oracle-free*: every branch of
        one race shares the same reseeded chaos (common random numbers,
        fair comparison) while being decorrelated from the future the live
        session will actually experience."""
        self.seed = int(seed)
        for k, s in enumerate(self.streams):
            s.seed(self.seed, k)
            s.next_t = None

    # ---- snapshot round-trip -------------------------------------------- #
    def state(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "streams": [s.state() for s in self.streams]}

    @classmethod
    def from_state(cls, payload: Dict[str, Any]) -> "Narrator":
        streams = []
        for sp in payload["streams"]:
            kind = sp["kind"]
            if kind not in _STREAMS:
                raise ValueError(
                    f"unknown narrator stream {kind!r} in snapshot; "
                    f"known: {list_streams()}")
            streams.append(_STREAMS[kind](**sp["params"]))
        nar = cls(streams, seed=payload["seed"])
        for s, sp in zip(nar.streams, payload["streams"]):
            s.load_state(sp)
        return nar

    def __repr__(self) -> str:
        return (f"Narrator({'+'.join(map(repr, self.streams))}, "
                f"seed={self.seed})")


def parse_narrator(spec: str, seed: int = 0) -> Narrator:
    """Build a narrator from the ``+`` grammar, e.g.
    ``"breakdown(mtbf=2e4,repair=2e3)+cancel(rate=1e-4)+noise(sigma=0.3)"``.
    A bare kind uses the stream's default parameters."""
    streams: List[Stream] = []
    for part in spec.split("+"):
        part = part.strip()
        m = re.fullmatch(r"([A-Za-z_][\w]*)\s*(?:\((.*)\))?", part)
        if not m:
            raise ValueError(f"malformed narrator stream {part!r}")
        kind, argstr = m.group(1), m.group(2)
        if kind not in _STREAMS:
            raise ValueError(f"unknown narrator stream {kind!r}; "
                             f"known: {list_streams()}")
        kwargs: Dict[str, float] = {}
        for kv in (argstr or "").split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, eq, val = kv.partition("=")
            if not eq:
                raise ValueError(
                    f"narrator stream argument {kv!r} must be key=value")
            kwargs[key.strip()] = float(val)
        streams.append(_STREAMS[kind](**kwargs))
    return Narrator(streams, seed=seed)
