"""Columnar Trace IR: the structure-of-arrays workload interchange format.

A :class:`Trace` is the frozen, columnar representation of one workload —
six parallel NumPy arrays (``jid``/``release``/``proc_time``/``n_tasks``/
``cpu_need``/``mem_req``) instead of a ``List[JobSpec]`` object graph.  It
is what workload generators produce and what the engine ingests column-wise
(``EngineState.from_trace``).

``fingerprint`` is a SHA-256 over the schema tag and the column bytes,
stable across processes and platforms, so two traces with the same jobs
have the same fingerprint whichever package built them.

Validation happens once, vectorized, at construction (the same invariants
as ``JobSpec.__post_init__``); ``to_specs`` then rebuilds plain validated
``JobSpec`` objects.  All columns are read-only; transforms build new
traces via :meth:`select`.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.job import JobSpec

__all__ = ["Trace", "as_trace", "COLUMNS"]

#: the trace format tag hashed into every fingerprint
_SCHEMA = "repro.trace/v1"

#: (column name, dtype) — the IR's canonical layout, in fingerprint order
COLUMNS: Tuple[Tuple[str, type], ...] = (
    ("jid", np.int64),
    ("release", np.float64),
    ("proc_time", np.float64),
    ("n_tasks", np.int64),
    ("cpu_need", np.float64),
    ("mem_req", np.float64),
)


class Trace:
    """Frozen columnar workload: parallel arrays, one row per job.

    ``proc_truth`` is an *optional* seventh column: the processing time the
    engine actually executes when it differs from the non-clairvoyant
    ``proc_time`` estimate the policies observe.  When absent the trace is
    clairvoyant and the column takes no part in the fingerprint.
    """

    __slots__ = ("jid", "release", "proc_time", "n_tasks", "cpu_need",
                 "mem_req", "proc_truth", "_fingerprint")

    def __init__(
        self,
        jid: np.ndarray,
        release: np.ndarray,
        proc_time: np.ndarray,
        n_tasks: np.ndarray,
        cpu_need: np.ndarray,
        mem_req: np.ndarray,
        proc_truth: Optional[np.ndarray] = None,
        validate: bool = True,
    ):
        cols = dict(jid=jid, release=release, proc_time=proc_time,
                    n_tasks=n_tasks, cpu_need=cpu_need, mem_req=mem_req)
        if proc_truth is not None:
            cols["proc_truth"] = proc_truth
        n = len(cols["jid"])
        for name, src in cols.items():
            dtype = np.int64 if name in ("jid", "n_tasks") else np.float64
            arr = np.ascontiguousarray(src, dtype=dtype)
            if arr.ndim != 1 or len(arr) != n:
                raise ValueError(
                    f"column {name!r} must be 1-D of length {n}, "
                    f"got shape {arr.shape}")
            if arr is src and arr.flags.writeable:
                arr = arr.copy()
            arr.flags.writeable = False
            object.__setattr__(self, name, arr)
        if proc_truth is None:
            object.__setattr__(self, "proc_truth", None)
        object.__setattr__(self, "_fingerprint", None)
        if validate:
            self._validate()

    # Trace is frozen: columns are read-only arrays, attributes final.
    def __setattr__(self, name, value):
        raise AttributeError("Trace is frozen; build a new one with select() or replace()")

    def _validate(self) -> None:
        """The JobSpec invariants, checked once over whole columns."""
        def bad(mask: np.ndarray, what: str) -> None:
            if mask.any():
                i = int(np.argmax(mask))
                raise ValueError(
                    f"{what} (first offender: row {i}, jid "
                    f"{int(self.jid[i])})")
        bad(~((self.cpu_need > 0.0) & (self.cpu_need <= 1.0)),
            "cpu_need must be in (0,1]")
        bad(~((self.mem_req > 0.0) & (self.mem_req <= 1.0)),
            "mem_req must be in (0,1]")
        bad(self.n_tasks < 1, "n_tasks must be >= 1")
        bad(self.proc_time <= 0.0, "proc_time must be > 0")
        bad(~np.isfinite(self.release), "release must be finite")
        if self.proc_truth is not None:
            bad(~(self.proc_truth > 0.0) | ~np.isfinite(self.proc_truth),
                "proc_truth must be finite and > 0")

    # ------------------------------------------------------------------ #
    # basics                                                              #
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.jid)

    def __repr__(self) -> str:
        return (f"Trace(n_jobs={len(self)}, "
                f"fingerprint={self.fingerprint[:12]}…)")

    def __eq__(self, other) -> bool:
        return isinstance(other, Trace) and self.fingerprint == other.fingerprint

    def __hash__(self) -> int:
        return hash(self.fingerprint)

    @property
    def fingerprint(self) -> str:
        """SHA-256 content hash of the columns (schema-tagged, process- and
        platform-stable for the fixed little-endian column dtypes)."""
        fp = self._fingerprint
        if fp is None:
            h = hashlib.sha256()
            h.update(f"{_SCHEMA}:{len(self)}".encode())
            for name, _ in COLUMNS:
                col = getattr(self, name)
                h.update(name.encode())
                h.update(col.astype(col.dtype.newbyteorder("<"),
                                    copy=False).tobytes())
            if self.proc_truth is not None:
                h.update(b"proc_truth")
                h.update(self.proc_truth.astype(
                    self.proc_truth.dtype.newbyteorder("<"),
                    copy=False).tobytes())
            fp = h.hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    def span(self) -> Tuple[float, float]:
        """(first release, max(release span, 1.0)) — the scenario timebase."""
        if not len(self):
            return 0.0, 1.0
        lo = float(self.release.min())
        hi = float(self.release.max())
        return lo, max(hi - lo, 1.0)

    # ------------------------------------------------------------------ #
    # construction boundaries                                             #
    # ------------------------------------------------------------------ #
    @classmethod
    def from_columns(cls, columns: Dict[str, np.ndarray]) -> "Trace":
        """Build a trace from a ``{column: array}`` mapping — the six
        :data:`COLUMNS` plus an optional ``proc_truth``.  Values are taken
        exactly as given, so a trace carried over from another program
        keeps its fingerprint."""
        known = {name for name, _ in COLUMNS} | {"proc_truth"}
        unknown = set(columns) - known
        if unknown:
            raise ValueError(f"unknown Trace columns: {sorted(unknown)}")
        missing = {name for name, _ in COLUMNS} - set(columns)
        if missing:
            raise ValueError(f"missing Trace columns: {sorted(missing)}")
        return cls(**{name: np.asarray(columns[name]) for name, _ in COLUMNS},
                   proc_truth=columns.get("proc_truth"))

    @classmethod
    def from_specs(cls, specs: Iterable[JobSpec]) -> "Trace":
        specs = list(specs)
        return cls(
            jid=np.array([s.jid for s in specs], dtype=np.int64),
            release=np.array([s.release for s in specs], dtype=np.float64),
            proc_time=np.array([s.proc_time for s in specs], dtype=np.float64),
            n_tasks=np.array([s.n_tasks for s in specs], dtype=np.int64),
            cpu_need=np.array([s.cpu_need for s in specs], dtype=np.float64),
            mem_req=np.array([s.mem_req for s in specs], dtype=np.float64),
        )

    def to_specs(self) -> List[JobSpec]:
        """Rebuild the ``JobSpec`` list (row order preserved, exact values)."""
        return [
            JobSpec(jid=int(j), release=float(r), proc_time=float(p),
                    n_tasks=int(t), cpu_need=float(c), mem_req=float(m))
            for j, r, p, t, c, m in zip(
                self.jid, self.release, self.proc_time,
                self.n_tasks, self.cpu_need, self.mem_req)
        ]

    # ------------------------------------------------------------------ #
    # transforms (always produce a new Trace)                             #
    # ------------------------------------------------------------------ #
    def replace(self, **columns: np.ndarray) -> "Trace":
        """New trace with the given columns replaced (others shared).
        ``proc_truth=None`` drops the truth column."""
        known = {name for name, _ in COLUMNS} | {"proc_truth"}
        unknown = set(columns) - known
        if unknown:
            raise ValueError(f"unknown Trace columns: {sorted(unknown)}")
        kw = {name: columns.get(name, getattr(self, name))
              for name in known}
        return Trace(**kw)

    def select(self, index: np.ndarray) -> "Trace":
        """Row subset / reorder by boolean mask or integer index array."""
        index = np.asarray(index)
        truth = None if self.proc_truth is None else self.proc_truth[index]
        return Trace(*(getattr(self, name)[index] for name, _ in COLUMNS),
                     proc_truth=truth, validate=False)

    def sorted_by_release(self) -> "Trace":
        """Rows ordered by (release, jid) — the engine's arrival order."""
        order = np.lexsort((self.jid, self.release))
        if (order == np.arange(len(order))).all():
            return self
        return self.select(order)

    def iter_chunks(self, window_s: float):
        """Yield release-windowed sub-traces for streaming ingest.

        Rows are partitioned into half-open windows
        ``[lo + k*window_s, lo + (k+1)*window_s)`` anchored at the first
        release; empty windows are skipped.  Chunks come out in release
        order (each is a contiguous slice of :meth:`sorted_by_release`),
        so concatenating them reproduces the sorted trace exactly — the
        contract :meth:`SimSession.stream
        <repro_torch.sched.session.SimSession.stream>` relies on for
        bit-identical results.
        """
        if not window_s > 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if not len(self):
            return
        t = self.sorted_by_release()
        lo = float(t.release[0])
        bucket = np.floor((t.release - lo) / float(window_s)).astype(np.int64)
        _, starts = np.unique(bucket, return_index=True)
        bounds = np.append(starts, len(t))
        for a, b in zip(bounds[:-1], bounds[1:]):
            yield t.select(np.arange(a, b))


def as_trace(trace_or_specs) -> Trace:
    """Coerce either IR form (a Trace passes through untouched)."""
    if isinstance(trace_or_specs, Trace):
        return trace_or_specs
    return Trace.from_specs(trace_or_specs)
