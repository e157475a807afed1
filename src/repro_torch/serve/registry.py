"""Session registry: named live sessions, snapshot-backed eviction, and
journal-based crash recovery.

Every (tenant, session) pair owns two files under the store root::

    <store>/<tenant>/<name>.snap.json   # {"schema", "seq", "closed", "session"}
    <store>/<tenant>/<name>.journal     # JSONL: {"seq", "op", "args"}

and the invariant tying them together: **the snapshot covers every
mutating op with ``seq < snap_seq``; the journal holds (at least) every
applied op with ``seq >= snap_seq``.**  Each mutating op is appended to
the journal — flushed and fsynced — *before* it is applied, so after any
crash the durable state implies the applied state:

* op journaled + applied + acked            → replayed, ``dup`` on resend
* op journaled, crash before apply/ack      → replayed; the client's
  resend of the same seq is answered ``dup`` — the op happened once
* crash before the journal write            → op never happened; the
  client's resend applies it fresh

Because :func:`~repro_torch.serve.protocol.apply_op` is deterministic and
:meth:`SimSession.restore` is bit-exact, ``snapshot ∘ journal-replay``
reproduces the uninterrupted session bit for bit — ``kill -9`` mid-run
included.  The same mechanism is the **eviction** path: an idle session
is persisted (snapshot at the current seq, journal truncated) and its
live object dropped; the next touch rehydrates it transparently.  The
server holds thousands of named sessions while only ``max_live`` engine
states exist in memory.

Sessions open and rehydrate on the registry's ``device``; an evicted or
closed session drops its allocation backend with its engine, so the
device memory in use follows ``max_live``, not the sessions held.  A
failure of the backend (:class:`~repro_torch.device.BackendFault`: no
card, a kernel that does not build or launch, a CUDA error) is not a
deterministic op failure: it is never swallowed on replay, and a failed
``open`` keeps its journaled entry, as after a crash.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.ioutil import atomic_write_json, atomic_write_text
from ..device import BackendFault
from ..sched.session import SimSession
from .protocol import (E_BAD_REQUEST, E_SEQ_GAP, E_SESSION_CLOSED,
                       E_UNKNOWN_SESSION, ProtocolError, apply_op,
                       build_session)

__all__ = ["SessionStore", "SessionRegistry"]

SNAP_SCHEMA = "repro.serve-snap/v1"


# --------------------------------------------------------------------------- #
# durable store                                                                #
# --------------------------------------------------------------------------- #
class SessionStore:
    """The on-disk half: snapshot + journal files per (tenant, session)."""

    def __init__(self, root: Optional[str], *, fsync: bool = True):
        self.root = root
        self.fsync = fsync
        if root is not None:
            os.makedirs(root, exist_ok=True)

    @property
    def persistent(self) -> bool:
        return self.root is not None

    # -- paths --------------------------------------------------------------
    def snap_path(self, tenant: str, name: str) -> str:
        return os.path.join(self.root, tenant, f"{name}.snap.json")

    def journal_path(self, tenant: str, name: str) -> str:
        return os.path.join(self.root, tenant, f"{name}.journal")

    # -- journal ------------------------------------------------------------
    def open_journal(self, tenant: str, name: str):
        path = self.journal_path(tenant, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return open(path, "a")

    def append(self, fh, entry: Dict[str, Any]) -> None:
        """Durable journal append: the entry is on disk before the op it
        describes is applied (write-ahead)."""
        fh.write(json.dumps(entry, separators=(",", ":")) + "\n")
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())

    def reset_journal(self, tenant: str, name: str) -> None:
        """Truncate the journal (atomically) — called right after a
        snapshot persist makes its entries redundant."""
        atomic_write_text(self.journal_path(tenant, name), "")

    def read_journal(self, tenant: str, name: str) -> List[Dict[str, Any]]:
        """Journal entries, tolerating a torn trailing line (a crash mid-
        append): parsing stops at the first undecodable line — by the
        write-ahead rule nothing after it was ever applied."""
        path = self.journal_path(tenant, name)
        if not os.path.exists(path):
            return []
        out: List[Dict[str, Any]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    print(f"warning: {path}: torn trailing journal entry "
                          f"dropped (crash mid-append)", file=sys.stderr)
                    break
        return out

    # -- snapshots ----------------------------------------------------------
    def persist_snapshot(self, tenant: str, name: str, seq: int,
                         session_payload: Dict[str, Any],
                         closed: bool) -> None:
        atomic_write_json(self.snap_path(tenant, name), {
            "schema": SNAP_SCHEMA,
            "seq": int(seq),
            "closed": bool(closed),
            "session": session_payload,
        }, indent=None)
        self.reset_journal(tenant, name)

    def read_snapshot(self, tenant: str,
                      name: str) -> Optional[Dict[str, Any]]:
        path = self.snap_path(tenant, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            payload = json.load(f)
        if payload.get("schema") != SNAP_SCHEMA:
            raise ValueError(f"{path} is not a {SNAP_SCHEMA} snapshot "
                             f"(schema: {payload.get('schema')!r})")
        return payload

    def delete(self, tenant: str, name: str) -> None:
        for path in (self.snap_path(tenant, name),
                     self.journal_path(tenant, name)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def scan(self) -> List[Tuple[str, str]]:
        """Every (tenant, session) with durable state on disk."""
        if not self.persistent or not os.path.isdir(self.root):
            return []
        found = set()
        for tenant in sorted(os.listdir(self.root)):
            tdir = os.path.join(self.root, tenant)
            if not os.path.isdir(tdir):
                continue
            for fname in sorted(os.listdir(tdir)):
                if fname.endswith(".snap.json"):
                    found.add((tenant, fname[:-len(".snap.json")]))
                elif fname.endswith(".journal"):
                    found.add((tenant, fname[:-len(".journal")]))
        return sorted(found)


# --------------------------------------------------------------------------- #
# registry                                                                     #
# --------------------------------------------------------------------------- #
def _release(ses: SimSession) -> None:
    """Close a session that leaves the live cache (its close hooks run) and
    drop its allocation backend, with whatever the backend holds."""
    ses.close()
    ses.engine.alloc_backend = None


class _Entry:
    __slots__ = ("tenant", "name", "session", "seq", "snap_seq", "closed",
                 "last_touch", "journal_fh", "dirty")

    def __init__(self, tenant: str, name: str):
        self.tenant = tenant
        self.name = name
        self.session: Optional[SimSession] = None
        self.seq = 0                # next expected mutating-op seq
        self.snap_seq = 0           # ops covered by the on-disk snapshot
        self.closed = False
        self.last_touch = 0.0
        self.journal_fh = None
        self.dirty = False          # mutations not yet in a snapshot

    @property
    def live(self) -> bool:
        return self.session is not None


class SessionRegistry:
    """Live-session cache over the durable :class:`SessionStore`.

    All mutating traffic funnels through :meth:`apply_mutating` — seq
    dedup, write-ahead journaling, lazy rehydration and the apply itself —
    so the live path and the crash-recovery path share one code path and
    cannot drift.  Not thread-safe by design: the server's single asyncio
    dispatcher is the only caller.
    """

    def __init__(self, store: SessionStore, *, max_live: int = 256,
                 idle_evict_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        self.store = store
        self.device = device
        self.max_live = max(1, int(max_live))
        self.idle_evict_s = idle_evict_s
        self._clock = clock
        self.entries: Dict[Tuple[str, str], _Entry] = {}
        self.n_evictions = 0
        self.n_rehydrations = 0

    # -- introspection ------------------------------------------------------
    @property
    def n_sessions(self) -> int:
        return len(self.entries)

    @property
    def n_live(self) -> int:
        return sum(1 for e in self.entries.values() if e.live)

    def stats(self) -> Dict[str, Any]:
        return {
            "sessions": self.n_sessions,
            "live": self.n_live,
            "closed": sum(1 for e in self.entries.values() if e.closed),
            "evictions": self.n_evictions,
            "rehydrations": self.n_rehydrations,
            "max_live": self.max_live,
        }

    def sessions_of(self, tenant: str) -> List[str]:
        return sorted(n for (t, n) in self.entries if t == tenant)

    # -- crash recovery -----------------------------------------------------
    def recover(self) -> int:
        """Scan the store and register every persisted session as a cold
        entry (rehydrated lazily on first touch).  Returns how many were
        recovered."""
        n = 0
        for tenant, name in self.store.scan():
            if (tenant, name) in self.entries:
                continue
            ent = _Entry(tenant, name)
            snap = self.store.read_snapshot(tenant, name)
            if snap is not None:
                ent.snap_seq = ent.seq = int(snap["seq"])
                ent.closed = bool(snap.get("closed", False))
            entries = self.store.read_journal(tenant, name)
            for rec in entries:
                if int(rec["seq"]) >= ent.seq:
                    ent.seq = int(rec["seq"]) + 1
                    ent.dirty = True
                if rec["op"] == "close":
                    ent.closed = True
            if snap is None and not entries:
                continue            # empty files: nothing durable happened
            ent.last_touch = self._clock()
            self.entries[(tenant, name)] = ent
            n += 1
        return n

    # -- the one mutating entry point ---------------------------------------
    def apply_mutating(self, tenant: str, name: str, op: str,
                       args: Dict[str, Any],
                       seq: Optional[int] = None) -> Dict[str, Any]:
        """Seq-checked, journaled application of one mutating op.

        Raises :class:`ProtocolError` for requests refused *before* the
        journal write (unknown/closed session, seq gap, duplicate open) —
        those consume no seq.  Once journaled, the op consumes its seq
        even if the simulation rejects it (the failure replays
        identically), and the error propagates to the caller.
        """
        key = (tenant, name)
        ent = self.entries.get(key)
        if op == "open":
            if ent is not None:
                if seq is not None and seq < ent.seq:
                    return self._dup(ent, seq)  # idempotent re-open
                if ent.closed:
                    raise ProtocolError(
                        E_SESSION_CLOSED,
                        f"session {tenant}/{name} is closed "
                        f"(seq={ent.seq}); delete it to reuse the name")
                raise ProtocolError(
                    E_BAD_REQUEST,
                    f"session {tenant}/{name} already exists "
                    f"(seq={ent.seq}); close it or pick a fresh name")
            ent = self.entries[key] = _Entry(tenant, name)
        else:
            if ent is None:
                raise ProtocolError(
                    E_UNKNOWN_SESSION,
                    f"unknown session {tenant}/{name}; open it first")
            if ent.closed:
                if seq is not None and seq < ent.seq:
                    return self._dup(ent, seq)
                raise ProtocolError(
                    E_SESSION_CLOSED,
                    f"session {tenant}/{name} is closed")
        if seq is None:
            seq = ent.seq
        if seq < ent.seq:
            return self._dup(ent, seq)
        if seq > ent.seq:
            raise ProtocolError(
                E_SEQ_GAP,
                f"seq {seq} is ahead of session {tenant}/{name} "
                f"(next expected: {ent.seq}); an earlier op was lost")
        self._touch(ent)
        if op != "open":
            # rehydrate BEFORE journaling the new entry: replay must only
            # see ops that were applied in a previous life, never the one
            # about to be applied (it would run twice)
            self._live(ent)
        self._journal(ent, {"seq": seq, "op": op, "args": args})
        ent.seq += 1
        ent.dirty = True
        return self._apply_live(ent, op, args)

    def _dup(self, ent: _Entry, seq: int) -> Dict[str, Any]:
        return {"dup": True, "seq": seq, "applied_seq": ent.seq}

    # -- read-only paths ----------------------------------------------------
    def live_session(self, tenant: str, name: str) -> SimSession:
        """The live session object, rehydrating a cold entry on demand."""
        ent = self.entries.get((tenant, name))
        if ent is None:
            raise ProtocolError(
                E_UNKNOWN_SESSION,
                f"unknown session {tenant}/{name}; open it first")
        self._touch(ent)
        return self._live(ent)

    def checkpoint(self, tenant: str, name: str) -> Dict[str, Any]:
        """Persist a snapshot now (the ``snapshot`` op): returns seq and
        the session fingerprint."""
        ent = self.entries.get((tenant, name))
        if ent is None:
            raise ProtocolError(
                E_UNKNOWN_SESSION,
                f"unknown session {tenant}/{name}; open it first")
        if not self.store.persistent:
            raise ProtocolError(
                E_BAD_REQUEST, "server has no snapshot store (started "
                "without --store); snapshots are unavailable")
        self._touch(ent)
        fp = self._persist(ent)
        return {"seq": ent.seq, "fingerprint": fp,
                "path": self.store.snap_path(tenant, name)}

    # -- reclamation --------------------------------------------------------
    def delete_session(self, tenant: str, name: str) -> Dict[str, Any]:
        """Forget a *closed* session entirely: drop its registry entry and
        remove its snapshot/journal files, freeing the name for reuse.
        The reclamation path for long-lived servers — without it closed
        entries (and their disk state) accumulate forever."""
        key = (tenant, name)
        ent = self.entries.get(key)
        if ent is None:
            raise ProtocolError(
                E_UNKNOWN_SESSION,
                f"unknown session {tenant}/{name}; nothing to delete")
        if not ent.closed:
            raise ProtocolError(
                E_BAD_REQUEST,
                f"session {tenant}/{name} is still open; close it "
                f"before deleting")
        self._drop(ent)
        return {"deleted": True, "seq": ent.seq}

    def _drop(self, ent: _Entry) -> None:
        """Remove an entry and all its durable state (the point of no
        return: the name is fresh afterwards)."""
        if ent.journal_fh is not None:
            ent.journal_fh.close()
            ent.journal_fh = None
        if ent.live:
            ses, ent.session = ent.session, None
            _release(ses)
        self.entries.pop((ent.tenant, ent.name), None)
        if self.store.persistent:
            self.store.delete(ent.tenant, ent.name)

    # -- eviction -----------------------------------------------------------
    def evict(self, tenant: str, name: str) -> None:
        ent = self.entries[(tenant, name)]
        if not ent.live:
            return
        if not self.store.persistent:
            raise ProtocolError(
                E_BAD_REQUEST, "cannot evict without a snapshot store")
        self._persist(ent)
        ses, ent.session = ent.session, None
        _release(ses)               # run close hooks, free the live object
        self.n_evictions += 1

    def evict_over_cap(self) -> int:
        """LRU-evict live sessions until at most ``max_live`` remain."""
        n = 0
        while self.store.persistent and self.n_live > self.max_live:
            victims = sorted(
                (e for e in self.entries.values() if e.live),
                key=lambda e: e.last_touch)
            self.evict(victims[0].tenant, victims[0].name)
            n += 1
        return n

    def evict_idle(self) -> int:
        """Evict live sessions untouched for ``idle_evict_s``."""
        if self.idle_evict_s is None or not self.store.persistent:
            return 0
        cutoff = self._clock() - self.idle_evict_s
        n = 0
        for ent in list(self.entries.values()):
            if ent.live and ent.last_touch < cutoff:
                self.evict(ent.tenant, ent.name)
                n += 1
        return n

    def close_all(self) -> None:
        """Server shutdown: persist every dirty live session and drop it."""
        for ent in self.entries.values():
            if ent.live and self.store.persistent:
                self._persist(ent)
            if ent.live:
                _release(ent.session)
                ent.session = None
            if ent.journal_fh is not None:
                ent.journal_fh.close()
                ent.journal_fh = None

    def abandon(self) -> None:
        """Stop after a backend fault: close every journal and drop every
        live session *without* persisting — the live state may hold a
        half-applied op, while the journals hold every op up to the fault,
        so the next start recovers as after a crash."""
        for ent in self.entries.values():
            ent.session = None
            if ent.journal_fh is not None:
                ent.journal_fh.close()
                ent.journal_fh = None

    # -- internals ----------------------------------------------------------
    def _touch(self, ent: _Entry) -> None:
        ent.last_touch = self._clock()

    def _journal(self, ent: _Entry, entry: Dict[str, Any]) -> None:
        if not self.store.persistent:
            return
        if ent.journal_fh is None:
            ent.journal_fh = self.store.open_journal(ent.tenant, ent.name)
        self.store.append(ent.journal_fh, entry)

    def _persist(self, ent: _Entry) -> str:
        """Snapshot the entry at its current seq and truncate the journal
        (snapshot-then-truncate: a crash in between leaves stale journal
        entries with seq < snap_seq, which replay skips)."""
        ses = self._live(ent)
        snap = ses.snapshot()
        self.store.persist_snapshot(ent.tenant, ent.name, ent.seq,
                                    snap.to_json_dict(), ent.closed)
        if ent.journal_fh is not None:
            ent.journal_fh.close()  # reopen against the truncated file
            ent.journal_fh = None
        ent.snap_seq = ent.seq
        ent.dirty = False
        return snap.fingerprint

    def _live(self, ent: _Entry) -> SimSession:
        if ent.session is not None:
            return ent.session
        ent.session = self._rehydrate(ent)
        self.n_rehydrations += 1
        return ent.session

    def _rehydrate(self, ent: _Entry) -> SimSession:
        """snapshot ∘ journal-replay: rebuild the live session exactly."""
        snap = self.store.read_snapshot(ent.tenant, ent.name)
        ses: Optional[SimSession] = None
        base_seq = 0
        if snap is not None:
            ses = SimSession.restore(snap["session"], device=self.device)
            base_seq = int(snap["seq"])
        for rec in self.store.read_journal(ent.tenant, ent.name):
            seq, op, args = int(rec["seq"]), rec["op"], rec["args"]
            if seq < base_seq:
                continue            # covered by the snapshot
            if op == "open":
                ses = build_session(args, self.device)
                continue
            if op == "close":
                continue            # terminal marker; ent.closed has it
            if ses is None:
                raise ValueError(
                    f"journal for {ent.tenant}/{ent.name} starts mid-"
                    f"stream (seq {seq} {op!r}) with no snapshot")
            try:
                apply_op(ses, op, args)
            except BackendFault:
                raise               # the device failed, not the op
            except Exception:       # noqa: BLE001 — deterministic: the op
                pass                # failed identically when applied live
        if ses is None:
            raise ValueError(
                f"no durable state for session {ent.tenant}/{ent.name}")
        return ses

    def _apply_live(self, ent: _Entry, op: str,
                    args: Dict[str, Any]) -> Dict[str, Any]:
        if op == "open":
            try:
                ent.session = build_session(args, self.device)
            except BackendFault:
                raise               # journaled: replayed as after a crash
            except Exception:
                # a failed open can never yield a usable session, and its
                # journaled op would poison every later rehydrate of the
                # entry — erase it (entry + journal) so the name stays
                # fresh and a corrected open can apply at seq 0
                self._drop(ent)
                raise
            return {"policy": ent.session.policy_name,
                    **ent.session.observe()}
        if op == "close":
            ent.closed = True
            if self.store.persistent:
                self._persist(ent)  # final durable state carries closed=True
            if ent.live:
                ses, ent.session = ent.session, None
                _release(ses)
            if ent.journal_fh is not None:
                ent.journal_fh.close()
                ent.journal_fh = None
            return {"closed": True, "seq": ent.seq}
        return apply_op(self._live(ent), op, args)
