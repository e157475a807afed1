"""Wire protocol + deterministic op semantics for the session server.

One JSON object per line over a TCP stream (the same JSONL convention as
the ``session`` CLI).  Requests carry::

    {"id": 7, "tenant": "acme", "op": "step_until", "session": "s0",
     "seq": 3, "t": 3600.0}

and responses echo the ``id``::

    {"id": 7, "ok": true, ...payload}                    # success
    {"id": 7, "ok": false, "code": "...", "error": "…"}  # failure

``op`` semantics are split into:

* **mutating ops** (:data:`MUTATING_OPS`) — they advance simulation
  state, are journaled *before* application, and carry a per-session
  monotonically increasing ``seq``.  Re-sending an already-applied seq is
  answered ``{"ok": true, "dup": true}`` without re-applying, which makes
  client retries after a connection loss (or a server ``kill -9`` +
  restart) exactly-once: the journal replay plus seq dedup reproduce the
  uninterrupted run bit for bit.  Every mutating response — success,
  dup or error — also carries ``next_seq``, the session's authoritative
  next expected seq, so clients resync instead of guessing whether a
  failed op consumed one (a journaled op that the engine rejected did).
* **read-only ops** (``observe``/``result``/``snapshot``/``stats``/…) —
  never journaled, no seq.
* ``delete`` — reclamation: forget a *closed* session (registry entry +
  snapshot/journal files), freeing its name for reuse.  Not journaled —
  its effect is removing the journal — and naturally idempotent (a
  repeat answers ``unknown-session``).

Everything a mutating op does must be a *deterministic* function of its
journaled ``(op, args)`` — that is what makes crash recovery a replay.
:func:`build_session` and :func:`apply_op` are that function, shared by
the live dispatch path and the journal-replay path so the two can never
drift.

The op set, the error codes and the frame format are the JAX package's
(``repro.serve/v1``), so either package's client talks to either
package's server.  A session opens (and rehydrates) on the server's
device: its §4.6 reallocations run there.  This module imports the
session layer (and so torch) only when a session is built, so the client
stays a plain socket program.
"""
from __future__ import annotations

import json
import re
from typing import TYPE_CHECKING, Any, Dict

if TYPE_CHECKING:  # pragma: no cover
    from ..sched.session import SimSession

SCHEMA = "repro.serve/v1"

#: ops that advance session state; journaled with a per-session ``seq``
MUTATING_OPS = frozenset({
    "open", "submit", "step_until", "step", "run", "inject", "period",
    "tune", "close",
})
#: ops that only read (or persist a checkpoint of) existing state
READ_OPS = frozenset({"observe", "result", "snapshot"})
#: tenant/server-level ops outside any session
CONTROL_OPS = frozenset({"hello", "ping", "stats", "shutdown"})

#: error codes a client can branch on
E_BAD_REQUEST = "bad-request"          # malformed frame / unknown op
E_ADMISSION = "admission-denied"       # queue full / tenant over limits
E_OVER_BUDGET = "over-budget"          # credit budget exhausted this window
E_UNKNOWN_SESSION = "unknown-session"
E_SESSION_CLOSED = "session-closed"
E_SEQ_GAP = "seq-gap"                  # seq from the future: lost request
E_OP_ERROR = "op-error"                # the op itself raised (deterministic)

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]{0,63}$")


class ProtocolError(ValueError):
    """A request the server refuses; carries a machine-readable code."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def check_name(kind: str, name: Any) -> str:
    """Tenant and session names become directory/file names in the
    snapshot store — constrain them to a path-safe alphabet."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ProtocolError(
            E_BAD_REQUEST,
            f"invalid {kind} name {name!r}: need 1-64 chars of "
            f"[A-Za-z0-9_.-], starting alphanumeric")
    return name


def encode(obj: Dict[str, Any]) -> bytes:
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def decode(line: bytes) -> Dict[str, Any]:
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as exc:
        raise ProtocolError(E_BAD_REQUEST, f"undecodable frame: {exc}")
    if not isinstance(obj, dict):
        raise ProtocolError(E_BAD_REQUEST, "frame must be a JSON object")
    return obj


def error_response(req_id: Any, code: str, message: str) -> Dict[str, Any]:
    return {"id": req_id, "ok": False, "code": code, "error": message}


# --------------------------------------------------------------------------- #
# deterministic op semantics (shared by live dispatch and journal replay)      #
# --------------------------------------------------------------------------- #
def build_session(args: Dict[str, Any], device="cuda") -> SimSession:
    """Materialize an ``open`` op: a fresh session from journaled args,
    allocating on ``device``.

    Deterministic: policy strings, node counts, param overrides and the
    (seeded) narrator spec fully determine the session.
    """
    from ..sched.session import open_session
    overrides = {k: args[k] for k in ("period", "penalty") if k in args}
    ses = open_session(int(args.get("nodes", 64)), args["policy"],
                       device=device, **overrides)
    spec = args.get("narrator")
    if spec:
        from ..sched.narrator import parse_narrator
        ses.attach_narrator(
            parse_narrator(spec, seed=int(args.get("narrator_seed", 0))))
    tune_spec = args.get("autotune")
    if tune_spec:
        # seeded and wall-clock-free, so an autotuned session replays
        # bit-identically from its journal like any other
        from ..tune.controller import AutoTuner
        ses.attach_autotuner(
            AutoTuner(tune_spec, seed=int(args.get("autotune_seed", 0))))
    return ses


def materialize_submit(ses: SimSession, args: Dict[str, Any]):
    """A ``submit`` op's jobs: inline ``specs`` or a registered workload
    kind (the registry materialization is seeded and deterministic)."""
    from ..core.job import JobSpec
    if "specs" in args:
        return [JobSpec(**{k: s[k] for k in
                           ("jid", "release", "proc_time", "n_tasks",
                            "cpu_need", "mem_req") if k in s})
                for s in args["specs"]]
    from ..workloads.registry import parse_workload
    return parse_workload(
        args["workload"],
        n_jobs=int(args.get("jobs", 100)),
        n_nodes=int(args.get("nodes", ses.engine.params.n_nodes)),
        seed=int(args.get("seed", 0)),
        load=args.get("load"),
    )


def apply_op(ses: SimSession, op: str, args: Dict[str, Any]) -> Dict[str, Any]:
    """Apply one journaled mutating op (except ``open``/``close``, which
    the registry handles) to a live session; returns the response payload.
    Raising is part of the contract: an op that fails live fails
    identically on replay, leaving the same session state either way.
    """
    if op == "submit":
        idx = ses.submit(materialize_submit(ses, args),
                         shift=args.get("shift"))
        return {"n_submitted": len(idx), **ses.observe()}
    if op == "step_until":
        ses.step_until(float(args["t"]))
        return ses.observe()
    if op == "step":
        n = ses.step(int(args.get("n", 1)))
        return {"steps": n, **ses.observe()}
    if op == "run":
        ses.run_to_exhaustion()
        return ses.observe()
    if op == "inject":
        ses.inject({k: v for k, v in args.items()
                    if k not in ("op", "id", "tenant", "session", "seq")})
        return ses.observe()
    if op == "period":
        ses.set_period(float(args["period"]))
        return ses.observe()
    if op == "tune":
        tun = ses.autotuner
        if tun is None:
            raise ProtocolError(
                E_OP_ERROR, "no autotuner attached (open the session "
                "with an 'autotune' spec)")
        swapped = tun.fire(ses, now=True)
        d = tun.decisions[-1]
        return {"swapped": swapped, "reason": d["reason"],
                "decisions": len(tun.decisions),
                "policy": ses.policy_name, **ses.observe()}
    raise ProtocolError(E_BAD_REQUEST, f"unknown mutating op {op!r}")


def op_args(req: Dict[str, Any]) -> Dict[str, Any]:
    """The journalable argument dict of a request: everything except the
    transport envelope (id/tenant/session/op/seq)."""
    return {k: v for k, v in req.items()
            if k not in ("id", "tenant", "session", "op", "seq")}


def result_payload(ses: SimSession) -> Dict[str, Any]:
    import dataclasses
    r = ses.result()
    d = dataclasses.asdict(r)
    d["partial"] = not ses.exhausted
    return d
