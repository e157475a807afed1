"""Synchronous stdlib client for the session server.

:class:`Client` speaks the JSONL protocol over one TCP connection and
adds the two things a caller should never hand-roll:

* **per-session sequence numbers** — every mutating op is stamped with
  the next ``seq`` for its session, making it idempotent on the wire;
  the counter resyncs from the ``next_seq`` the server echoes on every
  mutating response (success, dup or error), so an engine-rejected op —
  which still consumed its journaled seq — cannot desync the stream;
* **reconnect-and-resend** — with ``retry_for > 0`` a dropped connection
  (server restart, ``kill -9`` + recover) is retried transparently: the
  in-flight op is re-sent with its original seq, so an op the server
  journaled before dying is answered ``dup`` instead of applied twice.

Together with the server's write-ahead journal this gives exactly-once
op application end to end, which is what makes a client script re-run
against a recovered server finish bit-identically.  The wire format is the
JAX package's, so this client drives either package's server; it imports
no torch.
"""
from __future__ import annotations

import json
import socket
import time
from typing import Any, Dict, List, Optional

from .protocol import MUTATING_OPS

__all__ = ["Client", "ServeError", "connect"]


class ServeError(RuntimeError):
    """An ``ok: false`` response; ``code`` is the protocol error code."""

    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code


class Client:
    """One tenant's connection to a session server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7463, *,
                 tenant: str = "default", timeout: float = 60.0,
                 retry_for: float = 0.0):
        self.host = host
        self.port = int(port)
        self.tenant = tenant
        self.timeout = timeout
        self.retry_for = float(retry_for)
        self._sock: Optional[socket.socket] = None
        self._fh = None
        self._next_id = 0
        self._seq: Dict[str, int] = {}      # per-session next mutating seq

    # -- connection ---------------------------------------------------------
    def _connect(self) -> None:
        self.close()
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        self._fh = self._sock.makefile("rwb")

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self) -> "Client":
        self.call("hello")
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- the one wire primitive ---------------------------------------------
    def _roundtrip(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if self._fh is None:
            self._connect()
        data = (json.dumps(req, separators=(",", ":")) + "\n").encode()
        self._fh.write(data)
        self._fh.flush()
        line = self._fh.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        resp = json.loads(line)
        if resp.get("id") != req["id"]:
            raise ConnectionError(
                f"response id {resp.get('id')} != request id {req['id']}")
        return resp

    def call(self, op: str, session: Optional[str] = None,
             **args: Any) -> Dict[str, Any]:
        """Issue one op; raises :class:`ServeError` on ``ok: false``.

        Mutating ops are stamped with the session's next seq (unless the
        caller passes an explicit ``seq=``) and survive reconnects: the
        same request — same seq — is re-sent until ``retry_for`` runs out.
        """
        self._next_id += 1
        req: Dict[str, Any] = {"id": self._next_id, "tenant": self.tenant,
                               "op": op, **args}
        if session is not None:
            req["session"] = session
        mutating = op in MUTATING_OPS
        if mutating and session is not None and "seq" not in req:
            req["seq"] = self._seq.get(session, 0)
        deadline = time.monotonic() + self.retry_for
        while True:
            try:
                resp = self._roundtrip(req)
                break
            except (ConnectionError, OSError, json.JSONDecodeError):
                self.close()
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)     # server restarting; resend same seq
        if mutating and session is not None and "next_seq" in resp:
            # the server's authoritative next expected seq — present on
            # success, dup AND error responses.  An op the engine rejected
            # (op-error) still consumed its seq (it was journaled), so
            # syncing only on success would leave every later op answered
            # as a stale dup; resync unconditionally instead
            self._seq[session] = int(resp["next_seq"])
        if not resp.get("ok", False):
            raise ServeError(resp.get("code", "error"),
                             resp.get("error", "unknown server error"))
        if mutating and session is not None and "next_seq" not in resp:
            self._seq[session] = int(req["seq"]) + 1
        if op == "delete" and session is not None:
            self._seq.pop(session, None)    # a reused name restarts at 0
        return resp

    # -- convenience wrappers -----------------------------------------------
    def ping(self) -> bool:
        return bool(self.call("ping").get("pong"))

    def hello(self) -> Dict[str, Any]:
        return self.call("hello")

    def stats(self) -> Dict[str, Any]:
        return self.call("stats")

    def sessions(self) -> List[str]:
        return list(self.call("sessions").get("sessions", []))

    def open(self, session: str, policy: str, *, nodes: int = 64,
             **params: Any) -> Dict[str, Any]:
        return self.call("open", session, policy=policy, nodes=nodes,
                         **params)

    def submit(self, session: str, **args: Any) -> Dict[str, Any]:
        return self.call("submit", session, **args)

    def step_until(self, session: str, t: float) -> Dict[str, Any]:
        return self.call("step_until", session, t=float(t))

    def step(self, session: str, n: int = 1) -> Dict[str, Any]:
        return self.call("step", session, n=int(n))

    def run(self, session: str) -> Dict[str, Any]:
        return self.call("run", session)

    def inject(self, session: str, **event: Any) -> Dict[str, Any]:
        return self.call("inject", session, **event)

    def observe(self, session: str) -> Dict[str, Any]:
        return self.call("observe", session)

    def result(self, session: str) -> Dict[str, Any]:
        return self.call("result", session)

    def snapshot(self, session: str) -> Dict[str, Any]:
        return self.call("snapshot", session)

    def close_session(self, session: str) -> Dict[str, Any]:
        return self.call("close", session)

    def delete_session(self, session: str) -> Dict[str, Any]:
        """Forget a closed session server-side, freeing its name and
        reclaiming its snapshot/journal files."""
        return self.call("delete", session)

    def shutdown_server(self) -> Dict[str, Any]:
        return self.call("shutdown")


def connect(host: str = "127.0.0.1", port: int = 7463, *,
            tenant: str = "default", timeout: float = 60.0,
            retry_for: float = 0.0) -> Client:
    """Open a client connection (the :mod:`repro_torch.api` facade
    spelling)."""
    return Client(host, port, tenant=tenant, timeout=timeout,
                  retry_for=retry_for)
