"""The scheduler-as-a-service server: asyncio JSONL-over-TCP, stdlib only.

One process holds thousands of named :class:`SimSession`\\ s behind a
:class:`~repro.serve.registry.SessionRegistry`.  Connections are thin:
a reader task per connection parses frames and runs **admission control**
(queue caps, credit budget) — everything admitted lands in the
:class:`~repro.serve.admission.FairQueue`, and a single dispatcher task
services it in weighted-DRF order, so one hot tenant saturating its
connection cannot starve the others no matter how fast it writes.

Simulation ops run inline on the event loop: the engine is process-wide
single-threaded anyway (numpy releases the GIL only transiently) and the
fair queue — not connection order — already decides *whose* op runs next.
Durability (write-ahead journal + snapshot-backed eviction + crash
recovery) lives in the registry; the server adds the transport, the
fairness layer, and the idle/cap eviction policy.

Every session allocates on the server's device (``ServeConfig.device``,
``"cuda"`` unless the caller asks for ``"cpu"``), each through its own
backend; the device is resolved when the server starts, before it binds
a socket, so a server asked for a card that is not there never listens.
A :class:`~repro_torch.device.BackendFault` while an op runs is not an
op error: it stops the server without persisting anything (the journal
already holds the op), and :meth:`SchedServer.serve_forever` raises it.
"""
from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..device import BackendFault, resolve_device
from .admission import CreditParams, FairQueue
from .protocol import (CONTROL_OPS, E_BAD_REQUEST, E_OP_ERROR, MUTATING_OPS,
                       SCHEMA, ProtocolError, check_name, decode, encode,
                       error_response, op_args, result_payload)
from .registry import SessionRegistry, SessionStore

__all__ = ["ServeConfig", "SchedServer", "ServerThread", "run_server"]


@dataclass
class ServeConfig:
    host: str = "127.0.0.1"
    port: int = 0                   # 0 = ephemeral (announced on start)
    store: Optional[str] = None     # snapshot/journal root; None = RAM only
    max_live: int = 256             # live engine states held in memory
    idle_evict_s: Optional[float] = None   # evict sessions idle this long
    checkpoint_every: int = 0       # auto-snapshot every N ops per session
    fsync: bool = True              # fsync journal appends (durability)
    allow_shutdown: bool = True     # honor the "shutdown" control op
    credit: CreditParams = field(default_factory=CreditParams)
    device: str = "cuda"            # where every session allocates


class _Pending:
    __slots__ = ("req", "writer", "enqueued")

    def __init__(self, req: Dict[str, Any], writer: asyncio.StreamWriter,
                 enqueued: float):
        self.req = req
        self.writer = writer
        self.enqueued = enqueued


class SchedServer:
    """The long-lived service.  ``await start()`` resolves the device and
    binds the socket (and replays any persisted sessions), ``await
    serve_forever()`` blocks until a ``shutdown`` op or
    :meth:`request_stop`, and raises the backend fault that stopped the
    server, if one did."""

    def __init__(self, config: Optional[ServeConfig] = None, **overrides):
        if config is None:
            config = ServeConfig(**overrides)
        self.config = config
        self.store = SessionStore(config.store, fsync=config.fsync)
        self.registry = SessionRegistry(
            self.store, max_live=config.max_live,
            idle_evict_s=config.idle_evict_s, device=config.device)
        self.queue = FairQueue(config.credit)
        self.port: Optional[int] = None
        self.n_recovered = 0
        self._server: Optional[asyncio.base_events.Server] = None
        self._wake = asyncio.Event()
        self._stopped = asyncio.Event()
        self._dispatcher: Optional[asyncio.Task] = None
        self._events_seen: Dict[Tuple[str, str], int] = {}
        self._last_idle_sweep = time.monotonic()
        self._writers: set = set()
        #: the backend fault that stopped the server, if one did
        self.fault: Optional[BackendFault] = None
        self.started_at = time.monotonic()

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        resolve_device(self.config.device)      # raises before any bind
        self.n_recovered = self.registry.recover()
        # rebuild per-tenant session sets so max_sessions keeps counting
        # recovered (still-open) sessions across restarts
        for (tenant, name), ent in self.registry.entries.items():
            if not ent.closed:
                self.queue.tenant(tenant).sessions.add(name)
        self._server = await asyncio.start_server(
            self._on_connection, self.config.host, self.config.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._dispatcher = asyncio.ensure_future(self._dispatch_loop())

    async def serve_forever(self) -> None:
        await self._stopped.wait()
        if self.fault is not None:
            raise self.fault

    def request_stop(self) -> None:
        self._stopped.set()
        self._wake.set()

    async def stop(self) -> None:
        self.request_stop()
        if self._dispatcher is not None:
            await self._dispatcher
        if self.fault is not None:
            # as a crash: open connections drop, nothing is persisted
            for writer in list(self._writers):
                writer.transport.abort()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self.fault is not None:
            self.registry.abandon()
        else:
            self.registry.close_all()

    # -- connection reader ---------------------------------------------------
    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while not self._stopped.is_set():
                line = await reader.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                await self._on_frame(line, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _on_frame(self, line: bytes,
                        writer: asyncio.StreamWriter) -> None:
        req_id: Any = None
        try:
            req = decode(line)
            req_id = req.get("id")
            op = req.get("op")
            tenant = check_name("tenant", req.get("tenant", "default"))
            if op in CONTROL_OPS:
                resp = self._control(tenant, op, req)
                writer.write(encode({"id": req_id, "ok": True, **resp}))
                await writer.drain()
                return
            if op not in MUTATING_OPS and op not in (
                    "observe", "result", "snapshot", "sessions", "delete"):
                raise ProtocolError(E_BAD_REQUEST, f"unknown op {op!r}")
            # admission happens here, on the reader: refused ops never
            # enter the dispatcher queue
            self.queue.admit(tenant,
                             _Pending(req, writer, time.monotonic()))
            self._wake.set()
        except ProtocolError as exc:
            writer.write(encode(error_response(req_id, exc.code, str(exc))))
            await writer.drain()

    # -- control ops (cheap, serviced inline) --------------------------------
    def _control(self, tenant: str, op: str,
                 req: Dict[str, Any]) -> Dict[str, Any]:
        if op == "ping":
            return {"pong": True}
        if op == "hello":
            t = self.queue.tenant(tenant)
            return {"tenant": tenant, "credit": t.credit(),
                    "schema": SCHEMA,
                    "limits": {
                        "max_pending": self.queue.params.max_pending,
                        "max_sessions": self.queue.params.max_sessions,
                        "budget": self.queue.params.budget,
                    }}
        if op == "stats":
            return {"registry": self.registry.stats(),
                    "tenants": self.queue.stats(),
                    "backlog": self.queue.backlog(),
                    "uptime_s": time.monotonic() - self.started_at,
                    "recovered": self.n_recovered}
        if op == "shutdown":
            if not self.config.allow_shutdown:
                raise ProtocolError(E_BAD_REQUEST,
                                    "shutdown is disabled on this server")
            self.request_stop()
            return {"stopping": True}
        raise ProtocolError(E_BAD_REQUEST, f"unknown control op {op!r}")

    # -- dispatcher ----------------------------------------------------------
    async def _dispatch_loop(self) -> None:
        try:
            await self._dispatch()
        except BackendFault as exc:
            self.fault = exc
            self.request_stop()

    async def _dispatch(self) -> None:
        while not self._stopped.is_set():
            picked = self.queue.pick()
            if picked is None:
                self._wake.clear()
                idle = asyncio.ensure_future(self._wake.wait())
                done = asyncio.ensure_future(self._stopped.wait())
                try:
                    await asyncio.wait({idle, done}, timeout=1.0,
                                       return_when=asyncio.FIRST_COMPLETED)
                finally:
                    idle.cancel()
                    done.cancel()
                self.registry.evict_idle()
                self._last_idle_sweep = time.monotonic()
                continue
            tenant_state, pending = picked
            t0 = time.perf_counter()
            resp = self._execute(tenant_state.name, pending.req)
            wall = time.perf_counter() - t0
            events = self._events_delta(tenant_state.name, pending.req, resp)
            tenant_state.charge(ops=1.0, events=events, wall=wall)
            if not resp.get("ok", False):
                tenant_state.n_errors += 1
                tenant_state.violation()
            try:
                pending.writer.write(encode(resp))
                await pending.writer.drain()
            except (ConnectionError, OSError):
                pass                # client went away; the op still counts
            self.registry.evict_over_cap()
            # idle eviction must also fire under sustained load, not only
            # when the queue drains — sweep at most once a second
            now = time.monotonic()
            if now - self._last_idle_sweep >= 1.0:
                self.registry.evict_idle()
                self._last_idle_sweep = now
            # yield so reader tasks can enqueue between ops (fairness is
            # decided by the queue, not by who holds the loop)
            await asyncio.sleep(0)

    def _events_delta(self, tenant: str, req: Dict[str, Any],
                      resp: Dict[str, Any]) -> float:
        """Engine events this op advanced (the DRF 'simulation work' dim)."""
        total = resp.get("events")
        session = req.get("session")
        if total is None or not isinstance(session, str):
            return 0.0
        key = (tenant, session)
        prev = self._events_seen.get(key)
        self._events_seen[key] = int(total)
        if prev is None:
            # first sighting establishes the baseline: a freshly opened
            # session reports ~0 anyway, and a session recovered after a
            # restart must not have its lifetime count charged as a delta
            return 0.0
        return float(max(0, int(total) - prev))

    # -- op execution --------------------------------------------------------
    def _execute(self, tenant: str, req: Dict[str, Any]) -> Dict[str, Any]:
        req_id = req.get("id")
        op = req["op"]
        try:
            resp = self._execute_inner(tenant, req_id, op, req)
        except ProtocolError as exc:
            resp = error_response(req_id, exc.code, str(exc))
        except BackendFault:
            raise                   # the device failed, not the op
        except Exception as exc:    # noqa: BLE001 — op failed in the engine
            resp = error_response(
                req_id, E_OP_ERROR, f"{type(exc).__name__}: {exc}")
        if op in MUTATING_OPS and isinstance(req.get("session"), str):
            # every mutating response carries the session's authoritative
            # next expected seq — an engine-rejected op still consumed its
            # seq (it was journaled), and the client resyncs from this
            # instead of guessing which failures consumed one
            ent = self.registry.entries.get((tenant, req["session"]))
            if ent is not None:
                resp.setdefault("next_seq", ent.seq)
        return resp

    def _execute_inner(self, tenant: str, req_id: Any, op: str,
                       req: Dict[str, Any]) -> Dict[str, Any]:
        if op == "sessions":
            return {"id": req_id, "ok": True,
                    "sessions": self.registry.sessions_of(tenant)}
        name = check_name("session", req.get("session"))
        if op in MUTATING_OPS:
            t = self.queue.tenant(tenant)
            if op == "open":
                if (name not in t.sessions and len(t.sessions)
                        >= self.queue.params.max_sessions):
                    raise ProtocolError(
                        E_BAD_REQUEST,
                        f"tenant {tenant!r} is at its session cap "
                        f"({self.queue.params.max_sessions})")
            payload = self.registry.apply_mutating(
                tenant, name, op, op_args(req), seq=req.get("seq"))
            if op == "close":
                t.sessions.discard(name)
                self._events_seen.pop((tenant, name), None)
            else:
                t.sessions.add(name)
            ce = self.config.checkpoint_every
            if (ce > 0 and not payload.get("dup")
                    and self.store.persistent):
                ent = self.registry.entries.get((tenant, name))
                if (ent is not None and not ent.closed
                        and ent.seq - ent.snap_seq >= ce):
                    self.registry.checkpoint(tenant, name)
            return {"id": req_id, "ok": True, **payload}
        if op == "observe":
            ses = self.registry.live_session(tenant, name)
            return {"id": req_id, "ok": True, **ses.observe()}
        if op == "result":
            ses = self.registry.live_session(tenant, name)
            return {"id": req_id, "ok": True, **result_payload(ses)}
        if op == "snapshot":
            payload = self.registry.checkpoint(tenant, name)
            return {"id": req_id, "ok": True, **payload}
        if op == "delete":
            payload = self.registry.delete_session(tenant, name)
            self.queue.tenant(tenant).sessions.discard(name)
            self._events_seen.pop((tenant, name), None)
            return {"id": req_id, "ok": True, **payload}
        raise ProtocolError(E_BAD_REQUEST, f"unknown op {op!r}")


async def _amain(config: ServeConfig, announce) -> None:
    server = SchedServer(config)
    await server.start()
    if announce is not None:
        announce(server)
    try:
        await server.serve_forever()
    finally:
        await server.stop()


def run_server(config: Optional[ServeConfig] = None, *, announce=None,
               **overrides) -> None:
    """Blocking entry point (the ``python -m repro_torch serve`` path).
    ``announce(server)`` is called once the socket is bound (port known).
    A backend fault that stops the server propagates.
    """
    if config is None:
        config = ServeConfig(**overrides)
    asyncio.run(_amain(config, announce))


class ServerThread:
    """An in-process server on a background thread (tests, benchmarks).

    Context manager: ``with ServerThread(store=...) as srv:`` yields the
    running server with ``srv.port`` bound; exit stops it cleanly.  A
    backend fault that stopped the server is kept as :attr:`error`.
    """

    def __init__(self, config: Optional[ServeConfig] = None, **overrides):
        self.config = config if config is not None else ServeConfig(
            **overrides)
        self.server: Optional[SchedServer] = None
        self.port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as exc:  # noqa: BLE001 — surfaced via start()
            self._error = exc
            self._ready.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self.server = SchedServer(self.config)
        await self.server.start()
        self.port = self.server.port
        self._ready.set()
        try:
            await self.server.serve_forever()
        finally:
            await self.server.stop()

    @property
    def error(self) -> Optional[BaseException]:
        """What ended the server thread abnormally (a start failure or a
        backend fault), else None."""
        return self._error

    def start(self) -> "ServerThread":
        self._thread.start()
        self._ready.wait(timeout=30)
        if self._error is not None:
            raise RuntimeError("server thread failed to start") \
                from self._error
        if self.port is None:
            raise RuntimeError("server thread did not bind within 30s")
        return self

    def stop(self) -> None:
        if self._loop is not None and self._thread.is_alive():
            self._loop.call_soon_threadsafe(self.server.request_stop)
        self._thread.join(timeout=30)

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False
