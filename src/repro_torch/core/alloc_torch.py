"""Batched PyTorch backend for the §4.6 allocation kernels.

``alloc_kernels`` made the per-event allocation a handful of sparse numpy
matvecs; this module makes *many cells at once* one device dispatch.  The
CSR incidence is padded to a dense ``(batch, n_nodes, width)`` layout
(boolean ``present`` mask + float64 ``weight = cpu_need × multiplicity``),
and the OPT=MIN water-filling of every lane is one
:func:`~repro_torch.kernels.ops.maxmin_solve`: on the card one launch, in
which each lane's block runs its own freeze rounds (two sequential
matvecs, the bottleneck scan, the freeze update) until the lane is done,
and one host read of the yields and the round counts together.  A lane's
rounds depend on that lane alone, so this equals the JAX package's
lockstep loop, where finished lanes idle until the slowest converges.

Bit-identity contract: in float64, every per-lane result is **bit-equal**
to ``maxmin_yields_csr`` / ``avg_yields_csr`` on that lane's CSR alone:

* padding is exact — a padded column/row/lane contributes an exact
  ``+0.0`` to every accumulation, and padded lanes start all-frozen so the
  lockstep loop never writes them;
* the matvec rounds every product and adds left to right over ascending
  columns, never fusing the two (``kernels/alloc_matvec.py``);
* the bottleneck scan visits nodes in ascending order with the 1e-15 tie
  rule (``kernels/maxmin_solve.py``).

OPT=AVG is a HiGHS LP — a host simplex solver — so the batched path
computes the LP's yield floor (``1/max(1, Λ)``, Λ = max sequential node
load) on the device for all lanes at once and solves the small per-lane LPs
on the host from bit-identical inputs.

Device: the entry points take ``device="cuda"`` unless the caller passes
``device="cpu"``, where the kernels run as their plain PyTorch versions.
With no CUDA device, ``"cuda"`` raises; nothing falls back.  Whatever
fails in the device work of a request on the card (the copies to and
from it, a kernel's build or launch, a CUDA error) reaches the caller as
a :class:`~repro_torch.device.BackendFault`; a failure of the host work
(densifying, padding, the HiGHS LP) and everything on the CPU pass as
they are.

On top sits the lockstep machinery ``sweep.run_batched`` drives: a
:class:`TorchBatchedAllocator` turning N allocation requests into one
padded dispatch (shapes bucketed to powers of two), and a
:class:`LockstepDispatcher` that parks engine threads at their allocation
points until every live lane has a request in the batch.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..device import BackendFault
from ..kernels import ops
from .alloc_kernels import CSRIncidence

__all__ = [
    "resolve_device",
    "csr_from_arrays",
    "densify_csr",
    "pad_batch",
    "maxmin_yields_batch",
    "node_usage",
    "node_usage_batch",
    "TorchAllocBackend",
    "TorchBatchedAllocator",
    "LockstepDispatcher",
]


def resolve_device(device) -> torch.device:
    """The allocator's device: ``"cuda"`` (raising without a card) or
    ``"cpu"``; ``"meta"``, which the model code's dry run takes, holds no
    data to allocate with and is refused."""
    dev = _device.resolve_device(device)
    if dev.type == "meta":
        raise ValueError("the allocator runs on 'cuda' or 'cpu', not 'meta'")
    return dev


def csr_from_arrays(n_nodes: int, width: int, indptr, indices,
                    data) -> CSRIncidence:
    """A :class:`CSRIncidence` from raw arrays (e.g. an incidence carried
    over from another program), with the dtypes the kernels expect."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    if indptr.shape != (int(n_nodes) + 1,):
        raise ValueError(f"indptr must have n_nodes + 1 = {int(n_nodes) + 1} "
                         f"entries, got {indptr.shape}")
    if indices.shape != data.shape or indices.shape[0] != indptr[-1]:
        raise ValueError("indices/data must both hold indptr[-1] entries")
    if indices.size and (indices.min() < 0 or indices.max() >= int(width)):
        raise ValueError(f"column indices must lie in [0, {int(width)})")
    return CSRIncidence(int(n_nodes), int(width), indptr, indices, data)


def _bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) — bounds distinct shapes."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------- #
# padding: CSR -> dense (batch, n_nodes, width)                                #
# --------------------------------------------------------------------------- #
def densify_csr(
    inc: CSRIncidence,
    n_nodes: Optional[int] = None,
    cols: Optional[np.ndarray] = None,
    width: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense ``(present, weight)`` of one incidence snapshot.

    ``cols`` compacts the job axis to those (sorted) columns — ascending
    column order is preserved, so sequential accumulation over the compact
    axis performs the identical operation sequence (every entry must lie in
    ``cols``, which holds for engine snapshots: the incidence contains only
    running tasks).  ``n_nodes``/``width`` pad with exact zeros.
    """
    N = inc.n_nodes if n_nodes is None else n_nodes
    if cols is None:
        W = inc.width if width is None else width
        col_idx = inc.indices
    else:
        W = cols.shape[0] if width is None else width
        col_idx = np.searchsorted(cols, inc.indices)
    present = np.zeros((N, W), dtype=bool)
    weight = np.zeros((N, W), dtype=np.float64)
    rows = np.repeat(np.arange(inc.n_nodes), np.diff(inc.indptr))
    present[rows, col_idx] = True
    weight[rows, col_idx] = inc.data
    return present, weight


def pad_batch(
    incs: Sequence[CSRIncidence],
    actives: Sequence[np.ndarray],
    n_nodes: Optional[int] = None,
    width: Optional[int] = None,
    n_lanes: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a list of (incidence, active-mask) cells into one dense batch.

    Returns ``(present, weight, active)`` with shapes ``(B, N, W)``,
    ``(B, N, W)``, ``(B, W)``.  Extra lanes (``n_lanes > len(incs)``) are
    all-inactive: the lockstep loop treats them as already converged.
    """
    B = len(incs) if n_lanes is None else n_lanes
    N = n_nodes if n_nodes is not None else max(
        (i.n_nodes for i in incs), default=1)
    W = width if width is not None else max(
        (i.width for i in incs), default=1)
    present = np.zeros((B, N, W), dtype=bool)
    weight = np.zeros((B, N, W), dtype=np.float64)
    active = np.zeros((B, W), dtype=bool)
    for b, (inc, act) in enumerate(zip(incs, actives)):
        p, w = densify_csr(inc, n_nodes=N, width=W)
        present[b], weight[b] = p, w
        active[b, : act.shape[0]] = act
    return present, weight, active


# --------------------------------------------------------------------------- #
# the lockstep water-filling                                                   #
# --------------------------------------------------------------------------- #
def maxmin_yields_batch(
    present: torch.Tensor,
    weight: torch.Tensor,
    active: torch.Tensor,
    stats: Optional[Dict[str, int]] = None,
) -> torch.Tensor:
    """OPT=MIN water-filling over a padded dense batch on the tensors'
    device.  Per lane bit-equal to ``maxmin_yields_csr``.

    ``present`` (B, N, W) bool, ``weight`` (B, N, W) float64, ``active``
    (B, W) bool.  Returns (B, W) float64 yields.  ``stats``, if given,
    gains the rounds of the slowest lane (the lockstep loop's count) and
    one host sync: the yields come back to the host together with the
    round counts in one copy, and are returned there.
    """
    y, rounds = ops.maxmin_solve(present, weight, active)
    if stats is None:
        return y
    host = torch.cat([y.reshape(-1), rounds.to(torch.float64)]).cpu()
    lane_rounds = host[y.numel():]
    stats["host_syncs"] = stats.get("host_syncs", 0) + 1
    stats["rounds"] = stats.get("rounds", 0) + (
        int(lane_rounds.max()) if lane_rounds.numel() else 0)
    return host[: y.numel()].view(y.shape)


# --------------------------------------------------------------------------- #
# batched stretch scatter (§4.7 node-usage pass)                               #
# --------------------------------------------------------------------------- #
def node_usage_batch(nodes, vals, n_nodes: int, device="cuda") -> np.ndarray:
    """Per-node usage over ``(B, K)`` scatter lists (padded with the
    ``n_nodes`` sentinel), one dispatch on ``device``: per lane bit-equal
    to the in-order ``np.add.at`` accumulation of the §4.7 stretch passes,
    entries outside ``[0, n_nodes)`` dropped.  Returns ``(B, n_nodes)``."""
    dev = resolve_device(device)
    nodes_t = torch.as_tensor(np.asarray(nodes, dtype=np.int64)).to(dev)
    vals_t = torch.as_tensor(np.asarray(vals, dtype=np.float64)).to(dev)
    return ops.node_usage(nodes_t.contiguous(), vals_t.contiguous(),
                          int(n_nodes)).cpu().numpy()


def node_usage(nodes, vals, n_nodes: int, device="cuda") -> np.ndarray:
    """:func:`node_usage_batch` of one ``(K,)`` list: ``(n_nodes,)``."""
    return node_usage_batch(np.asarray(nodes)[None], np.asarray(vals)[None],
                            n_nodes, device=device)[0]


def _avg_lp(inc: CSRIncidence, cols: np.ndarray, y_min: float) -> np.ndarray:
    """The LP (2) solve of ``avg_yields_csr`` with the floor injected (the
    floor is the only device-computed input; from a bit-identical ``y_min``
    the host solve is the identical scipy call)."""
    from scipy.optimize import linprog

    m = int(cols.shape[0])
    res = linprog(
        c=-np.ones(m),
        A_ub=inc.scipy_csr(cols),
        b_ub=np.ones(inc.n_nodes),
        bounds=[(y_min, 1.0)] * m,
        method="highs",
    )
    if not res.success:  # numerically degenerate: the safe floor
        return np.full(m, y_min)
    return np.clip(res.x, 0.0, 1.0)


# --------------------------------------------------------------------------- #
# engine-pluggable backends                                                    #
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def _device_work(device: torch.device):
    """Around the copies and launches of a request: on the card, any
    failure is the backend's (:class:`BackendFault`); on the CPU, errors
    pass as they are."""
    if device.type != "cuda":
        yield
        return
    try:
        yield
    except BackendFault:
        raise
    except Exception as exc:
        raise BackendFault(f"allocation backend on {device} failed: "
                           f"{type(exc).__name__}: {exc}") from exc


class TorchBatchedAllocator:
    """Serve many cells' allocation requests as single padded dispatches.

    ``allocate_many([(inc, cols, opt), ...])`` answers every request with
    the bit-exact yields for its cell: OPT=MIN requests are compacted to
    their running columns, padded into one ``(B, N, W)`` batch (shapes
    bucketed to powers of two) and solved in one lockstep dispatch; OPT=AVG
    requests get their floors Λ from one device matvec and their LPs from
    the host solver.

    ``stats`` counts dispatches, freeze rounds, host syncs (device-to-host
    reads), the padded shapes seen, and the host-clock seconds spent serving
    MIN and AVG requests (padding, device work and host LPs included).
    """

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.stats: Dict[str, object] = {
            "dispatches": 0, "rounds": 0, "host_syncs": 0,
            "min_shapes": Counter(), "avg_shapes": Counter(),
            "min_s": 0.0, "avg_s": 0.0}

    # -- single request (the Engine alloc_backend protocol) ---------------- #
    def allocate(self, inc: CSRIncidence, cols: np.ndarray,
                 opt: str = "MIN") -> np.ndarray:
        return self.allocate_many([(inc, cols, opt)])[0]

    # -- batched ----------------------------------------------------------- #
    def allocate_many(
        self, requests: Sequence[Tuple[CSRIncidence, np.ndarray, str]],
    ) -> List[np.ndarray]:
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        min_idx = [i for i, (_, c, opt) in enumerate(requests)
                   if opt == "MIN" and c.shape[0]]
        avg_idx = [i for i, (_, c, opt) in enumerate(requests)
                   if opt == "AVG" and c.shape[0]]
        for i, (_, c, opt) in enumerate(requests):
            if opt not in ("MIN", "AVG"):
                raise ValueError(f"unknown OPT {opt!r}")
            if not c.shape[0]:
                out[i] = np.zeros(0)
        for idx, serve, key in ((min_idx, self._serve_min, "min_s"),
                                (avg_idx, self._serve_avg, "avg_s")):
            if not idx:
                continue
            t0 = time.perf_counter()
            serve(requests, idx, out)
            self.stats[key] += time.perf_counter() - t0
        return out  # fully populated

    def _pad_compact(self, requests, idx):
        """Compact each request to its running columns and pad the set into
        one bucketed batch on the device (per-lane exactness makes the
        co-batching safe: no lane's answer depends on what else is in the
        batch)."""
        N = _bucket(max(requests[i][0].n_nodes for i in idx))
        W = _bucket(max(requests[i][1].shape[0] for i in idx), 8)
        B = _bucket(len(idx))
        present = np.zeros((B, N, W), dtype=bool)
        weight = np.zeros((B, N, W), dtype=np.float64)
        active = np.zeros((B, W), dtype=bool)
        for b, i in enumerate(idx):
            inc, cols, _ = requests[i]
            p, w = densify_csr(inc, n_nodes=N, cols=cols, width=W)
            present[b], weight[b] = p, w
            active[b, : cols.shape[0]] = True
        dev = self.device
        with _device_work(dev):
            return (torch.from_numpy(present).to(dev),
                    torch.from_numpy(weight).to(dev),
                    torch.from_numpy(active).to(dev))

    def _serve_min(self, requests, idx, out):
        present, weight, active = self._pad_compact(requests, idx)
        self.stats["dispatches"] += 1
        self.stats["min_shapes"][tuple(weight.shape)] += 1
        # one host read: the yields with the round counts
        with _device_work(self.device):
            y = maxmin_yields_batch(present, weight, active,
                                    stats=self.stats).numpy()
        for b, i in enumerate(idx):
            m = requests[i][1].shape[0]
            out[i] = y[b, :m].copy()

    def _serve_avg(self, requests, idx, out):
        _, weight, _ = self._pad_compact(requests, idx)
        self.stats["dispatches"] += 1
        self.stats["avg_shapes"][tuple(weight.shape)] += 1
        B, _, W = weight.shape
        with _device_work(self.device):
            ones = torch.ones((B, W), dtype=torch.float64,
                              device=weight.device)
            # Λ per lane: max over nodes of the sequential row load sums
            lams = ops.alloc_matvec(weight, ones).max(dim=1).values
            lams = lams.cpu().numpy()
        self.stats["host_syncs"] += 1
        for b, i in enumerate(idx):
            inc, cols, _ = requests[i]
            lam = float(lams[b]) if inc.n_nodes else 0.0
            out[i] = _avg_lp(inc, cols, 1.0 / max(1.0, lam))


class TorchAllocBackend(TorchBatchedAllocator):
    """One-cell engine backend: ``Engine(..., alloc_backend=
    TorchAllocBackend())`` answers every §4.6 reallocation from the device,
    bit-identically to the host numpy path (``allocate_incidence``)."""


# --------------------------------------------------------------------------- #
# lockstep dispatch: many engine threads, one device                           #
# --------------------------------------------------------------------------- #
class LockstepDispatcher:
    """Coordinate N engine threads so their allocation requests land on the
    device as one batch per scheduling round.

    Each engine runs in its own thread through :meth:`run`, with a
    :meth:`lane` backend plugged in; a lane's ``allocate`` parks the thread
    until the driver thread (:meth:`serve`) has collected a request from
    *every* lane that is still running — engines that never allocate (batch
    baselines) simply run to completion and drop out of the barrier.  The
    driver answers each round with one ``allocate_many`` and wakes the
    lanes.  Per-lane results are bit-independent of batch composition, so
    the lockstep schedule cannot change any cell's outcome.  An exception
    on the driver (a CUDA error included) poisons the barrier: every parked
    and future lane raises it instead of waiting.

    The lanes' engine code shares one interpreter lock, so it runs one lane
    at a time in any case; :meth:`run` makes that explicit with a run token
    that a lane holds while it computes and hands on while it waits for its
    answer.  Without it every lane is runnable at once, and each brief lock
    release inside numpy or a wake-up lets another lane take the
    interpreter for a whole switch interval.  Wake-ups are targeted too:
    the driver is woken once the round is full, and each lane only when its
    own answer is ready (one event per lane).
    """

    def __init__(self, n_lanes: int, allocator: TorchBatchedAllocator):
        self.n_lanes = int(n_lanes)
        self.allocator = allocator
        self._cond = threading.Condition()      # the driver waits on it
        self._pending: Dict[int, Tuple[CSRIncidence, np.ndarray, str]] = {}
        self._results: Dict[int, object] = {}
        self._answered = [threading.Event() for _ in range(self.n_lanes)]
        self._finished: set = set()
        self._broken: Optional[BaseException] = None
        self._token = threading.Lock()  # held by the lane that computes

    def lane(self, i: int) -> "_Lane":
        return _Lane(self, i)

    def run(self, i: int, fn):
        """Run ``fn(lane)`` as lane ``i`` in the calling thread: holding the
        run token while it computes, leaving the barrier when it returns
        or raises."""
        self._token.acquire()
        try:
            return fn(self.lane(i))
        finally:
            self._token.release()
            self.finish_lane(i)

    def _round_full(self) -> bool:
        # caller holds self._cond
        return len(self._pending) + len(self._finished) >= self.n_lanes

    def finish_lane(self, i: int) -> None:
        """A lane's engine is done (or died) — it leaves the barrier."""
        with self._cond:
            self._finished.add(i)
            if self._round_full():
                self._cond.notify()

    def _request(self, i, inc, cols, opt) -> np.ndarray:
        answered = self._answered[i]
        with self._cond:
            if self._broken is not None:
                raise self._broken
            self._pending[i] = (inc, cols, opt)
            if self._round_full():
                self._cond.notify()
        self._token.release()
        answered.wait()
        answered.clear()
        self._token.acquire()
        with self._cond:
            res = self._results.pop(i, self._broken)
        if isinstance(res, BaseException):
            raise res
        return res

    def serve(self) -> None:
        """Drive rounds until every lane finished.  Call from the thread
        that owns the device (the sweep driver)."""
        while True:
            with self._cond:
                self._cond.wait_for(self._round_full)
                if not self._pending:
                    return              # every lane finished
                batch = sorted(self._pending.items())
                self._pending.clear()
            lanes = [i for i, _ in batch]
            try:
                answers = self.allocator.allocate_many([r for _, r in batch])
            except BaseException as exc:
                with self._cond:        # poison: wake every parked/future lane
                    self._broken = exc
                for ev in self._answered:
                    ev.set()
                raise
            with self._cond:
                for i, y in zip(lanes, answers):
                    self._results[i] = y
            for i in lanes:
                self._answered[i].set()


class _Lane:
    """The per-engine view of a :class:`LockstepDispatcher` (the object an
    ``Engine`` receives as ``alloc_backend``)."""

    __slots__ = ("_dispatcher", "index")

    def __init__(self, dispatcher: LockstepDispatcher, index: int):
        self._dispatcher = dispatcher
        self.index = index

    def allocate(self, inc: CSRIncidence, cols: np.ndarray,
                 opt: str = "MIN") -> np.ndarray:
        if not cols.shape[0]:
            return np.zeros(0)          # nothing running: no round trip
        return self._dispatcher._request(self.index, inc, cols, opt)
