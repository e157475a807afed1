"""Vectorized allocation kernels over a job×node CSR incidence matrix.

The §4.6 yield allocation reduces to one question: *per node, how much CPU
do the resident tasks of each job use?*  This module answers it with:

* :class:`CSRIncidence` — an immutable node-major CSR snapshot
  (``indptr``/``indices``/``data``) where row = node, column = job index and
  ``data = cpu_need * multiplicity``;
* :class:`NodeIncidence` — the engine-owned *incremental* structure: per-node
  ``{job: multiplicity}`` counts updated on start/pause/migrate/complete,
  with dirty-row tracking so a CSR snapshot costs only the changed rows;
* :func:`maxmin_yields_csr` — §4.6 water-filling as whole-array sparse
  matvecs (per-node frozen use and unfrozen need), one freeze round per pass.

These are the host (numpy) kernels.  The batched device path in
:mod:`repro_torch.core.alloc_torch` is held bit for bit to them: the row
sums use a sequential (left-to-right, column-ascending) CSR matvec — NOT
``np.sum``/``np.dot``, whose pairwise summation rounds differently.  Masked
terms contribute an exact ``+ 0.0``, which never changes a finite
non-negative partial sum.

:func:`reference_kernels` flips the whole engine (yield_alloc, greedy,
mcb8, stretch_opt and the engine's §4.6 reallocation, ahead of any
``alloc_backend``) onto the oracle in
:mod:`repro_torch.core.alloc_reference`.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import numpy as np

__all__ = [
    "CSRIncidence",
    "NodeIncidence",
    "build_csr",
    "maxmin_yields_csr",
    "avg_yields_csr",
    "reference_kernels",
    "reference_kernels_active",
]

_EPS = 1e-12

_EMPTY_I = np.zeros(0, dtype=np.int64)
_EMPTY_F = np.zeros(0, dtype=np.float64)

# --------------------------------------------------------------------------- #
# reference-mode switch                                                        #
# --------------------------------------------------------------------------- #
_REFERENCE = False


def reference_kernels_active() -> bool:
    """True while the engine is forced onto the pre-vectorization oracle."""
    return _REFERENCE


@contextlib.contextmanager
def reference_kernels() -> Iterator[None]:
    """Run everything under the :mod:`repro_torch.core.alloc_reference`
    oracle: a simulation executed inside this context takes the original
    dict/loop allocation paths end to end, whatever its ``alloc_backend``,
    so its ``SimResult`` is the ground truth the host hot path and the
    device path must match bit for bit."""
    global _REFERENCE
    prev = _REFERENCE
    _REFERENCE = True
    try:
        yield
    finally:
        _REFERENCE = prev


# --------------------------------------------------------------------------- #
# sequential CSR matvec                                                        #
# --------------------------------------------------------------------------- #
try:  # scipy's C kernel accumulates strictly left to right.  Private but
    # stable; guarded fallback.
    from scipy.sparse import _sparsetools as _sptools

    def _seq_matvec(indptr, indices, data, x, out):
        out[:] = 0.0
        _sptools.csr_matvec(indptr.shape[0] - 1, x.shape[0],
                            indptr, indices, data, x, out)
        return out
except Exception:  # pragma: no cover - depends on scipy version
    def _seq_matvec(indptr, indices, data, x, out):
        out[:] = 0.0
        np.add.at(out, np.repeat(np.arange(indptr.shape[0] - 1),
                                 np.diff(indptr)), data * x[indices])
        return out


class CSRIncidence:
    """Immutable node-major CSR snapshot of the job×node incidence.

    ``data[k]`` is ``cpu_need[j] * multiplicity`` for job ``j = indices[k]``
    on the row's node; columns are ascending within each row, which fixes
    the accumulation order of every kernel.
    """

    __slots__ = ("n_nodes", "width", "indptr", "indices", "data")

    def __init__(self, n_nodes: int, width: int,
                 indptr: np.ndarray, indices: np.ndarray, data: np.ndarray):
        self.n_nodes = n_nodes
        self.width = width          # number of job columns (dense job space)
        self.indptr = indptr
        self.indices = indices
        self.data = data

    def matvec(self, x: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-node sequential row sums of ``data * x[indices]``."""
        if out is None:
            out = np.empty(self.n_nodes)
        return _seq_matvec(self.indptr, self.indices, self.data, x, out)

    def scipy_csr(self, cols: np.ndarray):
        """Scipy CSR restricted to ``cols`` (sorted job columns) for the LP
        pass."""
        from scipy.sparse import csr_matrix

        pos = np.searchsorted(cols, self.indices)
        return csr_matrix((self.data, pos, self.indptr),
                          shape=(self.n_nodes, cols.shape[0]))


def build_csr(cpu_need: Sequence[float],
              mappings: Sequence[Sequence[int]],
              n_nodes: int) -> CSRIncidence:
    """From-scratch CSR for a (specs, mappings) pair: column ``j`` is
    position ``j`` in ``mappings``; rows hold ascending columns."""
    per_node: List[dict] = [dict() for _ in range(n_nodes)]
    for ji, mapping in enumerate(mappings):
        for node in mapping:
            per_node[node][ji] = per_node[node].get(ji, 0) + 1
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    idx_rows: List[np.ndarray] = []
    dat_rows: List[np.ndarray] = []
    cpu = np.asarray(cpu_need, dtype=np.float64)
    for node, d in enumerate(per_node):
        if d:
            items = sorted(d.items())
            ji = np.array([i for i, _ in items], dtype=np.int64)
            mult = np.array([m for _, m in items], dtype=np.float64)
            idx_rows.append(ji)
            dat_rows.append(cpu[ji] * mult)
        else:
            idx_rows.append(_EMPTY_I)
            dat_rows.append(_EMPTY_F)
        indptr[node + 1] = indptr[node] + idx_rows[-1].shape[0]
    indices = np.concatenate(idx_rows) if idx_rows else _EMPTY_I
    data = np.concatenate(dat_rows) if dat_rows else _EMPTY_F
    return CSRIncidence(n_nodes, len(mappings), indptr, indices, data)


class NodeIncidence:
    """Incrementally maintained job×node incidence.

    The engine calls :meth:`place` / :meth:`remove` on every
    start/pause/migrate/complete transition (mirroring its ``NodePool``
    bookkeeping), so at any scheduling event the CSR snapshot of the
    *currently running* tasks is available without rescanning any mapping.
    Rows are rebuilt lazily and only when dirty; the concatenated snapshot
    is cached until the next structural change.
    """

    def __init__(self, n_nodes: int, cpu_need: np.ndarray):
        self.n_nodes = int(n_nodes)
        # owned geometric buffer; cpu_need is the width-sized head view
        self._cpu_buf = np.array(cpu_need, dtype=np.float64)
        self._width = int(self._cpu_buf.shape[0])
        self.cpu_need = self._cpu_buf[: self._width]
        self.rows: List[dict] = [dict() for _ in range(self.n_nodes)]
        self._row_idx: List[np.ndarray] = [_EMPTY_I] * self.n_nodes
        self._row_dat: List[np.ndarray] = [_EMPTY_F] * self.n_nodes
        self._dirty: set = set()
        self._snap: Optional[CSRIncidence] = None

    def place(self, job: int, mapping: Sequence[int]) -> None:
        rows = self.rows
        for node in mapping:
            r = rows[node]
            r[job] = r.get(job, 0) + 1
        self._dirty.update(mapping)
        self._snap = None

    def remove(self, job: int, mapping: Sequence[int]) -> None:
        rows = self.rows
        for node in mapping:
            r = rows[node]
            m = r[job] - 1
            if m:
                r[job] = m
            else:
                del r[job]
        self._dirty.update(mapping)
        self._snap = None

    def extend(self, cpu_need_tail: np.ndarray) -> None:
        """Grow the job-column space (streaming sessions append jobs).

        Existing rows keep their cached arrays — old column data is
        untouched — but the cached CSR snapshot is invalidated because the
        matrix ``width`` (dense job count) changes.  Appends land in a
        geometrically doubled buffer (amortized O(1) per job).
        """
        tail = np.asarray(cpu_need_tail, dtype=np.float64)
        need = self._width + int(tail.shape[0])
        if need > self._cpu_buf.shape[0]:
            buf = np.empty(max(need, 2 * self._cpu_buf.shape[0], 16))
            buf[: self._width] = self._cpu_buf[: self._width]
            self._cpu_buf = buf
        self._cpu_buf[self._width:need] = tail
        self._width = need
        self.cpu_need = self._cpu_buf[:need]
        self._snap = None

    def compact(self, keep: np.ndarray, new_of_old: np.ndarray) -> None:
        """Drop evicted job columns (``EngineState.compact``).

        ``keep`` — ascending surviving dense indices; ``new_of_old`` — the
        old→new column map.  Every resident task belongs to a RUNNING job,
        so all occupied columns survive; the remap is monotone, which keeps
        each row's ``sorted(d.items())`` order — and therefore the CSR data
        order every kernel accumulates in — exactly what a from-scratch
        build over the compacted state would produce.
        """
        m = int(keep.shape[0])
        self._cpu_buf[:m] = self._cpu_buf[: self._width][keep]
        self._width = m
        self.cpu_need = self._cpu_buf[:m]
        for node, d in enumerate(self.rows):
            if d:
                self.rows[node] = {
                    int(new_of_old[j]): mult for j, mult in d.items()}
                self._dirty.add(node)
        self._snap = None

    def csr(self) -> CSRIncidence:
        if self._snap is not None:
            return self._snap
        cpu = self.cpu_need
        for node in self._dirty:
            d = self.rows[node]
            if d:
                items = sorted(d.items())
                ji = np.array([i for i, _ in items], dtype=np.int64)
                mult = np.array([m for _, m in items], dtype=np.float64)
                self._row_idx[node] = ji
                self._row_dat[node] = cpu[ji] * mult
            else:
                self._row_idx[node] = _EMPTY_I
                self._row_dat[node] = _EMPTY_F
        self._dirty.clear()
        indptr = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.cumsum([r.shape[0] for r in self._row_idx], out=indptr[1:])
        indices = np.concatenate(self._row_idx) if self.n_nodes else _EMPTY_I
        data = np.concatenate(self._row_dat) if self.n_nodes else _EMPTY_F
        self._snap = CSRIncidence(self.n_nodes, self.cpu_need.shape[0],
                                  indptr, indices, data)
        return self._snap


# --------------------------------------------------------------------------- #
# §4.6 kernels                                                                 #
# --------------------------------------------------------------------------- #
def maxmin_yields_csr(inc: CSRIncidence, active: np.ndarray) -> np.ndarray:
    """OPT=MIN water-filling over the incidence matrix.

    ``active`` flags the job columns that participate (the running set);
    inactive columns must have no incidence entries.  Returns the full-width
    yield vector (zeros at inactive columns).  Each freeze round is two
    sequential matvecs (frozen use, unfrozen need) plus an O(n_nodes) scan.
    """
    w = inc.width
    y = np.zeros(w)
    n_active = int(active.sum())
    if n_active == 0:
        return y
    frozen = ~active
    indptr, indices = inc.indptr, inc.indices
    f_use = np.empty(inc.n_nodes)
    u_need = np.empty(inc.n_nodes)
    for _ in range(n_active + 1):
        if frozen.all():
            break
        inc.matvec(np.where(frozen, y, 0.0), out=f_use)
        inc.matvec((~frozen).astype(np.float64), out=u_need)
        valid = np.nonzero(u_need > _EPS)[0]
        levels = np.maximum(0.0, 1.0 - f_use[valid]) / u_need[valid]
        # Sequential bottleneck scan in node order: a tolerance-updated
        # running minimum (order-dependent when two levels sit within 1e-15
        # of each other, so it cannot be a plain argmin).
        best_level = 1.0
        binding: List[int] = []
        for node, level in zip(valid.tolist(), levels.tolist()):
            if level < best_level - 1e-15:
                best_level = level
                binding = [node]
            elif abs(level - best_level) <= 1e-15:
                binding.append(node)
        newly = np.zeros(w, dtype=bool)
        if best_level >= 1.0 - 1e-12:
            best_level = 1.0
            newly |= ~frozen  # everyone capped
        else:
            for node in binding:
                sl = indices[indptr[node]:indptr[node + 1]]
                newly[sl[~frozen[sl]]] = True
        y[~frozen] = best_level
        if not newly.any():          # numerical safety
            newly |= ~frozen
        frozen |= newly
    return np.clip(y, 0.0, 1.0)


def avg_yields_csr(inc: CSRIncidence, cols: np.ndarray) -> np.ndarray:
    """OPT=AVG over the incidence matrix: LP (2) with the constraint matrix
    sliced straight out of the CSR snapshot.

    ``cols`` — sorted job columns participating (the running set).  Returns
    yields aligned with ``cols``.
    """
    from scipy.optimize import linprog

    m = int(cols.shape[0])
    if m == 0:
        return np.zeros(0)
    load_need = inc.matvec(np.ones(inc.width))
    lam = float(load_need.max()) if inc.n_nodes else 0.0
    y_min = 1.0 / max(1.0, lam)
    res = linprog(
        c=-np.ones(m),
        A_ub=inc.scipy_csr(cols),
        b_ub=np.ones(inc.n_nodes),
        bounds=[(y_min, 1.0)] * m,
        method="highs",
    )
    if not res.success:  # numerically degenerate: fall back to the safe floor
        return np.full(m, y_min)
    return np.clip(res.x, 0.0, 1.0)
