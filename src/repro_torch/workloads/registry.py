"""Declarative workload specs for sweep cells.

A cell carries a :class:`WorkloadSpec` — a small frozen record naming a
generator *kind* plus its seed/size knobs — and the driver materializes
(and memoizes) the columnar :class:`~repro_torch.workloads.trace.Trace`
with :func:`make_trace_ir`.  Two specs are the same workload iff they
compare equal, which also makes them usable as cache keys and JSON-friendly
via :meth:`WorkloadSpec.to_dict`.

Kinds: ``"lublin"`` — the Lublin–Feitelson synthetic model (paper §5.3.2);
with ``load`` set, inter-arrivals are rescaled to the target offered load
(the paper's scaled trace sets).  The archive-log and TPU-mix kinds are not
ported yet (see ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Mapping, Optional, Tuple, Union

from .lublin import lublin_trace, scale_to_load
from .trace import Trace

__all__ = ["WorkloadSpec", "make_trace_ir"]

ParamsLike = Union[Mapping, Tuple[Tuple[str, object], ...]]

_PORTED_KINDS = ("lublin",)


@dataclass(frozen=True)
class WorkloadSpec:
    """Declarative, hashable description of one generated trace."""

    kind: str
    n_jobs: int = 250
    n_nodes: int = 64
    seed: int = 0
    load: Optional[float] = None   # target offered load
    params: ParamsLike = ()        # kind-specific knobs (normalized tuple)

    def __post_init__(self) -> None:
        if self.kind not in _PORTED_KINDS:
            raise NotImplementedError(
                f"workload kind {self.kind!r} is not ported yet (ported: "
                f"{', '.join(_PORTED_KINDS)}); see ROADMAP.md")
        norm = tuple(sorted((str(k), v) for k, v in dict(self.params).items()))
        object.__setattr__(self, "params", norm)
        if norm:
            raise ValueError(
                f"workload kind {self.kind!r} does not accept params "
                f"{sorted(k for k, _ in norm)}; accepted: none")

    @property
    def params_dict(self) -> dict:
        return dict(self.params)

    @property
    def name(self) -> str:
        load = f"@{self.load:g}" if self.load is not None else ""
        extra = "".join(f"+{k}={v}" for k, v in self.params)
        return f"{self.kind}-j{self.n_jobs}-n{self.n_nodes}-s{self.seed}{load}{extra}"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "n_jobs": self.n_jobs,
                "n_nodes": self.n_nodes, "seed": self.seed, "load": self.load,
                "params": self.params_dict}


@lru_cache(maxsize=64)
def make_trace_ir(spec: WorkloadSpec) -> Trace:
    """Materialize the columnar trace for ``spec`` (memoized per process;
    the Trace is frozen, so the cache can hand out the same object)."""
    specs = lublin_trace(n_jobs=spec.n_jobs, n_nodes=spec.n_nodes,
                         seed=spec.seed)
    if spec.load is not None:
        specs = scale_to_load(specs, spec.n_nodes, spec.load)
    return Trace.from_specs(specs)
