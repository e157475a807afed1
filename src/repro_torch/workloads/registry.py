"""Open, declarative workload registry for sweep cells.

A cell carries a :class:`WorkloadSpec` — a small frozen record naming a
generator *kind* plus its seed/size knobs and an open ``params`` mapping —
and the sweep materializes (and memoizes) the columnar
:class:`~repro_torch.workloads.trace.Trace` with :func:`make_trace_ir`.
Two specs are the same workload iff they compare equal, which also makes
them usable as cache keys and JSON-friendly via :meth:`WorkloadSpec.to_dict`.

Workload kinds are an *open registry*: :func:`register_workload` binds a
name to a ``spec -> Trace`` generator together with its knob contract —
whether ``load=`` applies, which ``params`` keys it accepts/requires, and
which param a ``kind:<arg>`` spelling fills (:func:`parse_workload`).

Built-in kinds:

* ``"lublin"`` — Lublin–Feitelson synthetic model (paper §5.3.2); with
  ``load`` set, inter-arrivals are rescaled to the target offered load
  (the paper's scaled trace sets).
* ``"hpc2n"``  — synthetic trace with HPC2N-like marginals run through the
  §5.3.1 preprocessing (cluster fixed at 120 dual-core nodes → specs use
  ``n_nodes=128`` by convention in the benchmarks).
* ``"swf"``    — a real Parallel Workloads Archive log (``params["path"]``,
  spelled ``swf:<path>``) through ``parse_swf`` + the same §5.3.1
  preprocessing; ``n_jobs`` caps the prefix taken (0 = whole log).
* ``"swf-stream"`` — the same log and preprocessing as ``swf``, with a
  native streamer for :func:`stream_trace`: the log is parsed in
  submit-time windows (``params["window"]`` seconds, default one day) and
  never held whole.
* ``"tpu"``    — a Poisson mix of accelerator job types
  (:mod:`~repro_torch.workloads.jobgen`); ``load`` is the target offered
  load (default 0.6), ``params["records"]`` a JSON file of dry-run
  roofline records to derive the types from.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from ..core.job import JobSpec
from .hpc2n import (hpc2n_like_trace, hpc2n_preprocess, iter_swf_windows,
                    parse_swf)
from .lublin import lublin_trace, scale_to_load
from .trace import Trace

__all__ = [
    "WorkloadSpec", "WorkloadKind", "register_workload", "list_workloads",
    "workload_kind", "parse_workload", "make_trace", "make_trace_ir",
    "stream_trace", "trace_cache_info", "trace_cache_clear",
    "DEFAULT_STREAM_WINDOW_S", "WORKLOAD_KINDS",
]

_SCALARS = (str, int, float, bool)
ParamsLike = Union[Mapping, Tuple[Tuple[str, object], ...]]

@dataclass(frozen=True)
class WorkloadKind:
    """One registered generator: the ``spec -> Trace`` function plus its
    knob contract (which WorkloadSpec fields/params it honours)."""

    name: str
    fn: Callable[["WorkloadSpec"], Trace]
    doc: str = ""
    supports_load: bool = False      # does ``load=`` mean anything?
    params: Tuple[str, ...] = ()     # accepted params keys
    required: Tuple[str, ...] = ()   # params keys that must be present
    path_param: Optional[str] = None  # param filled by a "kind:<arg>" spelling
    #: optional native streamer ``(spec, window_s) -> Iterator[Trace]``;
    #: kinds without one stream via materialize-then-``Trace.iter_chunks``
    stream: Optional[Callable[["WorkloadSpec", float], object]] = None


_REGISTRY: Dict[str, WorkloadKind] = {}


def register_workload(
    name: str,
    *,
    doc: str = "",
    supports_load: bool = False,
    params: Tuple[str, ...] = (),
    required: Tuple[str, ...] = (),
    path_param: Optional[str] = None,
    stream: Optional[Callable] = None,
):
    """Decorator: register a ``spec -> Trace`` generator under ``name``.
    ``stream`` optionally binds a native ``(spec, window_s) -> chunks``
    streamer (see :func:`stream_trace`)."""
    if required and not set(required) <= set(params):
        raise ValueError("required params must be a subset of params")
    if path_param is not None and path_param not in params:
        raise ValueError("path_param must be one of params")

    def deco(fn: Callable[["WorkloadSpec"], Trace]):
        if name in _REGISTRY:
            raise ValueError(f"workload kind {name!r} already registered")
        _REGISTRY[name] = WorkloadKind(
            name=name, fn=fn, doc=doc or (fn.__doc__ or "").strip(),
            supports_load=supports_load, params=tuple(params),
            required=tuple(required), path_param=path_param, stream=stream)
        return fn
    return deco


def list_workloads() -> List[str]:
    return sorted(_REGISTRY)


def workload_kind(name: str) -> WorkloadKind:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(f"unknown workload kind {name!r}; "
                     f"expected one of {tuple(list_workloads())}")


def __getattr__(name: str):
    # live view kept for compatibility with the pre-registry tuple constant
    if name == "WORKLOAD_KINDS":
        return tuple(list_workloads())
    raise AttributeError(name)


@dataclass(frozen=True)
class WorkloadSpec:
    """Declarative, hashable description of one generated trace."""

    kind: str                      # a registered workload kind
    n_jobs: int = 250
    n_nodes: int = 64
    seed: int = 0
    load: Optional[float] = None   # target offered load (load-aware kinds)
    params: ParamsLike = ()        # kind-specific knobs (normalized tuple)

    def __post_init__(self) -> None:
        wk = workload_kind(self.kind)
        norm = tuple(sorted((str(k), v) for k, v in dict(self.params).items()))
        object.__setattr__(self, "params", norm)
        if self.load is not None and not wk.supports_load:
            loadable = [k for k in list_workloads()
                        if _REGISTRY[k].supports_load]
            raise ValueError(
                f"workload kind {self.kind!r} ignores load= — refusing the "
                f"silent no-op (load scaling is defined for: "
                f"{', '.join(loadable)})")
        given = {k for k, _ in norm}
        unknown = given - set(wk.params)
        if unknown:
            raise ValueError(
                f"workload kind {self.kind!r} does not accept params "
                f"{sorted(unknown)}; accepted: {list(wk.params) or 'none'}")
        missing = set(wk.required) - given
        if missing:
            raise ValueError(
                f"workload kind {self.kind!r} requires params "
                f"{sorted(missing)} (e.g. the spelling "
                f"'{self.kind}:<{wk.path_param or wk.required[0]}>')")
        for k, v in norm:
            if not isinstance(v, _SCALARS):
                raise ValueError(
                    f"param {k!r} must be a JSON scalar, got {type(v).__name__}")

    @property
    def params_dict(self) -> Dict[str, object]:
        return dict(self.params)

    def param(self, key: str, default=None):
        return self.params_dict.get(key, default)

    @property
    def name(self) -> str:
        load = f"@{self.load:g}" if self.load is not None else ""
        extra = "".join(f"+{k}={v}" for k, v in self.params)
        return f"{self.kind}-j{self.n_jobs}-n{self.n_nodes}-s{self.seed}{load}{extra}"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "n_jobs": self.n_jobs,
                "n_nodes": self.n_nodes, "seed": self.seed, "load": self.load,
                "params": self.params_dict}


def parse_workload(
    text: str,
    n_jobs: int = 250,
    n_nodes: int = 64,
    seed: int = 0,
    load: Optional[float] = None,
    params: Optional[Mapping] = None,
) -> WorkloadSpec:
    """The workload grammar: ``kind`` or ``kind:<arg>`` (the arg fills the
    kind's declared ``path_param``, e.g. ``swf:/data/HPC2N-2002.swf``)."""
    kind, sep, arg = text.partition(":")
    extra = dict(params or {})
    if sep:
        wk = workload_kind(kind)
        if wk.path_param is None:
            raise ValueError(
                f"workload kind {kind!r} takes no ':<arg>' "
                f"(spelled {text!r})")
        extra[wk.path_param] = arg
    return WorkloadSpec(kind, n_jobs=n_jobs, n_nodes=n_nodes, seed=seed,
                        load=load, params=tuple(sorted(extra.items())))


@lru_cache(maxsize=64)
def make_trace_ir(spec: WorkloadSpec) -> Trace:
    """Materialize the columnar trace for ``spec`` (memoized per process;
    the Trace is frozen, so the cache can hand out the same object)."""
    return workload_kind(spec.kind).fn(spec)


def make_trace(spec: WorkloadSpec) -> List[JobSpec]:
    """Materialize the trace for ``spec`` as a fresh ``JobSpec`` list."""
    return make_trace_ir(spec).to_specs()


def trace_cache_info():
    """Per-process memo statistics (hits/misses), for tests and diagnostics."""
    return make_trace_ir.cache_info()


def trace_cache_clear() -> None:
    """Drop the per-process trace memo (cold-materialization benchmarks)."""
    make_trace_ir.cache_clear()


# --------------------------------------------------------------------------- #
# built-in kinds                                                               #
# --------------------------------------------------------------------------- #
@register_workload(
    "lublin", supports_load=True,
    doc="Lublin–Feitelson synthetic model (§5.3.2); load= rescales "
        "inter-arrivals to the target offered load")
def _lublin(spec: WorkloadSpec) -> Trace:
    specs = lublin_trace(n_jobs=spec.n_jobs, n_nodes=spec.n_nodes,
                         seed=spec.seed)
    if spec.load is not None:
        specs = scale_to_load(specs, spec.n_nodes, spec.load)
    return Trace.from_specs(specs)


@register_workload(
    "hpc2n",
    doc="synthetic trace with HPC2N-like marginals through the §5.3.1 "
        "preprocessing (jobs wider than the cluster dropped)")
def _hpc2n(spec: WorkloadSpec) -> Trace:
    trace = Trace.from_specs(
        hpc2n_like_trace(n_jobs=spec.n_jobs, seed=spec.seed))
    # the generator models HPC2N's 120-node machine; on a smaller sweep
    # cluster, jobs wider than the cluster can never be placed — drop them
    return trace.select(trace.n_tasks <= spec.n_nodes)


@register_workload(
    "swf", params=("path",), required=("path",), path_param="path",
    doc="real Parallel Workloads Archive log (swf:<path>) through parse_swf "
        "+ §5.3.1 preprocessing; n_jobs caps the prefix (0 = whole log)")
def _swf(spec: WorkloadSpec) -> Trace:
    specs = hpc2n_preprocess(parse_swf(str(spec.param("path"))))
    trace = Trace.from_specs(specs)
    if spec.n_jobs and spec.n_jobs < len(trace):
        trace = trace.select(np.arange(spec.n_jobs))
    return trace.select(trace.n_tasks <= spec.n_nodes)


#: default streaming window: one day of release time per chunk
DEFAULT_STREAM_WINDOW_S = 86400.0


def stream_trace(spec: WorkloadSpec, window_s: Optional[float] = None):
    """Yield the workload as release-windowed :class:`Trace` chunks for
    :meth:`SimSession.stream <repro_torch.sched.session.SimSession.stream>`.

    Kinds registered with a native streamer (``swf-stream``) never
    materialize the whole log; every other kind falls back to
    ``make_trace_ir(spec).iter_chunks(window_s)`` — same chunk contract,
    just without the memory bound.  ``window_s`` defaults to the spec's
    ``window`` param, else :data:`DEFAULT_STREAM_WINDOW_S`.
    """
    if window_s is None:
        window_s = float(spec.param("window", DEFAULT_STREAM_WINDOW_S))
    wk = workload_kind(spec.kind)
    if wk.stream is not None:
        yield from wk.stream(spec, float(window_s))
    else:
        yield from make_trace_ir(spec).iter_chunks(float(window_s))


def _swf_stream_chunks(spec: WorkloadSpec, window_s: float):
    """Native streamer for ``swf-stream``: chunked parse + §5.3.1
    preprocessing, one submit-time window resident at a time."""
    for specs in iter_swf_windows(str(spec.param("path")), window_s,
                                  n_jobs=spec.n_jobs):
        tr = Trace.from_specs(specs)
        tr = tr.select(tr.n_tasks <= spec.n_nodes)
        if len(tr):
            yield tr


@register_workload(
    "swf-stream", params=("path", "window"), required=("path",),
    path_param="path", stream=_swf_stream_chunks,
    doc="streaming variant of 'swf' (swf-stream:<path>): identical trace, "
        "but stream_trace() parses the log in release windows "
        "(params[window]= seconds, default one day) without ever "
        "materializing it; requires a submit-sorted log")
def _swf_stream(spec: WorkloadSpec) -> Trace:
    # materialized fallback (simulate/sweep paths): same rows as 'swf'
    return _swf(spec)


@register_workload(
    "tpu", supports_load=True, params=("records", "chips_per_task"),
    doc="TPU-pod job mix from roofline job types (workloads.jobgen); "
        "load= is the target offered load (default 0.6), "
        "params[records]= derives types from a dry-run artifact")
def _tpu(spec: WorkloadSpec) -> Trace:
    from .jobgen import DEFAULT_TPU_JOB_TYPES, tpu_job_types, tpu_trace
    records_path = spec.param("records")
    if records_path:
        with open(str(records_path)) as f:
            types = tpu_job_types(json.load(f),
                                  chips_per_task=int(spec.param(
                                      "chips_per_task", 16)))
    else:
        types = DEFAULT_TPU_JOB_TYPES
    load = spec.load if spec.load is not None else 0.6
    return Trace.from_specs(
        tpu_trace(types, n_jobs=spec.n_jobs, n_nodes=spec.n_nodes,
                  seed=spec.seed, target_load=load))
