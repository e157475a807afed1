"""Readings of ``torch.profiler`` traces.

``device_summary`` is ``chip_smoke.device_busy``'s arithmetic: the
seconds in which a kernel or a copy ran on the card (the union of their
intervals, from kineto's raw events, which are read far faster than the
profiler's ``FunctionEvent`` list), the summed seconds by name, and the
card's idle gaps by the innermost host-side event of the trace open when
each opened (with the card's activity alone traced, the CUDA runtime's
calls: a launch, a synchronise, an allocation).

``host_ops`` traces one call on the host alone: the top-level ATen
operators it dispatches (``chip_smoke.host_ops``'s count: an ``aten::``
operator whose enclosing event on its thread is none or not an
``aten::`` one, found here from the raw events' intervals).
"""
from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, List, Tuple


def _events(prof, host: bool = False):
    """(card events, host events by thread): each card event (start, end,
    name) in seconds, sorted; each host event (start ns, -duration ns,
    name), kept only when ``host``."""
    from torch.autograd import DeviceType

    dev: List[Tuple[float, float, str]] = []
    threads: Dict[int, list] = {}
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            start = e.start_ns() / 1e9
            dev.append((start, start + e.duration_ns() / 1e9, e.name()))
        elif host and kind == DeviceType.CPU:
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.duration_ns(), e.name()))
    return sorted(dev), threads


def _merged(events) -> List[Tuple[float, float]]:
    spans: List[Tuple[float, float]] = []
    for start, end, _ in events:
        if spans and start <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], end))
        else:
            spans.append((start, end))
    return spans


def device_summary(prof) -> Dict:
    """``{"busy_s", "events", "by_name": {name: seconds}, "idle_gaps":
    {host event: seconds}}`` of a trace."""
    events, threads = _events(prof, host=True)
    by_name: Counter = Counter()
    for start, end, name in events:
        by_name[name] += end - start
    spans = _merged(events)
    host = [(s / 1e9, (s - d) / 1e9, n)
            for ev in threads.values() for s, d, n in ev]
    return {"busy_s": sum(end - start for start, end in spans),
            "events": len(events), "by_name": dict(by_name),
            "idle_gaps": _gaps_by_host(host, spans)}


def _top_level_aten(events) -> int:
    """``aten::`` events of one thread whose enclosing event is none or
    not an ``aten::`` one; events as (start, -duration, name)."""
    count, stack = 0, []                 # (end, name) of the open events
    for start, neg_dur, name in sorted(events):
        while stack and stack[-1][0] <= start:
            stack.pop()
        if name.startswith("aten::") and not (
                stack and stack[-1][1].startswith("aten::")):
            count += 1
        stack.append((start - neg_dur, name))
    return count


def host_ops(torch, fn) -> int:
    """Top-level ATen operators ``fn()`` dispatches from the host."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(_top_level_aten(ev) for ev in _events(prof, host=True)[1]
               .values())


def _gaps_by_host(cpu, spans) -> Dict[str, float]:
    """Seconds of the card's idle gaps between ``spans``, by the innermost
    host event (the latest started of those not yet ended) open when each
    gap opened; one sweep over both in time order."""
    cpu = sorted(cpu)
    gaps: Counter = Counter()
    heap: list = []                      # (-start, end, name) of started
    i = 0
    for (_, opened), (closed, _) in zip(spans, spans[1:]):
        while i < len(cpu) and cpu[i][0] <= opened:
            heapq.heappush(heap, (-cpu[i][0], cpu[i][1], cpu[i][2]))
            i += 1
        while heap and heap[0][1] <= opened:
            heapq.heappop(heap)
        gaps[heap[0][2] if heap else "(no host event)"] += closed - opened
    return dict(gaps)
