"""Pluggable race objectives: score a (possibly partial) branch record.

An :class:`Objective` maps one ``run_branches`` record — the flat metric
dict of a what-if branch, full-run or horizon-bounded — to a single
*minimized* scalar.  Quarantined or metric-less records score ``inf``, so
a crashing variant loses a race instead of winning it by vacuity.

Objectives are either registered names (``max_stretch``,
``mean_stretch``, ``underutilization``, ``migration``) or weighted blends
in a tiny ``w*key[+w*key...]`` grammar::

    parse_objective("max_stretch")
    parse_objective("0.7*max_stretch+0.3*mean_stretch")
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

__all__ = ["Objective", "parse_objective", "list_objectives",
           "SCORABLE_KEYS"]

#: record keys an objective term may reference — every one is
#: minimize-is-better on its own (utilization enters as UNDER-utilization)
SCORABLE_KEYS = (
    "max_stretch",
    "mean_stretch",
    "makespan",
    "underutilization",
    "pmtn_per_job",
    "mig_per_job",
    "bytes_moved_gb",
)


@dataclass(frozen=True)
class Objective:
    """A weighted sum of branch-record metrics, minimized."""

    name: str
    terms: Tuple[Tuple[float, str], ...]

    def score(self, record: Dict[str, Any]) -> float:
        """Scalar score of one branch record (``inf`` when any referenced
        metric is missing or non-finite — quarantined branches lose)."""
        total = 0.0
        for w, key in self.terms:
            v = record.get(key)
            if v is None or not math.isfinite(float(v)):
                return math.inf
            total += w * float(v)
        return total

    @property
    def prunable_by_max_stretch(self) -> bool:
        """True when a growing completed-job max stretch can only worsen
        the score — the single-term ``max_stretch`` objective, where a
        branch past the cutoff is safe to early-stop."""
        return self.terms == ((1.0, "max_stretch"),)

    def __str__(self) -> str:
        return self.name


_NAMED: Dict[str, Tuple[Tuple[float, str], ...]] = {
    "max_stretch": ((1.0, "max_stretch"),),
    "mean_stretch": ((1.0, "mean_stretch"),),
    "makespan": ((1.0, "makespan"),),
    "underutilization": ((1.0, "underutilization"),),
    # stretch with a disruption tax: racing should not reward a variant
    # that wins by migrating everything everywhere
    "migration": ((1.0, "max_stretch"), (0.1, "mig_per_job")),
}

_TERM = re.compile(r"^\s*(?:([0-9.eE+-]+)\s*\*\s*)?([a-z_]+)\s*$")


def list_objectives() -> List[str]:
    return sorted(_NAMED)


def parse_objective(spec) -> Objective:
    """Build an :class:`Objective` from a registered name or a
    ``w*key[+w*key...]`` blend; passes an :class:`Objective` through."""
    if isinstance(spec, Objective):
        return spec
    spec = str(spec).strip()
    if spec in _NAMED:
        return Objective(name=spec, terms=_NAMED[spec])
    terms: List[Tuple[float, str]] = []
    for part in spec.split("+"):
        m = _TERM.match(part)
        if not m:
            raise ValueError(
                f"malformed objective term {part!r} in {spec!r}; want "
                f"'key' or 'weight*key' terms joined by '+'")
        weight = float(m.group(1)) if m.group(1) else 1.0
        key = m.group(2)
        if key not in SCORABLE_KEYS:
            raise ValueError(
                f"unknown objective metric {key!r}; known: "
                f"{list(SCORABLE_KEYS)} (or a named objective from "
                f"{list_objectives()})")
        terms.append((weight, key))
    if not terms:
        raise ValueError("empty objective spec")
    return Objective(name=spec, terms=tuple(terms))
