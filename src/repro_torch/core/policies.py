"""DFRS policy naming scheme (paper §4.5, Table 1).

``"<submit>[ *]/per/OPT=<MIN|AVG|MAX>[/MINVT=<s>|/MINFT=<s>]"``

* first part: action on job submission — ``Greedy``, ``GreedyP``,
  ``GreedyPM``, ``MCB8`` or empty (no action);
* a trailing ``*`` on the first part: opportunistic scheduling on job
  completion (MCB8 if MCB8 was used on submission, Greedy for the greedy
  family — and for the bare ``Greedy`` policy itself);
* ``per``: apply MCB8 periodically; ``stretch-per``: apply MCB8-stretch
  periodically;
* ``OPT``: resource-allocation post-pass (§4.6/§4.7);
* ``MINVT``/``MINFT``: grace bound (seconds of virtual/flow time) under
  which MCB8 may pause a running job but must not *move* it.

The grammar is *sugar* over the declarative :class:`PolicySpec`:
:func:`parse_policy` canonicalizes every accepted spelling (case,
whitespace, component order, implicit ``/OPT=MIN``) so that equivalent
strings produce *equal* specs carrying one canonical ``name``.  The whole
grammar parses here; which specs can run is decided where a spec becomes a
policy (``repro_torch.sched.components.compose_from_spec``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

__all__ = ["PolicySpec", "parse_policy", "render_policy", "TABLE1_POLICIES",
           "all_paper_policies"]

_SUBMIT = {"": None, "greedy": "greedy", "greedyp": "greedyP", "greedypm": "greedyPM", "mcb8": "mcb8"}

#: canonical spelling of each submit component (inverse of ``_SUBMIT``)
_SUBMIT_CANON = {None: "", "greedy": "Greedy", "greedyP": "GreedyP",
                 "greedyPM": "GreedyPM", "mcb8": "MCB8"}


@dataclass(frozen=True)
class PolicySpec:
    name: str
    on_submit: Optional[str]       # None | greedy | greedyP | greedyPM | mcb8
    opportunistic: bool            # on-completion action enabled?
    periodic: Optional[str]        # None | mcb8 | mcb8-stretch
    opt: str = "MIN"               # MIN | AVG | MAX (MAX only for stretch-per)
    minvt: Optional[float] = None
    minft: Optional[float] = None

    @property
    def on_complete(self) -> Optional[str]:
        if not self.opportunistic:
            return None
        return "mcb8" if self.on_submit == "mcb8" else "greedy"

    @property
    def is_batch(self) -> bool:
        return self.name.upper() in ("FCFS", "EASY")

    @classmethod
    def make(
        cls,
        on_submit: Optional[str] = None,
        opportunistic: bool = False,
        periodic: Optional[str] = None,
        opt: str = "MIN",
        minvt: Optional[float] = None,
        minft: Optional[float] = None,
    ) -> "PolicySpec":
        """Construct a spec with its canonical ``name`` computed for you."""
        spec = cls("", on_submit, opportunistic, periodic, opt, minvt, minft)
        return cls(render_policy(spec), on_submit, opportunistic, periodic,
                   opt, minvt, minft)


def render_policy(spec: PolicySpec) -> str:
    """The canonical string spelling of ``spec`` (grammar sugar inverse).

    Canonical form: ``Submit[ *][/per|/stretch-per]/OPT=X[/MINVT=s|/MINFT=s]``
    with the submit part in its reference capitalization and ``OPT`` always
    explicit.
    """
    if spec.is_batch:
        return spec.name.upper()
    head = _SUBMIT_CANON[spec.on_submit]
    if spec.opportunistic:
        head = f"{head} *" if head else "*"
    parts = [head]
    if spec.periodic == "mcb8":
        parts.append("per")
    elif spec.periodic == "mcb8-stretch":
        parts.append("stretch-per")
    parts.append(f"OPT={spec.opt}")
    if spec.minvt is not None:
        parts.append(f"MINVT={spec.minvt:g}")
    if spec.minft is not None:
        parts.append(f"MINFT={spec.minft:g}")
    return "/".join(parts)


def parse_policy(name: str) -> PolicySpec:
    if name.strip().upper() in ("FCFS", "EASY"):
        return PolicySpec(name.strip().upper(), None, False, None)
    parts = name.split("/")
    head = parts[0].strip()
    opportunistic = head.endswith("*")
    head = head[:-1].strip() if opportunistic else head
    if head.lower() not in _SUBMIT:
        raise ValueError(f"unknown submit policy {head!r} in {name!r}")
    on_submit = _SUBMIT[head.lower()]
    periodic = None
    opt = "MIN"
    minvt = minft = None
    for part in parts[1:]:
        p = part.strip()
        if not p:
            continue
        low = p.lower()
        if low == "per":
            periodic = "mcb8"
        elif low == "stretch-per":
            periodic = "mcb8-stretch"
        elif low.startswith("opt="):
            opt = p.split("=", 1)[1].strip().upper()
        elif low.startswith("minvt="):
            minvt = float(p.split("=", 1)[1])
        elif low.startswith("minft="):
            minft = float(p.split("=", 1)[1])
        else:
            raise ValueError(f"unknown policy component {p!r} in {name!r}")
    if opt not in ("MIN", "AVG", "MAX"):
        raise ValueError(f"unknown OPT {opt!r}")
    if opt == "MAX" and periodic != "mcb8-stretch":
        raise ValueError("OPT=MAX is only defined for /stretch-per")
    return PolicySpec.make(on_submit, opportunistic, periodic, opt,
                           minvt, minft)


#: the 14 Table-1 combinations (with the paper's recommended parameters)
TABLE1_POLICIES: List[str] = [
    "Greedy *",
    "GreedyP *",
    "GreedyPM *",
    "Greedy/per",
    "GreedyP/per",
    "GreedyPM/per",
    "Greedy */per",
    "GreedyP */per",
    "GreedyPM */per",
    "MCB8 *",
    "MCB8/per",
    "MCB8 */per",
    "/per",
    "/stretch-per",
]


def all_paper_policies() -> List[str]:
    """The full 116-combination space of §6.1."""
    out = []
    for base in ["Greedy *", "GreedyP *", "GreedyPM *"]:
        for opt in ("MIN", "AVG"):
            out.append(f"{base}/OPT={opt}")
    mcb_bases = TABLE1_POLICIES[3:]  # every combination that invokes MCB8
    limits = ["", "/MINFT=300", "/MINFT=600", "/MINVT=300", "/MINVT=600"]
    for base in mcb_bases:
        opts = ("MAX", "AVG") if base == "/stretch-per" else ("MIN", "AVG")
        for opt in opts:
            for lim in limits:
                out.append(f"{base}/OPT={opt}{lim}")
    return out
