"""The comparison that decides ``correct`` for a training cell.

The program's readings and the reference's are each ``{"loss": [...],
"grad": {leaf: norm}, "change": {leaf: norm}}`` (``reference.train``).
Three numbers are compared, each with its limit from the cell's
``limits/<cell>.json``:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first clipped gradient, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap``: the same for each leaf's change over the checked
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

A reading that is not finite, or a leaf missing on one side, fails.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict

NAMES = ("loss_gap", "grad_gap", "change_gap")
#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone and is left out of ``change_gap``
STILL = 1e-3


def _leaf_gap(prog: Dict, ref: Dict, keys) -> float:
    if set(prog) != set(ref):
        return math.inf
    base = median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], base) for k in keys)


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    else:
        loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                        ref["loss"]))
    g = ref["grad"]
    med = median(g.values())
    moved = [k for k in g if g[k] >= STILL * med]
    out = {"loss_gap": loss,
           "grad_gap": _leaf_gap(prog["grad"], g, list(g)),
           "change_gap": (_leaf_gap(prog["change"], ref["change"], moved)
                          if set(prog["change"]) == set(ref["change"])
                          else math.inf)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """``{"correct": bool, "checks": {name: {"value", "limit"}}}``."""
    ok = all(math.isfinite(values[k]) and values[k] <= limits[k]
             for k in NAMES)
    # JSON has no infinity: a reading that is not finite prints as 1e308
    checks = {k: {"value": min(values[k], 1e308), "limit": limits[k]}
              for k in NAMES}
    return {"correct": ok, "checks": checks}
