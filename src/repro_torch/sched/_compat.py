"""One-shot deprecation warnings for the legacy scheduling entry points.

``repro_torch.api`` is the supported surface; the historical wrappers
(``simulate``, ``DFRSSimulator``, ``batch_schedule``) keep working but
announce themselves exactly once per process so long-running sweeps are
not flooded.  All of the legacy entry points are *closed-world* (full
trace in, one result out) — the migration pointer names both
``repro_torch.api.simulate`` (the like-for-like replacement) and
``repro_torch.api.open_session`` (the streaming session API).
"""
from __future__ import annotations

import warnings

_WARNED: set = set()

#: the migration pointer for closed-world simulate-style entry points
BATCH_REPLACEMENT = ("repro_torch.api.simulate (or "
                     "repro_torch.api.open_session for streaming/step-wise "
                     "runs)")


def warn_once(name: str, replacement: str = "repro_torch.api") -> None:
    """Emit one DeprecationWarning per ``name`` per process."""
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"{name} is deprecated; use {replacement} instead",
        DeprecationWarning,
        stacklevel=3,
    )


def reset() -> None:
    """Forget prior warnings (test hook)."""
    _WARNED.clear()
