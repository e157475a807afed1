"""Atomic file writes.

Session snapshots are written through :func:`atomic_write_json`: the
payload lands in a uniquely-named temp file in the destination directory
(``tempfile.mkstemp`` opens it with ``O_EXCL``, so two writers never share
a temp path), is fsynced, and is moved over the destination with the
atomic ``os.replace``.  Readers see either the old or one writer's
complete new content, never a torn mix.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

__all__ = ["atomic_write_json", "atomic_write_text"]


def atomic_write_text(path: str, text: str) -> str:
    """Atomically replace ``path`` with ``text`` (parents created)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        try:
            os.unlink(tmp)          # only reached when replace() didn't run
        except FileNotFoundError:
            pass
    return path


def atomic_write_json(path: str, payload: Any,
                      indent: Optional[int] = 1) -> str:
    """Serialize ``payload`` as JSON and atomically replace ``path``."""
    return atomic_write_text(path, json.dumps(payload, indent=indent))
