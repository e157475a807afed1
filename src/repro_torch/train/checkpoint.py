"""Checkpoints of trees of tensors with atomic commits and async save (a
port of the JAX package's ``train/checkpoint.py``, on its on-disk
protocol).

Layout (one directory per step):

    ckpt_dir/
      step_000000123/
        arrays.npz        # the tree's leaves, leaf_<i> in JAX's order
        manifest.json     # step, tree description, dtypes, user metadata
      LATEST              # text file: "step_000000123" (atomically replaced)

Guarantees:

* a checkpoint directory becomes visible only when complete (tmp + rename);
* LATEST is updated after the directory rename, so a crash anywhere leaves
  the previous checkpoint intact (restart safety for ``train.ft``);
* :func:`save_async` copies every leaf to the host before it returns (the
  caller may then update its tensors in place) and writes on a background
  thread;
* :func:`restore` validates the leaves' count and shapes against an
  optional template and puts each leaf on the template leaf's device and
  dtype.

numpy has no bf16: a bf16 leaf (Adafactor's first moment, bf16 weights)
is stored as its raw 16-bit pattern (uint16), its dtype in the manifest,
and comes back bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .tree import flatten, unflatten

__all__ = ["save", "save_async", "restore", "latest_step", "wait_pending"]

Tree = Any

_pending: List[threading.Thread] = []


def _host(x) -> Tuple[np.ndarray, str]:
    """(a host array that owns its bytes, the leaf's dtype name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.array(x)
    return a, a.dtype.name


def _to_host(tree: Tree):
    leaves, s = flatten(tree)
    arrays, dtypes = zip(*(_host(x) for x in leaves)) if leaves else ((), ())
    return list(arrays), list(dtypes), s


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _write(ckpt_dir: str, step: int, arrays, dtypes, structure,
           metadata: Optional[Dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": repr(structure),
        "n_leaves": len(arrays),
        "dtypes": dtypes,
        "metadata": metadata or {},
    }
    final = _step_dir(ckpt_dir, step)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # commit LATEST last (atomic rename of a small file)
    ptr = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr, os.path.join(ckpt_dir, "LATEST"))
    return final


def save(ckpt_dir: str, step: int, tree: Tree,
         metadata: Optional[Dict] = None) -> str:
    """Synchronous atomic save.  Returns the committed directory."""
    return _write(ckpt_dir, step, *_to_host(tree), metadata)


def save_async(ckpt_dir: str, step: int, tree: Tree,
               metadata: Optional[Dict] = None) -> threading.Thread:
    """Host copies of every leaf now; the disk write on a background
    thread."""
    arrays, dtypes, s = _to_host(tree)
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, arrays, dtypes, s, metadata),
                         daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending() -> None:
    while _pending:
        _pending.pop().join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[-1])


def _tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore(ckpt_dir: str, template: Optional[Tree] = None,
            step: Optional[int] = None) -> Tuple[int, Tree, Dict]:
    """Load (step, tree, metadata).  With ``template``, the stored leaves
    are validated against its leaves and restored into its structure, each
    on the template leaf's device and dtype; without, a list of CPU
    tensors in their stored dtypes."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n = manifest["n_leaves"]
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = [z[f"leaf_{i}"] for i in range(n)]
    leaves = [_tensor(a, name) for a, name in zip(arrays, manifest["dtypes"])]
    if template is None:
        return manifest["step"], leaves, manifest.get("metadata", {})
    t_leaves, s = flatten(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template {len(t_leaves)}")
    for i, (a, b) in enumerate(zip(leaves, t_leaves)):
        want = tuple(b.shape) if hasattr(b, "shape") else np.shape(b)
        if tuple(a.shape) != want:
            raise ValueError(f"leaf {i}: shape {tuple(a.shape)} != {want}")
    out = [a.to(device=b.device, dtype=b.dtype)
           if isinstance(b, torch.Tensor) else a.numpy()
           for a, b in zip(leaves, t_leaves)]
    return manifest["step"], unflatten(s, out), manifest.get("metadata", {})
