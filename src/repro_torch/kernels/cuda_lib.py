"""Build and load the port's CUDA kernels (``csrc/alloc.cu``).

The source has a plain C interface.  At first use it is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the root of the checkout, named by a hash of the
source and the flags, and loaded with ``ctypes``; a later process with the
same source loads the cached library.  Nothing here runs at import time,
so the package imports on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["load_library", "build_info", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "alloc.cu"

#: --fmad=false keeps every multiply and add separately rounded (the
#: bit-identity contract); -Xptxas -v records registers and spills in the
#: build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "repro_alloc_matvec_f64": [_P, _P, _P, _I, _I, _I, _P],
    "repro_maxmin_round_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_loaded: Dict[str, object] = {}


def _build_dir() -> Path:
    # <checkout>/build/repro_torch, next to src/
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the CUDA kernels are built from source at first use")


def _build() -> Dict[str, object]:
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"alloc-{key}.so"
    log_path = out_dir / f"alloc-{key}.log"
    t0 = time.perf_counter()
    cached = lib_path.exists()
    if not cached:
        tmp = out_dir / f".alloc-{key}.{os.getpid()}.so"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)        # atomic against concurrent builds
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return {"lib": lib, "path": str(lib_path), "cached": cached,
            "build_s": time.perf_counter() - t0,
            "log": log_path.read_text() if log_path.exists() else ""}


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with _lock:
        if "lib" not in _loaded:
            _loaded.update(_build())
        return _loaded["lib"]


def build_info() -> Optional[Dict[str, object]]:
    """Path, build seconds, cache hit and the compiler log of the loaded
    library (None before the first :func:`load_library`)."""
    with _lock:
        if "lib" not in _loaded:
            return None
        return {k: v for k, v in _loaded.items() if k != "lib"}
