"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is built into its own library,
with its own flags.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/repro_torch/`` at the root
of the checkout, named by a hash of the source and the flags, and loaded
with ``ctypes``; a later process with the same source loads the cached
library.  :func:`load_all` starts one ``nvcc`` per source, all together.
Nothing here runs at import time, so the package imports on machines with
no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

__all__ = ["load_library", "load_all", "build_info", "LIBRARIES"]

_CSRC = Path(__file__).resolve().parent / "csrc"

# -Xptxas -v records registers and spills in the build log
_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: name -> (source, nvcc flags, {C function: argtypes})
LIBRARIES = {
    # --fmad=false keeps every multiply and add separately rounded (the
    # allocation path's bit-identity contract)
    "alloc": (_CSRC / "alloc.cu",
              _COMMON[:3] + ("--fmad=false",) + _COMMON[3:], {
        "repro_alloc_matvec_f64": [_P, _P, _P, _I, _I, _I, _P],
        "repro_maxmin_solve_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "repro_node_usage_f64": [_P, _P, _P, _I, _I, _I, _P],
    }),
    "attention": (_CSRC / "attention.cu", _COMMON, {
        "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _F, _P],
        "repro_flash_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _F, _P],
    }),
    "rglru": (_CSRC / "rglru.cu", _COMMON, {
        "repro_rglru_scan_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "repro_rglru_scan_chunked_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _P],
        "repro_rglru_gated": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _P],
    }),
    "wkv6": (_CSRC / "wkv6.cu", _COMMON, {
        "repro_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _P],
        "repro_wkv6_chunked": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _P],
    }),
}

_lock = threading.Lock()
_loaded: Dict[str, Dict[str, object]] = {}


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


def _build(name: str) -> Dict[str, object]:
    source, flags, signatures = LIBRARIES[name]
    src = source.read_bytes()
    key = hashlib.sha256(src + "\0".join(flags).encode()).hexdigest()[:16]
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"{name}-{key}.so"
    log_path = out_dir / f"{name}-{key}.log"
    t0 = time.perf_counter()
    cached = lib_path.exists()
    if not cached:
        tmp = out_dir / f".{name}-{key}.{os.getpid()}.so"
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(source)],
            capture_output=True, text=True)
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)        # atomic against concurrent builds
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return {"lib": lib, "source": str(source), "path": str(lib_path),
            "flags": list(flags), "cached": cached,
            "build_s": time.perf_counter() - t0,
            "log": log_path.read_text() if log_path.exists() else ""}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (a key of :data:`LIBRARIES`),
    built on first call."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = _build(name)
        return _loaded[name]["lib"]


def load_all() -> None:
    """Build every library not yet loaded, one ``nvcc`` per source, all
    started together; raises the first build error."""
    with _lock:
        todo = [n for n in LIBRARIES if n not in _loaded]
        with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
            built = dict(zip(todo, pool.map(_build, todo)))
        _loaded.update(built)


def build_info() -> Dict[str, Dict[str, object]]:
    """Per loaded library: source, path, flags, build seconds, cache hit and
    the compiler log (libraries not loaded yet are absent)."""
    with _lock:
        return {name: {k: v for k, v in info.items() if k != "lib"}
                for name, info in _loaded.items()}

