"""ctypes binding of the port to the native C++ Rips engine in ``cpp/``.

Counterpart of ``tdax/ops/rips/native.py``: the same sources
(``cpp/tdax_rips.cc``, ``tdax_rips_f32.cc``, ``tdax_rips_sparse.cc``),
the same g++ line, the same symbols (``tdax_rips_dense``,
``tdax_rips_dense_f32``, ``tdax_free``) and return codes.  The library
is built at first use into ``build/tdax_torch/`` under a name hashed
from the sources, g++'s version and the target options that
``-march=native`` selects on this host, never into ``cpp/``, where
tdax's own binding builds.  A library built on a host with another
instruction set therefore has another name and is rebuilt, not loaded.
A failed build raises with g++'s output; there is no fallback engine in
the port.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from tdax_torch.ops._build import BUILD_DIR

CPP_DIR = Path(__file__).resolve().parents[3] / "cpp"
SOURCES = ("tdax_rips.cc", "tdax_rips_f32.cc", "tdax_rips_sparse.cc")
_HEADERS = ("tdax_threads.h",)
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-pthread")


def _host_key() -> bytes:
    """g++'s version and the target options ``-march=native`` resolves to
    on this host (the CPU's instruction set); empty without g++, and the
    build then raises."""
    try:
        version = subprocess.run(["g++", "--version"], capture_output=True, timeout=60).stdout
        target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                                capture_output=True, timeout=60).stdout
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return b""
    return version + target


@functools.cache
def _target() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + _HEADERS:
        h.update((CPP_DIR / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(_host_key())
    return BUILD_DIR / f"libtdax_rips_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine where needed (one build at a time across
    processes) and return the library's path."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtdax_rips.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), *(str(CPP_DIR / s) for s in SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"tdax_torch: native rips engine build failed: {e}") from e
        (BUILD_DIR / "libtdax_rips.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"tdax_torch: native rips engine build failed "
                               f"(g++ exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, in_t in (("tdax_rips_dense", ctypes.c_double),
                       ("tdax_rips_dense_f32", ctypes.c_float)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(in_t),                              # dist (n*n)
            ctypes.c_int,                                      # n
            ctypes.c_int,                                      # maxdim
            ctypes.c_double,                                   # thresh (inf -> enclosing radius)
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),  # out bars
            ctypes.POINTER(ctypes.c_long),                     # out record count
        ]
    lib.tdax_free.restype = None
    lib.tdax_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    return lib


def rips_native(dist: np.ndarray, maxdim: int = 1, thresh: float = np.inf) -> list[np.ndarray]:
    """Diagrams of a dense distance matrix.  float32 input runs the f32
    engine (exact on f32-derived distances, half the bytes); anything
    else the f64 engine."""
    lib = _library()
    n = dist.shape[0]
    if dist.dtype == np.float32:
        buf = np.ascontiguousarray(dist, dtype=np.float32)
        fn, ptr_t = lib.tdax_rips_dense_f32, ctypes.c_float
    else:
        buf = np.ascontiguousarray(dist, dtype=np.float64)
        fn, ptr_t = lib.tdax_rips_dense, ctypes.c_double
    if buf.shape != (n, n):
        raise ValueError(f"rips_native: expected a square matrix, got {dist.shape}")
    out_ptr = ctypes.POINTER(ctypes.c_double)()
    out_len = ctypes.c_long(0)
    rc = fn(buf.ctypes.data_as(ctypes.POINTER(ptr_t)), n, maxdim, float(thresh),
            ctypes.byref(out_ptr), ctypes.byref(out_len))
    if rc == 3:
        raise ValueError("native rips engine supports maxdim <= 3")
    if rc == 4:
        raise AssertionError(
            "zero column under enclosing-radius threshold — filtration "
            "should be acyclic above dim 0 (engine invariant violated)")
    if rc == 5:
        raise MemoryError("native rips engine ran out of memory (dense engine std::bad_alloc)")
    if rc != 0:
        raise RuntimeError(f"tdax_rips_dense failed with code {rc}")
    try:
        flat = np.ctypeslib.as_array(out_ptr, shape=(out_len.value,)).copy()
    finally:
        lib.tdax_free(out_ptr)
    # layout: repeated records (dim, birth, death); death = -1 encodes inf
    recs = flat.reshape(-1, 3)
    dgms = []
    for p in range(maxdim + 1):
        bars = recs[recs[:, 0] == p][:, 1:3].copy()
        bars[bars[:, 1] < 0, 1] = np.inf
        if len(bars):
            bars = bars[np.lexsort((bars[:, 1], bars[:, 0]))]
        dgms.append(bars)
    return dgms
