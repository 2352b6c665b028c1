"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``tdax_torch/ops/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, in
``build/tdax_torch/`` at the repository root (``build/`` is gitignored).
The library's file name carries a hash of its source and of the
``csrc/`` headers it includes, so an edited source or header is rebuilt
and a built one is reused.  Only the sources in the
repository are compiled; a failed build raises with nvcc's output.

``build(names)`` starts one nvcc per source that still needs building,
all at once, and waits for them together; each build's seconds go to
``BUILD_SECONDS`` and, with ``TDAX_LOG`` set, to a ``kernel_build``
event.  ``build_variants`` does the same for edited copies of a source
(the probe scripts' variants).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from tdax_torch.utils.log import log_event

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tdax_torch"

SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_fwd_sm90": "flash_fwd_sm90.cu",
           "flash_decode_sm90": "flash_decode_sm90.cu",
           "flash_bwd": "flash_bwd.cu", "flash_bwd_sm90": "flash_bwd_sm90.cu",
           "sqdist": "sqdist.cu", "sqdist_sm90": "sqdist_sm90.cu", "qmm": "qmm.cu",
           "qmm_sm90": "qmm_sm90.cu", "qmm_decode_sm90": "qmm_decode_sm90.cu"}
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("tdax_torch: nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built on the machine with the card")
    return str(path)


def _target(name: str) -> Path:
    """The library's path; its name hashes the source and every header of
    ``CSRC`` that the source includes (``#include "x.cuh"``)."""
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src)
    for header in _INCLUDE.findall(src.decode()):
        digest.update((CSRC / header).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, ctypes.CDLL]:
    """Compile (where needed, in parallel) and load the named libraries."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if n not in _LOADED and not _target(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        start = time.perf_counter()
        for n in todo:
            out = _target(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True), tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate()
            (BUILD_DIR / f"{n}.log").write_text(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"--- {SOURCES[n]} (nvcc exit {proc.returncode}):\n{stderr}")
                continue
            os.replace(tmp, out)
            BUILD_SECONDS[n] = time.perf_counter() - start
            log_event("kernel_build", name=n, seconds=round(BUILD_SECONDS[n], 3))
        if failed:
            raise RuntimeError("tdax_torch: kernel build failed\n" + "\n".join(failed))
    for n in names:
        if n not in _LOADED:
            _LOADED[n] = ctypes.CDLL(str(_target(n)))
    return {n: _LOADED[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    return build([name])[name]


def substitute(text: str, subs) -> str:
    """``text`` with each (old, new) of ``subs`` replaced; each old must
    occur exactly once."""
    for old, new in subs:
        n = text.count(old)
        if n != 1:
            raise ValueError(f"substitution found {n} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(texts: dict[str, str], out_dir: Path, declare) -> tuple[dict, dict]:
    """Compile each named source text (a variant of a source of ``CSRC``,
    whose headers it includes) with the port's flags into ``out_dir``, all
    at once; load those that built, ``declare(lib)`` setting each one's C
    signatures.  Returns ({name: library}, {name: {"built": bool,
    "ptxas": ptxas's register, spill and error lines}}); a variant that
    fails to build is reported there and left out."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, text in texts.items():
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), lib)
    libs, reports = {}, {}
    for name, (proc, lib) in procs.items():
        stdout, stderr = proc.communicate()
        reports[name] = {"built": proc.returncode == 0,
                         "ptxas": [ln.strip() for ln in (stdout + stderr).splitlines()
                                   if any(w in ln for w in ("registers", "spill", "C75",
                                                            "error"))]}
        if proc.returncode == 0:
            libs[name] = ctypes.CDLL(str(lib))
            declare(libs[name])
    return libs, reports
