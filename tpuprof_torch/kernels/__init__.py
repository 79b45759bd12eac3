"""Device kernels of the port and their plain PyTorch versions.

The CUDA sources under ``csrc/`` are compiled with nvcc for sm_90a at first
use into shared libraries with a plain C interface, loaded with ctypes.
:func:`build_all` starts every nvcc at once (one process per source) so a
cold start pays the slowest build, not the sum; :func:`library` then loads
those builds, or builds a single kernel at its first use when nothing
called :func:`build_all`.  :func:`library_paths` names the files a set of
kernels loads from, which the store of built libraries
(``runtime/aot.py``) packs and adopts; :func:`build` builds a set of them
at once (the store's background save).
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Callable, Dict, Iterable

from tpuprof_torch import _build

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = {name: os.path.join(_CSRC, f"{name}.cu")
           for name in ("fused_a", "hist_b", "fused_wide", "spear", "rank",
                        "fused_ab")}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}     # nvcc/ptxas output of this process


def _command():
    # -Xptxas -v only adds register/shared-memory usage to the build log
    return _build.nvcc_command(["-Xptxas", "-v"])


def library_paths(names: Iterable[str]) -> Dict[str, str]:
    """{kernel: the library file it loads from} in this process's build
    directory (the file's name is a digest of its sources and command)."""
    cmd = _command()
    return {name: _build.library_path(SOURCES[name], cmd)
            for name in sorted(names)}


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build the libraries of ``names`` that are not built yet, all nvcc
    processes started together, under the lock :func:`library` builds
    under (one build of a file at a time in this process).  Returns
    {name: seconds until its build finished}."""
    cmd = _command()
    with _lock:
        t0 = time.perf_counter()
        started = {name: _build.start_build(SOURCES[name], cmd)
                   for name in sorted(names)}
        took = {}
        for name, (out, proc) in started.items():
            log = _build.finish_build(out, proc)
            if log:
                build_logs[name] = log
            took[name] = time.perf_counter() - t0
    return took


def build_all() -> Dict[str, float]:
    """Build every kernel library that is not built yet, all nvcc processes
    started together.  Returns {name: seconds until its build finished}."""
    return build(SOURCES)


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for kernel ``name`` (built on first use), with
    ``bind`` applied once to declare its argument types."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, proc = _build.start_build(SOURCES[name], _command())
            log = _build.finish_build(out, proc)
            if log:
                build_logs[name] = log
            lib = ctypes.CDLL(out)
            bind(lib)
            _libs[name] = lib
        return lib


def check(status: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if status != 0:
        msg = lib.tpt_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")
