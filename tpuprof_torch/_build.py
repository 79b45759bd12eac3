"""Build native sources of the port at first use.

Every compiled artifact goes into one build directory: the process's
``compile_cache_dir`` when one was set (:func:`set_build_dir`; the CLI's
``--compile-cache``), else ``TPUPROF_TORCH_BUILD_DIR``, else
``build/tpuprof_torch/`` beside the package.  ``--no-compile-cache`` builds
into a directory private to the process, removed at exit
(:func:`use_private_build_dir`).  A library is named by a digest of its
source and command, so an edited source never loads a stale build, and is
written under a temporary name and renamed into place, so concurrent first
uses (test workers, a second process, two threads) never load a
half-written file.  :data:`builds` and :data:`build_seconds` count this
process's compiler runs by compiler (``nvcc``, ``g++``) (the store of built libraries, ``runtime/aot.py``,
exists to keep them at 0 on a restart).
"""

from __future__ import annotations

import atexit
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import List, Optional, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))

_override: Optional[str] = None     # set_build_dir / use_private_build_dir
_count_lock = threading.Lock()
builds = {}                 # compiler name -> processes this process started
build_seconds = {}          # compiler name -> their wall seconds


def default_build_dir() -> str:
    """``TPUPROF_TORCH_BUILD_DIR``, else ``build/tpuprof_torch/`` beside
    the package."""
    return os.environ.get("TPUPROF_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "tpuprof_torch")


def build_dir() -> str:
    path = _override or default_build_dir()
    os.makedirs(path, exist_ok=True)
    return path


def set_build_dir(path: Optional[str]) -> None:
    """Build into ``path`` from now on in this process (None: back to
    :func:`default_build_dir`).  Libraries already loaded stay loaded."""
    global _override
    _override = os.path.abspath(path) if path else None


def use_private_build_dir() -> str:
    """Build into a fresh directory that only this process uses and that
    is removed when it exits: nothing shared is written."""
    path = tempfile.mkdtemp(prefix="tpuprof-torch-build-")
    atexit.register(shutil.rmtree, path, True)
    set_build_dir(path)
    return path


def library_path(src: str, cmd: Sequence[str]) -> str:
    """Where the library built from ``src`` with compiler command ``cmd``
    (without its input and output arguments) lives.  The digest covers the
    headers beside ``src`` too, since a source may include them."""
    h = hashlib.sha256()
    src_dir = os.path.dirname(os.path.abspath(src))
    headers = sorted(f for f in os.listdir(src_dir)
                     if f.endswith((".cuh", ".h")))
    for path in [src] + [os.path.join(src_dir, f) for f in headers]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update("\0".join(cmd).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir(), f"lib{stem}-{h.hexdigest()[:12]}.so")


def start_build(src: str, cmd: Sequence[str]):
    """Start compiling ``src`` unless its library exists.  Returns
    ``(path, process)``; ``process`` is None when nothing needs building.
    Callers finish with :func:`finish_build`."""
    out = library_path(src, cmd)
    if os.path.exists(out):
        return out, None
    if shutil.which(cmd[0]) is None:
        raise RuntimeError(
            f"{cmd[0]} not found: {os.path.basename(src)} is built from "
            "source at first use (the CUDA kernels under "
            "tpuprof_torch/kernels/csrc with the CUDA toolkit's nvcc)")
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(list(cmd) + [src, "-o", tmp],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.tmp = tmp
    proc.t0 = time.perf_counter()
    proc.tool = os.path.basename(cmd[0])
    with _count_lock:
        builds[proc.tool] = builds.get(proc.tool, 0) + 1
    return out, proc


def finish_build(out: str, proc, timeout: float = 600.0) -> str:
    """Wait for a build from :func:`start_build`; returns the compiler's
    output (empty when nothing was built).  Raises on failure."""
    if proc is None:
        return ""
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    finally:
        with _count_lock:
            build_seconds[proc.tool] = build_seconds.get(proc.tool, 0.0) \
                + time.perf_counter() - proc.t0
    if proc.returncode != 0:
        raise RuntimeError(f"build of {out} failed "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp, out)
    return log


def nvcc() -> str:
    """The nvcc the libraries are built with (and named after).  Whether it
    exists is checked when a build starts, so a library that is already
    built, or adopted from the store, loads on a machine without one."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(extra: Sequence[str] = ()) -> List[str]:
    """The one nvcc command every kernel library is built with: sm_90a,
    full IEEE float (no fast math, no flush to zero), plain C interface."""
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            *extra]
