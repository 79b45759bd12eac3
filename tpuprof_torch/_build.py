"""Build native sources of the port at first use.

Every compiled artifact goes into one build directory, ``build/tpuprof_torch/``
beside the package (``TPUPROF_TORCH_BUILD_DIR`` overrides it).  A library is
named by a digest of its source and command, so an edited source never loads a
stale build, and is written under a temporary name and renamed into place, so
concurrent first uses (test workers, a second process) never load a half-written
file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import List, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    path = os.environ.get("TPUPROF_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "tpuprof_torch")
    os.makedirs(path, exist_ok=True)
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
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(list(cmd) + [src, "-o", tmp],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.tmp = tmp
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
    if proc.returncode != 0:
        raise RuntimeError(f"build of {out} failed "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp, out)
    return log


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "tpuprof_torch/kernels/csrc with the CUDA toolkit at first use")
    return path


def nvcc_command(extra: Sequence[str] = ()) -> List[str]:
    """The one nvcc command every kernel library is built with: sm_90a,
    full IEEE float (no fast math, no flush to zero), plain C interface."""
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            *extra]
