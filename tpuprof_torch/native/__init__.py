"""Host hashing in C++ via ctypes (counterpart of ``tpuprof/native``).

``hash.cpp`` is a copy of the reference's source, compiled with the host C++
compiler at first use into the port's build directory.  Every entry point
returns None (or False) when the library cannot be built, and the callers
fall back to numpy/pandas; the choice is made once per process so hashes
agree across batches.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from tpuprof_torch import _build

logger = logging.getLogger("tpuprof_torch")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hash.cpp")
_CMD = ("g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _bind(lib: ctypes.CDLL) -> None:
    p, n = ctypes.c_void_p, ctypes.c_size_t
    lib.tpuprof_hash_u64.argtypes = [p, p, n]
    lib.tpuprof_hash_bytes.argtypes = [p, p, p, n]
    lib.tpuprof_hll_update.argtypes = [p, n, n, ctypes.c_ssize_t,
                                       ctypes.c_ssize_t, p, n]
    lib.tpuprof_hash_pack_u64.argtypes = [p, p, p, n, ctypes.c_int]
    lib.tpuprof_pack_gather.argtypes = [p, n, p, p, p, n, ctypes.c_int]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            out, proc = _build.start_build(_SRC, _CMD)
            _build.finish_build(out, proc, timeout=120)
            lib = ctypes.CDLL(out)
            _bind(lib)
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as exc:
            logger.info("native hash unavailable (%s); using the numpy "
                        "fallbacks", exc)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _check_pack_precision(precision: int) -> None:
    from tpuprof_torch.kernels.hll import MAX_PRECISION
    if not 1 <= precision <= MAX_PRECISION:
        raise ValueError(f"hll precision {precision} cannot pack into "
                         f"uint16 (max {MAX_PRECISION})")


def _valid_ptr(valid: Optional[np.ndarray]):
    """(keep-alive array, pointer) for an optional validity mask."""
    if valid is None:
        return None, 0
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    return valid, valid.ctypes.data


def hash_u64_array(bits: np.ndarray) -> Optional[np.ndarray]:
    """splitmix64 of raw 64-bit patterns; None without the library."""
    lib = _load()
    if lib is None:
        return None
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    out = np.empty(bits.shape, dtype=np.uint64)
    lib.tpuprof_hash_u64(bits.ctypes.data, out.ctypes.data, bits.size)
    return out


def hll_update(regs: np.ndarray, packed: np.ndarray) -> bool:
    """Fold a (rows, cols) uint16 packed plane into (cols, m) int32
    registers in place; False without the library."""
    lib = _load()
    if lib is None:
        return False
    if regs.dtype != np.int32 or not regs.flags.c_contiguous:
        raise ValueError("registers must be C-contiguous int32")
    packed = packed if packed.dtype == np.uint16 else \
        packed.astype(np.uint16)
    n_rows, n_cols = packed.shape
    if regs.shape[0] != n_cols:
        raise ValueError("register rows must match the packed columns")
    rs, cs = (s // packed.itemsize for s in packed.strides)
    lib.tpuprof_hll_update(packed.ctypes.data, n_rows, n_cols, rs, cs,
                           regs.ctypes.data, regs.shape[1])
    return True


def hash_pack_u64(keys: np.ndarray, valid: Optional[np.ndarray],
                  precision: int) -> Optional[np.ndarray]:
    """Fused splitmix64 + HLL pack of raw 64-bit keys; bit-identical to
    ``hash_u64_array`` then ``kernels.hll.pack``; None without the
    library."""
    _check_pack_precision(precision)
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(keys.shape, dtype=np.uint16)
    keep, vptr = _valid_ptr(valid)
    lib.tpuprof_hash_pack_u64(keys.ctypes.data, vptr, out.ctypes.data,
                              keys.size, precision)
    del keep
    return out


def pack_gather(dict_hashes: np.ndarray, codes: np.ndarray,
                valid: Optional[np.ndarray],
                precision: int) -> Optional[np.ndarray]:
    """Fused gather + HLL pack for dictionary columns (rows with a
    negative, out-of-range or invalid code pack to 0); None without the
    library."""
    _check_pack_precision(precision)
    lib = _load()
    if lib is None:
        return None
    dict_hashes = np.ascontiguousarray(dict_hashes, dtype=np.uint64)
    codes = np.ascontiguousarray(codes, dtype=np.int64)
    out = np.empty(codes.shape, dtype=np.uint16)
    keep, vptr = _valid_ptr(valid)
    lib.tpuprof_pack_gather(dict_hashes.ctypes.data, dict_hashes.size,
                            codes.ctypes.data, vptr, out.ctypes.data,
                            codes.size, precision)
    del keep
    return out


def hash_string_dictionary(arr) -> Optional[np.ndarray]:
    """xxHash64 of every value of an Arrow string array, straight from its
    buffers; None without the library or for a layout it cannot walk."""
    lib = _load()
    if lib is None:
        return None
    import pyarrow as pa
    try:
        arr = arr.cast(pa.large_string())
    except pa.ArrowInvalid:
        return None
    if hasattr(arr, "combine_chunks"):
        arr = arr.combine_chunks()
    buffers = arr.buffers()           # [validity, offsets(int64), data]
    if len(buffers) < 3 or buffers[2] is None:
        return None
    # a sliced array keeps ABSOLUTE offsets into the shared data buffer
    offsets = np.frombuffer(buffers[1], dtype=np.int64,
                            count=len(arr) + 1 + arr.offset)[arr.offset:]
    data = np.frombuffer(buffers[2], dtype=np.uint8)
    out = np.empty(len(arr), dtype=np.uint64)
    lib.tpuprof_hash_bytes(data.ctypes.data, offsets.ctypes.data,
                           out.ctypes.data, len(arr))
    return out


# the buffer walk is value-level, not dictionary-specific: it hashes any
# Arrow string array row by row (null slots hash the empty range; callers
# mask them).  The plain-string row-hash path of ingest uses this name.
hash_string_array = hash_string_dictionary
