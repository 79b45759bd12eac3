"""Checkpoints of a profile's fold state: atomic, CRC-checked, rotated.

Counterpart of ``tpuprof/runtime/checkpoint.py``, format v5: a header
pickle first, holding the CRC32 and length of the payload, then the raw
payload bytes.  The payload is a pickled dict ``{"arrays_npz", "host_blob",
"cursor", "meta"}``: the device state as one ``.npz`` archive (leaves
flattened to ``/``-joined key paths, through
``runner.state_to_numpy`` / ``state_from_numpy``) and the host
aggregators pickled as they are.

* **atomic** — the payload goes to a dot-prefixed temporary file, is
  flushed and fsynced, then renamed over ``path``; a save that raises
  unlinks the temporary file.
* **integrity** — the CRC and length are checked before the payload is
  unpickled, so a torn or junk file of any length raises
  :class:`~tpuprof_torch.errors.CorruptCheckpointError`, never ``EOFError``
  or ``UnpicklingError``.
* **provenance** — the header names the writing package, ``"tpuprof_torch"``.
  A header without it (what the reference writes) is refused before the
  payload is read: the reference's payload pickles ``tpuprof`` classes,
  and unpickling it would import the JAX package.  Both pickles also load
  through an unpickler that refuses any ``tpuprof`` or ``jax`` module.
* **retention** — ``save(..., keep=N)`` rotates the previous file to
  ``path.1``, ``path.2``, ... (N generations in all), and
  :func:`restore_payload` walks them newest first past corrupt ones.
"""

from __future__ import annotations

import io
import os
import pickle
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from tpuprof_torch.errors import CorruptCheckpointError
from tpuprof_torch.testing import faults

FORMAT_VERSION = 5
PACKAGE = "tpuprof_torch"

# modules a payload of this package never names: loading one would import
# the reference package (and with it JAX)
_FOREIGN = ("tpuprof", "jax", "jaxlib")


class _PortUnpickler(pickle.Unpickler):
    """Refuses classes of the reference package and of JAX."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not a class of {PACKAGE}")
        return super().find_class(module, name)


def safe_loads(data: bytes) -> Any:
    """``pickle.loads`` that never imports the reference package or JAX."""
    return _PortUnpickler(io.BytesIO(data)).load()


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays as ``{"a/b": array}``."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten(template: Any, flat: Dict[str, np.ndarray],
              prefix: str = "") -> Any:
    """``flat`` in the shape of ``template`` (nested dicts of arrays or
    tensors); a missing leaf or one of another shape raises
    ``ValueError``."""
    out = {}
    for key, value in template.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out[key] = unflatten(value, flat, path + "/")
            continue
        if path not in flat:
            raise ValueError(f"checkpoint lacks the state leaf {path!r} — "
                             "config/schema mismatch")
        arr = flat[path]
        if tuple(arr.shape) != tuple(value.shape):
            raise ValueError(
                f"checkpoint leaf {path!r} has shape {tuple(arr.shape)}, "
                f"expected {tuple(value.shape)} — config/schema mismatch")
        out[key] = arr
    return out


def payload_header(payload_bytes: bytes) -> Dict[str, Any]:
    """The v5 header of a serialized payload, naming this package."""
    return {"format_version": FORMAT_VERSION, "package": PACKAGE,
            "payload_crc32": zlib.crc32(payload_bytes) & 0xFFFFFFFF,
            "payload_len": len(payload_bytes)}


def _rotate(path: str, keep: int) -> None:
    """``path`` -> ``path.1`` -> ... keeping ``keep`` generations."""
    if keep <= 1 or not os.path.exists(path):
        return
    for i in range(keep - 1, 1, -1):
        src = f"{path}.{i - 1}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i}")
    os.replace(path, path + ".1")


def candidate_paths(path: str) -> Iterator[str]:
    """The retention chain, newest first, to the first missing slot."""
    yield path
    i = 1
    while os.path.exists(f"{path}.{i}"):
        yield f"{path}.{i}"
        i += 1


def _tmp_path(path: str) -> str:
    return os.path.join(os.path.dirname(path) or ".",
                        f".{os.path.basename(path)}.tmp")


def clear(path: str) -> None:
    """Remove a checkpoint chain (head, rotations, a stray temporary)."""
    for cand in list(candidate_paths(path)) + [_tmp_path(path)]:
        try:
            os.remove(cand)
        except OSError:
            pass


def encode_state(state: Optional[Dict[str, Any]]) -> bytes:
    """The device state (nested dicts of tensors or arrays) as ``.npz``
    bytes; ``None`` is an empty archive."""
    from tpuprof_torch.runtime.runner import state_to_numpy
    buf = io.BytesIO()
    np.savez(buf, **(flatten(state_to_numpy(state))
                     if state is not None else {}))
    return buf.getvalue()


def save(path: str, state: Optional[Dict[str, Any]], host_blob: Any,
         cursor: int, meta: Dict[str, Any], keep: int = 1) -> int:
    """Write one atomic, fsynced, CRC-stamped checkpoint, rotating the
    previous ``keep - 1`` generations.  Returns its size in bytes."""
    payload = {"arrays_npz": encode_state(state), "host_blob": host_blob,
               "cursor": int(cursor), "meta": meta}
    payload_bytes = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    tmp = _tmp_path(path)
    try:
        with open(tmp, "wb") as fh:
            faults.hit("checkpoint_write", key=int(cursor))
            pickle.dump(payload_header(payload_bytes), fh,
                        protocol=pickle.HIGHEST_PROTOCOL)
            fh.write(faults.mangle("checkpoint_write", payload_bytes))
            # data on disk before the rename: a crash after an early
            # rename would leave a torn head that looks good
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _rotate(path, keep)
    os.replace(tmp, path)
    return os.path.getsize(path)


def load_payload(path: str) -> Dict[str, Any]:
    """Read one checkpoint and check its version, package, length and CRC
    before unpickling its payload.  Every failure but a missing file
    raises :class:`CorruptCheckpointError`."""
    try:
        with open(path, "rb") as fh:
            header = _PortUnpickler(fh).load()
            if not isinstance(header, dict):
                raise CorruptCheckpointError(
                    f"checkpoint {path!r} has no header")
            version = header.get("format_version")
            if version != FORMAT_VERSION:
                raise CorruptCheckpointError(
                    f"unsupported checkpoint format {version} in {path!r} "
                    f"(this build reads v{FORMAT_VERSION})")
            if header.get("package") != PACKAGE:
                raise CorruptCheckpointError(
                    f"checkpoint {path!r} was written by "
                    f"{header.get('package') or 'another package'}, not "
                    f"{PACKAGE}; its payload is not read (it would name "
                    "that package's classes)")
            crc = header.get("payload_crc32")
            length = header.get("payload_len")
            if crc is None or length is None:
                raise CorruptCheckpointError(
                    f"checkpoint {path!r} header lacks integrity fields "
                    "(payload_crc32/payload_len) — torn or hand-edited")
            payload_bytes = fh.read()
        if len(payload_bytes) != length:
            raise CorruptCheckpointError(
                f"checkpoint {path!r} payload is {len(payload_bytes)} "
                f"bytes, header says {length} — truncated write")
        if zlib.crc32(payload_bytes) & 0xFFFFFFFF != crc:
            raise CorruptCheckpointError(
                f"checkpoint {path!r} payload CRC mismatch — corrupt")
        payload = safe_loads(payload_bytes)
        if not isinstance(payload, dict):
            raise CorruptCheckpointError(
                f"checkpoint {path!r} payload decodes to "
                f"{type(payload).__name__}, not a payload dict")
    except (CorruptCheckpointError, FileNotFoundError):
        raise
    except Exception as exc:
        # EOFError, UnpicklingError, a refused class, OSError mid-read:
        # to a caller all say the same, this file cannot be trusted
        raise CorruptCheckpointError(
            f"checkpoint {path!r} is unreadable "
            f"({type(exc).__name__}: {exc})") from exc
    return payload


def materialize(payload: Dict[str, Any], template: Dict[str, Any],
                device) -> Dict[str, Any]:
    """The device state of a payload, checked against the shapes of
    ``template`` (a state of the runner that resumes) and placed on
    ``device``.  ``template`` may be ``{"a": pass-A state, "hist":
    histogram state}`` for a single-pass scan."""
    from tpuprof_torch.runtime.runner import state_from_numpy
    try:
        with np.load(io.BytesIO(payload["arrays_npz"])) as npz:
            flat = {k: npz[k] for k in npz.files}
    except Exception as exc:      # BadZipFile, KeyError, OSError ...
        raise CorruptCheckpointError(
            f"checkpoint device-state archive is unreadable "
            f"({type(exc).__name__}: {exc})") from exc
    tree = unflatten(template, flat)
    if "a" in tree and "hist" in tree:
        return {"a": state_from_numpy(tree["a"], device),
                "hist": state_from_numpy(tree["hist"], device)}
    return state_from_numpy(tree, device)


def restore_payload(path: str) -> Tuple[Dict[str, Any], str]:
    """``(payload, used_path)`` of the newest generation of the chain at
    ``path`` that passes its checks (a deleted head whose rotations
    survive is walked past too); raises :class:`CorruptCheckpointError`
    only when none does."""
    last: Optional[Exception] = None
    tried = 0
    for cand in candidate_paths(path):
        tried += 1
        try:
            return load_payload(cand), cand
        except (CorruptCheckpointError, OSError) as exc:
            last = exc
    raise CorruptCheckpointError(
        f"no readable checkpoint at {path!r} ({tried} generation(s) "
        f"tried; newest failure: {last})") from last
