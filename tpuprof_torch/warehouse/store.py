"""The append-only per-source warehouse directory.

Counterpart of ``tpuprof/warehouse/store.py``.  Layout under a warehouse
root::

    <warehouse_dir>/<source-key>/gen_<n>.stats.parquet

where ``<source-key>`` is the watch layer's stable per-source name
(serve/watch.source_key — basename + short path hash, the reference's key
for the same path), so a watch spool's warehouse and its retained JSON
chains key identically and ``history SOURCE`` resolves the directory the
watch loop fed.

The directory is APPEND-ONLY: the JSON artifact chain rotates at
``artifact_keep`` generations, but one columnar row-set per generation is
cheap, so the warehouse keeps the whole history.

Generation numbers are assigned by the writer (the watch loop passes its
cycle counter; one-shot ``--artifact`` writes take max+1), padded to 8
digits so lexical order is numeric order.  Scans filter through
:data:`GEN_RE`, so a dot-prefixed in-flight temp is never read.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

from tpuprof_torch.warehouse import columnar

GEN_RE = re.compile(r"gen_(\d{8})\.stats\.parquet$")


def source_dir(warehouse_dir: str, source: Any) -> str:
    """The per-source directory for ``source``: an existing directory
    whose basename already IS a warehouse key (or that directly holds
    ``gen_*`` files) is used as-is, else the watch-layer key of the
    source path is appended to the root."""
    from tpuprof_torch.serve.watch import source_key
    text = str(source)
    if os.path.isdir(text) and _has_generations(text):
        return text
    candidate = os.path.join(warehouse_dir, text)
    if os.path.isdir(candidate) and _has_generations(candidate):
        return candidate
    return os.path.join(warehouse_dir, source_key(source))


def _has_generations(path: str) -> bool:
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return any(GEN_RE.match(n) for n in names)


def chain(dirpath: str) -> List[Tuple[int, str]]:
    """Retained ``(generation, path)`` files, OLDEST first (history is
    a time series; the watch chain walks newest-first because it wants
    a baseline, not a series)."""
    out = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    for name in names:
        m = GEN_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(dirpath, name)))
    return sorted(out)


def generation_path(dirpath: str, generation: int) -> str:
    return os.path.join(dirpath, f"gen_{generation:08d}.stats.parquet")


def append_generation(warehouse_dir: str, source: Any,
                      stats_json: Dict[str, Any],
                      sketches: Optional[Dict[str, Any]] = None, *,
                      generation: Optional[int] = None,
                      rows: Optional[int] = None,
                      config_fingerprint: Optional[str] = None,
                      artifact_crc32: Optional[int] = None,
                      created_unix: Optional[float] = None) -> str:
    """Append one generation for ``source`` and return its path.  With
    no explicit ``generation`` the next number after the newest on disk
    is taken (the one-shot ``--artifact`` path); the watch loop passes
    its cycle counter so warehouse generations and watch cycles share a
    number line."""
    columnar.import_pyarrow()       # gate BEFORE any filesystem effect:
                                    # a pyarrow-less box must not even
                                    # litter an empty per-source dir
    d = os.path.join(warehouse_dir,
                     _key(source))
    os.makedirs(d, exist_ok=True)
    if generation is None:
        existing = chain(d)
        generation = (existing[-1][0] + 1) if existing else 1
    path = generation_path(d, int(generation))
    columnar.write_stats_parquet(
        path, stats_json, sketches, source=str(source),
        generation=int(generation), rows=rows,
        config_fingerprint=config_fingerprint,
        artifact_crc32=artifact_crc32, created_unix=created_unix)
    return path


def append_artifact(warehouse_dir: str, artifact, *,
                    source: Any = None,
                    generation: Optional[int] = None) -> str:
    """Append a generation derived from an already-read JSON artifact
    (the watch cycle path: the artifact was just validated + admitted
    to the chain, so its sections are trusted).  ``artifact.crc32`` —
    the verified integrity envelope — becomes the file's provenance
    token."""
    cfg = (artifact.meta.get("config") or {})
    return append_generation(
        warehouse_dir,
        source if source is not None
        else artifact.meta.get("source") or artifact.path,
        artifact.stats, artifact.sketches, generation=generation,
        rows=artifact.rows,
        config_fingerprint=cfg.get("fingerprint"),
        artifact_crc32=artifact.crc32,
        created_unix=artifact.meta.get("created_unix"))


def _key(source: Any) -> str:
    from tpuprof_torch.serve.watch import source_key
    return source_key(source)
