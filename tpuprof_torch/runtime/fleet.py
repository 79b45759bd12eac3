"""The elastic fleet: a work-stealing fragment scheduler that survives a
lost member.

Counterpart of ``tpuprof/runtime/fleet.py``, its protocol unchanged.  The
fixed-membership runtime (``runtime/distributed.py``) stripes fragments and
runs gathers that every process must reach, so one dead process stops them
all.  Here membership is a shared **fleet directory** and work is pulled:
members are independent processes (each on the CUDA devices it sees) that
coordinate with atomic file operations on storage all of them see:

* ``manifest.json`` — the fragment count and the source/config
  fingerprint, written once by the first member (a hard link of a complete
  temporary, so it appears with its content) and validated by the rest;
  CRC-sealed, its schema naming this package: a torn manifest, or one the
  reference package wrote, raises :class:`CorruptManifestError`.
* ``claim.<phase>.<k>`` — fragment k is being scanned by the member named
  in the file; a hard link of a fully written temporary is the arbiter
  (exactly one winner, never an empty claim).  A slow member claims fewer
  fragments, a dead one stops claiming.
* ``done.<phase>.<k>`` — the claimant folded every batch of fragment k.
* ``steal.<phase>.<k>.<g>`` — generation g's takeover of a dead member's
  fragment, decided by the same arbiter.  Liveness is a heuristic, so
  correctness does not rest on it: just before contributing, a member
  re-checks it still owns every fragment its part covers; a fragment stolen
  from it fences the whole part (its rows are inside the fold), and the
  fragments it still owns are scanned again from scratch.  The finish
  barrier also checks that the parts' fragment lists are disjoint.
* ``hb.<host>`` — a heartbeat whose mtime a daemon thread refreshes;
  stale (``liveness_timeout_s``) or missing is dead.  The ``host_death``
  fault deletes it on the way out (:meth:`FleetMember.depart`).
* ``part.<phase>.<host>.<seq>`` — a CRC-sealed contribution: finalized,
  mergeable fold state (numpy arrays and host sketches, never a device
  tensor) covering an explicit fragment list.  A fragment counts as
  covered only when a part lists it; a member that died before
  contributing left nothing anyone merged, and its fragments are scanned
  again by a survivor, so the result equals a clean run by the merge laws
  (``runtime/distributed.merge_*_parts``).  Parts unpickle with the
  checkpoint's unpickler, which refuses classes of the reference package.
* ``wire.<host>`` — each member's final metrics wire; the live leader
  merges them into ``<metrics_path>.fleet.prom`` labelled by member id.

A new process simply starts claiming; a restarted one presenting the same
``fleet_host_id`` adopts its predecessor's claims and, with a checkpoint
path, its checkpoint cursor.  Claims marked done after the checkpoint's
last save are replayed, fragments stolen while it was down are not adopted,
and its first contribution a phase supersedes any part the predecessor
left.  Elastic runs join no process group: ``backends/gpu.py`` refuses the
combination.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from tpuprof_torch.errors import CorruptManifestError, InputError
from tpuprof_torch.obs import events
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.runtime.checkpoint import _PortUnpickler, safe_loads

# the reference writes "tpuprof-fleet-manifest-v1": a port member refuses
# such a directory instead of folding the reference's parts
MANIFEST_SCHEMA = "tpuprof_torch-fleet-manifest-v1"
PART_VERSION = 1

_REBALANCES = _obs_metrics.counter(
    "tpuprof_fleet_rebalances_total",
    "dead-host rebalance events (one per steal sweep that took work)")
_STOLEN = _obs_metrics.counter(
    "tpuprof_fragments_stolen_total",
    "fragments taken over from dead fleet members, by phase")
_CLAIMED = _obs_metrics.gauge(
    "tpuprof_fleet_fragments_claimed",
    "fragments this member has claimed from the manifest (by phase)")
_DONE = _obs_metrics.gauge(
    "tpuprof_fleet_fragments_done",
    "claimed fragments this member finished folding (by phase)")


def _canonical(doc: Dict[str, Any]) -> bytes:
    return json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _atomic_write(path: str, data: bytes) -> None:
    # dot-prefixed so an in-flight write can NEVER match the prefix
    # scans (``part.``/``wire.``) — a reader racing the os.replace must
    # see either nothing or the complete file, not torn bytes
    # pid + thread id: two members in ONE process (tests) must not
    # collide on the temp name — a shared temp lets writer A link it
    # away while writer B still needs it
    tmp = os.path.join(
        os.path.dirname(path) or ".",
        f".tmp.{os.path.basename(path)}"
        f".{os.getpid()}.{threading.get_ident()}")
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


def _excl_create(path: str, content: str) -> bool:
    """Atomically create ``path`` with ``content``; False if it already
    exists (someone else won).  Hardlinking a fully-written temp file
    onto the final name is the fleet's only arbiter — no locks, no
    read-modify-write, and (unlike an O_EXCL open followed by a write)
    no window where a concurrent reader observes the file EMPTY: an
    empty claim would read as owned by nobody, i.e. instantly dead,
    and a live host's fresh claim could be wrongly stolen."""
    d = os.path.dirname(path) or "."
    tmp = os.path.join(
        d, f".tmp.{os.path.basename(path)}"
           f".{os.getpid()}.{threading.get_ident()}")
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(content)
        fh.flush()
        os.fsync(fh.fileno())
    try:
        os.link(tmp, path)
        return True
    except FileExistsError:
        return False
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _read_small(path: str) -> Optional[str]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return fh.read().strip()
    except OSError:
        return None


# the reference's public names of the three arbiters (the serve daemon's
# fleet claims, serve/server.py, use them on whole jobs)
atomic_write = _atomic_write
excl_create = _excl_create
read_small = _read_small


def write_part_bytes(payload: Dict[str, Any]) -> bytes:
    """Serialize one contribution part: a header pickle carrying the
    payload CRC32 + length, then the raw payload pickle — the same
    torn-write envelope checkpoints use (runtime/checkpoint.py v5)."""
    body = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    header = pickle.dumps(
        {"part_version": PART_VERSION,
         "payload_crc32": zlib.crc32(body) & 0xFFFFFFFF,
         "payload_len": len(body)},
        protocol=pickle.HIGHEST_PROTOCOL)
    return header + body


def read_part_bytes(raw: bytes, origin: str = "part") -> Dict[str, Any]:
    """Decode + integrity-check a contribution part.  ANY failure —
    truncation at any offset, bit rot, a foreign version — surfaces as
    :class:`CorruptManifestError`: a torn part must never silently
    merge into fleet statistics."""
    try:
        buf = io.BytesIO(raw)
        header = _PortUnpickler(buf).load()
        if not isinstance(header, dict) \
                or header.get("part_version") != PART_VERSION:
            raise CorruptManifestError(
                f"fleet {origin} has unsupported version "
                f"{header.get('part_version') if isinstance(header, dict)
                   else header!r}")
        body = buf.read()
        if len(body) != header.get("payload_len"):
            raise CorruptManifestError(
                f"fleet {origin} payload is {len(body)} bytes, header "
                f"says {header.get('payload_len')} — truncated write")
        if zlib.crc32(body) & 0xFFFFFFFF != header.get("payload_crc32"):
            raise CorruptManifestError(
                f"fleet {origin} payload CRC mismatch — corrupt")
        payload = safe_loads(body)
        if not isinstance(payload, dict):
            raise CorruptManifestError(
                f"fleet {origin} decodes to {type(payload).__name__}, "
                "not a payload dict")
        return payload
    except CorruptManifestError:
        raise
    except Exception as exc:
        raise CorruptManifestError(
            f"fleet {origin} is unreadable "
            f"({type(exc).__name__}: {exc})") from exc


def write_manifest_bytes(doc: Dict[str, Any]) -> bytes:
    body = _canonical(doc)
    return _canonical({"schema": MANIFEST_SCHEMA,
                       "crc32": zlib.crc32(body) & 0xFFFFFFFF}
                      ) + b"\n" + body + b"\n"


def read_manifest_bytes(raw: bytes) -> Dict[str, Any]:
    try:
        head, _, body = raw.partition(b"\n")
        envelope = json.loads(head)
        if envelope.get("schema") != MANIFEST_SCHEMA:
            raise CorruptManifestError(
                f"fleet manifest schema {envelope.get('schema')!r} is "
                f"not {MANIFEST_SCHEMA!r}")
        body = body.rstrip(b"\n")
        if zlib.crc32(body) & 0xFFFFFFFF != envelope.get("crc32"):
            raise CorruptManifestError(
                "fleet manifest CRC mismatch — torn or hand-edited")
        return json.loads(body)
    except CorruptManifestError:
        raise
    except Exception as exc:
        raise CorruptManifestError(
            f"fleet manifest is unreadable "
            f"({type(exc).__name__}: {exc})") from exc


class FleetMember:
    """One process's membership in an elastic fleet.

    Lifecycle::

        member = FleetMember(fleet_dir, host_id, n_fragments, fp)
        while (k := member.claim_next("a")) is not None:
            ... scan fragment k ...
            member.mark_done("a", k)
        parts = member.finish("a", my_payload, my_fragments, steal_scan)
        ... merge parts (runtime/distributed.merge_*_parts) ...
        member.close()

    ``finish`` is the resume-barrier point: it contributes this
    member's part, then waits until EVERY manifest fragment is covered
    by some part — stealing and re-scanning (via ``steal_scan``) any
    fragment whose current owner died uncontributed."""

    def __init__(self, fleet_dir: str, host_id: str, n_fragments: int,
                 fingerprint: str, liveness_timeout_s: float = 10.0,
                 poll_s: Optional[float] = None):
        if "/" in host_id or host_id in ("", ".", ".."):
            raise InputError(
                f"fleet_host_id {host_id!r} must be a plain filename "
                "token (it names heartbeat/claim files)")
        self.dir = fleet_dir
        self.host_id = host_id
        self.n_fragments = int(n_fragments)
        self.liveness_timeout_s = float(liveness_timeout_s)
        self.poll_s = poll_s if poll_s is not None \
            else min(max(self.liveness_timeout_s / 10.0, 0.05), 1.0)
        os.makedirs(self.dir, exist_ok=True)
        self._ensure_manifest(fingerprint)
        self._claimed: Dict[str, Set[int]] = {}
        self._done: Dict[str, Set[int]] = {}
        self._scan_cursor: Dict[str, int] = {}
        self._stolen_total = 0
        # parts are immutable once published and their names are never
        # reused (monotone per-phase seq), so each file is read + CRC-
        # checked + unpickled ONCE — the finish barrier polls coverage
        # every poll_s and would otherwise re-read every part each tick
        self._part_cache: Dict[str, Dict[str, Any]] = {}
        self._next_seq: Dict[str, int] = {}
        self._adopted = self._adopt()
        # heartbeat BEFORE any claim: a claim by a host with no
        # heartbeat file would read as instantly dead
        self._hb_path = self._p(f"hb.{self.host_id}")
        _atomic_write(self._hb_path, b"alive\n")
        self._stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._beat, daemon=True,
            name=f"tpuprof-fleet-hb-{self.host_id}")
        self._hb_thread.start()
        events.emit("fleet_join", host=self.host_id,
                    fragments=self.n_fragments,
                    adopted=sorted(self._adopted))

    # -- paths -------------------------------------------------------------

    def _p(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _claim_path(self, phase: str, k: int) -> str:
        return self._p(f"claim.{phase}.{k}")

    def _done_path(self, phase: str, k: int) -> str:
        return self._p(f"done.{phase}.{k}")

    def _steal_path(self, phase: str, k: int, g: int) -> str:
        return self._p(f"steal.{phase}.{k}.{g}")

    # -- manifest ----------------------------------------------------------

    def _ensure_manifest(self, fingerprint: str) -> None:
        path = self._p("manifest.json")
        doc = {"n_fragments": self.n_fragments,
               "fingerprint": fingerprint}
        if not os.path.exists(path):
            # hardlink a fully-written temp onto the final name: the
            # manifest appears ATOMICALLY with its content (an O_EXCL
            # create + write would let a racing member read a partial
            # manifest and abort with CorruptManifestError); EEXIST =
            # lost the race, the loser validates below
            tmp = self._p(f".tmp.manifest.{self.host_id}")
            _atomic_write(tmp, write_manifest_bytes(doc))
            try:
                os.link(tmp, path)
            except FileExistsError:
                pass
            finally:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        with open(path, "rb") as fh:
            existing = read_manifest_bytes(fh.read())
        if existing != doc:
            raise InputError(
                f"fleet manifest at {path!r} describes "
                f"{existing.get('n_fragments')} fragments of source "
                f"{existing.get('fingerprint')!r}; this member sees "
                f"{self.n_fragments} fragments of {fingerprint!r} — "
                "members must profile the same source with the same "
                "config (point fleet_dir somewhere fresh)")

    def _adopt(self) -> Set[int]:
        """Claims already held by this host id (a previous incarnation
        that died or was restarted) — adopted as ours.  Fragments whose
        CURRENT owner is someone else are excluded: a survivor stole
        them while the predecessor was down, its part covers them, and
        re-contributing them would double-count.  Done markers are
        re-read by the caller against its checkpoint coverage; here we
        only rebuild the ownership view."""
        adopted: Set[int] = set()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return adopted
        for name in names:
            if not (name.startswith("claim.") or name.startswith("steal.")):
                continue
            if _read_small(self._p(name)) != self.host_id:
                continue
            bits = name.split(".")
            phase, k = bits[1], int(bits[2])
            if self._owner(phase, k) != self.host_id:
                continue        # stolen from the predecessor
            self._claimed.setdefault(phase, set()).add(k)
            adopted.add(k)
            if os.path.exists(self._done_path(phase, k)):
                self._done.setdefault(phase, set()).add(k)
        return adopted

    # -- heartbeat / liveness ----------------------------------------------

    def _beat(self) -> None:
        interval = min(max(self.liveness_timeout_s / 4.0, 0.05), 1.0)
        while not self._stop.wait(interval):
            try:
                os.utime(self._hb_path)
            except OSError:
                pass        # a deleted heartbeat means we departed

    def live_hosts(self) -> Set[str]:
        now = time.time()
        live = set()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return live
        for name in names:
            if not name.startswith("hb."):
                continue
            try:
                age = now - os.path.getmtime(self._p(name))
            except OSError:
                continue
            if age <= self.liveness_timeout_s:
                live.add(name[len("hb."):])
        return live

    def is_dead(self, host: Optional[str], live: Set[str]) -> bool:
        """A host with no fresh heartbeat is dead.  ``None`` (a claim
        whose content was torn/unreadable) is treated as dead too —
        nobody can vouch for it."""
        return host is None or host not in live

    def depart(self) -> None:
        """Leave the fleet LOUDLY: delete the heartbeat so survivors
        detect the death immediately instead of waiting out the
        staleness window (the ``host_death`` injection path; a real
        SIGKILL skips this and survivors wait for staleness)."""
        self._stop.set()
        try:
            os.remove(self._hb_path)
        except OSError:
            pass
        events.emit("fleet_depart", host=self.host_id)

    def close(self) -> None:
        self._stop.set()
        if self._hb_thread.is_alive():
            self._hb_thread.join(timeout=2.0)

    # -- work-stealing scheduler -------------------------------------------

    def claim_next(self, phase: str) -> Optional[int]:
        """Pull the next unclaimed fragment off the manifest (ascending
        id — deterministic single-host order, racy-by-design multi-host
        with O_EXCL as the arbiter).  None when every fragment is
        claimed or done."""
        mine = self._claimed.setdefault(phase, set())
        start = self._scan_cursor.get(phase, 0)
        for k in range(start, self.n_fragments):
            if k in mine:
                continue
            if os.path.exists(self._done_path(phase, k)) \
                    or os.path.exists(self._claim_path(phase, k)):
                if k == start:
                    self._scan_cursor[phase] = k + 1
                continue
            if _excl_create(self._claim_path(phase, k), self.host_id):
                mine.add(k)
                _CLAIMED.set(len(mine), phase=phase)
                return k
            # lost the race — somebody else owns k now; keep scanning
        return None

    def mark_done(self, phase: str, k: int) -> None:
        done = self._done.setdefault(phase, set())
        done.add(k)
        _DONE.set(len(done), phase=phase)
        _excl_create(self._done_path(phase, k), self.host_id)

    def undo_done(self, phase: str, ks: Sequence[int]) -> None:
        """Un-mark fragments a restarted member must replay: their done
        markers postdate the adopted checkpoint's last save, so the
        fold state covering them died with the predecessor."""
        done = self._done.setdefault(phase, set())
        for k in ks:
            done.discard(k)
            try:
                os.remove(self._done_path(phase, k))
            except OSError:
                pass

    def claimed(self, phase: str) -> Set[int]:
        return set(self._claimed.get(phase, set()))

    def done(self, phase: str) -> Set[int]:
        return set(self._done.get(phase, set()))

    def _owner_gen(self, phase: str, k: int):
        """(current owner, next steal generation) of fragment k: the
        latest steal generation's thief, else the original claimant."""
        g = 1
        owner = _read_small(self._claim_path(phase, k))
        while os.path.exists(self._steal_path(phase, k, g)):
            owner = _read_small(self._steal_path(phase, k, g))
            g += 1
        return owner, g

    def _owner(self, phase: str, k: int) -> Optional[str]:
        return self._owner_gen(phase, k)[0]

    def _steal(self, phase: str, k: int, gen: Optional[int] = None
               ) -> bool:
        """Take over fragment k at steal generation ``gen`` — the one
        OBSERVED alongside the dead owner, so a racing survivor who
        already took generation g (and is alive, owning the fragment)
        cannot be re-robbed at g+1 by a stale decision; False when
        another survivor won the O_EXCL race."""
        if gen is None:
            gen = self._owner_gen(phase, k)[1]
        if _excl_create(self._steal_path(phase, k, gen), self.host_id):
            self._claimed.setdefault(phase, set()).add(k)
            return True
        return False

    # -- contributions / the finish barrier --------------------------------

    def contribute(self, phase: str, payload: Dict[str, Any],
                   fragments: Sequence[int]) -> str:
        """Persist one CRC-sealed contribution part covering
        ``fragments`` (atomic write — a crash mid-contribute leaves no
        torn part, just an uncovered fragment set for survivors).

        The FIRST contribution of a phase supersedes any part a
        predecessor incarnation (same host id, restarted) left behind:
        this incarnation re-covers at least those fragments, so merging
        both would double-count every row the predecessor folded.  The
        stale parts are deleted BEFORE the new one is published — a
        racing reader sees old coverage or new coverage, never both —
        and seq stays monotone across incarnations so a peer's part
        cache can never alias old bytes onto a reused name."""
        prefix = f"part.{phase}.{self.host_id}."
        if phase not in self._next_seq:
            try:
                names = os.listdir(self.dir)
            except OSError:
                names = []
            stale = [n for n in names
                     if n.startswith(prefix) and ".tmp." not in n
                     and n[len(prefix):].isdigit()]
            self._next_seq[phase] = 1 + max(
                [int(n[len(prefix):]) for n in stale], default=-1)
            for n in stale:
                try:
                    os.remove(self._p(n))
                except OSError:
                    pass
        seq = self._next_seq[phase]
        self._next_seq[phase] = seq + 1
        envelope = dict(payload)
        envelope["fragments"] = sorted(int(k) for k in fragments)
        envelope["host"] = self.host_id
        envelope["seq"] = seq
        path = self._p(f"part.{phase}.{self.host_id}.{seq}")
        _atomic_write(path, write_part_bytes(envelope))
        events.emit("fleet_contribute", host=self.host_id, phase=phase,
                    seq=seq, fragments=len(envelope["fragments"]))
        return path

    def _fenced_away(self, phase: str, k: int) -> bool:
        """True when fragment k's current owner is some OTHER host —
        it was stolen from us by a peer to whom our heartbeat merely
        looked stale (clock skew between hosts, NFS attribute-cache
        lag, a >liveness_timeout_s stall)."""
        owner = self._owner(phase, k)
        return owner is not None and owner != self.host_id

    def _contribute_fenced(self, phase: str, payload: Dict[str, Any],
                           fragments: Sequence[int],
                           rescan: Callable[[List[int]], Dict[str, Any]]
                           ) -> List[int]:
        """Fenced publication: immediately before publishing, re-check
        ownership of every fragment the part claims to cover.  A
        fragment stolen from us taints the WHOLE part — its rows are
        inside the monolithic fold and cannot be subtracted — so the
        payload is discarded and the surviving fragments are re-scanned
        from scratch via ``rescan``.  Loops because a steal can land
        during the re-scan too; terminates because the fragment set
        strictly shrinks every round.  Returns the fragments actually
        contributed."""
        frags = sorted({int(k) for k in fragments})
        while True:
            lost = [k for k in frags if self._fenced_away(phase, k)]
            if not lost:
                self.contribute(phase, payload, frags)
                return frags
                events.emit("fleet_fenced", host=self.host_id, phase=phase,
                        lost=lost)
            self._claimed.setdefault(phase, set()).difference_update(lost)
            self._done.setdefault(phase, set()).difference_update(lost)
            frags = [k for k in frags if k not in set(lost)]
            if not frags:
                return []
            payload = rescan(frags)

    def read_parts(self, phase: str) -> List[Dict[str, Any]]:
        """Every contribution part of ``phase``, sorted by (host, seq)
        — the deterministic merge order every survivor agrees on.  A
        torn part raises :class:`CorruptManifestError` (fleet stats
        must never silently lose a member's rows).  Parsed parts are
        cached by filename: parts are immutable once published and
        names are never reused, so each file pays its read + CRC +
        unpickle once no matter how long the finish barrier polls."""
        parts = []
        prefix = f"part.{phase}."
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            names = []
        for name in names:
            if not name.startswith(prefix) or ".tmp." in name:
                continue
            cached = self._part_cache.get(name)
            if cached is None:
                try:
                    with open(self._p(name), "rb") as fh:
                        raw = fh.read()
                except FileNotFoundError:
                    continue    # superseded between listdir and open
                cached = read_part_bytes(raw, origin=name)
                self._part_cache[name] = cached
            parts.append(cached)
        parts.sort(key=lambda p: (str(p.get("host")), int(p.get("seq", 0))))
        return parts

    @staticmethod
    def _check_disjoint(phase: str, parts: List[Dict[str, Any]]) -> None:
        """Backstop for every steal/fence/supersede race: parts'
        fragment lists must be pairwise disjoint, or the merge would
        double-count the overlap's rows — a protocol violation that
        must surface as a typed error, never as silently wrong stats."""
        owners: Dict[int, str] = {}
        for part in parts:
            label = f"part.{phase}.{part.get('host')}.{part.get('seq')}"
            for k in part.get("fragments", ()):
                if k in owners:
                    raise CorruptManifestError(
                        f"fleet fragment {k} is covered by both "
                        f"{owners[k]} and {label} — overlapping "
                        "contributions would double-count its rows")
                owners[k] = label

    def coverage(self, phase: str) -> Set[int]:
        covered: Set[int] = set()
        for part in self.read_parts(phase):
            covered.update(part.get("fragments", ()))
        return covered

    def finish(self, phase: str, payload: Dict[str, Any],
               fragments: Sequence[int],
               steal_scan: Callable[[List[int]], Dict[str, Any]],
               timeout_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """The elastic resume barrier: contribute this member's part
        (fenced — see :meth:`_contribute_fenced` — and superseding a
        restarted predecessor's parts), then wait until every manifest
        fragment is covered by a contribution, stealing (and re-scanning
        via ``steal_scan``) any fragment whose owner died uncontributed.
        Returns all parts in deterministic merge order, after asserting
        their fragment lists are pairwise disjoint.

        ``steal_scan(frag_ids)`` must scan the fragments from scratch
        into a FRESH finalized part payload — the dead owner's partial
        folds died with it, and replay-from-zero plus the merge laws is
        exactly what makes the survivor's totals equal a clean run."""
        from tpuprof_torch.runtime.guard import Deadline
        self._contribute_fenced(phase, payload, fragments, steal_scan)
        deadline = Deadline(timeout_s, site="fleet_finish",
                            heartbeat=lambda: {
                                "host": self.host_id, "phase": phase,
                                "covered": len(self.coverage(phase)),
                                "fragments": self.n_fragments})
        all_frags = set(range(self.n_fragments))
        while True:
            # ONE directory read per tick: coverage and the returned
            # part list must come from the same snapshot, or a part
            # superseded between two reads could report coverage that
            # the merge then silently misses
            parts = self.read_parts(phase)
            covered: Set[int] = set()
            for part in parts:
                covered.update(part.get("fragments", ()))
            missing = sorted(all_frags - covered)
            if not missing:
                self._check_disjoint(phase, parts)
                return parts
            deadline.check()
            live = self.live_hosts()
            stolen: List[int] = []
            for k in missing:
                # unclaimed fragments (a member died between manifest
                # write and claiming) go through the normal claim path
                if not os.path.exists(self._claim_path(phase, k)):
                    if _excl_create(self._claim_path(phase, k),
                                    self.host_id):
                        self._claimed.setdefault(phase, set()).add(k)
                        stolen.append(k)
                    continue
                owner, gen = self._owner_gen(phase, k)
                if owner == self.host_id:
                    continue        # ours; covered once we contribute
                if self.is_dead(owner, live) \
                        and self._steal(phase, k, gen):
                    stolen.append(k)
            if stolen:
                self._stolen_total += len(stolen)
                _STOLEN.inc(len(stolen), phase=phase)
                _REBALANCES.inc()
                events.emit("fleet_rebalance", host=self.host_id,
                            phase=phase, stolen=stolen)
                self._contribute_fenced(phase, steal_scan(stolen),
                                        stolen, steal_scan)
                continue
            time.sleep(self.poll_s)

    # -- fleet metrics publication -----------------------------------------

    def publish(self, metrics_path: Optional[str],
                reason: str = "collect") -> Optional[str]:
        """The elastic twin of runtime/distributed.publish_fleet: every
        member drops its registry wire into the fleet dir; the LIVE
        leader (lowest live host id) merges the wires into
        ``<metrics_path>.fleet.prom`` with per-host labels.  No
        collective — a dead member simply contributes no wire.  The
        leader first waits, at most ``liveness_timeout_s``, for a wire
        from every member still alive (the reference merges whatever
        wires exist at that instant, so a peer finishing a moment later
        went missing from its dump)."""
        from tpuprof_torch.obs import fleet as obs_fleet
        wire = _obs_metrics.registry().to_wire()
        _atomic_write(self._p(f"wire.{self.host_id}"),
                      write_part_bytes({"wire": wire}))
        live = self.live_hosts()
        if live and min(live) != self.host_id:
            return None
        deadline = time.monotonic() + self.liveness_timeout_s
        while time.monotonic() < deadline and any(
                not os.path.exists(self._p(f"wire.{h}"))
                for h in self.live_hosts()):
            time.sleep(self.poll_s)
        wires: Dict[str, Dict[str, Any]] = {}
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            names = []
        for name in names:
            if not name.startswith("wire.") or ".tmp." in name:
                continue
            try:
                with open(self._p(name), "rb") as fh:
                    wires[name[len("wire."):]] = \
                        read_part_bytes(fh.read(), origin=name)["wire"]
            except (OSError, CorruptManifestError):
                continue    # a torn wire degrades the dump, not the run
        return obs_fleet.write_fleet_labeled(metrics_path, wires,
                                            reason=reason)
