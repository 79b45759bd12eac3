"""Errors the port raises (counterpart of the subset of ``tpuprof/errors.py``
that this package uses) and the CLI's exit code for each.

``CorruptCheckpointError`` is what a torn, foreign or garbage checkpoint
raises (``runtime/checkpoint.py``).  The ingest guard (``runtime/guard.py``)
adds three, each under the base
class its call sites raised before, so existing ``except`` clauses hold:
``TransientError`` (``OSError``, the retryable class), ``PoisonBatchError``
(a batch failed past the retry and quarantine budgets; carries the
quarantine manifest) and ``WatchdogTimeout`` (a watched blocking call
overran its deadline; carries the site and a heartbeat snapshot).  The
multi-GPU slice adds ``CorruptManifestError`` (a fleet directory's manifest,
claim or contribution part failed its integrity check, or another package
wrote it) and ``HostDeathError`` (the injected ``host_death`` fault).  The
serve daemon adds ``CorruptResultError`` (a spool result file that does not
parse), ``CorruptAotCacheError`` (an entry of the store of built kernel
libraries failed its integrity check), ``CorruptReadCacheError`` (a cached
answer failed its CRC) and ``DeadlineExceededError`` (a queued job's client
deadline passed before a worker reached it).  ``TYPED_ERRORS`` is the
reference's taxonomy of expected failure shapes, as far as the port has
them.
"""

from typing import Any, Dict, List, Optional


class InputError(ValueError):
    """The source or the configuration cannot be profiled as given."""


class TransientError(OSError):
    """An error worth retrying: the operation is idempotent and the failure
    (an I/O hiccup, an injected fault) is expected to clear."""


class CorruptCheckpointError(ValueError):
    """A checkpoint failed an integrity check (CRC32, truncation, format
    version, a payload another package wrote, an undecodable payload):
    never a raw ``EOFError`` or ``UnpicklingError``."""


class CorruptArtifactError(ValueError):
    """A ``tpuprof-stats-v1`` artifact failed an integrity check (truncated,
    bit-flipped, foreign schema): never a raw decode error."""


class CorruptResultError(CorruptArtifactError):
    """A serve result file (``serve/server.py``) exists but does not parse:
    torn by a crash on a non-atomic filesystem, or rotted on disk.  Never a
    raw ``json.JSONDecodeError``; shares exit code 6."""


class CorruptAotCacheError(CorruptArtifactError):
    """An entry of the store of built kernel libraries
    (``runtime/aot.py``) failed its integrity check: truncated or
    bit-flipped envelope bytes, a CRC or length mismatch, or a fingerprint
    or key inside that disagrees with the entry's digest-addressed name.
    The acquire seam demotes it loudly to an nvcc build; shares exit
    code 6."""


class CorruptReadCacheError(CorruptArtifactError):
    """A cached answer of the read tier (``serve/cache.ResultCache``) no
    longer matches the CRC recorded when it was stored.  The cache drops it
    and reports a miss; shares exit code 6."""


class PoisonBatchError(RuntimeError):
    """A batch failed permanently and no quarantine budget remains."""

    def __init__(self, message: str,
                 manifest: Optional[List[Dict[str, Any]]] = None):
        super().__init__(message)
        self.manifest = list(manifest or [])


class CorruptManifestError(ValueError):
    """A fleet-directory artifact (the fragment manifest, a claim, a
    contribution part; ``runtime/fleet.py``) failed its integrity check:
    truncated or undecodable bytes, a CRC32 mismatch, or a schema this
    package cannot trust (the reference's manifest among them).  Never a
    raw ``EOFError`` or ``UnpicklingError``."""


class HostDeathError(RuntimeError):
    """This process's part in the fleet was killed by the ``host_death``
    fault site.  Carries the call number at death."""

    def __init__(self, site: str, at_call: int):
        super().__init__(
            f"injected host death at {site!r} (call {at_call}) — this "
            "process stops participating in the fleet")
        self.site = site
        self.at_call = at_call


class WatchdogTimeout(TimeoutError):
    """A watched blocking call overran its deadline."""

    def __init__(self, site: str, timeout_s: float,
                 heartbeat: Optional[Dict[str, Any]] = None):
        super().__init__(
            f"watchdog: {site!r} exceeded {timeout_s:g}s"
            + (f" (heartbeat: {heartbeat})" if heartbeat else ""))
        self.site = site
        self.timeout_s = timeout_s
        self.heartbeat = heartbeat


class DeadlineExceededError(TimeoutError):
    """A serve job's client deadline passed before the job started
    (``serve/scheduler.py``): the job is never run.  Carries how late it
    was when it reached the front of the queue."""

    def __init__(self, job_id: str, late_by_s: float):
        super().__init__(
            f"deadline exceeded: job {job_id!r} reached the front of "
            f"the queue {late_by_s:.3f}s past its client deadline — "
            "not started")
        self.job_id = job_id
        self.late_by_s = late_by_s


# the expected failure shapes: one line and an exit code, no traceback
TYPED_ERRORS = (InputError, CorruptCheckpointError, CorruptArtifactError,
                CorruptManifestError, PoisonBatchError, WatchdogTimeout,
                HostDeathError, DeadlineExceededError)

# the reference's codes (``tpuprof/errors.py`` ``_EXIT_CODES``) for the
# classes the port has; the most specific class first
_EXIT_CODES = ((CorruptCheckpointError, 3), (CorruptArtifactError, 6),
               (CorruptManifestError, 7), (DeadlineExceededError, 11),
               (WatchdogTimeout, 4), (PoisonBatchError, 5),
               (HostDeathError, 8), (InputError, 2))


def exit_code(exc: BaseException) -> int:
    """The CLI's exit code for a typed error (1 for anything else)."""
    for cls, code in _EXIT_CODES:
        if isinstance(exc, cls):
            return code
    return 1
