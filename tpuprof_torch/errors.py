"""Errors the port raises (counterpart of ``tpuprof/errors.py``) and the
CLI's exit code for each.

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
deadline passed before a worker reached it).  The HTTP edge and the
warehouse add ``ServeUnavailableError`` (the edge cannot be reached; exit
9), ``WarehouseUnavailableError`` (pyarrow cannot be imported; exit 10)
and ``CorruptWarehouseError`` (a columnar stats file failed its integrity
check; exit 6).  The ``lint`` verb adds ``LintFindingsError`` (unsuppressed
invariant findings; an ``InputError``, exit 2).  ``TYPED_ERRORS`` is the
reference's taxonomy of expected failure shapes, every class of it.
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


class CorruptWarehouseError(CorruptArtifactError):
    """A columnar stats file (``tpuprof-stats-parquet-v1`` —
    ``warehouse/columnar.py``) failed its integrity check: truncated or
    undecodable Parquet bytes, or a missing or foreign schema id in the
    file metadata.  Never a raw ``pyarrow.lib.ArrowInvalid``; history
    queries walk past a corrupt generation.  Shares exit code 6."""


class ServeUnavailableError(OSError):
    """The serve daemon's HTTP edge could not be reached (connection
    refused, DNS failure, socket timeout on ``submit --url``).  The request
    never entered any queue — safe to retry against the same or another
    edge; the CLI maps it to exit code 9."""


class WarehouseUnavailableError(RuntimeError):
    """A columnar-warehouse operation needs pyarrow and this environment
    cannot import it.  Nothing was written, and the JSON artifact path is
    unaffected; the CLI maps it to exit code 10."""


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


class LintFindingsError(InputError):
    """``lint`` found unsuppressed invariant violations
    (``tpuprof_torch/analysis``; ANALYSIS.md).  Subclasses
    :class:`InputError` and shares its exit code 2 — "the tree you asked
    us to bless is not blessable" is an input problem — so CI gates on
    exit 2 without a new branch."""


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
                HostDeathError, ServeUnavailableError, LintFindingsError,
                WarehouseUnavailableError, DeadlineExceededError)

# the reference's codes (``tpuprof/errors.py`` ``_EXIT_CODES``); the most
# specific class first (``LintFindingsError`` takes ``InputError``'s 2)
_EXIT_CODES = ((CorruptCheckpointError, 3), (CorruptArtifactError, 6),
               (CorruptManifestError, 7), (DeadlineExceededError, 11),
               (WatchdogTimeout, 4), (PoisonBatchError, 5),
               (HostDeathError, 8), (ServeUnavailableError, 9),
               (WarehouseUnavailableError, 10), (InputError, 2))


def exit_code(exc: BaseException) -> int:
    """The CLI's exit code for a typed error (1 for anything else)."""
    for cls, code in _EXIT_CODES:
        if isinstance(exc, cls):
            return code
    return 1
