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
wrote it) and ``HostDeathError`` (the injected ``host_death`` fault).
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


# the reference's codes (``tpuprof/errors.py`` ``_EXIT_CODES``) for the
# classes the port has
_EXIT_CODES = ((CorruptCheckpointError, 3), (CorruptArtifactError, 6),
               (CorruptManifestError, 7), (WatchdogTimeout, 4),
               (PoisonBatchError, 5), (HostDeathError, 8), (InputError, 2))


def exit_code(exc: BaseException) -> int:
    """The CLI's exit code for a typed error (1 for anything else)."""
    for cls, code in _EXIT_CODES:
        if isinstance(exc, cls):
            return code
    return 1
