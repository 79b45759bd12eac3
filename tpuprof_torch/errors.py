"""Errors the port raises (counterpart of the subset of ``tpuprof/errors.py``
that this package uses) and the CLI's exit code for each.

``CorruptCheckpointError`` is what a torn, foreign or garbage checkpoint
raises (``runtime/checkpoint.py``).  The ingest guard (``runtime/guard.py``)
adds three, each under the base
class its call sites raised before, so existing ``except`` clauses hold:
``TransientError`` (``OSError``, the retryable class), ``PoisonBatchError``
(a batch failed past the retry and quarantine budgets; carries the
quarantine manifest) and ``WatchdogTimeout`` (a watched blocking call
overran its deadline; carries the site and a heartbeat snapshot).
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
               (WatchdogTimeout, 4), (PoisonBatchError, 5), (InputError, 2))


def exit_code(exc: BaseException) -> int:
    """The CLI's exit code for a typed error (1 for anything else)."""
    for cls, code in _EXIT_CODES:
        if isinstance(exc, cls):
            return code
    return 1
