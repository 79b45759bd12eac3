"""Errors the port raises (counterpart of the subset of ``tpuprof/errors.py``
that this package uses) and the CLI's exit code for each."""


class InputError(ValueError):
    """The source or the configuration cannot be profiled as given."""


class CorruptArtifactError(ValueError):
    """A ``tpuprof-stats-v1`` artifact failed an integrity check (truncated,
    bit-flipped, foreign schema): never a raw decode error."""


# the reference's codes (``tpuprof/errors.py`` ``_EXIT_CODES``) for the
# classes the port has
_EXIT_CODES = ((CorruptArtifactError, 6), (InputError, 2))


def exit_code(exc: BaseException) -> int:
    """The CLI's exit code for a typed error (1 for anything else)."""
    for cls, code in _EXIT_CODES:
        if isinstance(exc, cls):
            return code
    return 1
