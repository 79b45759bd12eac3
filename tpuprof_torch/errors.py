"""Errors the port raises (counterpart of the subset of ``tpuprof/errors.py``
that this package uses)."""


class InputError(ValueError):
    """The source or the configuration cannot be profiled as given."""


class CorruptArtifactError(ValueError):
    """A ``tpuprof-stats-v1`` artifact failed an integrity check (truncated,
    bit-flipped, foreign schema): never a raw decode error."""
