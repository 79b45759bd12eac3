"""Checker modules of the port's lint (counterpart of
``tpuprof/analysis/checkers``) — importing this package registers every checker
(the ``@checker`` decorators run at import).  Import order IS report
order (the registry is insertion-ordered); keep it the ANALYSIS.md
catalogue order."""

from tpuprof_torch.analysis.checkers import durability      # noqa: F401
from tpuprof_torch.analysis.checkers import config_surface  # noqa: F401
from tpuprof_torch.analysis.checkers import obs_contract    # noqa: F401
from tpuprof_torch.analysis.checkers import taxonomy        # noqa: F401
from tpuprof_torch.analysis.checkers import discipline      # noqa: F401
