"""``python -m tpuprof_torch`` — the port's command line (``cli.py``)."""

import sys

from tpuprof_torch.cli import main

sys.exit(main())
