"""The profile warehouse of the port: profile artifacts as a queryable
time series.

Counterpart of ``tpuprof/warehouse``, with its file format, layout and
answer documents, so each package reads the generations the other wrote:

* warehouse/columnar.py  — ``tpuprof-stats-parquet-v1``: one row per
                           profiled column per generation, stats as typed
                           Parquet columns, histogram sketches as list
                           columns, schema/CRC provenance in the file
                           metadata; reads prune to the columns asked for.
* warehouse/store.py     — the append-only per-source generation
                           directory (``<warehouse_dir>/<source-key>/
                           gen_<n>.stats.parquet``) the watch loop feeds
                           and ``profile --artifact --warehouse-dir``
                           writes alongside.
* warehouse/history.py   — ``history SOURCE --stat mean --col price`` /
                           ``--trend``: stat series and PSI/KS over time
                           from the columnar chain, corrupt generations
                           walked past; also ``GET /v1/history/<key>``
                           off the HTTP edge.
* warehouse/backtest.py  — ``backtest SOURCE --psi-threshold X``: replay
                           changed alert bands against the retained JSON
                           chain with the live watch loop's own rules.

pyarrow is imported lazily (``columnar.import_pyarrow``): an environment
without it gets the typed
:class:`~tpuprof_torch.errors.WarehouseUnavailableError` (CLI exit code 10)
and the JSON artifact path is unaffected.  Nothing here touches the card.
"""

from tpuprof_torch.warehouse.backtest import (BACKTEST_SCHEMA, backtest,
                                        chain_dir)
from tpuprof_torch.warehouse.columnar import (STATS_PARQUET_SCHEMA, Generation,
                                        import_pyarrow,
                                        read_stats_parquet,
                                        write_stats_parquet)
from tpuprof_torch.warehouse.history import (HISTORY_SCHEMA, query_stat,
                                       query_trend)
from tpuprof_torch.warehouse.store import (append_artifact, append_generation,
                                     chain, generation_path, source_dir)

__all__ = [
    "BACKTEST_SCHEMA", "Generation", "HISTORY_SCHEMA",
    "STATS_PARQUET_SCHEMA", "append_artifact", "append_generation",
    "backtest", "chain", "chain_dir", "generation_path",
    "import_pyarrow", "query_stat", "query_trend", "read_stats_parquet",
    "source_dir", "write_stats_parquet",
]
