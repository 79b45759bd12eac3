"""Profile-as-a-service of the port: one resident process per host holds
the card, the warm runners and the loaded kernel libraries, so the process
start, the ``torch`` import, the CUDA context and the nvcc builds are paid
once and repeat profiles answer warm.

Counterpart of ``tpuprof/serve``:

* serve/cache.py      keyed runner cache (the fields that decide what a
                      runner launches) + the read tier's ResultCache
                      (answers keyed by source/config fingerprints,
                      CRC-checked, LRU-bounded)
* serve/jobs.py       job state machine + bounded multi-tenant queue
* serve/scheduler.py  worker pool, SLO metrics, job lifecycle, per-job
                      watchdog (job_timeout_s)
* serve/server.py     spool-directory daemon + submit client transport,
                      plus the fleet claim path (N daemons, one spool:
                      atomic job claims, heartbeats, stale-claim steal)
* serve/http.py       the network edge: a selector-based HTTP server on
                      the same scheduler (POST /v1/jobs, results with
                      ETag/304, POST /v1/query pushdown, metrics, watch
                      alert feeds, warehouse history; bearer token ->
                      tenant) + the ``submit --url`` client
* serve/breaker.py    the circuit breaker on the query's warehouse tier
* serve/watch.py      continuous drift watch: scheduled re-profiles,
                      artifact retention, alerts, crash-safe manifests

The store of built kernel libraries that makes a restart warm is
``runtime/aot.py``.  The CLI (``python -m tpuprof_torch serve`` /
``submit``) is one client of this package; embed
:class:`ProfileScheduler` directly for in-process use.
"""

from tpuprof_torch.serve.cache import (ResultCache, RunnerCache,
                                       acquire_runner, cache_stats,
                                       canonical_body, etag_for,
                                       process_cache, runner_key,
                                       source_fingerprint)
from tpuprof_torch.serve.jobs import (BacklogFull, Job, JobQueue,
                                      QueueClosed, QueueFull,
                                      TenantQuotaExceeded)
from tpuprof_torch.serve.scheduler import ProfileScheduler
from tpuprof_torch.serve.http import (HttpEdge, discover_edges,
                                      load_auth_file, submit_job,
                                      wait_result_http)
from tpuprof_torch.serve.server import (JOB_SCHEMA, RESULT_SCHEMA,
                                        ServeDaemon, poll_intervals,
                                        read_result, wait_result, write_job)
from tpuprof_torch.serve.watch import (DriftWatcher, SourceWatch,
                                       WATCH_MANIFEST_SCHEMA, read_manifest,
                                       write_manifest)

__all__ = [
    "BacklogFull", "DriftWatcher", "HttpEdge", "JOB_SCHEMA", "Job",
    "JobQueue", "ProfileScheduler", "QueueClosed", "QueueFull",
    "RESULT_SCHEMA", "ResultCache", "RunnerCache", "ServeDaemon",
    "SourceWatch", "TenantQuotaExceeded", "WATCH_MANIFEST_SCHEMA",
    "acquire_runner", "cache_stats", "canonical_body", "discover_edges",
    "etag_for", "load_auth_file", "poll_intervals", "process_cache",
    "read_manifest", "read_result", "runner_key", "source_fingerprint",
    "submit_job", "wait_result", "wait_result_http", "write_job",
    "write_manifest",
]
