"""One reader a metric, found by the metric's name in BENCHMARK.json.

``portbench/metrics/<name>.py`` defines ``read(ctx)``, which returns the
metric's value from the run's context (see ``portbench/run.py``), or
``None`` when it finds nothing to read; the harness then leaves the metric
out of the result's line.
"""
