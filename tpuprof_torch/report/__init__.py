"""Report layer of the port: the stats dict's machine-readable export
(``export.py``) and its HTML report (``render.py``, ``svg.py``,
``formatters.py`` and ``templates/``, copies of ``tpuprof/report``)."""
