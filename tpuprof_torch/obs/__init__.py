"""Observability of the port: phase spans (``spans.py``)."""
