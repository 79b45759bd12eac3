"""Tracing helpers of the port (``trace.py``)."""
