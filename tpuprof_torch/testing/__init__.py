"""Test harness of the port: deterministic fault injection (``faults.py``)."""
