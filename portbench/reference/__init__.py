"""The plain reference that decides a run's ``correct``: imports nothing of
tpuprof or tpuprof_torch."""
