"""portbench: the benchmark of tpuprof_torch on an NVIDIA H100 (see
README.md).  Nothing here imports jax or the JAX package tpuprof."""
