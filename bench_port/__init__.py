"""The benchmark of bayesian_optimization_tpu_torch on one NVIDIA H100 (see README.md)."""
