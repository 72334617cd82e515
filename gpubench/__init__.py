"""The benchmark of mcmc_spec_tpu_torch on an NVIDIA H100 (README.md)."""
