"""mcmc_spec_tpu_torch: the PyTorch/CUDA port of ``mcmc_spec_tpu``.

The package mirrors the JAX package's module paths and function names
(``inference/batched.py`` <-> ``inference/batched.py``), imports ``torch``
and never ``jax``, and replaces each Pallas TPU kernel on the two-stage fit
and the fleet path with a hand-written CUDA C++ kernel for Hopper
(``csrc/``, bound through ``ops/cuda_kernels.py``).  Its entry points put
targets on the card unless the caller asks for the CPU.  On CPU tensors every kernel wrapper runs its
plain PyTorch version; on CUDA tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"
