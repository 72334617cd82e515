"""Pack-time accuracy dials and the fused-eval switch (env-overridable), as in
``mcmc_spec_tpu.utils.flags``.

Each dial is resolved ONCE, when a target is packed (``inference.target``),
and stamped on the ``PackedTarget``; the kernels never read the environment.
``MCMC_SPEC_FUSED_EVAL`` is read per evaluation, single-target and fleet, as
in JAX.  ``MCMC_SPEC_COMPILE_CACHE`` chooses the kernels' build directory
(``enable_persistent_compile_cache``).  The env names and defaults are the JAX
package's.
"""
from __future__ import annotations

import os


def median_iters() -> int:
    """Radix-median pass count (``MCMC_SPEC_FAST_MEDIAN``): default 14, 31 = exact.

    ``exact`` -> 31 (``np.median``-identical), ``1`` -> 20 (legacy alias),
    any integer in [8, 31] selects that pass count.  Below 31 the kernels
    return the midpoint of the remaining rank-search bracket.  The annealer's
    median-only scoring always uses 31 regardless of this dial
    (``inference.batched.optimizer_chi2_batch``).
    """
    raw = os.environ.get("MCMC_SPEC_FAST_MEDIAN", "")
    if not raw:
        return 14
    if raw.lower() == "exact":
        return 31
    n = int(raw)
    if n == 1:
        return 20
    if not 8 <= n <= 31:
        raise ValueError(f"MCMC_SPEC_FAST_MEDIAN={raw!r}: use 'exact', 1, or 8..31")
    return n


def recip_newton() -> int:
    """Newton steps of the magic-seed reciprocal (``MCMC_SPEC_FAST_RECIP``): default 2.

    Used for the two continuum-renorm divides; ``exact`` or ``0`` means true
    divides, ``1``..``3`` select the Newton depth.
    """
    raw = os.environ.get("MCMC_SPEC_FAST_RECIP", "")
    if not raw:
        return 2
    if raw.lower() == "exact":
        return 0
    n = int(raw)
    if not 0 <= n <= 3:
        raise ValueError(f"MCMC_SPEC_FAST_RECIP={raw!r}: use 'exact' or 0..3")
    return n


def matmul_passes() -> int:
    """``MCMC_SPEC_MATMUL_PASSES``: default 3, ``exact`` = 6 (values 1, 3, 6).

    The JAX package emulates an f32 matmul with this many split-bf16 MXU
    passes.  The port validates and stamps the dial for parity of the packed
    target, but computes the full f32 product for every value.
    """
    raw = os.environ.get("MCMC_SPEC_MATMUL_PASSES", "")
    if not raw:
        return 3
    if raw.lower() == "exact":
        return 6
    n = int(raw)
    if n not in (1, 3, 6):
        raise ValueError(f"MCMC_SPEC_MATMUL_PASSES={raw!r}: use 3, 6, or 'exact'")
    return n


def _fused_eval_mode() -> str:
    """Parse ``MCMC_SPEC_FUSED_EVAL`` once, for both the single-target and
    fleet gates: ``auto``, ``1``/``force``/``pallas`` or ``0``/``off``/``xla``."""
    mode = os.environ.get("MCMC_SPEC_FUSED_EVAL", "auto").lower()
    if mode in ("1", "force", "pallas"):
        return "force"
    if mode in ("0", "off", "xla"):
        return "off"
    if mode != "auto":
        raise ValueError(f"bad MCMC_SPEC_FUSED_EVAL={mode!r}")
    return "auto"


def fused_eval_forced() -> bool:
    """True when the fused kernel is explicitly forced on: the fleet's fused
    posterior (K5) is opt-in, the composition with the fleet spectrum kernel
    (K4) is the default."""
    return _fused_eval_mode() == "force"


def fused_eval_off() -> bool:
    """True when fusion is switched off: a fusable single target then takes the
    spectrum kernel (K3) and the composition instead of the fused posterior (K1)."""
    return _fused_eval_mode() == "off"


def enable_persistent_compile_cache(path: str = None) -> "str | None":
    """Keep the kernels' build across processes (``MCMC_SPEC_COMPILE_CACHE``).

    On CUDA the only compile is nvcc's, into the library that
    ``runtime.cuda_build`` keys on the sources' hash and reuses where it
    exists, so the persistent cache is that library's directory.  Values, as
    in JAX: unset, ``1`` or ``auto``: ``mcmc_spec_tpu_torch/build/``
    (``cuda_build.BUILD_DIR``); ``0``, ``off`` or empty: no cache, a temporary
    directory removed when the process exits, so every process runs nvcc;
    anything else: that directory, created if needed.  ``path`` stands in
    for the variable's directory.  Returns the directory, or None when the
    cache is off.  Idempotent; called by the CLI before the first dispatch.
    Raises once the library was loaded from another directory.
    """
    from mcmc_spec_tpu_torch.runtime import cuda_build

    setting = cuda_build.cache_setting(path)
    chosen = cuda_build.use_build_dir(setting)
    return None if setting is None else str(chosen)
