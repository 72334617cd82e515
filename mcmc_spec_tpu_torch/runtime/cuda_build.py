"""Build and load the CUDA kernels of ``csrc/`` (counterpart of ``runtime/native_loader.py``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``: one ``nvcc``
per source, all started together, then one link.  The build goes to
``mcmc_spec_tpu_torch/build/`` by default and is keyed on a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused.  There
is no fallback: a missing ``nvcc`` or a failed build raises.

``MCMC_SPEC_COMPILE_CACHE`` chooses the build directory, read at build time
unless ``utils.flags.enable_persistent_compile_cache`` chose it first: unset,
``1`` or ``auto`` is ``BUILD_DIR``; ``0``, ``off`` or empty a temporary
directory of this process, removed when it exits, so every process runs nvcc;
anything else that directory.  The kernels are SASS for ``sm_90a``, so no PTX
is compiled at load time: the library is the whole persistent cache, and one
library serves every shape.
"""
from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("log_posterior_fused.cu", "spectrum_chi2.cu", "spectrum_chi2_fleet.cu",
           "log_posterior_fleet_fused.cu", "model_extinct.cu", "median_kary.cu",
           "segmented_stats.cu", "microbench.cu", "spectrum_recip.cu", "posterior_transposed.cu",
           "median_adaptive.cu", "median_packed.cu", "spectrum_overlap.cu", "fleet_grid_order.cu",
           "launch_probe.cu", "median_rounds.cu", "posterior_ablate.cu", "fleet_sections.cu",
           "posterior_pair.cu")
HEADERS = ("block_common.cuh", "spectrum_block.cuh", "posterior_body.cuh",
           "spectrum_warp.cuh", "posterior_warp.cuh")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
# no --use_fast_math: the tolerances assume libm expf/logf and true division.
# -Xptxas -v writes each kernel's registers and shared memory to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CACHE_ENV = "MCMC_SPEC_COMPILE_CACHE"

_chosen: Optional[Path] = None  # the directory use_build_dir chose
_temporary: Optional[Path] = None  # this process's directory when the cache is off
_loaded: Optional[Path] = None  # the directory load() took the library from


def cache_setting(path=None) -> Optional[Path]:
    """The build directory that ``MCMC_SPEC_COMPILE_CACHE`` names, read now; None when
    the cache is off.  ``path``, where given, takes the place of the variable's
    directory, as in the JAX package's ``enable_persistent_compile_cache``."""
    raw = os.environ.get(CACHE_ENV, "auto")
    if raw.lower() in ("0", "off", ""):
        return None
    if path is not None:
        return Path(path)
    return BUILD_DIR if raw.lower() in ("1", "auto") else Path(raw)


def use_build_dir(path: Optional[Path]) -> Path:
    """Build into and load from ``path`` (None: a temporary directory of this process,
    removed when it exits) from now on; returns the directory.

    Raises once the library was loaded from another directory: ``load`` is cached
    for the process, so a later choice could not take effect.
    """
    global _chosen, _temporary
    target = Path(path) if path is not None else _temporary
    if _loaded is not None and (target is None or target.resolve() != _loaded.resolve()):
        raise RuntimeError(
            f"the kernel library is already loaded from {_loaded}; {CACHE_ENV} can no "
            "longer move it in this process")
    if target is None:
        target = _temporary = Path(tempfile.mkdtemp(prefix="mcmc_spec_kernels."))
        atexit.register(shutil.rmtree, target, True)
    target.mkdir(parents=True, exist_ok=True)
    _chosen = target
    return target


def build_dir() -> Path:
    """The directory of the library: the one ``use_build_dir`` chose, else the one that
    ``MCMC_SPEC_COMPILE_CACHE`` names now (for ``off`` this process's temporary one)."""
    if _chosen is not None:
        return _chosen
    setting = cache_setting()
    return setting if setting is not None else use_build_dir(None)


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"libmcmc_spec_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists; return its path.

    Each source compiles in its own ``nvcc`` process, all at once; the
    objects are then linked into the library.  The compilers' output (ptxas
    resource usage included) is kept beside the library as ``<name>.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # pid-tagged objects and an atomic rename of the library: ranks that share a cold
    # directory each build their own and the last rename wins
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [lib.parent / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    tmp = lib.with_name(f"{tag}.tmp")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
            *map(str, objs)]
    failed = [(cmd, out) for cmd, out, proc in zip(cmds, outs, procs) if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        outs.append(proc.stdout + proc.stderr)
        cmds.append(link)
        if proc.returncode != 0:
            failed = [(link, outs[-1])]
    lib.with_suffix(".log").write_text(
        "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs)))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    global _chosen, _loaded
    lib = build()
    handle = ctypes.CDLL(str(lib))
    _chosen = _loaded = lib.parent  # the process keeps this directory from now on
    return handle
