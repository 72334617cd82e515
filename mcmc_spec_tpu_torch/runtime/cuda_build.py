"""Build and load the CUDA kernels of ``csrc/`` (counterpart of ``runtime/native_loader.py``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``: one ``nvcc``
per source, all started together, then one link.  The build goes to
``mcmc_spec_tpu_torch/build/`` and is keyed on a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused.  There
is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("log_posterior_fused.cu", "spectrum_chi2.cu", "spectrum_chi2_fleet.cu",
           "log_posterior_fleet_fused.cu", "model_extinct.cu", "median_kary.cu",
           "segmented_stats.cu", "microbench.cu", "spectrum_recip.cu", "posterior_sections.cu",
           "posterior_transposed.cu", "median_adaptive.cu", "median_packed.cu",
           "spectrum_overlap.cu", "fleet_grid_order.cu", "launch_probe.cu")
HEADERS = ("block_common.cuh", "spectrum_block.cuh", "posterior_body.cuh")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
# no --use_fast_math: the tolerances assume libm expf/logf and true division.
# -Xptxas -v writes each kernel's registers and shared memory to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    return BUILD_DIR / f"libmcmc_spec_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists; return its path.

    Each source compiles in its own ``nvcc`` process, all at once; the
    objects are then linked into the library.  The compilers' output (ptxas
    resource usage included) is kept beside the library as ``<name>.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
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
    return ctypes.CDLL(str(build()))
