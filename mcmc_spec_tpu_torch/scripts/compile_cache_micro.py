"""The kernel build cache in three fresh processes (counterpart of ``scripts/compile_cache_micro.py``).

The JAX script's three arms separate its client-side persistent cache from
the server-side cache of the remote-compile tunnel, and it picks a fresh
kernel shape so that neither has seen it.  Neither has a counterpart here:
no tunnel stands between the port and its compiler, and one library of
``sm_90a`` SASS (``runtime.cuda_build``) serves every shape, so a fresh nd
compiles nothing.  The port's arms are the build directory's three states
under ``MCMC_SPEC_COMPILE_CACHE``:

  A: an empty directory: the cold build (nvcc for every source, the link);
  B: the same directory: a hit, the library loaded without nvcc;
  C: ``MCMC_SPEC_COMPILE_CACHE=off``: a temporary directory, nvcc again.

Each arm is a fresh process that launches K1
(``ops.cuda_kernels.log_posterior_fused``) once on 1,024 bench walkers at nd
= 1,808 at the production dials (14, 3, 2) and holds it against its plain
version (the JAX kernel gate on all but 0.1 % of the walkers, as
``chip_smoke.py``).  Each prints the seconds of the torch import with CUDA
initialisation, of the build or load of the library, and of the first
launch; the parent adds the process's wall time.

    python -m mcmc_spec_tpu_torch.scripts.compile_cache_micro [nd]

``main(device="cpu", ...)`` runs the arms on the CPU, where K1's wrapper
takes its plain version and nothing is built.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
ND, NW = 1808, 1024
PROD = dict(median_iters=14, matmul_passes=3, recip_newton=2)
RTOL = 5e-5  # the JAX package's kernel gate
MAX_OUTSIDE_FRAC = 1e-3  # the 14-pass midpoint median: >= 99.9 % of walkers in the gate
RESULT = "MICRO RESULT "

# the child: the __NAMES__ are replaced by child_source
# (not str.format: the source's own braces would be read as fields)
CHILD = """
import time
t_start = time.perf_counter()
import dataclasses, json, sys
sys.path.insert(0, __REPO__)
import numpy as np
import torch
dev = torch.device(__DEVICE__)
cuda = dev.type == "cuda"
if cuda:
    torch.zeros(1, device=dev)  # the CUDA context
    torch.cuda.synchronize()
t_import = time.perf_counter() - t_start
from mcmc_spec_tpu_torch.runtime import cuda_build
lib, built, t_lib = None, None, 0.0
if cuda:
    if __FORBID_NVCC__:
        def no_nvcc():
            raise RuntimeError(f"nvcc was asked for: no library in {cuda_build.build_dir()}")
        cuda_build.find_nvcc = no_nvcc
    path = cuda_build.library_path()
    built = not path.exists()
    t = time.perf_counter()
    cuda_build.load()
    t_lib = time.perf_counter() - t
    lib = str(path)
from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
tgt, truth = build_bench_target(torch.float32, device=dev, nd=__ND__, grid_step=__GRID_STEP__)
tgt = dataclasses.replace(tgt, **__PROD__)
coords = init_walker_batch(tgt, truth, __NW__)
if cuda:
    torch.cuda.synchronize()
t = time.perf_counter()
got = ck.log_posterior_fused(coords, tgt)
if cuda:
    torch.cuda.synchronize()
t_first = time.perf_counter() - t
ref = ck.log_posterior_fused_reference(coords, tgt)
g, r = got.double().cpu().numpy(), ref.double().cpu().numpy()
fin = np.isfinite(r)
scale = float(np.abs(r[fin]).max()) if fin.any() else 0.0
with np.errstate(invalid="ignore"):
    close = np.abs(g - r) <= 1e-4 * scale + __RTOL__ * np.abs(r)
inside = (np.isfinite(g) == fin) & (~fin | close)
rel = None
if fin.any():
    rel = float(np.max(np.abs(g[fin] - r[fin]) / np.maximum(np.abs(r[fin]), 1e-30)))
print(__RESULT__ + json.dumps(dict(
    device=torch.cuda.get_device_name(0) if cuda else "cpu", lib=lib, built=built,
    import_s=t_import, library_s=t_lib, first_launch_s=t_first, walkers=int(r.size),
    outside=int((~inside).sum()), max_rel_err=rel, launches=ck.LAUNCHES["log_posterior_fused"])),
    flush=True)
"""


def child_source(device="cuda", nd=ND, nw=NW, forbid_nvcc=False, grid_step=1.0) -> str:
    """The arm's program, for ``python -c``: K1 once on ``nw`` bench walkers at ``nd``;
    with ``forbid_nvcc`` a build raises instead of running nvcc."""
    subs = {"__REPO__": repr(str(REPO)), "__DEVICE__": repr(device), "__ND__": str(int(nd)),
            "__NW__": str(int(nw)), "__FORBID_NVCC__": repr(bool(forbid_nvcc)),
            "__GRID_STEP__": repr(float(grid_step)),
            "__PROD__": repr(PROD), "__RTOL__": repr(RTOL), "__RESULT__": repr(RESULT)}
    src = CHILD
    for key, value in subs.items():
        src = src.replace(key, value)
    return src


def parse_result(stdout: str) -> dict:
    """The arm's record: the last line of its output that starts with ``RESULT``."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith(RESULT)]
    if not lines:
        raise ValueError("the arm printed no result line")
    return json.loads(lines[-1][len(RESULT):])


def in_gate(rec: dict) -> bool:
    """K1 against its plain version: at most 0.1 % of the walkers outside the gate."""
    return rec["outside"] <= int(MAX_OUTSIDE_FRAC * rec["walkers"])


def run_arm(tag: str, cache, device="cuda", nd=ND, nw=NW, forbid_nvcc=False,
            grid_step=1.0) -> dict:
    """One arm in a fresh process with ``MCMC_SPEC_COMPILE_CACHE=cache``; returns its
    record with the process's wall time (``wall_s``) and prints it."""
    env = dict(os.environ, MCMC_SPEC_COMPILE_CACHE=str(cache))
    src = child_source(device, nd, nw, forbid_nvcc, grid_step)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", src],
                         env=env, capture_output=True, text=True, cwd=REPO, check=False)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-2000:] + out.stderr[-4000:])
        raise RuntimeError(f"arm {tag} failed with exit code {out.returncode}")
    rec = dict(parse_result(out.stdout), arm=tag, cache=str(cache), wall_s=wall)
    lib = Path(rec["lib"]).name if rec["lib"] else "none (the CPU builds nothing)"
    print(f"[{tag}] torch import + CUDA init {rec['import_s']:.3f} s, library "
          f"{'built' if rec['built'] else 'loaded'} in {rec['library_s']:.3f} s ({lib}), "
          f"first K1 launch {rec['first_launch_s']:.4f} s, process wall {wall:.3f} s; K1 vs "
          f"plain: {rec['outside']} of {rec['walkers']} outside the gate, max rel "
          f"{rec['max_rel_err']}", flush=True)
    return rec


def main(nd=ND, device="cuda", nw=NW) -> list:
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: torch.cuda.is_available() is false (pass "
                               "device='cpu' to run the arms on the plain K1)")
        from mcmc_spec_tpu_torch.scripts.timing import describe

        print(describe(torch.device("cuda")), flush=True)
    work = Path(tempfile.mkdtemp(prefix="cache_micro_"))
    try:
        cache = work / "kernels"
        recs = [run_arm("A empty directory (cold build)", cache, device, nd, nw),
                run_arm("B same directory (hit)", cache, device, nd, nw, forbid_nvcc=True),
                run_arm("C MCMC_SPEC_COMPILE_CACHE=off", "off", device, nd, nw)]
        libs = sorted(p.name for p in cache.glob("*.so")) if cache.is_dir() else []
        print(f"libraries in the directory: {libs}")
        a, b, c = (r["library_s"] for r in recs)
        print(json.dumps(dict(device=recs[0]["device"], nd=nd, walkers=nw, cold_build_s=a,
                              hit_load_s=b, off_build_s=c,
                              walls_s=[r["wall_s"] for r in recs],
                              first_launch_s=[r["first_launch_s"] for r in recs],
                              all_in_gate=all(in_gate(r) for r in recs))))
        if not all(in_gate(r) for r in recs):
            raise RuntimeError("K1 left its gate against the plain version in an arm")
        if device == "cuda" and [r["built"] for r in recs] != [True, False, True]:
            raise RuntimeError("the arms did not build, hit and build again: "
                               f"{[r['built'] for r in recs]}")
        return recs
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else ND)
