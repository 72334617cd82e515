"""Cold and warm wall time of the same CLI fit (counterpart of ``scripts/compile_cache_receipt.py``).

The JAX script runs its koi2298 production fit twice, each in a fresh
process, against one fresh ``MCMC_SPEC_COMPILE_CACHE`` directory, and
reports the cold and warm wall times.  This does the same with the port's
CLI (``python -m mcmc_spec_tpu_torch.cli -f ... -o True -e True
--noplots``), whose only compile is the kernels' nvcc build into that
directory: the cold run builds the library, the warm run loads it.

The JAX child fits the reference's ``param_koi2298.txt``, which is not in
the repository; this one fits a directory that ``testing.write_fit_dir``
writes at the koi2298 widths (nd = 1,792, 3,072 walkers, the synthetic 14x4
grid), as ``chip_smoke.py`` phase 11 does.  ``--depth production`` (the
default) takes ``param_koi2298.txt``'s nstep 400, nburn 301 and nsteps
15,001; ``--depth smoke`` phase 11's 20 / 200 / 2,000.  The fit directory
and its grid cache are written once, before either run, so the two runs
differ only in the kernel build directory; the artifact directory is removed
between them, as in JAX.

    python -m mcmc_spec_tpu_torch.scripts.compile_cache_receipt [--depth production|smoke]
        [--device cuda|cpu]

``--device cpu`` fits on the CPU, where nothing is built.  The last line is
JSON: ``cold_s``, ``warm_s``, ``speedup`` and the device's name.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DEPTHS = {"production": dict(nstep=400, nburn=301, nsteps=15001),  # param_koi2298.txt
          "smoke": dict(nstep=20, nburn=200, nsteps=2000)}  # chip_smoke.py phase 11
ND, NWALK = 1792, 3072  # the koi2298 widths (BASELINE.md config 2)
WALL = "CHILD WALL "
LIBRARY = "CHILD LIBRARY "

# the child: the __NAMES__ are replaced by child_source (not str.format: the source's
# own braces would be read as fields)
CHILD = """
import time
t0 = time.perf_counter()
import sys
sys.path.insert(0, __REPO__)
import torch
from mcmc_spec_tpu_torch.cli import main
from mcmc_spec_tpu_torch.runtime import cuda_build
cuda = torch.device(__DEVICE__).type == "cuda"
found = cuda and cuda_build.library_path().exists()
main(["cli", "-f", __PARAM__, "-o", "True", "-e", "True", "--noplots", "--device", __DEVICE__])
if cuda:
    torch.cuda.synchronize()
print(__LIBRARY__ + (("found " if found else "built ") + cuda_build.library_path().name
                      if cuda else "none (the CPU builds nothing)"), flush=True)
print(__WALL__ + repr(time.perf_counter() - t0), flush=True)
"""


def child_source(paramfile: str, device: str = "cuda") -> str:
    """The child's program, for ``python -c``, run in the fit directory."""
    subs = {"__REPO__": repr(str(REPO)), "__PARAM__": repr(str(paramfile)),
            "__DEVICE__": repr(device), "__LIBRARY__": repr(LIBRARY), "__WALL__": repr(WALL)}
    src = CHILD
    for key, value in subs.items():
        src = src.replace(key, value)
    return src


def parse_child(stdout: str) -> dict:
    """The child's library line and its own wall time."""
    lib = re.findall(rf"^{LIBRARY}(.*)$", stdout, re.M)
    wall = re.findall(rf"^{WALL}(\S+)$", stdout, re.M)
    if not lib or not wall:
        raise ValueError("the child printed no library or wall line")
    return {"library": lib[-1], "child_wall_s": float(wall[-1])}


def run_once(tag: str, fit: dict, cache: Path, device: str) -> dict:
    """The CLI fit in a fresh process with ``MCMC_SPEC_COMPILE_CACHE=cache``."""
    env = dict(os.environ, MCMC_SPEC_COMPILE_CACHE=str(cache))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", child_source(fit["paramfile"], device)],
                         cwd=fit["root"], env=env, capture_output=True, text=True, check=False)
    wall = time.perf_counter() - t0
    sys.stdout.write(out.stdout[-2000:])
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise RuntimeError(f"{tag} run failed with exit code {out.returncode}")
    rec = dict(parse_child(out.stdout), wall_s=wall)
    libs = len(list(cache.glob("*.so"))) if cache.is_dir() else 0
    print(f"[{tag}] wall {wall:.3f} s (the CLI's process {rec['child_wall_s']:.3f} s), "
          f"library {rec['library']}, libraries in the directory: {libs}", flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", choices=sorted(DEPTHS), default="production")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch

    from mcmc_spec_tpu_torch import testing
    from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(describe(dev), flush=True)
    work = Path(tempfile.mkdtemp(prefix="cache_receipt_"))
    try:
        t0 = time.perf_counter()
        fit = testing.write_fit_dir(str(work / "fit"), nd=ND, nwalk=NWALK, **DEPTHS[args.depth])
        print(f"[fit directory] nd {ND}, nwalk {NWALK}, {args.depth} depth "
              f"{DEPTHS[args.depth]}, grid cache built, in {time.perf_counter() - t0:.1f} s",
              flush=True)
        cache = work / "kernels"
        cold = run_once("cold", fit, cache, args.device)
        shutil.rmtree(fit["dirname"], ignore_errors=True)  # the artifacts, as in JAX
        warm = run_once("warm", fit, cache, args.device)
        rec = dict(cold_s=cold["wall_s"], warm_s=warm["wall_s"],
                   speedup=cold["wall_s"] / warm["wall_s"], device=name, depth=args.depth,
                   cold_library=cold["library"], warm_library=warm["library"])
        print(json.dumps(rec))
        return rec
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
