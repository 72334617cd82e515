"""Peak host memory of the streamed fleet samples writer (counterpart of ``scripts/fleet_memory_receipt.py``).

A fleet chain at the reference's config-5 schedule (15,001 steps x 9
targets x 4,096 walkers x 6 parameters, float32) is ~13.3 GB.  Holding every
chunk and concatenating them before writing each target's ``samples.txt``
holds that twice; ``fleet_pipeline.stream_fleet_samples`` writes the
per-target files straight from the on-disk ``ChainStore``, one chunk at a
time.  This measures the port's writer on a synthetic store, each run in a
fresh process, whose peak resident set (``VmHWM``) is set beside its resident
set after its imports (``VmRSS``, before the write): the difference is the
writer's own.  With torch built for CUDA the imports alone map several GB of
libraries, and ``ru_maxrss`` carries a high-water mark from before the
process's ``exec``, so neither alone is the writer's memory.

1. the new path at the full config-5 chain shape, 150 chunks of
   [100, 9, 4,096, 6] float32 (13.3 GB on disk), and at half the schedule
   (75 chunks): the peak is flat in the schedule's length;
2. the new path and the old pattern (hold every chunk, concatenate, slice
   per target, ``io.results.write_samples``) at 512 walkers, with the old
   path's analytic cost at the full shape.

Each record names the writer that ran: pandas' ``to_csv`` where pandas
imports, ``np.savetxt`` otherwise (``io.results.write_sample_block``).  The
writer is host numpy (and pandas): no card takes part, and the child process
imports no JAX (its record says so).

    python -m mcmc_spec_tpu_torch.scripts.fleet_memory_receipt [--chunks 150]
        [--walkers 4096] [--dir DIR]

``--chunks`` and ``--walkers`` set step 1's shape (step 1's second run takes
half the chunks; step 2 keeps 512 walkers, or fewer where ``--walkers`` is
smaller); ``--dir`` the directory of the store and the text (default: the
temporary directory), which needs room for the store and one run's text
(~45 GB at the full shape).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
NTHIN, NTGT, NDIM = 100, 9, 6
OLD_NW = 512  # the old pattern's walkers: at the full shape it would hold ~27 GB
RECORD = "FLEET MEMORY "

# the child: the __NAMES__ are replaced by child_source (not str.format: the source's
# own braces would be read as fields)
CHILD = """
import json, os, resource, sys, time
sys.path.insert(0, __REPO__)
import numpy as np
from mcmc_spec_tpu_torch.io.results import ChainStore, _pandas_or_none, write_samples
from mcmc_spec_tpu_torch.fleet_pipeline import stream_fleet_samples


def status_gb(field):
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith(field + ":"):
                    return int(ln.split()[1]) / 1e6
    except OSError:
        pass
    return None


writer = "pandas to_csv" if _pandas_or_none() is not None else "np.savetxt"
import_rss = status_gb("VmRSS")

root, mode, n_chunks, nw = __ROOT__, __MODE__, __CHUNKS__, __NW__
store = ChainStore(root, name=f"chunks_{nw}")
dirnames = []
for t in range(__NTGT__):
    d = os.path.join(root, f"out_{mode}_{n_chunks}_{nw}", f"tgt{t}")
    os.makedirs(d, exist_ok=True)
    dirnames.append(d)
t0 = time.perf_counter()
if mode == "new":
    stream_fleet_samples(store, dirnames, n_chunks, __NDIM__, return_samples=False)
else:  # hold every chunk, concatenate, slice per target
    full = np.concatenate(list(store.iter_chunks(n_chunks)), axis=0)
    for t, d in enumerate(dirnames):
        write_samples(d, full[:, t].reshape(-1, __NDIM__))
dt = time.perf_counter() - t0
peak = status_gb("VmHWM")
if peak is None:  # no /proc: the process's high-water mark
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
print(__RECORD__ + json.dumps(dict(
    mode=mode, n_chunks=n_chunks, nw=nw, peak_rss_gb=peak, import_rss_gb=import_rss,
    writer_rss_gb=None if import_rss is None else peak - import_rss, wall_s=dt, writer=writer,
    text_gb=sum(os.path.getsize(os.path.join(d, "samples.txt")) for d in dirnames) / 1e9,
    jax_imported="jax" in sys.modules)), flush=True)
"""


def out_dir(root, mode: str, n_chunks: int, nw: int) -> Path:
    """Where the child of (mode, n_chunks, nw) writes the targets' ``samples.txt``."""
    return Path(root) / f"out_{mode}_{n_chunks}_{nw}"


def build_store(root, n_chunks: int, nw: int, seed: int = 0):
    """A ``ChainStore`` of ``n_chunks`` copies of one [100, 9, nw, 6] float32 chunk (the
    values do not matter for the memory receipt)."""
    from mcmc_spec_tpu_torch.io.results import ChainStore

    store = ChainStore(str(root), name=f"chunks_{nw}")
    base = np.random.RandomState(seed).rand(NTHIN, NTGT, nw, NDIM).astype(np.float32)
    for i in range(n_chunks):
        store.append(i, base)
    return store


def child_source(mode: str, root, n_chunks: int, nw: int) -> str:
    """One writer run's program, for ``python -c``."""
    subs = {"__REPO__": repr(str(REPO)), "__ROOT__": repr(str(root)), "__MODE__": repr(mode),
            "__CHUNKS__": str(int(n_chunks)), "__NW__": str(int(nw)), "__NTGT__": str(NTGT),
            "__NDIM__": str(NDIM), "__RECORD__": repr(RECORD)}
    src = CHILD
    for key, value in subs.items():
        src = src.replace(key, value)
    return src


def parse_record(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith(RECORD)]
    if not lines:
        raise ValueError("the writer run printed no record")
    return json.loads(lines[-1][len(RECORD):])


def run_child(mode: str, root, n_chunks: int, nw: int) -> dict:
    """One writer run in a fresh process; returns its record."""
    out = subprocess.run([sys.executable, "-c", child_source(mode, root, n_chunks, nw)],
                         capture_output=True, text=True, check=False, cwd=REPO)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise RuntimeError(f"the {mode} writer run failed with exit code {out.returncode}")
    return parse_record(out.stdout)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=150)
    ap.add_argument("--walkers", type=int, default=4096)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    from mcmc_spec_tpu_torch.scripts.timing import describe_host

    print(describe_host(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="fleet_mem_", dir=args.dir))
    results = []

    def measure(mode, n_chunks, nw):
        rec = run_child(mode, work, n_chunks, nw)
        print(json.dumps(rec), flush=True)
        results.append(rec)
        shutil.rmtree(out_dir(work, mode, n_chunks, nw), ignore_errors=True)

    try:
        nw = args.walkers
        gb = args.chunks * NTHIN * NTGT * nw * NDIM * 4 / 1e9
        print(f"building the store: {args.chunks} chunks of [{NTHIN}, {NTGT}, {nw}, {NDIM}] "
              f"float32, {gb:.2f} GB", flush=True)
        build_store(work, args.chunks, nw)
        for n_chunks in (max(args.chunks // 2, 1), args.chunks):
            measure("new", n_chunks, nw)
        shutil.rmtree(work / f"chunks_{nw}")

        small = min(OLD_NW, nw)
        print(f"building the store: {args.chunks} chunks at {small} walkers", flush=True)
        build_store(work, args.chunks, small)
        for mode in ("new", "old"):
            measure(mode, args.chunks, small)
        summary = dict(summary=results, chain_gb=gb, old_path_analytic_gb=2 * gb)
        print(json.dumps(summary, indent=2))
        return summary
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
