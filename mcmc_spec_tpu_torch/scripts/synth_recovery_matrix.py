"""The 12-fixture synthetic-truth recovery matrix, on the card (counterpart of
``scripts/synth_recovery_matrix.py``).

The reference's ground truth is its ``Data/synth_spec_{T1}_{T2}`` binaries:
T1 in {3850, 4200} against six T2 each, radii from the MIST track, 1 % noise
(mft6.py:3599-3642).  Each fixture's analogue is made from the ``synthetic``
model family at the same (T1, T2) (``recovery_fixtures``), then fitted by the
real two-stage pipeline (``setup_context``, ``run_optimize_stage``,
``run_mcmc_stage(nthin=100, check_convergence=True, mesh=None)``) at the
production dials: K3 in stage 1, K1 in stage 2.  It prints each fixture's z =
(median - truth) / sigma, the calibration over the 12 noise seeds (no
systematic bias, no overconfident widths), ``calibration: PASS`` or ``FAIL``,
and the rows as JSON.

    python -m mcmc_spec_tpu_torch.scripts.synth_recovery_matrix [--cpu]

``--cpu`` runs the same on the CPU, where the dispatch takes the composition:
exact arithmetic, whatever the dials.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import recovery_fixtures as rf
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

# the reference generator's two binary families (mft6.py:3599-3605)
T_PAIRS = ([(3850, t2) for t2 in (3025, 3225, 3425, 3600, 3625, 3800)]
           + [(4200, t2) for t2 in (3225, 3425, 3625, 3825, 4025, 4175)])
LABELS = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]


def matrix_fixture(i, t1, t2, work, ref, device):
    """Fixture ``i`` of the matrix: observation seed 100 + i, magnitudes' seed 200 + i."""
    write = lambda datafile, cmag, pmag, truth: rf.matrix_param(
        work, ref, t1, t2, datafile, cmag, pmag, truth)
    return rf.make_fixture(ref, (t1, t2), write, os.path.join(work, f"synth_spec_{t1}_{t2}.txt"),
                           obs_seed=100 + i, mag_seed=200 + i, cmag0=[1.0, 1.0], n_cnoise=2,
                           device=device)


def run(work, ref, device="cuda", pairs=T_PAIRS, fit=rf.fit):
    """The matrix's rows, each fixture built and fitted in ``work`` (the working
    directory); ``fit(fixture, device) -> (ctx, samples)``."""
    rows = []
    for i, (t1, t2) in enumerate(pairs):
        t0 = time.perf_counter()
        fx = matrix_fixture(i, t1, t2, work, ref, device)
        _, samples = fit(fx, device)
        _, sig, z = rf.z_scores(samples, fx.truth)
        rows.append(dict(t1=t1, t2=t2, shift=[round(float(s), 3) for s in z],
                         sigma=[float(s) for s in sig],
                         wall_s=round(time.perf_counter() - t0, 1)))
        print(f"[{i + 1:2d}/{len(pairs)}] T1={t1} T2={t2}: max|shift| "
              f"{np.max(np.abs(z)):.3f} sigma  "
              + " ".join(f"{lab}={s:+.2f}" for lab, s in zip(LABELS, z)), flush=True)
    return rows


def verdict(rows):
    """Print the calibration over ``rows`` and return whether it passes.

    Recovered against injected at one noise draw scatters at ~1 posterior sigma
    by construction, so the acceptance is calibration: per parameter, mean z ~ 0
    and std z not above 1.8 over the fixtures' independent seeds.
    """
    Z = np.array([r["shift"] for r in rows])  # [fixtures, 6]
    print(f"worst |z| across {len(rows)} fixtures x 6 params: {float(np.max(np.abs(Z))):.3f} "
          f"(max of 72 N(0,1) draws expects ~2.5)")
    ok, lines = rf.calibration_matrix(Z, LABELS)
    print("\n".join(lines))
    print("calibration: " + ("PASS" if ok else "FAIL"), flush=True)
    return ok


def main(argv=None, pairs=T_PAIRS, fit=rf.fit):
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device("cpu" if "--cpu" in argv else "cuda")
    print(f"[env] {describe(dev)}", flush=True)
    work = tempfile.mkdtemp(prefix="recovery_")
    cwd = os.getcwd()
    os.chdir(work)  # the fits' dirnames and the grid cache are relative to it
    try:
        ref = rf.write_reference(os.path.join(work, "reference"))
        ck.reset_launches()
        t_start = time.perf_counter()
        rows = run(work, ref, str(dev), pairs, fit)
        print(f"\ntotal wall: {time.perf_counter() - t_start:.0f}s")
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        print(f"[launches] {launches}")
        ok = verdict(rows)
        print(json.dumps(rows))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return dict(ok=ok, rows=rows, launches=launches)


if __name__ == "__main__":
    main()
