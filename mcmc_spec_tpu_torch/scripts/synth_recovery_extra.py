"""The triple and nospec truth-recovery lanes, on the card (counterpart of
``scripts/synth_recovery_extra.py``).

The matrix (``synth_recovery_matrix``) covers binaries only.  This runs two
more layouts through the real two-stage pipeline at the production dials,
three noise seeds each:

* **triple**: (4200, 3625, 3100), ``nspec 3``, the MIST radii, 1 % spectrum
  noise and 0.02 mag magnitude noise;
* **nospec**: the binary (3850, 3625) fitted with ``spectrum_weight = 0``
  (photometry, contrasts and priors only, the parallax capped at 1/100): its
  temperatures rest on the colours alone, so the check is calibration, not
  precision.

For each fixture it also prints logpost(median) - logpost(truth) from one
``log_posterior_batch`` call: positive when the posterior prefers the
recovered mode on this noise draw (a multi-modal landscape), negative when
the sampler missed the better fit.  The verdict per lane and parameter: no
systematic bias and max |z| < 3.5 over the seeds.

    python -m mcmc_spec_tpu_torch.scripts.synth_recovery_extra [--cpu]
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import recovery_fixtures as rf
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

TRIPLE, TRIPLE_SEEDS = (4200, 3625, 3100), (7, 17, 27)
NOSPEC, NOSPEC_SEEDS = (3850, 3625), (8, 18, 28)


def labels_of(nspec):
    return ([f"T{i + 1}" for i in range(nspec)] + ["Av", "R1"]
            + [f"R{i + 2}/R1" for i in range(nspec - 1)] + ["plx"])


def lane_fixture(tag, teffs, seed, work, ref, nospec=False, device="cuda"):
    """A lane's fixture: observation seed ``seed``, magnitudes' seed ``seed + 100``."""
    nspec = len(teffs)
    write = lambda datafile, cmag, pmag, truth: rf.lane_param(
        work, ref, tag, datafile, cmag, pmag, truth, nspec)
    return rf.make_fixture(ref, teffs, write, os.path.join(work, f"synth_spec_{tag}.txt"),
                           obs_seed=seed, mag_seed=seed + 100, cmag0=[1.0] * (nspec - 1),
                           n_cnoise=nspec - 1, spectrum_weight=0.0 if nospec else 1.0,
                           device=device)


def run_fixture(tag, teffs, work, ref, nospec=False, seed=7, device="cuda", fit=rf.fit):
    """One fixture's row: its z, the mode diagnostic and the fit's wall time."""
    fx = lane_fixture(tag, teffs, seed, work, ref, nospec, device)
    t0 = time.perf_counter()
    ctx, samples = fit(fx, device)
    wall = time.perf_counter() - t0
    med, sig, z = rf.z_scores(samples, fx.truth)
    labels = labels_of(len(teffs))
    tgt = ctx.target
    pts = torch.as_tensor(np.stack([fx.truth, med]), dtype=tgt.data_flux.dtype,
                          device=tgt.device)
    lp_truth, lp_med = log_posterior_batch(pts, tgt).double().cpu().numpy()
    print(f"[{tag}] wall {wall:.0f}s  max|z| {np.max(np.abs(z)):.3f}  "
          f"logpost(median)-logpost(truth)={lp_med - lp_truth:+.2f}  "
          + " ".join(f"{lab}={s:+.2f}" for lab, s in zip(labels, z)), flush=True)
    return dict(tag=tag, labels=labels,
                dlogpost_med_minus_truth=round(float(lp_med - lp_truth), 3),
                truth=[float(v) for v in fx.truth], median=[float(v) for v in med],
                sigma=[float(v) for v in sig], z=[round(float(s), 3) for s in z],
                wall_s=round(wall, 1))


def fixtures(triple_seeds=TRIPLE_SEEDS, nospec_seeds=NOSPEC_SEEDS):
    """(tag, teffs, nospec, seed) of every fixture, the triples first."""
    return ([(f"triple_{'_'.join(map(str, TRIPLE))}_s{s}", TRIPLE, False, s)
             for s in triple_seeds]
            + [(f"nospec_{'_'.join(map(str, NOSPEC))}_s{s}", NOSPEC, True, s)
               for s in nospec_seeds])


def main(argv=None, cases=None, fit=rf.fit):
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device("cpu" if "--cpu" in argv else "cuda")
    print(f"[env] {describe(dev)}", flush=True)
    work = tempfile.mkdtemp(prefix="recovery_extra_")
    cwd = os.getcwd()
    os.chdir(work)  # the fits' dirnames and the grid cache are relative to it
    try:
        ref = rf.write_reference(os.path.join(work, "reference"))
        ck.reset_launches()
        rows = [run_fixture(tag, teffs, work, ref, nospec, seed, str(dev), fit)
                for tag, teffs, nospec, seed in (fixtures() if cases is None else cases)]
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        print(f"[launches] {launches}")
        ok, lines = rf.calibration_lanes(rows)
        print("\n".join(lines))
        print("\ncalibration: " + ("PASS" if ok else "FAIL"))
        print(json.dumps(rows))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return dict(ok=ok, rows=rows, launches=launches)


if __name__ == "__main__":
    main()
