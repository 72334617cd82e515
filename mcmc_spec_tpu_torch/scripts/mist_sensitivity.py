"""How far the builtin MIST table's radius systematic moves the posterior (counterpart
of ``scripts/mist_sensitivity.py``).

The builtin isochrone track runs ~+8 % in radius against genuine MIST v1.2,
while the reference's radius prior holds walkers to 2 % of the model radius.
On the JAX test suite's synthetic fit target with the radius prior on
(``testing.make_setup(rad_prior=True)``, float64, on the CPU) the script runs
three chains of 24 walkers: the true table at sigma 0.02, the table with +8 %
radii at 0.02 (the reference's width), and the same table at 0.082 (0.02
widened in quadrature by the table's 8 %, which ``MistTable.rad_prior_sigma_frac``
applies to the builtin table), and prints each variant's median shifts in the
baseline's sigma and in its own.

    python -m mcmc_spec_tpu_torch.scripts.mist_sensitivity [n_steps]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu_torch.inference.target import pack_target
from mcmc_spec_tpu_torch.testing import make_setup

LABELS = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]
N_STEPS = 1200
N_WALKERS = 24
BASELINE = "baseline (true table, sigma=0.02)"


def _repack(st, mist, rad_sigma_frac):
    return pack_target(
        st["grid"], st["data_wl_um"], st["data_flux"], st["data_err"], st["cfilts"],
        st["cmag"], st["cerr"], st["pfilts"], st["zps"], st["pmag"], st["perr"], mist,
        st["av_profile"], nspec=2, dist_fit=True, rad_prior=True, dtype=torch.float64,
        device="cpu", rad_sigma_frac=rad_sigma_frac)


def _run_chain(tgt, p_truth, n_steps, n_walkers=N_WALKERS, seed=0):
    """[n_steps // 2 * n_walkers, 6] samples at thin 2 after n_steps // 3 burn-in steps,
    the walkers 1 % around the truth from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    p0 = torch.as_tensor(np.stack([p_truth * (1 + 0.01 * rng.randn(6))
                                   for _ in range(n_walkers)]), dtype=torch.float64)
    logp = lambda b: log_posterior_batch(b, tgt)
    state = init_ensemble(p0, logp, torch.Generator().manual_seed(seed))
    state, _, _ = run_ensemble(state, logp, n_steps=n_steps // 3, thin=n_steps // 3)
    _, chain, _ = run_ensemble(state, logp, n_steps=n_steps, thin=2)
    return chain.numpy().reshape(-1, 6)


def main(n_steps: int = N_STEPS):
    st, _ = make_setup(rad_prior=True)
    p_truth = np.asarray(st["p_truth"], dtype=np.float64)
    mist = st["mist"]
    variants = {
        BASELINE: (mist, 0.02),
        "table +8% R, sigma=0.02 (reference width)": (mist.perturbed(radius_scale=1.08), 0.02),
        "table +8% R, sigma=0.082 (widened)": (mist.perturbed(radius_scale=1.08), 0.082),
    }
    chains = {name: _run_chain(_repack(st, m, sig), p_truth, n_steps)
              for name, (m, sig) in variants.items()}

    base = chains[BASELINE]
    med0, sig0 = np.median(base, axis=0), base.std(axis=0)
    print(f"truth:   {np.array2string(p_truth, precision=4)}")
    print(f"baseline medians: {np.array2string(med0, precision=4)}  "
          f"sigma: {np.array2string(sig0, precision=4)}")
    out = {}
    for name, ch in chains.items():
        if name == BASELINE:
            continue
        med, sig = np.median(ch, axis=0), ch.std(axis=0)
        shift = (med - med0) / sig0  # bias against the unbiased posterior
        shift_own = (med - med0) / sig  # the bias in the variant's own sigma: honest bars?
        print(f"\n{name}")
        for i, lab in enumerate(LABELS):
            print(f"  {lab:>6}: median {med[i]:.5g}  shift {shift[i]:+.2f} "
                  f"baseline-sigma  ({shift_own[i]:+.2f} own-sigma)")
        print(f"  max |shift| = {np.max(np.abs(shift)):.2f} baseline-sigma, "
              f"{np.max(np.abs(shift_own)):.2f} own-sigma")
        out[name] = dict(shift=shift, shift_own=shift_own)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else N_STEPS)
