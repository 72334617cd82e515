"""The fast median's posterior perturbation, computed on the host (counterpart of
``scripts/median_tempering_bound_cpu.py``).

On the renorm path (stage 2) a relative median error ``eps`` of the k-pass
midpoint rank search rescales the spectrum chi^2 by ``(1 + eps)^-2``, so the
log-posterior moves by

    dL = -0.5 * w * chi_spec * ((1 + eps)^-2 - 1),   w = spectrum_weight * (nc + np)

Both ingredients are computed here: ``eps`` from the bit-level rank search of
the kernels (``ops.cuda_kernels._row_median_nonneg``, the plain twin of K1's
median) on the exact model rows, and ``chi_spec`` from the exact composition.
For each pass count k the script reports the tempering formula against a
direct recomputation of the renorm path with the k-pass median, and the
annealer path (no renorm, so no factorization: its change is measured by
recomputation, with the annealer's x3 spectrum weight).

The ensemble (1,024 walkers around the bench truth) is equilibrated for 1,500
steps at the exact dials on the CPU, where ``log_posterior_batch`` takes the
composition with the exact median.

    python -m mcmc_spec_tpu_torch.scripts.median_tempering_bound_cpu
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference import batched
from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu_torch.ops.cuda_kernels import _row_median_nonneg

NWALK = 1024
NBURN = 1500
PASSES = (20, 16, 14, 12, 10)
EXACT = dict(median_iters=31, matmul_passes=6, recip_newton=0)


def model_and_exact(coords, tgt):
    """[nw, nd] extincted model rows of the walkers ``coords``."""
    *_, Wcomb = batched._forward_small(coords, tgt)
    av = coords[:, tgt.nspec]
    nT, nG, nd = tgt.D.shape
    model_raw = Wcomb @ tgt.D.reshape(nT * nG, nd)
    trans = torch.where((av > 0)[:, None],
                        torch.exp((-0.4 * math.log(10.0)) * av[:, None] * tgt.ext_k_data[None, :]),
                        torch.ones((), dtype=model_raw.dtype, device=model_raw.device))
    return model_raw * trans


def chi_renorm_with_med(model, med, tgt):
    """The stage-2 (renorm) spectrum chi^2 with a given per-walker median ``med`` [nw]:
    ``batched._spec_chi2_xla`` from the median scaling on."""
    m = model * (tgt.med_data / med)[:, None]
    frac = tgt.data_flux[None, :] / m
    coeffs = frac @ tgt.Vpinv.T
    data_renorm = tgt.data_flux[None, :] / (coeffs @ tgt.V.T)
    resid2 = ((m - data_renorm) / tgt.data_err) ** 2
    resid2 = torch.where(torch.isfinite(resid2), resid2, torch.zeros_like(resid2))
    return resid2.sum(dim=1) / tgt.n_data_true.to(m.dtype)


def chi_median_only_with_med(model, med, tgt):
    """The annealer's (median-only) spectrum chi^2 with a given median ``med`` [nw]."""
    m = model * (tgt.med_data / med)[:, None]
    resid2 = ((m - tgt.data_flux[None, :]) / tgt.data_err) ** 2
    resid2 = torch.where(torch.isfinite(resid2), resid2, torch.zeros_like(resid2))
    return resid2.sum(dim=1) / tgt.n_data_true.to(m.dtype)


def _host64(t):
    return t.detach().cpu().numpy().astype(np.float64)


def equilibrate(tgt, truth, nwalk, nburn, seed=7):
    """Walkers ``init_walker_batch`` around ``truth`` after ``nburn`` stretch steps of
    ``log_posterior_batch`` on ``tgt``, from a generator seeded ``seed``."""
    logp = lambda b: batched.log_posterior_batch(b, tgt)
    coords = init_walker_batch(tgt, truth, nwalk, tgt.D.dtype)
    gen = torch.Generator(device=tgt.device).manual_seed(seed)
    state = init_ensemble(coords, logp, gen)
    state, _, _ = run_ensemble(state, logp, n_steps=nburn, thin=nburn)
    return state.coords


def tempering_tables(model, tgt, fin, passes=PASSES):
    """Per pass count k, the relative median error and the three dL distributions over
    the walkers ``fin`` (a numpy mask) of the model rows ``model`` [nw, nd] f32."""
    med_exact = _host64(_row_median_nonneg(model, iters=31)[:, 0])
    as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=model.device)
    w = float(tgt.spectrum_weight) * float(int(tgt.n_contrast_true) + int(tgt.n_phot_true))
    chi_ex = _host64(chi_renorm_with_med(model, as_f32(med_exact), tgt))
    chi_med_ex = _host64(chi_median_only_with_med(model, as_f32(med_exact), tgt))
    out = {}
    for k in passes:
        med_k = _host64(_row_median_nonneg(model, iters=k)[:, 0])
        eps = med_k[fin] / med_exact[fin] - 1.0
        # the tempering formula (the structural bound's quantity)
        dL_temper = -0.5 * w * chi_ex[fin] * ((1.0 + eps) ** -2 - 1.0)
        # direct recomputation through the whole renorm path: its agreement with the
        # formula is the factorization, float32 rounding included
        chi_k = _host64(chi_renorm_with_med(model, as_f32(med_k), tgt))[fin]
        dL_direct = -0.5 * w * (chi_k - chi_ex[fin])
        # the annealer path: no factorization, the x3 stage-1 spectrum weight
        chi_mk = _host64(chi_median_only_with_med(model, as_f32(med_k), tgt))[fin]
        dL_anneal = -0.5 * 3.0 * w * (chi_mk - chi_med_ex[fin])
        out[k] = dict(
            eps_bound=float(np.log(2) * 2.0 ** (7 - k)),
            eps_max=float(np.max(np.abs(eps))),
            eps_std=float(np.std(eps)),
            dL_std=float(np.std(dL_temper)),
            dL_max=float(np.max(np.abs(dL_temper))),
            dL_direct_std=float(np.std(dL_direct)),
            dL_direct_max=float(np.max(np.abs(dL_direct))),
            anneal_dL_std=float(np.std(dL_anneal)),
            anneal_dL_max=float(np.max(np.abs(dL_anneal))),
        )
    return out, dict(w=w, chi_ex=chi_ex, chi_med_ex=chi_med_ex)


def main(nwalk=NWALK, nburn=NBURN, nd=1792, grid_step=1.0):
    print("[env] cpu: the composition with the exact median, float32", flush=True)
    tgt, truth = build_bench_target(torch.float32, device="cpu", nd=nd, grid_step=grid_step)
    tgt = dataclasses.replace(tgt, **EXACT)
    eq = equilibrate(tgt, truth, nwalk, nburn)
    L = _host64(batched.log_posterior_batch(eq, tgt))
    fin = np.isfinite(L)
    print(f"equilibrated: {int(fin.sum())}/{nwalk} finite logp", flush=True)

    out, ex = tempering_tables(model_and_exact(eq, tgt), tgt, fin)
    chi_ex = ex["chi_ex"]
    print(f"w = {ex['w']}, equilibrium chi_spec (mean-per-point): "
          f"median {np.median(chi_ex[fin]):.3f}, p95 {np.percentile(chi_ex[fin], 95):.3f}",
          flush=True)
    for k, r in out.items():
        print(f"k={k:2d}: |eps|max {r['eps_max']:.2e} (bound {r['eps_bound']:.2e})  "
              f"renorm dL std {r['dL_std']:.4f} max {r['dL_max']:.4f} "
              f"(direct {r['dL_direct_std']:.4f}/{r['dL_direct_max']:.4f})  "
              f"anneal dL std {r['anneal_dL_std']:.3f} max {r['anneal_dL_max']:.3f}", flush=True)
    print("\n" + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
