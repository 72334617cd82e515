"""Per-section cost ablation of the fused posterior K1 on the card
(counterpart of ``scripts/ablate_fused_sections.py``).

``posterior_sections`` (S12, ``csrc/posterior_sections.cu``) is K1 with its
sections switched off at compile time, one instantiation per variant:

  full        K1's posterior on the block-per-walker body (it must agree with
              ``log_posterior_fused``, one warp per walker, to rel 5e-5)
  no_phot     contrast and photometry magnitudes skipped
  no_priors   the Av(d) and Gaussian priors and the bounds skipped
  no_epilogue both of the above skipped (W construction + spectrum only)
  no_spectrum the spectrum block skipped
  spec_only   the spectrum block alone, W stubbed to a 2-op broadcast
  empty       near-empty body, the full input signature: the launch floor

A section switched off yields the JAX variant's stub: zeros for the band
chi^2 or the log-prior, ``sum(Wcomb)`` for the spectrum chi^2, ``Wk = teff *
1e-4`` for the blend weights.  ``spec_only``'s stub W weights all 56 grid
points, so its row build reads every D row where production reads at most 8:
it prices a dense build, not the production one.  The scope is the JAX
variant's: a binary with a fitted parallax and the distance bounds, no radius
prior and a non-zero spectrum weight.

Each variant is timed with CUDA events at the production shape: 32,768
walkers on the bench target, nd = 1792, dials (14, 3, 2).

    python -m mcmc_spec_tpu_torch.scripts.ablate_fused_sections
"""
from __future__ import annotations

import dataclasses

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NWALK = 32768
ND = 1792
NCHECK = 512
FULL_RTOL = 5e-5  # full against K1, which sums in another order
DIALS = dict(median_iters=14, matmul_passes=3, recip_newton=2)
# (phot, priors, spectrum, W) per variant, in the order of the JAX script and the
# kernel's variant ids
VARIANTS = {
    "full": (True, True, True, True),
    "no_phot": (False, True, True, True),
    "no_priors": (True, False, True, True),
    "no_epilogue": (False, False, True, True),
    "no_spectrum": (True, True, False, True),
    "spec_only": (False, False, True, False),
    "empty": (False, False, False, False),
}
_F32 = torch.float32


def check_scope(tgt, kernel="posterior_sections") -> None:
    """The JAX variant's branch of the posterior, or ``ValueError`` naming ``kernel``."""
    bad = [why for why, off in (("nspec != 2", tgt.nspec != 2),
                                ("no fitted parallax", not tgt.fit_plx),
                                ("no distance bounds", not tgt.dist_fit),
                                ("a radius prior", tgt.rad_prior),
                                ("spectrum weight 0", tgt.spectrum_weight == 0.0)) if off]
    if bad:
        raise ValueError(f"{kernel} covers a binary with a fitted parallax, distance bounds, "
                         "no radius prior and a spectrum: this target has " + ", ".join(bad))


def _variant(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(
            f"posterior_sections: unknown variant {variant!r} (one of {list(VARIANTS)})")
    return list(VARIANTS).index(variant)


def posterior_sections_reference(p, tgt, variant):
    """Plain PyTorch version of ``posterior_sections``: ``ck._posterior_plain`` with the
    variant's sections switched off ([B] f32)."""
    _variant(variant)
    check_scope(tgt)
    iters, _, recip = ck.resolve_dials(tgt)
    t = ck.kernel_tables(tgt)
    p = p.to(device=tgt.device, dtype=_F32)
    return ck._posterior_plain(p, tgt, t, t["scal"][0], t["scal"][1], t["scal"][2],
                               tgt.spectrum_weight * ck._chi2_weight(tgt), iters, recip,
                               sections=VARIANTS[variant])


def posterior_sections(p, tgt, variant):
    """S12: the fused posterior of walkers ``p`` [B, ndim] with the sections of
    ``variant`` switched off ([B] f32); ``full`` is ``log_posterior_fused``."""
    vid = _variant(variant)
    check_scope(tgt)
    ck.resolve_dials(tgt)
    if p.device.type == "cpu":
        return posterior_sections_reference(p, tgt, variant)
    ck._require_cuda(p, "posterior_sections")
    out, args = ck.posterior_launch_args(p, tgt, "posterior_sections")
    if args:
        ck._launch("posterior_sections_launch", "posterior_sections", *args, vid,
                   ck._stream(p.device))
    return out


def main(device="cuda", nwalk=NWALK, nd=ND, grid_step=1.0):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    tgt, truth = build_bench_target(_F32, device=dev, nd=nd, grid_step=grid_step)
    tgt = dataclasses.replace(tgt, **DIALS)
    coords = init_walker_batch(tgt, truth, nwalk)
    check = coords[:NCHECK]
    real = ck.log_posterior_fused(check, tgt)

    results = {}
    for name in VARIANTS:
        got = posterior_sections(check, tgt, name)
        if name == "full":
            # the JAX script's comparison: the same -inf support, rel 5e-5 on the rest
            fin = torch.isfinite(real)
            same = bool(torch.equal(fin, torch.isfinite(got)))
            g, r = got[fin].double(), real[fin].double()
            rel = float(((g - r).abs() / r.abs().clamp(min=1e-9)).max()) if len(r) else 0.0
            if not same or rel >= FULL_RTOL:
                raise RuntimeError(f"full variant differs from log_posterior_fused: support "
                                   f"identical {same}, max rel {rel:.2e}")
            print(f"full-variant sanity vs the production kernel: max rel {rel:.2e} on "
                  f"{check.shape[0]} walkers", flush=True)
        elif torch.allclose(got, real, equal_nan=True):
            raise RuntimeError(f"variant {name} computes the same values as the full kernel")
        dt = time_fn(lambda name=name: posterior_sections(coords, tgt, name))
        results[name] = dt * 1e3
        print(f"  {name:>12}: {dt * 1e3:.4f} ms/call ({nwalk / dt / 1e6:.2f}M evals/s)",
              flush=True)

    f = results["full"]
    print("\nattribution (vs full):")
    for name, ms in results.items():
        if name != "full":
            note = (f" (stub W: all {tgt.D.shape[0] * tgt.D.shape[1]} D rows per point)"
                    if name == "spec_only" else "")
            print(f"  {name:>12}: saves {f - ms:+.4f} ms ({100 * (f - ms) / f:+.1f}%){note}")
    return results


if __name__ == "__main__":
    main()
