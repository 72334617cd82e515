"""Per-section cost ablation of the fused posterior K1 on the card
(counterpart of ``scripts/ablate_fused_sections.py``).

``posterior_sections`` runs the JAX script's seven variants on S13
``posterior_ablate`` (``csrc/posterior_ablate.cu``, K1 v2 with its sections
gated at compile time), each variant one of its masks (phot, priors,
spectrum, W) written ``PRSW``:

  full        1111  K1 itself, bit for bit ``log_posterior_fused``
  no_phot     0111  contrast and photometry magnitudes skipped
  no_priors   1011  the Av(d) and Gaussian priors and the bounds skipped
  no_epilogue 0011  both of the above skipped (W construction + spectrum only)
  no_spectrum 1101  the spectrum block skipped
  spec_only   0010  the spectrum block alone, W stubbed to a 2-op broadcast
  empty       0000  every section stubbed, the full input signature

A section switched off yields the JAX variant's stub: zeros for the band
chi^2 or the log-prior, ``sum(Wcomb)`` for the spectrum chi^2, ``Wk = teff *
1e-4`` for the blend weights.  ``spec_only``'s stub W weights all 56 grid
points, so its row build reads every D row where production reads at most 8:
it prices a dense build, not the production one.  The scope is the JAX
variant's: a binary with a fitted parallax and the distance bounds, no radius
prior and a non-zero spectrum weight.  ``scripts.ablate_matrix`` runs all 16
masks.

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
DIALS = dict(median_iters=14, matmul_passes=3, recip_newton=2)
# (phot, priors, spectrum, W) per variant, in the order of the JAX script
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


def _mask(variant: str) -> str:
    """The S13 mask ("PRSW") of ``variant``."""
    if variant not in VARIANTS:
        raise ValueError(
            f"posterior_sections: unknown variant {variant!r} (one of {list(VARIANTS)})")
    return "".join("1" if on else "0" for on in VARIANTS[variant])


def posterior_sections_reference(p, tgt, variant):
    """Plain PyTorch version of ``posterior_sections`` ([B] f32)."""
    mask = _mask(variant)
    ck.section_scope(tgt, "posterior_sections")
    return ck.posterior_ablate_reference(p, tgt, mask)


def posterior_sections(p, tgt, variant):
    """The fused posterior of walkers ``p`` [B, ndim] with the sections of ``variant``
    switched off ([B] f32), on S13; ``full`` is ``log_posterior_fused`` bit for bit."""
    mask = _mask(variant)
    ck.section_scope(tgt, "posterior_sections")
    return ck.posterior_ablate(p, tgt, mask)


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
            # S13's mask 1111 is K1's code: the same bits
            if not torch.equal(got.view(torch.int32), real.view(torch.int32)):
                raise RuntimeError("full variant differs from log_posterior_fused")
            print(f"full-variant sanity vs the production kernel: max rel 0 (bit for bit) "
                  f"on {check.shape[0]} walkers", flush=True)
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
