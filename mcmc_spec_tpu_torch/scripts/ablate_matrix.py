"""The full 2^4 section matrix of the fused posterior K1 on the card
(counterpart of ``scripts/ablate_matrix.py``).

S13 ``posterior_ablate`` (``csrc/posterior_ablate.cu``) is K1 with each
combination of four sections stubbed at compile time, as
``scripts/ablate_fused_sections.py:variant_kernel`` stubs them: the contrast and
photometry magnitudes (P), the priors and bounds (R), the spectrum block (S) and
the blend-weight construction (W).  A mask is written ``PRSW``: ``1111`` is K1,
``0000`` every section stubbed.  Every mask is checked on 512 walkers (``1111``
bit for bit K1, every other mask different from it, the JAX script's
per-variant assertions) and timed with CUDA events at the production shape:
32,768 walkers on the bench target, nd = 1,792, dials (14, 3, 2): the binary, or the
triple (``--nspec 3``: the bench target's third star, 12 D rows a walker).

Then the inclusion-exclusion fit over the 4-bit lattice (its Moebius transform,
exact for 16 points): ``t(mask) = sum over the subsets T of the mask's sections
of c_T``, ``c_{}`` the all-stubbed base, ``c_P`` ... each section's own cost,
``c_PS`` ... each pair's interaction, up to ``c_PRSW``; and each section's
marginal cost in each context of the other three.  The W stub weights every grid
point, so wherever the spectrum is on its row build reads all 56 D rows where
production reads at most 8: a mask without W prices a dense build.  The script
prints the production list's length beside it: the mean and largest count of
non-zero blend weights a walker (the D rows K1 reads for it), and the mean count of
distinct D rows a block of K1's walkers holds (U, the rows K1 stages once a block)
with the share of the walkers' D-row reads that are staged rows (the offline
counterpart of the staging counter, ``rows_staged / rows_read``).

    python -m mcmc_spec_tpu_torch.scripts.ablate_matrix [--nspec 3]
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference.batched import _forward_small
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NWALK = 32768
ND = 1792
NCHECK = 512
DIALS = dict(median_iters=14, matmul_passes=3, recip_newton=2)
GATES = ("phot", "priors", "spectrum", "W")
MASKS = ck.ABLATE_MASKS


def prepare(dev, nwalk=NWALK, nd=ND, grid_step=1.0, nspec=2):
    """(target at the production dials, walkers) on ``dev``: the binary bench target, or
    its triple at ``nspec`` 3."""
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step,
                                    nspec=nspec)
    tgt = dataclasses.replace(tgt, **DIALS)
    return tgt, init_walker_batch(tgt, truth, nwalk)


def check_masks(tgt, coords, ncheck=NCHECK) -> None:
    """``1111`` bit for bit K1 and every other mask different from it, on the first
    ``ncheck`` walkers; raises ``RuntimeError`` otherwise."""
    check = coords[:ncheck]
    real = ck.log_posterior_fused(check, tgt)
    for mask in MASKS:
        got = ck.posterior_ablate(check, tgt, mask)
        if mask == "1111":
            if not torch.equal(got.view(torch.int32), real.view(torch.int32)):
                raise RuntimeError("mask 1111 differs from log_posterior_fused")
        elif torch.allclose(got, real, equal_nan=True):
            raise RuntimeError(f"mask {mask} computes the same values as K1")
    print(f"masks checked on {check.shape[0]} walkers: 1111 bit for bit K1, the other 15 "
          "differ from it", flush=True)


def row_list(tgt, coords, wpb=None) -> tuple:
    """(mean, largest, union, share) on the walkers ``coords`` (any state): the mean and
    largest count of non-zero blend weights a walker, the length of the compact list
    over which K1 builds its model row, the D rows it reads; the mean count of distinct
    grid rows a block of ``wpb`` walkers holds (U, the D rows K1 stages once a block;
    ``ck.staged_block``'s walkers a block where None), the walkers in K1's order with the
    last block's missing warps repeating the last walker, as the kernel's do; and the sum
    of U over the sum of the lists (``rows_staged / rows_read``)."""
    nz = _forward_small(coords, tgt)[4] != 0
    B, NO = nz.shape
    n = nz.sum(dim=1).float()
    if wpb is None:
        wpb = ck.staged_block(tgt.D.shape[-1], NO, 1 + tgt.nspec)[0]
    pad = -B % wpb
    blocks = torch.cat([nz, nz[-1:].expand(pad, NO)]).view(-1, wpb, NO).any(dim=1).sum(dim=1)
    return (float(n.mean()), int(n.max()), float(blocks.float().mean()),
            float(blocks.sum()) / max(float(n.sum()), 1.0))


def _subsets(mask: str):
    """The masks whose sections are a subset of ``mask``'s."""
    on = [i for i, c in enumerate(mask) if c == "1"]
    for bits in itertools.product((0, 1), repeat=len(on)):
        sub = ["0"] * len(mask)
        for i, b in zip(on, bits):
            sub[i] = "1" if b else "0"
        yield "".join(sub)


def moebius(t: dict) -> dict:
    """The inclusion-exclusion terms ``{mask: c}`` of the times ``t`` over the 16 masks:
    ``c_S = sum over T subset of S of (-1)^(|S| - |T|) t(T)``, so that ``t(S)`` is the
    sum of ``c_T`` over the subsets T of S."""
    return {m: sum((-1) ** (m.count("1") - s.count("1")) * t[s] for s in _subsets(m))
            for m in t}


def term_name(mask: str) -> str:
    """``c_{}`` (the base), ``c_P`` ... for the mask's sections."""
    letters = "".join(g for g, c in zip("PRSW", mask) if c == "1")
    return f"c_{{{letters}}}"


def marginals(t: dict) -> dict:
    """``{gate: {context: t(gate on) - t(gate off)}}``, the context the other three gates."""
    out = {}
    for i, g in enumerate(GATES):
        out[g] = {}
        for m in MASKS:
            if m[i] == "1":
                off = m[:i] + "0" + m[i + 1:]
                out[g][m[:i] + m[i + 1:]] = t[m] - t[off]
    return out


def report(t: dict, unit: str = "ms") -> tuple:
    """Print the base, the inclusion-exclusion terms and the marginal costs of ``t``;
    return (terms, marginals)."""
    terms, marg = moebius(t), marginals(t)
    print(f"\nall-stubbed base t(0000): {t['0000']:.4f} {unit}; full t(1111): {t['1111']:.4f} "
          f"{unit}", flush=True)
    print("inclusion-exclusion terms (t(mask) = sum of c over the subsets of its sections):")
    for m in sorted(terms, key=lambda m: (m.count("1"), m[::-1])):
        print(f"  {term_name(m):>9}: {terms[m]:+.4f} {unit}")
    for i, (g, rows) in enumerate(marg.items()):
        others = "PRSW"[:i] + "PRSW"[i + 1:]
        print(f"\nmarginal cost of {g} by context (the gates {others}):")
        for ctx, d in rows.items():
            print(f"  ctx={ctx}: {d:+.4f} {unit}")
    return terms, marg


def parse_nspec(argv=None) -> int:
    """The ``--nspec`` of the command line (2, the binary, where it is left out)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nspec", type=int, choices=ck.ABLATE_NSPECS, default=2)
    return ap.parse_args(argv).nspec


def main(device="cuda", nwalk=NWALK, nd=ND, grid_step=1.0, nspec=2):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}; nspec {nspec}", flush=True)
    tgt, coords = prepare(dev, nwalk, nd, grid_step, nspec)
    check_masks(tgt, coords)
    t = {}
    for mask in MASKS:
        t[mask] = time_fn(lambda mask=mask: ck.posterior_ablate(coords, tgt, mask)) * 1e3
        print(json.dumps({"mask(PRSW)": mask, "ms": round(t[mask], 4),
                          "evals_per_s_M": round(nwalk / t[mask] * 1e-3, 2)}), flush=True)
    terms, marg = report(t)
    mean, most, union, share = row_list(tgt, coords)
    print(f"\nproduction row list: {mean:.4f} non-zero blend weights a walker on average, "
          f"{most} at most, of {tgt.D.shape[0] * tgt.D.shape[1]} (the stubbed W weights all); "
          f"{union:.4f} distinct D rows a block of K1 on average, staged rows / rows read "
          f"{share:.4f}", flush=True)
    return {"ms": t, "terms": terms, "marginal": marg, "row_list": (mean, most, union, share)}


if __name__ == "__main__":
    main(nspec=parse_nspec())
