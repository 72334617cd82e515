"""Device traces of back-to-back fused-posterior launches (counterpart of
``scripts/trace_fused_call.py``).

For nd = 896, 1,792 and 3,584 (the bench target, 32,768 walkers, production
dials) it traces 20 launches of K1 v2 (``log_posterior_fused``) and 20 of S13's
``empty`` variant, K1's launch with no body (the launch floor behind the same
signature, grid and shared memory; the empty body the JAX script's docstring,
``:9-10``, sets beside the production kernel), prints each op table and the
device time a launch (the mean over the launches the trace holds), and the
walkers a block and an SM that the shared memory admits at each nd.  Then it
fits K1's device time as ``a + b * nd`` between each pair of neighbouring nd:
``a`` is the nd-independent floor of K1 v2 where the residency does not change.

    python -m mcmc_spec_tpu_torch.scripts.trace_fused_call
"""
from __future__ import annotations

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import ablate_matrix as am
from mcmc_spec_tpu_torch.scripts import op_table
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NWALK = 32768
NDS = (896, 1792, 3584)
N_LAUNCHES = 20


def trace_one(tag, fn, kernel):
    """Device ms a launch of ``kernel`` over ``N_LAUNCHES`` calls of ``fn``, or None."""
    tab = op_table.trace_calls(fn, n=N_LAUNCHES)
    op_table.print_table(tab, f"{tag}: {N_LAUNCHES} launches", per=N_LAUNCHES)
    n = op_table.launches(tab, kernel)
    ms = op_table.device_ms(tab, kernel) / n if n else None
    print(f"    => {'not measured' if ms is None else f'{ms:.4f} ms'} a launch device time "
          f"({n} launches of {kernel} in the trace)", flush=True)
    return ms


def residency(nd: int, NO: int, nspec: int) -> tuple:
    """(walkers a block, walkers an SM) of K1 at ``nd``: the blocks an SM's shared memory
    holds, one warp a walker, each block with its tile buffers (v3)."""
    wpb, stage = ck.staged_block(nd, NO, 1 + nspec)
    block = ck.staged_smem_bytes(nd, NO, 1 + nspec, wpb, stage) + ck.BLOCK_RESERVED_BYTES
    return wpb, wpb * (ck.SM_SMEM_BYTES // block)


def main(device="cuda", nwalk=NWALK, nds=NDS, grid_step=1.0):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}", flush=True)
    rows = {}
    for nd in nds:
        tgt, coords = am.prepare(dev, nwalk, nd, grid_step)
        nT, nG, _ = tgt.D.shape
        wpb, per_sm = residency(nd, nT * nG, tgt.nspec)
        print(f"[nd={nd}] {wpb} walkers a block, {per_sm} walkers (warps) an SM by shared memory",
              flush=True)
        rows[nd] = {
            "full": trace_one(f"K1 nd={nd}", lambda: ck.log_posterior_fused(coords, tgt),
                              "log_posterior_fused_kernel"),
            "empty": trace_one(f"S13 empty nd={nd}",
                               lambda: ck.posterior_ablate(coords, tgt, "empty"),
                               "posterior_empty_kernel"),
            "walkers_per_sm": per_sm}
    full = [(nd, r["full"]) for nd, r in rows.items() if r["full"] is not None]
    fits = []
    for (n0, t0), (n1, t1) in zip(full, full[1:]):
        b = (t1 - t0) / (n1 - n0)
        fits.append({"nd": (n0, n1), "a_ms": t0 - b * n0, "b_ms_per_point": b})
        print(f"K1 v2 between nd = {n0} and {n1}: {t0 - b * n0:+.4f} ms + {b * 1e3:.4f} us x nd "
              f"(walkers an SM {rows[n0]['walkers_per_sm']} and {rows[n1]['walkers_per_sm']})",
              flush=True)
    if full:
        print("the launch floor (S13 empty): "
              + ", ".join(f"{r['empty']:.4f} ms at nd={nd}" for nd, r in rows.items()
                          if r["empty"] is not None), flush=True)
    return {"rows": rows, "fits": fits}


if __name__ == "__main__":
    main()
