"""The 2^4 section matrix of K1 timed by device time (counterpart of
``scripts/ablate_matrix_traced.py``).

The masks of ``ablate_matrix`` (S13 ``posterior_ablate``, checked as there),
each timed by its kernel's device time in a ``torch.profiler`` trace of 20
back-to-back launches (``op_table.trace_calls``; the mean over the launches
the trace holds), which leaves out the wrapper's host time that CUDA events
around a call also see.  It prints the
16-row table (device ms a launch, launches seen), the sum of the sections'
in-context marginals against full minus the all-stubbed base, and each
section's marginal device cost in each context of the other three, with the
inclusion-exclusion terms of ``ablate_matrix``.  On the CPU the trace holds no
device time: the rows say so and nothing is fitted.

    python -m mcmc_spec_tpu_torch.scripts.ablate_matrix_traced [--nspec 3]
"""
from __future__ import annotations

import json

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import ablate_matrix as am
from mcmc_spec_tpu_torch.scripts import op_table
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NWALK = am.NWALK
ND = am.ND
N_LAUNCHES = 20
KERNEL = "posterior_ablate_kernel"


def main(device="cuda", nwalk=NWALK, nd=ND, grid_step=1.0, nspec=2):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}; nspec {nspec}", flush=True)
    tgt, coords = am.prepare(dev, nwalk, nd, grid_step, nspec)
    am.check_masks(tgt, coords)
    t, rows = {}, {}
    for mask in am.MASKS:
        tab = op_table.trace_calls(lambda mask=mask: ck.posterior_ablate(coords, tgt, mask),
                                   n=N_LAUNCHES)
        n = op_table.launches(tab, KERNEL)
        ms = op_table.device_ms(tab, KERNEL) / n if n else None  # over the launches seen
        rows[mask] = {"mask(PRSW)": mask, "kernel_ms_device": ms, "kernel_calls": n,
                      "busy_share": tab["busy_share"]}
        print(json.dumps(rows[mask]), flush=True)
        if ms is not None:
            t[mask] = ms
    if len(t) < len(am.MASKS):
        print("device time not measured (no kernel in the trace): nothing fitted", flush=True)
        return {"rows": rows}
    marg_sum = sum(t["1111"] - t["1111"[:i] + "0" + "1111"[i + 1:]] for i in range(4))
    print(f"\nempty-body device floor t(0000): {t['0000']:.4f} ms; full kernel: "
          f"{t['1111']:.4f} ms; sum of the in-context marginals (each gate off from full): "
          f"{marg_sum:.4f} ms (full - base {t['1111'] - t['0000']:.4f} ms)", flush=True)
    terms, marg = am.report(t, unit="ms device")
    return {"rows": rows, "ms": t, "terms": terms, "marginal": marg}


if __name__ == "__main__":
    main(nspec=am.parse_nspec())
