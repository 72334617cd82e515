"""The fast median's posterior shift on the large-nd lane, on the card (counterpart of
``scripts/segmented_median_bound_tpu.py``).

The segmented lane (K6-K9) honours the same median dial as K1, and the
tempering argument does not depend on the lane; this measures the shift at the
lane's own scale.  1,024 walkers on the bench target at nd = 65,536
(``grid_step=8``, the ``largend`` cell) are equilibrated for 400 steps at the
production dials, then the same coordinates are scored at 14 and at 31 passes:
dL = L_fast - L_exact over the walkers, everything downstream of the median
(the renorm included) in the number.  It prints the JAX script's JSON keys.

    python -m mcmc_spec_tpu_torch.scripts.segmented_median_bound

``main(device="cpu", ...)`` runs the plain versions at the sizes given; the
lane is taken only for CUDA float32 walkers, so a CPU run takes the
composition unless ``batched._on_cuda_f32`` is patched.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target
from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.ops.spec_segmented import LARGE_ND
from mcmc_spec_tpu_torch.scripts.median_tempering_bound_cpu import equilibrate
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NWALK = 1024
NBURN = 400
ND = 65536
FAST_ITERS = 14


def shift(tgt, eq, iters=FAST_ITERS):
    """(L_iters, L_31): float64 log-posteriors of ``eq`` on ``tgt`` at ``iters`` and at
    31 median passes, the other dials as packed."""
    return tuple(log_posterior_batch(eq, dataclasses.replace(tgt, median_iters=k))
                 .double().cpu().numpy() for k in (iters, 31))


def main(device="cuda", nwalk=NWALK, nburn=NBURN, nd=ND, grid_step=8.0):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}", flush=True)
    t0 = time.perf_counter()
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step)
    ck.reset_launches()
    # equilibrate at the production dials (the fast median on the renorm path)
    eq = equilibrate(tgt, truth, nwalk, nburn)
    L_fast, L_ex = shift(tgt, eq)
    fin = np.isfinite(L_fast) & np.isfinite(L_ex)
    dL = L_fast[fin] - L_ex[fin]
    lanes = {k: v for k, v in ck.LAUNCHES.items() if v}
    out = {
        "metric": "segmented_fast_median_posterior_shift",
        "nd": nd, "walkers_finite": int(fin.sum()), "nburn": nburn,
        "iters": FAST_ITERS,
        "dials": [int(tgt.median_iters), int(tgt.matmul_passes), int(tgt.recip_newton)],
        "lane": nd > LARGE_ND,
        "dL_std_sigma": round(float(np.std(dL)), 4),
        "dL_max_abs": round(float(np.max(np.abs(dL))), 4),
        "dL_mean": round(float(np.mean(dL)), 4),
        "L_exact_spread_std": round(float(np.std(L_ex[fin])), 2),
    }
    print(f"[launches] {lanes}; wall {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(out), flush=True)
    return dict(out, dL_std=float(np.std(dL)), launches=lanes,
                wall_s=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
