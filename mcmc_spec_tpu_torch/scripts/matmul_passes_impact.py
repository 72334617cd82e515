"""The ``matmul_passes`` dial's end-to-end posterior impact, on the card (counterpart
of ``scripts/matmul_passes_impact.py``).

The JAX package emulates the model's f32 product with 6 or 3 split-bf16
passes on the TPU's matrix unit; the port computes the full f32 product at
every value of the dial (``tests/test_torch_warp.py::test_matmul_passes_receipt``).
So the two chains, at ``matmul_passes`` 6 and 3, the shapes of
``fast_median_impact`` (2,048 walkers, 3,000 burn-in, 6,000 steps at thin 8,
the same walkers and generator) on K1, must be equal bit for bit: the script
prints whether they are, then the marginals' shifts as the JAX script does.

    python -m mcmc_spec_tpu_torch.scripts.matmul_passes_impact
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.fast_median_impact import (NBURN, NSTEPS, NWALK, print_shifts,
                                                             run_chain)
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

PASSES = (6, 3)


def main(device="cuda", nwalk=NWALK, nburn=NBURN, nsteps=NSTEPS, nd=1792, grid_step=1.0):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}", flush=True)
    t_start = time.perf_counter()
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step)
    ck.reset_launches()
    chains = {n: run_chain(dataclasses.replace(tgt, matmul_passes=n), truth, nwalk, nburn,
                           nsteps, label=f"passes={n}")
              for n in PASSES}
    same = bool(np.array_equal(chains[6], chains[3]))
    print(f"\nchains at matmul_passes 6 and 3 equal bit for bit: {same}")
    print(f"6-pass medians: {np.array2string(np.median(chains[6], axis=0), precision=4)}")
    print(f"6-pass sigmas:  {np.array2string(chains[6].std(axis=0), precision=4)}")
    shift, sratio = print_shifts("matmul_passes=3", chains[3], chains[6])
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    wall = time.perf_counter() - t_start
    print(f"[launches] {launches}; wall {wall:.1f} s", flush=True)
    return dict(same=same, shift=shift, sigma_ratio=sratio, launches=launches, wall_s=wall)


if __name__ == "__main__":
    main()
