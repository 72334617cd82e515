"""The fleet spectrum kernel K4 at each block size, and with its median ranks frozen
(counterpart of ``scripts/try_fleet_block.py``).

The fleet of config 5 (nine bench targets stacked, 4,096 walkers each, the
production dials).  JAX swept the Pallas block (128, 256, 512 walkers); a block of
K4 holds one walker a warp, so the port sweeps the walkers a block from 1 to
``WALKERS_MAX`` (each that its shared memory admits; the production choice is
``walkers_per_block``), the outputs bit for bit the same, each timed with CUDA
events.  Then the variant the JAX script's docstring prices: S14 ``fleet_sections``
``scalar_rank``, whose median ranks are compile-time constants instead of the
per-target table (every target here has the same nd, so its output is K4's bit
for bit), timed in turns with ``full``.

    python -m mcmc_spec_tpu_torch.scripts.try_fleet_block
"""
from __future__ import annotations

import dataclasses
import json

import torch

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer
from mcmc_spec_tpu_torch.scripts.trace_fleet_step import NTGT, NWALK, build_fleet, fleet_wcomb

DIALS = dict(median_iters=14, matmul_passes=3, recip_newton=2)


def fitting_blocks(nd: int, NO: int, weight_rows: int) -> list:
    """The walkers-per-block counts whose shared memory a block admits."""
    per = ck.warp_smem_bytes(nd, NO, weight_rows)
    return [w for w in range(1, ck.WALKERS_MAX + 1) if w * per <= ck.ROW_SMEM_BYTES]


def main(device="cuda", ntgt=NTGT, nwalk=NWALK, nd=1792, grid_step=1.0):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}; {ntgt} targets x {nwalk} walkers, nd={nd}", flush=True)
    fleet, coords, _ = build_fleet(dev, ntgt, nwalk, nd, grid_step)
    fleet = dataclasses.replace(fleet, **DIALS)
    W, av = fleet_wcomb(coords, fleet)
    NO = W.shape[-1]
    default = ck.walkers_per_block(nd, NO, 0)
    base = ck.spectrum_chi2_fleet(W, av, fleet)
    blocks = {}
    for w in fitting_blocks(nd, NO, 0):
        out = ck.spectrum_chi2_fleet(W, av, fleet, walkers_per_block=w)
        if not torch.equal(out.view(torch.int32), base.view(torch.int32)):
            raise RuntimeError(f"K4 at {w} walkers a block differs from the default block")
        ms = time_fn(lambda w=w: ck.spectrum_chi2_fleet(W, av, fleet, walkers_per_block=w)) * 1e3
        blocks[w] = ms
        print(json.dumps({"variant": f"walkers_per_block_{w}", "default": w == default,
                          "ms_per_call": round(ms, 4),
                          "evals_per_sec_M": round(ntgt * nwalk / ms * 1e-3, 2)}), flush=True)
    frozen = None
    if ck.FROZEN_ND == nd:
        out = ck.fleet_sections(W, av, fleet, "scalar_rank")
        if not torch.equal(out.view(torch.int32), base.view(torch.int32)):
            raise RuntimeError("S14 scalar_rank differs from K4")
        turns = {"full": [], "scalar_rank": []}
        for mode in ("full", "scalar_rank", "scalar_rank", "full"):
            turns[mode].append(time_fn(lambda mode=mode: ck.fleet_sections(W, av, fleet, mode)))
        frozen = {m: 1e3 * min(v) for m, v in turns.items()}
        print(json.dumps({"variant": "scalar_rank", "ms_per_call": round(frozen["scalar_rank"], 4),
                          "full_ms_per_call": round(frozen["full"], 4),
                          "bit_for_bit_K4": True}), flush=True)
    return {"blocks": blocks, "default": default, "frozen": frozen}


if __name__ == "__main__":
    main()
