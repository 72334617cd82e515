"""Two walkers a warp in turn (counterpart of ``scripts/try_two_blocks.py``).

JAX's hypothesis: a fixed cost a grid program pays once, so one 512-row program
running the production body on two 256-row halves in turn should beat two
256-row programs.  The port's counterpart is S15 ``posterior_pair``
(``csrc/posterior_pair.cu``): K1 v2 with each warp evaluating two walkers in
turn on the same shared memory, so a block of ``w`` warps takes ``2 w``
walkers and the grid has half the blocks.  The variants, each bit for bit
K1's output at the production block (the parity check; JAX's was rel 1e-5), timed
with CUDA events at 32,768 walkers, nd = 1,792, production dials:

  k1_8    K1 at the production block (8 walkers, 8 warps)
  k1_4    K1 at 4 walkers a block (the control: half the block)
  pair_4  S15, 4 warps a block taking 8 walkers (K1's walkers a block, half the warps)
  pair_8  S15, 8 warps a block taking 16 walkers

    python -m mcmc_spec_tpu_torch.scripts.try_two_blocks
"""
from __future__ import annotations

import torch

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import ablate_matrix as am
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NWALK = 32768
NCHECK = 512 + 3  # an odd count: the last block's second turn is partly empty


def variants(default: int) -> dict:
    half = max(default // 2, 1)
    return {f"k1_{default}": (ck.log_posterior_fused, default),
            f"k1_{half}": (ck.log_posterior_fused, half),
            f"pair_{half}": (ck.posterior_pair, half),
            f"pair_{default}": (ck.posterior_pair, default)}


def main(device="cuda", nwalk=NWALK, nd=am.ND, grid_step=1.0):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    tgt, coords = am.prepare(dev, nwalk, nd, grid_step)
    nT, nG, nd = tgt.D.shape
    default = ck.walkers_per_block(nd, nT * nG, 1 + tgt.nspec)
    check = coords[:NCHECK]
    real = ck.log_posterior_fused(check, tgt)
    results = {}
    for name, (fn, w) in variants(default).items():
        got = fn(check, tgt, walkers_per_block=w)
        same = bool(torch.equal(got.view(torch.int32), real.view(torch.int32)))
        print(f"{name}: parity on {check.shape[0]} walkers: bit for bit K1 {same}", flush=True)
        if not same:
            raise RuntimeError(f"{name} differs from K1")
        results[name] = time_fn(lambda fn=fn, w=w: fn(coords, tgt, walkers_per_block=w)) * 1e3
        print(f"  {name:>8}: {results[name]:.4f} ms/call "
              f"({nwalk / results[name] * 1e-3:.2f}M evals/s)", flush=True)
    base = results[f"k1_{default}"]
    for name, ms in results.items():
        if name != f"k1_{default}":
            print(f"{name}: {ms - base:+.4f} ms vs k1_{default} ({100 * (ms - base) / base:+.1f}%)")
    return results


if __name__ == "__main__":
    main()
