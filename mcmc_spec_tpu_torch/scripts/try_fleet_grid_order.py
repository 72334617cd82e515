"""The fleet spectrum chi^2 under two grid orders, on the card (counterpart of
``scripts/try_fleet_grid_order.py``).

The fleet kernel K4 (``ops.cuda_kernels.spectrum_chi2_fleet``) scores every
walker of a stacked fleet in one launch, one thread block per walker, in a
flat grid whose block ``b`` is walker ``b % nw`` of target ``b / nw``: a
target's walkers are neighbours, so its tables (D, 401 KB at nd = 1792) are
read by a run of blocks in flight together.  ``spectrum_chi2_fleet_2d`` (S6,
``csrc/fleet_grid_order.cu``) runs K4's body, unchanged, under an explicit
order:

* ``target_major``: a 2-D grid (walker, target), the JAX script's B, which on
  this card repeats K4's schedule;
* ``walker_major``: consecutive blocks alternate targets, so no run of
  neighbouring blocks shares a target's tables.

Both must equal K4 bit for bit; their times against K4's say whether a
target's tables have to stay hot across its walker blocks.  The script
prints, as the JAX one does: [A] K4, [B] both orders with ``|A - B|max``, [C]
the composed fleet posterior (``inference.fleet.log_posterior_fleet``, K4 and
the composition), [D] the fused posterior K1 on target 0 at the fleet's total
walker count.  The fleet is nine bench targets (seeds 0-8) of 4,096 walkers at
the dials (14, 3, 2).

    python -m mcmc_spec_tpu_torch.scripts.try_fleet_grid_order
"""
from __future__ import annotations

import dataclasses

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference.batched import _forward_small
from mcmc_spec_tpu_torch.inference.fleet import log_posterior_fleet, stack_targets, target_views
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NTGT = 9
NW = 4096
DIALS = dict(median_iters=14, matmul_passes=3, recip_newton=2)
ORDERS = {"target_major": 0, "walker_major": 1}
_F32 = torch.float32


# The order is a schedule and changes no arithmetic: S6's plain version is K4's.
spectrum_chi2_fleet_2d_reference = ck.spectrum_chi2_fleet_reference


def spectrum_chi2_fleet_2d(Wcomb, av, fleet, order="target_major"):
    """S6: K4 (``Wcomb`` [ntgt, nw, NO], ``av`` [ntgt, nw] on the stacked ``fleet``) with
    its blocks in ``order`` (``target_major`` or ``walker_major``): [ntgt, nw] f32."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}: use one of {list(ORDERS)}")
    iters, _, recip = ck.resolve_dials(fleet)
    if Wcomb.device.type == "cpu":
        return ck.spectrum_chi2_fleet_reference(Wcomb, av, fleet)
    ck._require_cuda(Wcomb, "spectrum_chi2_fleet_2d")
    dev = Wcomb.device
    t = ck.fleet_kernel_tables(fleet)
    ntgt, nw, NO = Wcomb.shape
    nd = t["D"].shape[2]
    Wcomb, av = Wcomb.contiguous(), av.contiguous()
    for x, name, shape in ((Wcomb, "Wcomb", (ntgt, nw, NO)), (av, "av", (ntgt, nw)),
                           (t["D"], "D", (ntgt, NO, nd)), (t["kd"], "kd", (ntgt, nd)),
                           (t["data"], "data", (ntgt, nd)), (t["inv_err"], "inv_err", (ntgt, nd)),
                           (t["VpinvT"], "VpinvT", (ntgt, 3, nd)), (t["VT"], "VT", (ntgt, 3, nd)),
                           (t["scal"], "scal", (ntgt, 5))):
        ck._check(x, name, dev, shape)
    ck._check(t["ranks"], "ranks", dev, (ntgt, 2), torch.int32)
    out = torch.empty((ntgt, nw), dtype=_F32, device=dev)
    if ntgt * nw == 0:
        return out
    ck._launch("fleet_grid_order_launch", "spectrum_chi2_fleet_2d",
               Wcomb.data_ptr(), av.data_ptr(), t["D"].data_ptr(), t["kd"].data_ptr(),
               t["data"].data_ptr(), t["inv_err"].data_ptr(), t["VpinvT"].data_ptr(),
               t["VT"].data_ptr(), t["scal"].data_ptr(), t["ranks"].data_ptr(), out.data_ptr(),
               ntgt, nw, NO, nd, iters, recip, ORDERS[order], ck._stream(dev))
    return out


def fleet_inputs(dev, ntgt=NTGT, nw=NW, nd=1792, grid_step=1.0):
    """(fleet, unpadded targets, walkers [ntgt, nw, ndim], Wcomb, av, truth): ``ntgt`` bench
    targets of seeds 0.. at the dials (14, 3, 2), stacked, with ``nw`` walkers each (seed
    ``s`` for target ``s``) and their blend weights, as the JAX script builds them."""
    singles, truth = [], None
    for s in range(ntgt):
        t, truth = build_bench_target(_F32, device=dev, nd=nd, grid_step=grid_step, seed=s)
        singles.append(dataclasses.replace(t, **DIALS))
    fleet = stack_targets(singles)
    P = torch.stack([init_walker_batch(fleet, truth, nw, seed=s) for s in range(ntgt)])
    Wcomb = torch.stack([_forward_small(p, v)[4] for p, v in zip(P, target_views(fleet))])
    return fleet, singles, P, Wcomb, P[..., fleet.nspec].contiguous(), truth


def main(device="cuda", ntgt=NTGT, nw=NW, nd=1792, grid_step=1.0):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    fleet, singles, P, Wcomb, av, truth = fleet_inputs(dev, ntgt, nw, nd, grid_step)
    n = ntgt * nw
    rate = lambda t: f"{n / t / 1e6:.2f}M walker-evals/s"

    tA = time_fn(lambda: ck.spectrum_chi2_fleet(Wcomb, av, fleet))
    print(f"[A] flat grid (K4):          {tA * 1e3:.4f} ms ({rate(tA)})", flush=True)
    outA = ck.spectrum_chi2_fleet(Wcomb, av, fleet)
    res = {"A": tA}
    for order in ORDERS:
        outB = spectrum_chi2_fleet_2d(Wcomb, av, fleet, order)
        err = float((outA - outB).abs().nan_to_num(nan=0.0).max())
        same = bool(torch.equal(outA.view(torch.int32), outB.view(torch.int32)))
        tB = time_fn(lambda: spectrum_chi2_fleet_2d(Wcomb, av, fleet, order))
        print(f"[B] {order:<13} (S6):     {tB * 1e3:.4f} ms ({rate(tB)}), |A-B|max={err:.3g}, "
              f"bit-identical to K4: {same}, {100 * (tB - tA) / tA:+.2f}% vs K4", flush=True)
        if not same:
            raise RuntimeError(f"spectrum_chi2_fleet_2d {order} differs from K4 (|A-B|max "
                               f"{err:.3g})")
        res[order] = tB

    # host-bound (a Python loop over the targets around K4): fewer calls do
    tC = time_fn(lambda: log_posterior_fleet(P, fleet), n=5, warmup=1, reps=2)
    print(f"[C] composed fleet posterior: {tC * 1e3:.4f} ms ({n / tC / 1e6:.2f}M evals/s)",
          flush=True)
    tgt1 = singles[0]
    P1 = init_walker_batch(tgt1, truth, n)
    tD = time_fn(lambda: ck.log_posterior_fused(P1, tgt1))
    print(f"[D] single-target fused (K1) @ {n}: {tD * 1e3:.4f} ms ({n / tD / 1e6:.2f}M evals/s)",
          flush=True)
    res.update(C=tC, D=tD)
    return res


if __name__ == "__main__":
    main()
