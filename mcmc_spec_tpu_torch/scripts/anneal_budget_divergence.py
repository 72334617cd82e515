"""The annealer's attempt budget under the reference's and the port's accounting
(counterpart of ``scripts/anneal_budget_divergence.py``).

The reference's out-of-bounds branch burns ``total_n`` once per reflection
increment (+100 K a temperature step, +0.1 mag Av, +0.01 R, 1 % parallax
steps; mft6.py:1070-1103), possibly dozens per out-of-bounds proposal, where
the annealer (``inference.anneal``) burns exactly one: reflection is
rejection either way.  The two accountings differ only in how fast they reach
the runaway cap ``total_n < 50 * steps`` (mft6.py:966), so they diverge only
if the cap binds.

This replays the koi2298-shaped schedule (150 walkers, steps = 400, the
coarse and fine sigmas and bounds of mft6.py:952-982) on the host with both
accountings on one proposal stream, scoring with ``optimizer_chi2_batch`` on
the bench target at nd = 256 on the CPU, and reports the out-of-bounds rate,
the reference's burn per out-of-bounds proposal, each accounting's budget per
walker, whether the cap binds, and the real (scored) proposals each admits.

    python -m mcmc_spec_tpu_torch.scripts.anneal_budget_divergence
"""
from __future__ import annotations

import numpy as np
import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target
from mcmc_spec_tpu_torch.inference.anneal import init_walkers
from mcmc_spec_tpu_torch.inference.batched import optimizer_chi2_batch

NWALK, STEPS = 150, 400  # param_koi2298.txt nwalk/nstep
CAP = 50 * STEPS


def reference_oob_burn(t, av, r1, rr, plx, tmin, tmax):
    """total_n burned by the reference's reflection loops for one OOB
    proposal (mft6.py:1070-1103), including the initial +1."""
    burn = 1
    t = list(t)
    # temperatures low / high
    for i in range(len(t)):
        while t[i] < tmin:
            t[i] += 100.0
            burn += 1
    for i in range(len(t)):
        while t[i] > tmax:
            t[i] -= 100.0
            burn += 1
    while t[0] < t[1]:
        t[1] -= 100.0
        burn += 1
    while av < 0:
        av += 0.1
        burn += 1
    for r in (r1, rr):
        while r < 0.05:
            r += 0.01
            burn += 1
    while plx > 1.0 / 100.0:
        plx -= 0.01 * abs(plx)
        burn += 1
    while plx < 1.0 / 3000.0:
        plx += 0.01 * abs(plx)
        burn += 1
    return burn


def main(nwalk=NWALK, steps=STEPS, nd=256):
    cap = 50 * steps
    tgt, truth = build_bench_target(torch.float32, device="cpu", nd=nd, grid_step=8.0)
    tmin, tmax = float(tgt.tmin), float(tgt.tmax)
    p0 = init_walkers(tgt, nwalk, float(truth[-1]), 0.05e-3,
                      torch.Generator().manual_seed(0)).double().numpy()

    def chi_fn(p, rs):
        rs = None if rs is None else torch.as_tensor(rs, dtype=torch.float32)
        return optimizer_chi2_batch(torch.as_tensor(p, dtype=torch.float32), tgt,
                                    rad_sigma=rs).double().numpy()

    rng = np.random.RandomState(1)
    params = p0.copy()
    chi = chi_fn(params, None)
    n = np.zeros(nwalk, int)
    tot_ours, tot_ref = np.zeros(nwalk, int), np.zeros(nwalk, int)
    real_ours, real_ref = np.zeros(nwalk, int), np.zeros(nwalk, int)
    oob_events, oob_burns = 0, []

    sig_c = np.concatenate([np.full((nwalk, 2), 250.0), np.full((nwalk, 1), 0.05),
                            0.1 * p0[:, 3:5], 0.02 * p0[:, 5:6]], axis=1)
    sig_f = np.concatenate([np.full((nwalk, 2), 20.0), np.full((nwalk, 1), 0.01),
                            0.05 * p0[:, 3:5], 0.005 * p0[:, 5:6]], axis=1)

    it = 0
    while True:
        active_ours = (n < steps) & (tot_ours < cap)
        active_ref = (n < steps) & (tot_ref < cap)
        active = active_ours | active_ref
        if not active.any() or it > cap:
            break
        it += 1
        fine = n > steps // 2
        sig = np.where(fine[:, None], sig_f, sig_c)
        prop = params + rng.normal(size=params.shape) * sig
        ok = ((prop[:, 0] > tmin) & (prop[:, 0] < tmax)
              & (prop[:, 1] > tmin) & (prop[:, 1] < tmax)
              & (prop[:, 2] >= 0)
              & (prop[:, 3] >= 0.05) & (prop[:, 3] <= 1.5)
              & (prop[:, 4] > 0.05) & (prop[:, 4] < 1.0)
              & (prop[:, 5] > 1.0 / 3000.0) & (prop[:, 5] < 0.1))
        cn = chi_fn(prop, sig[:, 3:5])
        better = ok & (cn < chi) & active
        params = np.where(better[:, None], prop, params)
        chi = np.where(better, cn, chi)
        n = np.where(active & ok, n + 1, n)
        n = np.where(better, np.where(fine, steps // 2 + 1, 0), n)
        # budget accounting
        tot_ours = np.where(active_ours, tot_ours + 1, tot_ours)
        real_ours = np.where(active_ours & ok, real_ours + 1, real_ours)
        real_ref = np.where(active_ref & ok, real_ref + 1, real_ref)
        for w in np.where(active_ref)[0]:
            if ok[w]:
                tot_ref[w] += 1
            else:
                burn = reference_oob_burn(prop[w, :2], prop[w, 2], prop[w, 3], prop[w, 4],
                                          prop[w, 5], tmin, tmax)
                tot_ref[w] += burn
                oob_events += 1
                oob_burns.append(burn)

    oob_burns = np.asarray(oob_burns) if oob_burns else np.zeros(1)
    print(f"schedule: nwalk={nwalk} steps={steps} cap={cap}")
    print(f"OOB events: {oob_events} "
          f"({oob_events / max(tot_ours.sum(), 1):.4%} of attempts)")
    print(f"reference burn per OOB event: mean {oob_burns.mean():.2f}, "
          f"max {int(oob_burns.max())}")
    print(f"total budget burned  ours: mean {tot_ours.mean():.0f}  "
          f"max {tot_ours.max()}   reference: mean {tot_ref.mean():.0f}  "
          f"max {tot_ref.max()}")
    print(f"walkers hitting the 50*steps cap  ours: "
          f"{int((tot_ours >= cap).sum())}   reference: "
          f"{int((tot_ref >= cap).sum())}")
    print(f"real (chi-evaluated) proposals admitted  ours: mean "
          f"{real_ours.mean():.0f}   reference: mean {real_ref.mean():.0f}  "
          f"(diff {real_ours.mean() - real_ref.mean():+.1f}, "
          f"{(real_ours.mean() - real_ref.mean()) / max(real_ref.mean(), 1):.3%})")
    return dict(oob_events=oob_events, oob_burns=oob_burns, tot_ours=tot_ours, tot_ref=tot_ref,
                real_ours=real_ours, real_ref=real_ref, iterations=it)


if __name__ == "__main__":
    main()
