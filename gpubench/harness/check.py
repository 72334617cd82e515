"""The comparison that decides ``correct``: the program's ensemble after the window
against the plain reference.

After the window has closed the reference evaluates every walker of the final state
and the proposals of the window's last evaluation, judges that half-step's accept and
reject update (``reference.sampler.update_mismatch``), with the draws reproduced from
the generator's state at the start of the chunk, and finds the walkers that did not
move in the whole last chunk, which a sound chunk of tens of stretch steps leaves
almost none of.  The numbers compared:

* ``lp_gap_median``: the median of |L_program - L_reference| over the log-posteriors the
  program holds for its walkers and those it gave the last proposals;
* ``outside_share``: the share of those that are outside: whose gap exceeds ``GATE``, or
  whose walker did not move in the last chunk, or whose last update the reference
  decides otherwise;
* ``nonfinite_mismatch``: walkers whose log-posterior is finite on one side only (an
  exact comparison: limit 0).

Each has its limit in the cell's file (``limits``); a run is correct when every number
is at or under its limit.
"""
from __future__ import annotations

import math

import torch

from gpubench.reference import posterior, sampler

NAMES = ("lp_gap_median", "outside_share", "nonfinite_mismatch")
GATE = 1e-3  # the largest sound gap of one log-posterior, absolute


def _gaps(lp_prog, lp_ref):
    fin_p, fin_r = torch.isfinite(lp_prog), torch.isfinite(lp_ref)
    both = fin_p & fin_r
    gap = torch.where(both, (lp_prog.double() - lp_ref.double()).abs(),
                      torch.zeros_like(lp_ref, dtype=torch.float64))
    gap = torch.where(fin_p != fin_r, torch.full_like(gap, math.inf), gap)
    return gap, int((fin_p != fin_r).sum())


def judge(out: dict, tables: list, dials: dict) -> dict:
    """The numbers of ``NAMES`` for the program's outputs ``out``: ``coords`` [ntgt, nw,
    ndim], ``log_prob`` [ntgt, nw], ``start`` (the walkers when the last chunk began,
    [ntgt, nw, ndim]), ``draws`` (z, idx, log_u of the last half-step of the second half,
    each [ntgt, nw - nw//2]) and ``last_eval``: the proposals and log-posteriors of the
    last evaluation ([ntgt, nw - nw//2, ndim], [ntgt, nw - nw//2]), None where the chunk
    evaluated nothing, which sets every walker of the second half wrong.  ``tables``:
    each target's reference tables."""
    iters, recip = dials["median_iters"], dials["recip_newton"]
    gaps, flagged, mismatch, n_update, n_unmoved = [], [], 0, 0, 0
    z, idx, log_u = out["draws"]
    for i, t in enumerate(tables):
        lp_fn = lambda x, t=t: posterior.log_posterior(x, t, iters, recip)
        coords, lp_prog = out["coords"][i], out["log_prob"][i]
        lp_ref = lp_fn(coords)
        dev = lp_ref.device
        flag = (coords == out["start"][i]).all(dim=1).to(dev)
        n_unmoved += int(flag.sum())
        gap, n_bad = _gaps(lp_prog.to(dev), lp_ref)
        gaps.append(gap)
        mismatch += n_bad
        nh = coords.shape[0] // 2
        extra = []
        wrong = torch.ones(coords.shape[0] - nh, dtype=torch.bool, device=dev)
        if out["last_eval"] is not None:
            proposal, lp_prop = (x[i] for x in out["last_eval"])
            wrong = sampler.update_mismatch(coords[:nh], coords[nh:], proposal, z[i],
                                            idx[i], log_u[i], lp_fn).to(dev)
            ref_prop = lp_fn(proposal)
            gap, n_bad = _gaps(lp_prop.to(dev), ref_prop)
            gaps.append(gap)
            mismatch += n_bad
            extra = [torch.zeros_like(gap, dtype=torch.bool)]
        n_update += int(wrong.sum())
        flag = flag | torch.cat([torch.zeros(nh, dtype=torch.bool, device=dev), wrong])
        flagged.append(torch.cat([flag, *extra]))
    gap, flagged = torch.cat(gaps), torch.cat(flagged)
    return {
        "lp_gap_median": float(gap.median()),
        "outside_share": float(((gap > GATE) | flagged).double().mean()),
        "nonfinite_mismatch": mismatch,
        "_judged": int(gap.numel()),
        "_gap_max": float(gap.max()),
        "_updates_wrong": n_update,
        "_unmoved": n_unmoved,
    }


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NAMES)
