"""The spectrum block in four program orders, on the card (counterpart of
``scripts/try_mxu_overlap.py``).

``spectrum_overlap`` (S5, ``csrc/spectrum_overlap.cu``) is K2 with renorm on,
a 16-pass midpoint median and the 2-Newton reciprocal (the JAX script's
dials), in four modes:

  baseline  one walker per block, row build then tail (S4 at recip 2);
  nomxu     the row is ``Wc[:, 0] * D[0]``: wrong numbers on purpose, a row
            that costs one multiply per point, so ``baseline - nomxu`` is the
            row build's marginal cost in context;
  stagger2  two walkers per block, both rows built before both tails;
  stagger4  four walkers per block, row k+1 built before the tail of row k.

``stagger2`` and ``stagger4`` must equal ``baseline`` bit for bit.  The modes
run twice: on the JAX script's synthetic inputs (32,768 walkers of dense
Dirichlet weights over 56 grid points, the draws of ``try_fast_recip``), whose
row build reads all 56 D rows per point, and on the bench target's production
blend weights (at most 8 non-zero per walker), whose row build is the one K1
runs.

    python -m mcmc_spec_tpu_torch.scripts.try_mxu_overlap
"""
from __future__ import annotations

import dataclasses

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference.batched import _forward_small
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import try_fast_recip as fr
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NW = 32768
ITERS = 16
RECIP = 2
MODES = ("baseline", "nomxu", "stagger2", "stagger4")
PROD = dict(median_iters=14, matmul_passes=3, recip_newton=2)
_F32 = torch.float32


def _mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"spectrum_overlap: unknown mode {mode!r} (one of {list(MODES)})")
    return MODES.index(mode)


def production_inputs(tgt, coords) -> tuple:
    """(medd, Wc, av, D, kd, data, ie, Vp, VT) in the script's layout from a target's
    kernel tables and the production blend weights of walkers ``coords``."""
    t = ck.kernel_tables(tgt)
    Wc = _forward_small(coords, tgt)[4].to(_F32).contiguous()
    av = coords[:, tgt.nspec : tgt.nspec + 1].to(_F32).contiguous()
    row = lambda v: v.reshape(1, -1).contiguous()
    return (t["scal"][2].reshape(1, 1).contiguous(), Wc, av, t["D"], row(t["kd"]),
            row(t["data"]), row(t["inv_err"]), t["VpinvT"], t["VT"])


def spectrum_overlap_reference(medd, Wc, av, D, kd, data, ie, Vp, VT, mode, iters=ITERS,
                               recip=RECIP):
    """Plain PyTorch version of ``spectrum_overlap``: [NW, 1] f32.  Every mode but
    ``nomxu`` is the spectrum block of ``try_fast_recip`` (``ck._spectrum_block``);
    ``nomxu`` runs it on the one-row product ``Wc[:, :1] @ D[:1]``."""
    if _mode(mode) == MODES.index("nomxu"):
        Wc, D = Wc[:, :1].contiguous(), D[:1].contiguous()
    return fr.spectrum_recip_reference(medd, Wc, av, D, kd, data, ie, Vp, VT, recip, iters=iters)


def spectrum_overlap(medd, Wc, av, D, kd, data, ie, Vp, VT, mode, iters=ITERS, recip=RECIP):
    """S5: the spectrum chi^2 of walkers ``Wc`` [NW, NO] in program order ``mode``
    ([NW, 1] f32); the operands in the layout of ``try_fast_recip.synthetic_arrays``."""
    mid = _mode(mode)
    if recip < 0 or not 1 <= iters <= 31:
        raise ValueError(f"spectrum_overlap: recip >= 0 and 1 <= iters <= 31 (got {recip}, "
                         f"{iters})")
    if Wc.device.type == "cpu":
        return spectrum_overlap_reference(medd, Wc, av, D, kd, data, ie, Vp, VT, mode, iters,
                                          recip)
    ck._require_cuda(Wc, "spectrum_overlap")
    dev = Wc.device
    nw, no = Wc.shape
    nd = D.shape[1]
    if 4 * 4 * (nd + no) > ck.ROW_SMEM_BYTES:
        raise ValueError(f"spectrum_overlap: four rows of {nd} floats do not fit shared memory")
    for t, name, shape in ((medd, "medd", (1, 1)), (Wc, "Wc", (nw, no)), (av, "av", (nw, 1)),
                           (D, "D", (no, nd)), (kd, "kd", (1, nd)), (data, "data", (1, nd)),
                           (ie, "ie", (1, nd)), (Vp, "Vp", (3, nd)), (VT, "VT", (3, nd))):
        ck._check(t, name, dev, shape)
    out = torch.empty((nw, 1), dtype=_F32, device=dev)
    if nw == 0:
        return out
    ck._launch("spectrum_overlap_launch", "spectrum_overlap", Wc.data_ptr(), av.data_ptr(),
               D.data_ptr(), kd.data_ptr(), data.data_ptr(), ie.data_ptr(), Vp.data_ptr(),
               VT.data_ptr(), medd.data_ptr(), out.data_ptr(), nw, no, nd, iters, recip, mid,
               ck._stream(dev))
    return out


def _run_modes(label, args, time_fn):
    """Check stagger2/4 against baseline bit for bit, time the four modes, print."""
    base = spectrum_overlap(*args, mode="baseline")
    for m in ("stagger2", "stagger4"):
        same = bool(torch.equal(spectrum_overlap(*args, mode=m).view(torch.int32),
                                base.view(torch.int32)))
        print(f"[num {label}] {m} bit-identical to baseline: {same}", flush=True)
        if not same:
            raise RuntimeError(f"{m} differs from baseline ({label})")
    t = {m: time_fn(lambda m=m: spectrum_overlap(*args, mode=m)) for m in MODES}
    for m in MODES:
        print(f"[time {label}] {m:9s}: {t[m] * 1e3:.4f} ms  ({t['baseline'] / t[m]:.3f}x)")
    marg = t["baseline"] - t["nomxu"]
    print(f"[info {label}] row-build marginal (baseline - nomxu): {marg * 1e3:+.4f} ms "
          f"({marg / t['baseline'] * 100:.1f}% of the kernel)", flush=True)
    return t


def main(device="cuda", nw=NW, nd=fr.ND, grid_step=1.0):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    res = {"synthetic": _run_modes("synthetic, dense weights",
                                   fr.synthetic_inputs(dev, nw=nw, nd=nd), time_fn)}
    tgt, truth = build_bench_target(_F32, device=dev, nd=nd, grid_step=grid_step)
    tgt = dataclasses.replace(tgt, **PROD)
    args = production_inputs(tgt, init_walker_batch(tgt, truth, nw))
    nz = float((args[1] != 0).sum(dim=1).double().mean())
    res["production"] = _run_modes(f"production weights, {nz:.1f} of {args[1].shape[1]} "
                                   "non-zero", args, time_fn)
    return res


if __name__ == "__main__":
    main()
