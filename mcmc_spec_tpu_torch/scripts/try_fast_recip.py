"""The receipt for the ``recip_newton`` dial on the card (counterpart of
``scripts/try_fast_recip.py``).

The continuum renorm divides twice per point: ``frac = data / model`` and
``data_renorm = data / fitted``.  The dial replaces both by ``data *`` the
integer-magic reciprocal seed refined by 1 or 2 Newton steps.  Whether that
beats the card's IEEE division is a measurement: ``spectrum_recip`` (S4,
``csrc/spectrum_recip.cu``) is the whole spectrum block (model product,
extinction, 16-pass midpoint median, renorm, chi^2) with only the two
divides on the dial, so the difference is measured in context.  ``noexp``
swaps the extinction exp for a same-shape linear term (wrong numbers, one exp
fewer) to price the exp.

The synthetic inputs are the JAX script's, from the same
``np.random.RandomState(0)`` draws: 32,768 walkers of dense Dirichlet blend
weights over 56 grid points, so the model-row build reads all 56 rows of D
per point where a production walker reads at most 8.

    python -m mcmc_spec_tpu_torch.scripts.try_fast_recip
"""
from __future__ import annotations

import numpy as np
import torch

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NW = 32768
NO = 56
ND = 1792
ITERS = 16
_F32 = torch.float32


def synthetic_arrays(nw=NW, no=NO, nd=ND) -> tuple:
    """(medd, Wc, av, D, kd, data, ie, Vp, VT) as float32 numpy arrays, the JAX
    script's draws: medd [1, 1], Wc [nw, no], av [nw, 1], D [no, nd], kd, data and
    ie [1, nd], Vp and VT [3, nd]."""
    rng = np.random.RandomState(0)
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    Wc = f32(rng.dirichlet(np.ones(no), nw) * 2.0)
    av = f32(rng.uniform(0.0, 0.5, nw)).reshape(nw, 1)
    D = f32(rng.uniform(0.5, 2.0, (no, nd)))
    kd = f32(rng.uniform(0.3, 1.2, nd)).reshape(1, nd)
    data = f32(rng.uniform(0.5, 2.0, nd)).reshape(1, nd)
    ie = f32(1.0 / rng.uniform(0.005, 0.02, nd)).reshape(1, nd)
    # deg-2 Vandermonde on a scaled domain, like target packing
    xs = np.linspace(-1.0, 1.0, nd)
    V = np.stack([np.ones(nd), xs, xs * xs], axis=1)
    Vp = f32(np.linalg.pinv(V))
    VT = f32(V.T)
    medd = f32(np.median(data)).reshape(1, 1)
    return medd, Wc, av, D, kd, data, ie, Vp, VT


def synthetic_inputs(device, nw=NW, no=NO, nd=ND) -> tuple:
    """``synthetic_arrays`` as contiguous float32 tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device).contiguous()
                 for a in synthetic_arrays(nw, no, nd))


def spectrum_recip_reference(medd, Wc, av, D, kd, data, ie, Vp, VT, recip, noexp=False,
                             iters=ITERS):
    """Plain PyTorch version of ``spectrum_recip`` (``ck._spectrum_block``): [NW, 1] f32."""
    return ck._spectrum_block(Wc, av, D, kd[0], data[0], ie[0], Vp, VT, medd[0, 0], iters,
                              renorm=True, recip=recip, noexp=noexp)


def spectrum_recip(medd, Wc, av, D, kd, data, ie, Vp, VT, recip, noexp=False, iters=ITERS):
    """S4: the spectrum chi^2 with its renorm divides exact (``recip`` = 0) or by the
    magic-seed reciprocal with ``recip`` Newton steps; [NW, 1] f32.

    The operands in the JAX script's layout (``synthetic_arrays``).  At
    ``recip`` = 0 without ``noexp`` it is K3's arithmetic (``spectrum_chi2``, renorm
    on) on the block-per-walker body: the same model row and median, the sums in
    another order.
    """
    if recip < 0 or not 1 <= iters <= 31:
        raise ValueError(f"spectrum_recip: recip >= 0 and 1 <= iters <= 31 (got {recip}, {iters})")
    if Wc.device.type == "cpu":
        return spectrum_recip_reference(medd, Wc, av, D, kd, data, ie, Vp, VT, recip, noexp,
                                        iters)
    ck._require_cuda(Wc, "spectrum_recip")
    dev = Wc.device
    nw, no = Wc.shape
    nd = D.shape[1]
    if 4 * (nd + no) > ck.ROW_SMEM_BYTES:
        raise ValueError(f"spectrum_recip: a row of {nd} floats does not fit shared memory")
    for t, name, shape in ((medd, "medd", (1, 1)), (Wc, "Wc", (nw, no)), (av, "av", (nw, 1)),
                           (D, "D", (no, nd)), (kd, "kd", (1, nd)), (data, "data", (1, nd)),
                           (ie, "ie", (1, nd)), (Vp, "Vp", (3, nd)), (VT, "VT", (3, nd))):
        ck._check(t, name, dev, shape)
    out = torch.empty((nw, 1), dtype=_F32, device=dev)
    if nw == 0:
        return out
    ck._launch("spectrum_recip_launch", "spectrum_recip", Wc.data_ptr(), av.data_ptr(),
               D.data_ptr(), kd.data_ptr(), data.data_ptr(), ie.data_ptr(), Vp.data_ptr(),
               VT.data_ptr(), medd.data_ptr(), out.data_ptr(), nw, no, nd, iters, recip,
               int(bool(noexp)), ck._stream(dev))
    return out


def max_rel_err(got, ref) -> float:
    """max |got - ref| / max(|ref|, 1e-12): the JAX script's chi^2 comparison."""
    got, ref = got.double().flatten(), ref.double().flatten()
    return float(((got - ref).abs() / ref.abs().clamp(min=1e-12)).max())


def main(device="cuda", nw=NW, nd=ND):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    args = synthetic_inputs(dev, nw=nw, nd=nd)
    out = {r: spectrum_recip(*args, recip=r) for r in (0, 2, 1)}
    rel2, rel1 = max_rel_err(out[2], out[0]), max_rel_err(out[1], out[0])
    print(f"[num] recip2 max rel chi2 err: {rel2:.3e}")
    print(f"[num] recip1 max rel chi2 err: {rel1:.3e}")

    t = {r: time_fn(lambda r=r: spectrum_recip(*args, recip=r)) for r in (0, 2, 1)}
    tx = time_fn(lambda: spectrum_recip(*args, recip=0, noexp=True))
    t0 = t[0]
    print(f"[time] divide baseline: {t0 * 1e3:.4f} ms")
    print(f"[time] recip 2-Newton:  {t[2] * 1e3:.4f} ms  ({t0 / t[2]:.3f}x)")
    print(f"[time] recip 1-Newton:  {t[1] * 1e3:.4f} ms  ({t0 / t[1]:.3f}x)")
    print(f"[time] exp->linear:     {tx * 1e3:.4f} ms  (exp marginal {(t0 - tx) * 1e3:+.4f} ms, "
          f"{(t0 - tx) / t0 * 100:.1f}% of kernel)")
    print(f"[info] baseline kernel evals/s: {nw / t0 / 1e6:.2f}M (spectrum-only; dense weights: "
          f"all {NO} D rows per point)")
    faster = "faster" if t[2] < t0 else "not faster"
    print(f"[receipt] on {describe(dev)}: the 2-Newton magic-seed reciprocal is {faster} than "
          f"IEEE division ({t[2] * 1e3:.4f} vs {t0 * 1e3:.4f} ms, {100 * (t[2] - t0) / t0:+.1f}%), "
          f"max rel chi2 err {rel2:.3e}")
    return {"rel": {1: rel1, 2: rel2}, "times": t, "noexp": tx}


if __name__ == "__main__":
    main()
