"""Fixed 31 passes against an early exit for the exact row median, on the card
(counterpart of ``scripts/try_whileloop_median.py``).

The exact median bisects the int32 bit pattern for 31 passes.  Most rows hold
a single distinct value in their bracket long before that.  ``median_adaptive``
(S9, ``csrc/median_adaptive.cu``) checks for it from pass 14 on, every third
pass, and stops; one block per row, so each row stops on its own.  ``fixed31``
is K1's median at 31 passes, S11 ``median_only`` (``vpu_microbench``).  Both
must equal ``np.median`` bit for bit; the script prints their times and the
mean number of bisection passes per row.

The rows are the JAX script's lognormal draws, 8,192 x 1792, from the same
``np.random.RandomState(0)``.

    python -m mcmc_spec_tpu_torch.scripts.try_whileloop_median
"""
from __future__ import annotations

import numpy as np
import torch

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import vpu_microbench as vb
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

B, ND, NBLOCKS = 512, 1792, 16  # the JAX script's block of rows, row width and grid
NW = B * NBLOCKS
FIRST_CHECK, CHECK_EVERY = 14, 3
_F32 = torch.float32


def synthetic_rows(nw=NW, nd=ND) -> np.ndarray:
    """The JAX script's rows ([nw, nd] f32): one lognormal row, scaled per row, with 1 %
    multiplicative noise, made non-negative."""
    rng = np.random.RandomState(0)
    base = np.abs(rng.lognormal(0.0, 1.0, size=nd)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, size=(nw, 1)).astype(np.float32)
    x = scales * base[None, :] * (1 + 0.01 * rng.randn(nw, nd)).astype(np.float32)
    return np.abs(x)


def _checks_before(passes: int) -> int:
    """Bracket checks made in the first ``passes`` bisection passes."""
    return sum(1 for k in range(passes) if k >= FIRST_CHECK and k % CHECK_EVERY == CHECK_EVERY - 1)


def sweeps_per_row(passes: torch.Tensor, nd: int) -> float:
    """Mean sweeps over the row: the bisection passes, the checks, the final min and
    repair count, and for an even row the refinement."""
    p = passes.to(torch.int64).cpu()
    checks = torch.tensor([_checks_before(k) for k in range(32)])[p]
    return float((p + checks + 2 + (nd % 2 == 0)).double().mean())


def median_adaptive_reference(x):
    """Plain PyTorch version of ``median_adaptive``: ([NW, 1] f32 medians, [NW] int32
    bisection passes per row).  Each row stops at its own first successful check."""
    nw, nd = x.shape
    r1 = (nd + 1) // 2
    mi = x.contiguous().view(torch.int32)
    inf_bits = torch.full((), ck._F32_INF_BITS, dtype=torch.int32, device=x.device)
    lo = torch.zeros((nw, 1), dtype=torch.int32, device=x.device)
    hi = torch.full((nw, 1), ck._F32_INF_BITS, dtype=torch.int32, device=x.device)
    active = torch.ones((nw, 1), dtype=torch.bool, device=x.device)
    passes = torch.zeros(nw, dtype=torch.int32, device=x.device)
    min_at_least = lambda lo: torch.where(mi >= lo, mi, inf_bits).min(dim=1, keepdim=True).values
    for k in range(31):
        mid = lo + ((hi - lo) >> 1)
        ge = (mi <= mid).sum(dim=1, keepdim=True) >= r1
        lo = torch.where(active & ~ge, mid + 1, lo)
        hi = torch.where(active & ge, mid, hi)
        passes += active[:, 0].to(torch.int32)
        if k >= FIRST_CHECK and k % CHECK_EVERY == CHECK_EVERY - 1:
            active = active & ~(min_at_least(lo) >= hi)
        if not bool(active.any()):
            break
    vmin = min_at_least(lo)
    v1 = torch.where((mi <= vmin).sum(dim=1, keepdim=True) >= r1, vmin, hi)
    return ck._refine_upper(x, mi, v1, 0 if nd % 2 else r1 + 1), passes


def median_adaptive(x):
    """S9: np.median of each non-negative f32 row of ``x`` [NW, nd], exact, with the
    early exit: ([NW, 1] f32, [NW] int32 bisection passes per row)."""
    if x.dim() != 2 or x.dtype != _F32:
        raise ValueError(f"median_adaptive: a 2-D float32 tensor expected, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.device.type == "cpu":
        return median_adaptive_reference(x)
    ck._require_cuda(x, "median_adaptive")
    nw, nd = x.shape
    if 4 * nd > ck.ROW_SMEM_BYTES:
        raise ValueError(f"median_adaptive: a row of {nd} floats does not fit shared memory")
    ck._check(x, "x", x.device, (nw, nd))
    out = torch.empty((nw, 1), dtype=_F32, device=x.device)
    passes = torch.empty(nw, dtype=torch.int32, device=x.device)
    if nw * nd == 0:
        return out, passes
    ck._launch("median_adaptive_launch", "median_adaptive", x.data_ptr(), out.data_ptr(),
               passes.data_ptr(), nw, nd, ck._stream(x.device))
    return out, passes


def main(device="cuda", nw=NW, nd=ND):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    rows = synthetic_rows(nw, nd)
    x = torch.from_numpy(rows).to(dev)
    ref = np.median(rows, axis=1).astype(np.float32)
    res = {}
    for name, fn in (("fixed31", lambda: vb.median_only(x, 31)),
                     ("adaptive", lambda: median_adaptive(x)[0])):
        got = fn().cpu().numpy()[:, 0]
        exact = bool(np.array_equal(got, ref))
        err = float(np.max(np.abs(got - ref) / np.abs(ref)))
        dt = time_fn(fn)
        res[name] = dt
        print(f"{name}: exact={exact} maxrelerr={err:.2e} time={dt * 1e3:.4f} ms", flush=True)
        if not exact:
            raise RuntimeError(f"{name} differs from np.median")
    passes = median_adaptive(x)[1]
    mean_passes = float(passes.double().mean())
    res.update(mean_passes=mean_passes, sweeps=sweeps_per_row(passes, nd))
    print(f"adaptive: {mean_passes:.2f} bisection passes per row on average (min "
          f"{int(passes.min())}, max {int(passes.max())}), {res['sweeps']:.2f} sweeps with the "
          f"checks and the finish, against {31 + (nd % 2 == 0)} for fixed31; "
          f"{100 * (res['fixed31'] - res['adaptive']) / res['fixed31']:+.1f}% time", flush=True)
    return res


if __name__ == "__main__":
    main()
