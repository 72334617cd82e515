"""The exact row median with 16-bit coarse passes, on the card (counterpart of
``scripts/try_packed_median.py``).

The exact median runs 31 count passes over the int32 bit patterns.  The first
16 only ever look at the high 16 bits, so ``median_packed`` (S7,
``csrc/median_packed.cu``) runs them on a packed copy of the high halves, two
keys to a 32-bit word, then 16 fine passes over the full patterns inside the
bucket found.  It reads half the words in each coarse pass and keeps each
pass's two barriers, so its time against ``base31`` (S11 ``median_only`` at 31
passes, K1's median) says whether a median pass costs its shared-memory sweep
or its barriers.  Both must equal ``np.median`` bit for bit.

The rows are [32,768, 1792] f32 |N(0, 1)| * 1e-14 from a numpy seed (torch
cannot reproduce ``jax.random``'s draws).

    python -m mcmc_spec_tpu_torch.scripts.try_packed_median
"""
from __future__ import annotations

import numpy as np
import torch

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import vpu_microbench as vb
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

NW = 32768
ND = 1792
COARSE_PASSES = FINE_PASSES = 16
HIGH_INF = 0x7F80  # the high half of +inf's pattern
_F32 = torch.float32


def synthetic_rows(nw=NW, nd=ND, seed=0) -> np.ndarray:
    """[nw, nd] f32 rows of |N(0, 1)| * 1e-14."""
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal((nw, nd), dtype=np.float32)) * np.float32(1e-14)


def median_packed_reference(x):
    """Plain PyTorch version of ``median_packed``: [NW, 1] f32, the arithmetic of the JAX
    body (its bf16 sign-of-difference count is count(high <= mid) in integers)."""
    nw, nd = x.shape
    r1 = (nd + 1) // 2
    mi = x.contiguous().view(torch.int32)
    zeros = torch.zeros((nw, 1), dtype=torch.int32, device=x.device)
    h = ck._row_order_stat_bits(mi >> 16, r1, COARSE_PASSES, lo=zeros,
                                hi=torch.full_like(zeros, HIGH_INF))
    v1 = ck._row_order_stat_bits(mi, r1, FINE_PASSES, lo=h << 16, hi=(h << 16) | 0xFFFF)
    return ck._refine_upper(x, mi, v1, 0 if nd % 2 else r1 + 1)


def median_packed(x):
    """S7: np.median of each non-negative f32 row of ``x`` [NW, nd], exact, by 16
    coarse passes over the packed high halves and 16 fine passes ([NW, 1] f32)."""
    if x.dim() != 2 or x.dtype != _F32:
        raise ValueError(f"median_packed: a 2-D float32 tensor expected, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.device.type == "cpu":
        return median_packed_reference(x)
    ck._require_cuda(x, "median_packed")
    nw, nd = x.shape
    if 4 * nd + 4 * ((nd + 1) // 2) > ck.ROW_SMEM_BYTES:
        raise ValueError(f"median_packed: a row of {nd} floats and its packed keys do not fit "
                         "shared memory")
    ck._check(x, "x", x.device, (nw, nd))
    out = torch.empty((nw, 1), dtype=_F32, device=x.device)
    if nw * nd == 0:
        return out
    ck._launch("median_packed_launch", "median_packed", x.data_ptr(), out.data_ptr(), nw, nd,
               ck._stream(x.device))
    return out


def main(device="cuda", nw=NW, nd=ND):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    rows = synthetic_rows(nw, nd)
    x = torch.from_numpy(rows).to(dev)
    ref = np.median(rows, axis=1)
    fns = {"base31": lambda: vb.median_only(x, 31), "16-bit coarse 16+16": lambda: median_packed(x)}
    for name, fn in fns.items():
        got = fn().cpu().numpy()[:, 0]
        ok = bool(np.array_equal(got, ref))
        print(f"[exact] {name}: np.median-identical = {ok}", flush=True)
        if not ok:
            bad = np.flatnonzero(got != ref)
            raise RuntimeError(f"{name} differs from np.median on {bad.size} rows, first "
                               f"{bad[:5]}: got {got[bad[:5]]}, want {ref[bad[:5]]}")
    t = {name: time_fn(fn) for name, fn in fns.items()}
    t_base, t_packed = t["base31"], t["16-bit coarse 16+16"]
    print(f"[time] base 31-pass:           {t_base * 1e3:.4f} ms")
    print(f"[time] 16-bit coarse 16+16:    {t_packed * 1e3:.4f} ms  ({t_base / t_packed:.3f}x)",
          flush=True)
    return {"base31": t_base, "packed": t_packed}


if __name__ == "__main__":
    main()
