"""K1's signature added to the trivial probe one ingredient at a time, on the
card (counterpart of ``scripts/dma_probe_bisect.py``).

``bisect_probe`` (S2, ``csrc/launch_probe.cu``) is S1 (``dma_probe``) at 32,768
walkers, nd = 1792 and 256 walkers a block, beside 6 broadcast [56, nd]
tables, with the ingredients of the fused posterior K1's signature that the
trivial kernel lacks:

* ``smem``: three scalars, passed by value as kernel arguments (the nearest
  counterpart of the Pallas SMEM operand); the kernel reads the first, or the
  third in the body variant, as the JAX body does;
* ``prefetch``: a scalar-prefetch grid spec with no scalars has no CUDA
  counterpart: the variant runs the ``base`` launch, so the table keeps its row;
* ``many``: 12 more [4, 56] tables, 19 operands in all;
* ``width6``: p of 6 columns (K1's ndim);
* ``body``: the empty-section op chain of the JAX script in f32, in its order:
  a [B, 56] blend-weight stub, its lane sum, the isnan/isfinite selects;
* ``all``: every ingredient together.

Each variant is timed eager (20 launches between CUDA events, the JAX script's
direct dispatch of 20 calls) and as a CUDA graph of 50 launches, per launch.
The inputs are the JAX script's: one ``RandomState(0)`` stream for p, the six
tables, the small tables and the scalars, in that order.

    python -m mcmc_spec_tpu_torch.scripts.dma_probe_bisect
"""
from __future__ import annotations

import numpy as np
import torch

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.dma_probe import (check_probe, row_sum_reference, table_args,
                                                   to_device)
from mcmc_spec_tpu_torch.scripts.timing import describe, graph_timer, resolve_device, timer

NW = 32768
NO = 56
ND = 1792
BLOCK = 256
VARIANTS = {
    "base": {},
    "smem": dict(use_smem=True),
    "prefetch": dict(use_prefetch=True),
    "many": dict(n_small=12),
    "width6": dict(pw=6),
    "body": dict(body_ops=True),
    "all": dict(use_smem=True, use_prefetch=True, n_small=12, pw=6, body_ops=True),
}
# the f32 constants of the op chain, as the Python floats meet an f32 array
_RSUN_CM = np.float32(6.957e10)
_PC_CM = np.float32(3.086e18)
_STUB_WEIGHT = np.float32(1e-4)
_F32 = torch.float32


def bisect_arrays(variant, nw=NW, nd=ND) -> tuple:
    """(p [nw, pw], tables, scal or None) as float32 numpy arrays, the JAX script's
    ``build`` draws: 6 [56, nd] tables then the [4, 56] ones; ``scal`` [1, 3] with
    ``smem``."""
    kw = VARIANTS[variant]
    rng = np.random.RandomState(0)
    f32 = lambda a: np.asarray(a, np.float32)
    p = f32(rng.randn(nw, kw.get("pw", 8)))
    tables = [f32(rng.randn(NO, nd)) for _ in range(6)]
    tables += [f32(rng.randn(4, NO)) for _ in range(kw.get("n_small", 0))]
    scal = f32(rng.rand(1, 3)) if kw.get("use_smem") else None
    return p, tables, scal


def bisect_inputs(dev, variant, nw=NW, nd=ND) -> tuple:
    """(p, tables, scal, body) of ``bisect_probe`` for a variant: tensors on ``dev``, the
    scalars as Python floats (they travel by value)."""
    p, tables, scal = bisect_arrays(variant, nw, nd)
    p, tables = to_device(dev, p, tables)
    scal = None if scal is None else tuple(float(x) for x in scal[0])
    return p, tables, scal, bool(VARIANTS[variant].get("body_ops"))


def bisect_probe_reference(p, tables, scal=None, body=False):
    """Plain PyTorch version of ``bisect_probe``: [nw] f32."""
    t00 = tables[0].reshape(-1)[0]
    if not body:
        s = row_sum_reference(p) + t00
        return s + (scal[0] if scal is not None else 0.0)
    # the f32 constants as Python floats (exact): a float32 tensor meets them in f32,
    # and no host-to-device copy breaks a CUDA graph capture
    r1 = p[:, 1]
    plx = p[:, 2] if p.shape[1] > 2 else r1
    base = r1 * float(_RSUN_CM) * plx / float(_PC_CM)
    base = base * base
    wk = p[:, 0] * float(_STUB_WEIGHT)
    wc = base * wk + wk
    s = wc
    for _ in range(NO - 1):
        s = s + wc
    s = s + t00
    if scal is not None:
        s = s + scal[2]
    ll = (-0.5 * s).masked_fill(torch.isnan(s), -np.inf)
    return 0.0 + ll  # lp = 0 is finite: lp + ll


def bisect_probe(p, tables, scal=None, body=False):
    """S2: the trivial probe with K1's ingredients: ``p`` [nw, pw] (pw >= 2) beside
    ``tables`` (1 to 20; the first is read), the three scalars ``scal`` (Python floats,
    by value; None: none), and with ``body`` the empty-section op chain, 256 walkers
    to a thread block ([nw] f32)."""
    if p.dim() != 2 or p.shape[1] < 2:
        raise ValueError(f"bisect_probe: p must be [nw, pw] with pw >= 2, got {tuple(p.shape)}")
    dev, nw = check_probe("bisect_probe", p, tables, p.shape[1], min_tables=1)
    if scal is not None and len(scal) != 3:
        raise ValueError(f"bisect_probe: three scalars expected, got {len(scal)}")
    if dev.type == "cpu":
        return bisect_probe_reference(p, tables, scal, body)
    out = torch.empty(nw, dtype=_F32, device=dev)
    if nw == 0:
        return out
    s0, _, s2 = scal if scal is not None else (0.0, 0.0, 0.0)
    ptrs, sizes, n, _keep = table_args(tables)
    ck._launch("bisect_probe_launch", "bisect_probe", p.data_ptr(), p.shape[1], ptrs, sizes, n,
               s0, s2, int(scal is not None), int(bool(body)), out.data_ptr(), nw, BLOCK,
               ck._stream(dev))
    return out


def bisect_bytes(nw, pw) -> int:
    """The bytes one call needs: p [nw, pw] read once, the output written once, and the
    one float of the first table that it reads (the scalars travel by value)."""
    return 4 * (nw * pw + 1 + nw)


def bisect_ops(nw, body) -> int:
    """Operations of one call: the row sum and two adds, or the op chain (the 56-lane
    sum, ~10 scalar operations and the selects) per walker."""
    return nw * (NO + 12 if body else 10)


def main(device="cuda", nw=NW, nd=ND):
    dev = resolve_device(device)
    eager_fn, graph_fn = timer(dev), graph_timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    res = {}
    for name in VARIANTS:
        p, tables, scal, body = bisect_inputs(dev, name, nw, nd)
        fn = lambda: bisect_probe(p, tables, scal, body)
        res[name] = (graph_fn(fn), eager_fn(fn))
        note = (" (no CUDA counterpart of a zero-scalar prefetch grid spec: the base launch)"
                if name == "prefetch" else "")
        print(f"  {name:>9}: eager {res[name][1] * 1e3:.5f} ms, graph {res[name][0] * 1e3:.5f} "
              f"ms per launch; {len(tables) + 1 + (scal is not None)} operands{note}", flush=True)
    if dev.type == "cuda":
        print(f"[launches] graph replays: {graph_fn.replayed} launches of bisect_probe outside "
              "its launch count", flush=True)
    res["replayed"] = graph_fn.replayed
    return res


if __name__ == "__main__":
    main()
