"""The trivial probe with every table read, on the card (counterpart of
``scripts/dma_probe_bisect2.py``).

``bisect2_probe`` (S3, ``csrc/launch_probe.cu``): every thread block of the
trivial probe reads every table beside it, its first element (``peek``) or all
of it (``full``: a block-wide sum in a fixed order), and adds the total to each
walker's row sum, ``out[w] = sum(p[w, :8]) + sum over tables``.  The variants
of the JAX script, at 32,768 walkers, nd = 1792 and 256 walkers a block:

* ``peek6``: 6 [56, nd] tables, the first element of each;
* ``read6``: 6 [56, nd] tables, all of each;
* ``rows1``, ``rows3``: 6 [1, nd] or [3, nd] tables, all of each;
* ``tiny12``: 12 tables of a few dozen to a few hundred floats;
* ``realmix``: the fused posterior K1's operand multiset (``REALMIX``: one
  [56, nd] table and 16 small ones, 118,748 floats, 475 KB at nd = 1792).

``realmix`` runs again at one walker a block: K1's block count, 32,768 blocks
each re-reading the 475 KB, 15.6 GB a call from L2, which says how much of
K1's fixed cost the re-reading of its tables could be.  Each is timed eager (20
launches between CUDA events) and as a CUDA graph of 50 launches, per launch.
The inputs are the JAX script's: one ``RandomState(0)`` stream, p, then each
table times 1e-3.

    python -m mcmc_spec_tpu_torch.scripts.dma_probe_bisect2
"""
from __future__ import annotations

import numpy as np
import torch

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.dma_probe import (PW, check_probe, row_sum_reference,
                                                   table_args, to_device)
from mcmc_spec_tpu_torch.scripts.timing import describe, graph_timer, resolve_device, timer

NW = 32768
ND = 1792
BLOCK = 256
READS = ("peek", "full")
TINY12 = [(4, 220), (2, 220), (4, 2), (2, 2), (56, 2), (56, 6), (2, 2), (4, 6), (2, 6),
          (4, 56), (4, 56), (2, 6)]
_F32 = torch.float32


def realmix(nd=ND) -> list:
    """The fused posterior's broadcast table shapes at data width ``nd``."""
    return ([(56, nd)] + [(1, nd)] * 3 + [(3, nd)] * 2 + [(4, 56)] * 2
            + [(4, 220), (2, 220), (4, 2), (2, 2), (56, 2), (56, 6), (2, 2), (4, 6), (2, 6)])


REALMIX = realmix()


def variants(nd=ND) -> dict:
    """name -> (table shapes, read) of the JAX script's six variants at width ``nd``."""
    return {"peek6": ([(56, nd)] * 6, "peek"), "read6": ([(56, nd)] * 6, "full"),
            "rows1": ([(1, nd)] * 6, "full"), "rows3": ([(3, nd)] * 6, "full"),
            "tiny12": (TINY12, "full"), "realmix": (realmix(nd), "full")}


def bisect2_arrays(shapes, nw=NW) -> tuple:
    """(p [nw, 8], tables) as float32 numpy arrays, the JAX script's draws."""
    rng = np.random.RandomState(0)
    p = np.asarray(rng.randn(nw, PW), np.float32)
    return p, [np.asarray(rng.randn(*s) * 1e-3, np.float32) for s in shapes]


def table_total_reference(tables, read="full", device=None):
    """The table term of ``bisect2_probe``'s plain version: a 0-d f32 tensor."""
    acc = torch.zeros((), dtype=_F32, device=tables[0].device if tables else device)
    for t in tables:
        acc = acc + (t.reshape(-1)[0] if read == "peek" else t.sum())
    return acc


def bisect2_probe_reference(p, tables, read="full"):
    """Plain PyTorch version of ``bisect2_probe``: [nw] f32."""
    return row_sum_reference(p) + table_total_reference(tables, read, p.device)


def bisect2_probe(p, tables, read="full", walkers_per_cta=BLOCK):
    """S3: ``sum(p[w, :8])`` plus, over ``tables`` (0 to 20), each table's first element
    (``read="peek"``) or sum (``"full"``), read by every thread block, for each walker
    ``w`` of ``p`` [nw, 8], ``walkers_per_cta`` walkers to a block ([nw] f32)."""
    if read not in READS:
        raise ValueError(f"bisect2_probe: unknown read {read!r}: use one of {READS}")
    dev, nw = check_probe("bisect2_probe", p, tables, PW)
    if walkers_per_cta < 1:
        raise ValueError(f"bisect2_probe: walkers_per_cta must be >= 1, got {walkers_per_cta}")
    if dev.type == "cpu":
        return bisect2_probe_reference(p, tables, read)
    out = torch.empty(nw, dtype=_F32, device=dev)
    if nw == 0:
        return out
    ptrs, sizes, n, _keep = table_args(tables)
    ck._launch("bisect2_probe_launch", "bisect2_probe", p.data_ptr(), ptrs, sizes, n,
               int(read == "full"), out.data_ptr(), nw, int(walkers_per_cta), ck._stream(dev))
    return out


def table_floats(shapes) -> int:
    return sum(int(np.prod(s)) for s in shapes)


def bisect2_bytes(nw, shapes, read) -> int:
    """The bytes one call needs: p [nw, 8] read once, the output written once, and of
    each table its first float (``peek``) or all of it (``full``), once."""
    return 4 * (nw * PW + (len(shapes) if read == "peek" else table_floats(shapes)) + nw)


def main(device="cuda", nw=NW, nd=ND):
    dev = resolve_device(device)
    eager_fn, graph_fn = timer(dev), graph_timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    res = {}
    runs = [(name, shapes, read, BLOCK) for name, (shapes, read) in variants(nd).items()]
    runs.append(("realmix", realmix(nd), "full", 1))
    for name, shapes, read, block in runs:
        p, tables = to_device(dev, *bisect2_arrays(shapes, nw))
        fn = lambda: bisect2_probe(p, tables, read, block)
        res[(name, block)] = (graph_fn(fn), eager_fn(fn))
        nblk = -(-nw // block)
        reread = nblk * (4 * len(shapes) if read == "peek" else 4 * table_floats(shapes))
        print(f"  {name:>8} @ {block:>3} walkers a block ({nblk} blocks): eager "
              f"{res[(name, block)][1] * 1e3:.5f} ms, graph {res[(name, block)][0] * 1e3:.5f} ms "
              f"per launch; tables {4 * table_floats(shapes) / 1e3:.1f} KB, read "
              f"{reread / 1e9:.4g} GB a call", flush=True)
    if dev.type == "cuda":
        print(f"[launches] graph replays: {graph_fn.replayed} launches of bisect2_probe outside "
              "its launch count", flush=True)
    res["replayed"] = graph_fn.replayed
    return res


if __name__ == "__main__":
    main()
