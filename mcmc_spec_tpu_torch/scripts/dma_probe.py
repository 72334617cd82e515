"""The launch cost of a trivial kernel beside broadcast tables, on the card
(counterpart of ``scripts/dma_probe.py``).

The fused posterior K1 spends a fixed cost per walker block that its compute
does not explain (PERF.md).  ``trivial_probe`` (S1, ``csrc/launch_probe.cu``)
computes ``out[w] = sum(p[w, :8]) + tab0[0, 0]`` for 32,768 walkers beside 0, 1,
3 or 6 broadcast [56, nd] tables, ``walkers_per_cta`` walkers to a thread block
of 256 threads.  On the TPU every grid step copied its blocks; here the tables
are pointers in a struct passed by value, and CUDA copies nothing a kernel
does not read, so the tables cost nothing by construction.  What is left is
the launch and the block count:

* [A] the time against the table count and width at 256 walkers a block;
* [B] the time against the walkers per block with 6 tables at nd = 1792,
  from one walker a block (K1's shape: 32,768 blocks) and 32 (the 32-walker
  tiles of S8) to 2,048.

Each is timed two ways: ``graph``, the JAX probe's counterpart of its one
dispatch of 50 calls, is a CUDA graph of 50 launches replayed and timed with
CUDA events, per launch: the device's cost without the host.  ``eager`` is 20
launches back to back between CUDA events: it includes the host's launch path
through Python and ctypes, which is longer than the kernel.  The inputs are the
JAX script's: ``RandomState(0)`` for p, ``RandomState(i + 1)`` for table i.

    python -m mcmc_spec_tpu_torch.scripts.dma_probe
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, graph_timer, resolve_device, timer

NW = 32768
NO = 56
PW = 8
BLOCK = 256
ND_SWEEP = (896, 1792, 3584)
NTAB_SWEEP = (0, 1, 3, 6)
BLOCK_SWEEP = (1, 32, 128, 256, 512, 1024, 2048)
MAX_TABLES = 20  # kMaxProbeTables of csrc/launch_probe.cu
_F32 = torch.float32


def trivial_arrays(nd, ntab, nw=NW) -> tuple:
    """(p [nw, 8], [ntab tables [56, nd]]) as float32 numpy arrays, the JAX script's draws."""
    p = np.asarray(np.random.RandomState(0).randn(nw, PW), np.float32)
    tables = [np.asarray(np.random.RandomState(i + 1).randn(NO, nd), np.float32)
              for i in range(ntab)]
    return p, tables


def to_device(dev, p, tables) -> tuple:
    """Numpy ``p`` and ``tables`` as contiguous float32 tensors on ``dev``."""
    return (torch.from_numpy(p).to(dev).contiguous(),
            [torch.from_numpy(t).to(dev).contiguous() for t in tables])


def row_sum_reference(p):
    """sum_k p[:, k] in column order ([nw] f32), the probes' row sum."""
    s = p[:, 0]
    for k in range(1, p.shape[1]):
        s = s + p[:, k]
    return s


def check_probe(name, p, tables, pw, min_tables=0) -> tuple:
    """Validate a probe's operands; returns (device, nw).  ``p`` is a contiguous
    float32 [nw, pw] tensor, ``tables`` a list of ``min_tables`` to 20 non-empty
    contiguous float32 tensors on its device."""
    if p.dim() != 2 or p.shape[1] != pw or p.dtype != _F32:
        raise ValueError(f"{name}: p must be a float32 [nw, {pw}] tensor, got "
                         f"{tuple(p.shape)} {p.dtype}")
    if not min_tables <= len(tables) <= MAX_TABLES:
        raise ValueError(f"{name}: {min_tables} to {MAX_TABLES} tables expected, got "
                         f"{len(tables)}")
    for k, t in enumerate(tables):
        if t.device != p.device or t.dtype != _F32 or t.numel() < 1 or not t.is_contiguous():
            raise ValueError(f"{name}: table {k} must be a non-empty contiguous float32 tensor "
                             f"on {p.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if p.device.type != "cpu":
        ck._require_cuda(p, name)
        ck._check(p, "p", p.device, (p.shape[0], pw))
    return p.device, p.shape[0]


def table_args(tables) -> tuple:
    """(pointer array, size array, count, arrays to keep alive) of the launch functions:
    the tables' device pointers and element counts as C arrays."""
    n = len(tables)
    ptrs = (ctypes.c_void_p * max(n, 1))(*(t.data_ptr() for t in tables))
    sizes = (ctypes.c_int * max(n, 1))(*(t.numel() for t in tables))
    return ctypes.addressof(ptrs), ctypes.addressof(sizes), n, (ptrs, sizes)


def trivial_probe_reference(p, tables):
    """Plain PyTorch version of ``trivial_probe``: [nw] f32."""
    s = row_sum_reference(p)
    return s + tables[0].reshape(-1)[0] if tables else s + 0.0


def trivial_probe(p, tables, walkers_per_cta=BLOCK):
    """S1: ``sum(p[w, :8]) + tables[0][0, 0]`` (no table: + 0) for each walker ``w`` of
    ``p`` [nw, 8], ``walkers_per_cta`` walkers to a thread block ([nw] f32)."""
    dev, nw = check_probe("trivial_probe", p, tables, PW)
    if walkers_per_cta < 1:
        raise ValueError(f"trivial_probe: walkers_per_cta must be >= 1, got {walkers_per_cta}")
    if dev.type == "cpu":
        return trivial_probe_reference(p, tables)
    out = torch.empty(nw, dtype=_F32, device=dev)
    if nw == 0:
        return out
    ptrs, sizes, n, _keep = table_args(tables)
    ck._launch("trivial_probe_launch", "trivial_probe", p.data_ptr(), ptrs, sizes, n,
               out.data_ptr(), nw, int(walkers_per_cta), ck._stream(dev))
    return out


def trivial_bytes(nw, ntab) -> int:
    """The bytes one call needs: p read once, the output written once, and the one float
    of the first table that it reads (it reads nothing else of the tables)."""
    return 4 * (nw * PW + min(ntab, 1) + nw)


def main(device="cuda", nw=NW, nd_sweep=ND_SWEEP, block_sweep=BLOCK_SWEEP):
    dev = resolve_device(device)
    eager_fn, graph_fn = timer(dev), graph_timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    res = {}

    def probe(nd, block, ntab):
        p, tables = to_device(dev, *trivial_arrays(nd, ntab, nw))
        fn = lambda: trivial_probe(p, tables, block)
        return graph_fn(fn), eager_fn(fn)

    fmt = lambda t: f"graph {t[0] * 1e3:.5f} ms, eager {t[1] * 1e3:.5f} ms"
    print(f"[A] trivial kernel, {BLOCK} walkers a block ({-(-nw // BLOCK)} blocks), vs #tables "
          "x nd (per launch):", flush=True)
    for nd in nd_sweep:
        row = []
        for ntab in NTAB_SWEEP:
            res[("A", nd, ntab)] = probe(nd, BLOCK, ntab)
            row.append(f"ntab={ntab}: {fmt(res[('A', nd, ntab)])}")
        print(f"    nd={nd}: " + "; ".join(row), flush=True)

    nd_b = nd_sweep[len(nd_sweep) // 2]
    print(f"[B] trivial kernel, 6 tables nd={nd_b}, vs walkers a block:", flush=True)
    for block in block_sweep:
        res[("B", block)] = probe(nd_b, block, 6)
        print(f"    block={block} ({-(-nw // block)} blocks): {fmt(res[('B', block)])}",
              flush=True)

    replays = graph_fn.replayed
    p, _ = to_device(dev, *trivial_arrays(nd_b, 0, nw))
    lib = lambda: torch.sum(p, 1)
    res["library"] = (graph_fn(lib), eager_fn(lib))
    print(f"[library] torch.sum(p, 1), the whole function at ntab=0: {fmt(res['library'])}",
          flush=True)
    print(f"\nbytes one call needs: {trivial_bytes(nw, 0) / 1e6:.3f} MB without tables, "
          f"{trivial_bytes(nw, 6) / 1e6:.3f} MB with 6 (it reads 4 B of them); a per-block "
          f"copy of the 6 tables at nd={nd_b} and {BLOCK} walkers a block would move "
          f"{6 * NO * nd_b * 4 * (-(-nw // BLOCK)) / 1e6:.0f} MB", flush=True)
    if dev.type == "cuda":
        print(f"[launches] graph replays: {replays} launches of trivial_probe outside its "
              "launch count", flush=True)
    res["replayed"] = replays
    return res


if __name__ == "__main__":
    main()
