"""The FP32 issue ceiling, the row median alone, and the median's share of the
fused posterior (counterpart of ``scripts/vpu_microbench.py``).

On the card (``python -m mcmc_spec_tpu_torch.scripts.vpu_microbench``):

  C. ``fma_chains`` (S10, ``csrc/microbench.cu``): 4 independent
     multiply chains of length ``k`` per element, then their sum -> the
     achievable FP32 operation rate.  At k = 24 the call's 470 MB of input
     and output take about as long as its multiplies, so larger k are run as
     well; the ceiling is read at the largest;
  D. ``median_only`` (S11, ``csrc/microbench.cu``): the radix row median
     alone at 31 and 15 passes -> the marginal cost of one pass;
  A/B. the fused posterior K1 at 31 and 20 median passes -> the median's
     share of a real evaluation;
  E. the same two-parameter model, with no refit, against K1 at 16 and 12
     passes and on the nd = 896 bench target.

Times are CUDA events (the least of 3 means over 20 calls).  The ceiling is
given in operations per second (a multiply or an add is one) and as a share
of one multiply per FP32 lane per clock, beside the card's name and power
limit.
"""
from __future__ import annotations

import dataclasses

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts.timing import describe, nvidia_smi, resolve_device, timer

NW = 32768
ND = 1792
ND_HALF = 896
CHAIN_K = (24, 96, 192)
CHAIN_LANES = 4  # the JAX script's call, vpu_ceiling(lanes=4)
FP32_LANES_PER_SM = 128  # Hopper: 128 FP32 lanes per SM
_F32 = torch.float32


# --- C: the FP32 ceiling (S10) ---------------------------------------------


def fma_chains_reference(x, k=24):
    """Plain PyTorch version of ``fma_chains``: [NW, nd] f32."""
    # c_j = float32(1 + 1e-7 (j+1)), rounded from double as the JAX script's are
    cs = [torch.tensor(1.0 + 1e-7 * (j + 1), dtype=_F32, device=x.device)
          for j in range(CHAIN_LANES)]
    ys = [x * c for c in cs]
    for _ in range(k - 1):
        ys = [y * c for y, c in zip(ys, cs)]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc


def fma_chains(x, k=24):
    """S10: ``CHAIN_LANES`` multiply chains of length ``k`` per element, summed ([NW, nd] f32)."""
    if k < 1:
        raise ValueError(f"fma_chains: k must be >= 1 (got {k})")
    if x.device.type == "cpu":
        return fma_chains_reference(x, k)
    ck._require_cuda(x, "fma_chains")
    ck._check(x, "x", x.device, tuple(x.shape))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ck._launch("fma_chains_launch", "fma_chains", x.data_ptr(), out.data_ptr(), x.numel(), k,
               ck._stream(x.device))
    return out


def vpu_ceiling(x, time_fn, k=24):
    """(operations per second, seconds per call) of ``fma_chains`` on ``x``: the
    script's count, ``CHAIN_LANES`` multiplies per element and chain step plus the sum."""
    dt = time_fn(lambda: fma_chains(x, k))
    return x.numel() * (k * CHAIN_LANES + CHAIN_LANES) / dt, dt


# --- D: the median alone (S11) ---------------------------------------------


def median_only_reference(x, iters):
    """Plain PyTorch version of ``median_only``: ``ck._row_median_nonneg`` ([NW, 1] f32)."""
    return ck._row_median_nonneg(x, iters=iters)


def median_only(x, iters):
    """S11: the radix median of each non-negative row, ``iters`` passes ([NW, 1] f32).

    The same device code as K1/K3's median (``row_median``, whole-row ranks):
    31 passes are exact, fewer return the bracket midpoint.
    """
    if not 1 <= iters <= 31:
        raise ValueError(f"median_only: iters must be in [1, 31] (got {iters})")
    if x.device.type == "cpu":
        return median_only_reference(x, iters)
    ck._require_cuda(x, "median_only")
    NW, nd = x.shape
    if 4 * nd > ck.ROW_SMEM_BYTES:
        raise ValueError(f"median_only: a row of {nd} floats does not fit shared memory")
    ck._check(x, "x", x.device, (NW, nd))
    out = torch.empty((NW, 1), dtype=_F32, device=x.device)
    if NW == 0:
        return out
    ck._launch("median_only_launch", "median_only", x.data_ptr(), out.data_ptr(), NW, nd, iters,
               ck._stream(x.device))
    return out


# --- A/B/E: the fused posterior K1 at several pass counts -----------------


def fused_eval_time(tgt, coords, iters, time_fn):
    t = dataclasses.replace(tgt, median_iters=iters)
    return time_fn(lambda: ck.log_posterior_fused(coords, t))


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``)."""
    return float(nvidia_smi("clocks.max.sm").split()[0])


def main(device="cuda", nw=NW, nd=ND, nd_half=ND_HALF, grid_step=1.0, chain_k=CHAIN_K):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}", flush=True)
    tgt, truth = build_bench_target(_F32, device=dev, nd=nd, grid_step=grid_step)
    coords = init_walker_batch(tgt, truth, nw)
    elems = nw * nd
    res = {}

    x1 = torch.ones((nw, nd), dtype=_F32, device=dev)
    if dev.type == "cuda":
        sms, mhz = torch.cuda.get_device_properties(dev).multi_processor_count, sm_clock_mhz()
    for k in chain_k:
        rate, dt = vpu_ceiling(x1, time_fn, k=k)
        res[("ceiling", k)] = (rate, dt)
        line = (f"[C] {CHAIN_LANES}-chain multiply, k={k}: {rate / 1e12:.3f} T ops/s "
                f"({dt * 1e3:.4f} ms/call")
        if dev.type == "cuda":
            mults = elems * k * CHAIN_LANES / dt
            share = mults / (sms * FP32_LANES_PER_SM * mhz * 1e6)
            line += (f"; {mults / 1e12:.3f} T multiplies/s = {100 * share:.1f}% of one multiply "
                     f"per FP32 lane per clock, {sms} SMs x {FP32_LANES_PER_SM} lanes at the "
                     f"{mhz:.0f} MHz maximum")
        print(line + ")", flush=True)
    ceil = max(res[("ceiling", k)][0] for k in chain_k)

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((nw, nd), generator=gen, dtype=_F32, device=dev).abs()
    t31 = time_fn(lambda: median_only(x, 31))
    t15 = time_fn(lambda: median_only(x, 15))
    per_pass = (t31 - t15) / 16
    res.update(median31=t31, median15=t15, per_pass=per_pass)
    print(f"[D] median-only: iters=31 {t31 * 1e3:.4f} ms, iters=15 {t15 * 1e3:.4f} ms")
    print(f"    marginal per-pass: {per_pass * 1e3:.4f} ms = {elems / per_pass / 1e12:.3f} "
          f"T elem/s = {ceil * per_pass / elems:.2f} measured op-equivalents per element",
          flush=True)

    f31 = fused_eval_time(tgt, coords, 31, time_fn)
    f20 = fused_eval_time(tgt, coords, 20, time_fn)
    fpp = (f31 - f20) / 11
    rest = f31 - 31 * fpp
    res.update(fused31=f31, fused20=f20, fused_per_pass=fpp, rest=rest)
    print(f"[A] fused posterior K1 ({nw} walkers): iters=31 {f31 * 1e3:.4f} ms "
          f"({nw / f31 / 1e6:.2f}M evals/s), iters=20 {f20 * 1e3:.4f} ms "
          f"({nw / f20 / 1e6:.2f}M evals/s)")
    print(f"[B] fused marginal per-pass {fpp * 1e3:.4f} ms (median-only said "
          f"{per_pass * 1e3:.4f} ms)")
    print(f"    median-loop share of the fused eval: {100 * 31 * fpp / f31:.1f}% (31 x marginal)")
    print(f"    non-median remainder: {rest * 1e3:.4f} ms = {ceil * rest / elems:.1f} "
          f"op-equivalents per element", flush=True)

    print("[E] overdetermination (no refit):", flush=True)
    for k in (16, 12):
        fk = fused_eval_time(tgt, coords, k, time_fn)
        pred = rest + k * fpp
        res[("fused", nd, k)] = fk
        print(f"    fused k={k} nd={nd}: measured {fk * 1e3:.4f} ms, model {pred * 1e3:.4f} ms, "
              f"residual {100 * (fk - pred) / fk:+.1f}%", flush=True)
    tgt2, truth2 = build_bench_target(_F32, device=dev, nd=nd_half, grid_step=grid_step)
    coords2 = init_walker_batch(tgt2, truth2, nw)
    for k in (31, 16):
        fk = fused_eval_time(tgt2, coords2, k, time_fn)
        pred = (rest + k * fpp) * (nd_half / nd)
        res[("fused", nd_half, k)] = fk
        print(f"    fused k={k} nd={nd_half}: measured {fk * 1e3:.4f} ms, per-element-scaled "
              f"model {pred * 1e3:.4f} ms, residual {100 * (fk - pred) / fk:+.1f}% (the "
              "non-nd-scaling share of the remainder)", flush=True)
    return res


if __name__ == "__main__":
    main()
