#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``mcmc_spec_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the kernels of ``mcmc_spec_tpu_torch/csrc`` with nvcc;
3. kernels vs plain: the walkers per block and ptxas lines (no barrier) of
   the one-warp-per-walker kernels K1, K3, K4 and K5, and K6's to K9's (no
   spill); the
   fused-posterior (K1) and spectrum-chi^2 (K3) kernels against their plain
   PyTorch versions on the card at both dial sets: 16,384 + 5 walkers on the
   bench target, three small targets, and nd = 1,791 and 4,096 with a ragged
   last block; then CUDA-event times;
4. the two-stage fit on the koi2298-scale bench target: annealer (K3) on
   3,072 walkers, top third seeds the stretch sampler (K1), launch counts;
5. throughput: the bench workload, 32,768 walkers, 128 timed steps, at the
   production and the exact dials;
6. fleet: nine ragged koi2298-scale targets (nd 1792 ... 1408, 2 or 1
   contrasts) padded to (1792, 2) and stacked, 4,096 walkers each: the fleet
   spectrum-chi^2 (K4) and fused fleet posterior (K5) kernels, both one warp
   per walker of the flattened fleet, so blocks span targets, against their
   plain versions and K5 against K1 on the unpadded targets; a half-step of
   K4 timed beside K4 v1's body (S6 ``target_major``); then
   ``run_fleet_ensemble`` (16 warm-up + 64 timed steps) on the composed
   default (K4) and with ``MCMC_SPEC_FUSED_EVAL=1`` (K5), with launch counts
   and the device busy share under ``torch.profiler``;
7. large nd: the segmented lane (K6 model with extinction over a shared D
   tile and each walker's non-zero weights, K7 k-ary median by a histogram
   select, K8 renorm partials and K9 chi^2 residual over chunks of walkers
   and segments of the points) on the bench target at nd = 65,536 (the JAX
   package's ``largend`` cell) and 131,072: each kernel and the composition
   against their plain versions (K7 bit for bit) at 1,024 + 5 walkers, again
   at the untileable odd nd = 65,535; K8 and K9 (renorm on and off) also on
   the last 171 of those walkers (the fit's stage-2 half-step) and at nd =
   4,096 (there also at recip 1) and 131,072, every call twice and the second
   bit for bit the first;
   K6 also at nd = 4,096 and 131,072 and on 257 walkers with NO = 300 (rows past the staged
   ones from device memory, a dense and a NaN-weighted walker); K7 bit
   for bit on 1,024 real rows and its edge rows (negative and NaN patterns,
   zeros, constant and tied rows, one bin holding 90 %, the 1e30 sentinel
   above odd and even counts) at nd = 65,536, 65,535, 131,072 and 4,096 and
   ``iters`` 31, 14, 15, 30; the composition against K3 at nd = 4,096 where
   the dispatch switches lanes, the two-stage fit at nd = 65,536 through
   ``log_posterior_batch`` and ``optimizer_chi2_batch`` (K7's launches split
   into the annealer's exact and stage 2's fast medians, K9's into the
   annealer's without renorm and stage 2's with), the throughput of 2,048
   walkers (16 warm-up + 128 timed steps) with K6's to K9's shares of the
   device time, K7's fast, exact and constant-row times, K8's and K9's (on
   and off) times as events and alone at 1,024 and 171 walkers, K6 beside
   ``torch.matmul(Wcomb, D)`` (the product alone: a yardstick for the row
   build) and a ``fill_`` of the model's size (the write alone), and a
   crossover of the lanes at 1,024 walkers from nd = 4,096 to 65,536;
8. experiments: the cost-attribution kernels of ``mcmc_spec_tpu_torch.scripts``
   against their plain versions on the card (S10 multiply chains and S11 row
   median bit for bit, S11 also against ``torch.kthvalue``; S4 spectrum with
   the reciprocal dial at every dial, and against K3 at recip 0 in the gate;
   S12 fused-posterior sections, every variant on 16,384 + 5 walkers at both
   dial sets, and ``full`` against K1 in the gate), then the three
   experiments' ``main()`` at full size (32,768 walkers, nd = 1792) with
   launch counts;
9. the K1 redesign experiments against their plain versions on the card: S8
   walker-lanes epilogue on 16,384 + 5 walkers at both dial sets, also
   against K1; S9 early-exit median (both variants) on the script's 8,192
   rows and S7 16-bit-coarse median on 32,768 rows, at nd = 1792 and 1791,
   bit for bit, also against ``np.median`` and S11; S5's four program orders
   on the synthetic and the production blend weights, ``stagger2``/``4`` bit
   for bit against ``baseline`` and ``baseline`` against S4 at recip 2; then
   the four experiments' ``main()`` at full size with launch counts;
10. fleet order and launch probes: S6 (K4 v1's body under an explicit grid
   order) on the ragged fleet of phase 6, both orders at both dial sets: bit
   for bit each other, each within the gate of its plain version, and K4 v2
   within the gate of ``target_major`` (the bodies sum in another order), then
   K4 v2 and both orders timed in turns; S1-S3 (trivial
   kernels with K1's operands: ``trivial_probe``, ``bisect_probe``,
   ``bisect2_probe``) against their plain versions on the scripts' own
   numpy-seeded inputs at full size, every configuration; then the four
   scripts' ``main()`` at full size with launch counts.  The probes' kernel
   time in the report is per launch in a CUDA graph of 50; the phase prints
   its wall time against a 20 s budget.

Each kernel's ``bound_ms`` is the least time the card could take for the
work of the timed call: the larger of its bytes (each input read once, the
output written once) over 3.35 TB/s and its operations over the 67 TFLOP/s
float32 peak outside the tensor cores (H100 SXM data sheet).  Operations are
counted from this run's inputs: an add, multiply, compare, divide or exp is
one, an FMA two; the model row counts only the non-zero blend weights; a
median count pass is a compare and an add per point and threshold.  K7's
bound is its function's bytes alone (the model read once, the medians
written), whatever algorithm computes the median; its report entry also
carries ``launches_exact``, ``launches_fast`` and ``ms_exact``.  K9's entry
(``ms`` with renorm) carries ``ms_raw`` and ``bound_ms_raw`` without renorm,
and ``launches_raw`` and ``launches_renorm``.  The
multiply chains of S10 count one operation per multiply and per add, so their
bound holds them against 67 TFLOP/s, twice the rate of one multiply per FP32
lane per clock (S10 measures the latter).

The phases' wall times are printed with the summary.  The line before the last
is the kernel report (JSON, twenty kernels); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NWALK_BENCH = 32768
N_TIMED_STEPS = 128
RTOL = 5e-5  # the JAX package's own kernel gate (tests/test_pallas_kernel.py)
PROD_MAX_OUTSIDE_FRAC = 1e-3  # 14-pass midpoint median: >= 99.9% of walkers within tolerance
EXACT = dict(median_iters=31, matmul_passes=6, recip_newton=0)
PROD = dict(median_iters=14, matmul_passes=3, recip_newton=2)
NTGT, NW_FLEET = 9, 4096
FLEET_WARMUP, FLEET_TIMED = 16, 64
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ND_FIT, ND_WIDE, ND_ODD = 65536, 131072, 65535  # the JAX largend cell and bench_large_nd.py
NW_LARGE = 1024  # the JAX largend cell's evaluation batch
LARGE_ANNEAL_STEPS, LARGE_SAMPLE_STEPS = 8, 64
LARGE_WARMUP, LARGE_TIMED = 16, 128
CROSSOVER_ND = (4096, 8192, 16384, 32768, 65536)
NW_STAGE2 = -(-(NW_LARGE // 3) // 2)  # the larger of the fit's stage-2 half-steps (171 of 341)
# the device names of K6-K9 (K8's and K9's segment sum too), for their share of the step
LANE_KERNEL_NAMES = ("model_extinct_kernel", "median_kary_kernel", "renorm_partials_kernel",
                     "resid_chi2_kernel", "lane_segments_sum_kernel")
K7_ITERS = (31, 14, 15, 30)  # K7's dials held bit for bit: exact, production, two levels
K7_CONST = 1.2345  # the value of K7's constant rows
ND_EXP_ODD = 1791  # S11's odd row
PROBES_BUDGET_S = 20  # phase 10's wall-time budget, printed beside its time
TOTAL_RTOL = 1e-5  # S3's full table totals against the plain ones (phase 10)


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def device_phase():
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    # full-f32 products in the plain versions (set explicitly, not left to defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0), smi


def build_phase():
    from mcmc_spec_tpu_torch.runtime import cuda_build

    t0 = time.perf_counter()
    lib = cuda_build.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel, reps=20):
    """Mean device milliseconds per call of ``fn()`` of the kernels whose name holds
    ``kernel`` (a name or a tuple of names) over ``reps`` calls under ``torch.profiler``:
    the kernels alone, without the wrapper's host time that CUDA events around the call
    also see; None where the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    names = (kernel,) if isinstance(kernel, str) else kernel
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and any(n in e.key for n in names)]
    return sum(dev_us(e) for e in ev) * 1e-3 / reps if ev else None


def fmt_ms(ms):
    return "not measured (the profiler reported no device time)" if ms is None else f"{ms:.4f} ms"


def compare(got, ref, rtol=RTOL):
    """(walkers outside tolerance, max relative error, max absolute error).

    ``got`` and ``ref`` are [walkers] or [walkers, ...].  A walker is outside
    when the finiteness of one of its values differs, or |got-ref| > atol +
    rtol*|ref| with atol = 1e-4 * max|ref| over the finite values (the JAX
    kernel gate)."""
    got = got.double().reshape(got.shape[0], -1)
    ref = ref.double().reshape(ref.shape[0], -1).to(got.device)
    fin_g, fin_r = torch.isfinite(got), torch.isfinite(ref)
    fin = fin_g & fin_r
    require(bool(fin.any()), "no finite value to compare")
    mag = torch.where(fin, ref.abs(), torch.zeros_like(ref))
    atol = 1e-4 * float(mag.max())
    diff = torch.where(fin, (got - ref).abs(), torch.zeros_like(got))
    bad = (fin_g != fin_r) | (diff > atol + rtol * mag)
    rel = diff / mag.clamp(min=1e-30)
    return int(bad.any(dim=1).sum()), float(rel.max()), float(diff.max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def library_median(x):
    """np.median of each row of ``x`` from ``torch.kthvalue``'s order statistics ([NW, 1])."""
    r1 = (x.shape[1] + 1) // 2
    lib = torch.kthvalue(x, r1, dim=1, keepdim=True).values
    if x.shape[1] % 2 == 0:
        lib = 0.5 * (lib + torch.kthvalue(x, r1 + 1, dim=1, keepdim=True).values)
    return lib


def spectrum_ops(Wcomb, av, nd, iters, renorm=True):
    """Operations of the spectrum block for these walkers (counting convention in the docstring)."""
    NO = Wcomb.shape[-1]
    B = Wcomb.numel() // NO
    ops = 2 * int(torch.count_nonzero(Wcomb)) * nd  # model row over the non-zero weights
    ops += 3 * int((av > 0).sum()) * nd  # extinction: multiply, exp, multiply
    ops += 2 * B * nd * iters  # each median pass: a compare and a count per point
    if iters >= 31:
        ops += 2 * B * nd  # upper-middle refinement: a count and a masked min
    # renorm fit (divide, multiply, 3 FMAs) + the renormed residual and its square sum
    ops += B * nd * (19 if renorm else 5)
    return ops


def posterior_scalar_ops(B, tgt):
    """The per-walker scalar part of K1/K5: tent weights, band fluxes, priors."""
    nT, nG = tgt.D.shape[-3:-1]
    NO, nm = nT * nG, tgt.mist_teff_nodes.shape[-1]
    per = tgt.nspec * (14 * NO + 8 * nm + 2 * NO * tgt.n_contrast) + 2 * NO * tgt.n_phot + 64
    return B * per


def bound(nbytes_moved, ops):
    """(bound_ms, bound_by): the larger of the memory and the arithmetic time."""
    t_bytes, t_ops = nbytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def device_busy(fn):
    """(device busy share of the wall time, kernel launches, top kernels [(name, ms)], every
    kernel {name: ms}) of ``fn()`` under ``torch.profiler``; (None, 0, [], {}) where it
    reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(dev_us(e) for e in kernels)
    if total <= 0:
        return None, 0, [], {}
    top = sorted(kernels, key=dev_us, reverse=True)[:4]
    return (total * 1e-6 / wall, sum(e.count for e in kernels),
            [(e.key[:60], dev_us(e) * 1e-3) for e in top],
            {e.key: dev_us(e) * 1e-3 for e in kernels})


def edge_walkers(truth, tgt):
    """Av = 0, far out of bounds, T on the grid edges and just outside."""
    t = np.asarray(truth, dtype=np.float64)
    tmin, tmax = float(tgt.tmin), float(tgt.tmax)
    rows = []
    av0 = t.copy()
    av0[tgt.nspec] = 0.0
    rows.append(av0)
    rows.append(np.ones_like(t))
    edge = t.copy()
    edge[0], edge[tgt.nspec - 1] = tmax, tmin
    rows.append(edge)
    out = t.copy()
    out[0] = tmax + 1.0
    rows.append(out)
    low = t.copy()
    low[tgt.nspec - 1] = tmin - 1.0
    rows.append(low)
    return torch.as_tensor(np.stack(rows), dtype=torch.float32, device=tgt.device)


def check_k1(name, tgt, P, max_outside):
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    got = ck.log_posterior_fused(P, tgt)
    torch.cuda.synchronize()
    ref = ck.log_posterior_fused_reference(P, tgt)
    outside, rel, err = compare(got, ref)
    n_fin = int(torch.isfinite(ref).sum())
    print(f"[K1 {name}] {P.shape[0]} walkers ({n_fin} finite): {outside} outside tolerance "
          f"(allowed {max_outside}), max rel err {rel:.3e}, max abs err {err:.3e}")
    require(outside <= max_outside, f"K1 {name}: {outside} walkers outside tolerance")
    return err


def warp_kernels_report(tgt):
    """K1, K3, K4 and K5 run one warp per walker: print each kernel's walkers per block at
    the bench shape (K4's and K5's fleet is padded to it) and at LARGE_ND, and its ptxas
    line, which must show no barrier; then K6's to K9's ptxas lines (each instantiation,
    and K8's and K9's segment sum), which must show no spill."""
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg
    from mcmc_spec_tpu_torch.runtime import compare_builds, cuda_build

    lines = compare_builds.ptxas_lines(cuda_build.library_path().with_suffix(".log").read_text())
    nT, nG, nd = tgt.D.shape
    for name, kernel, weight_rows in (("K1", "log_posterior_fused_kernel", 1 + tgt.nspec),
                                      ("K3", "spectrum_chi2_kernel", 0),
                                      ("K4", "spectrum_chi2_fleet_kernel", 0),
                                      ("K5", "log_posterior_fleet_fused_kernel", 1 + tgt.nspec)):
        line = next(v for k, v in lines.items() if kernel in k)
        wpb = {n: ck.walkers_per_block(n, nT * nG, weight_rows) for n in (nd, seg.LARGE_ND)}
        print(f"[{name} one warp per walker] walkers per block: "
              + ", ".join(f"{w} at nd={n} ({w * ck.warp_smem_bytes(n, nT * nG, weight_rows)} "
                          "bytes of shared memory)" for n, w in wpb.items())
              + f"; ptxas: {line}")
        require("used 0 barriers" in line, f"{name}: ptxas reports a barrier: {line}")
    log = cuda_build.library_path().with_suffix(".log").read_text().splitlines()
    for name, kernel in (("K6 shared D tile", "model_extinct_kernel"),
                         ("K7 histogram select", "median_kary_kernel"),
                         ("K8 walker chunks", "renorm_partials_kernel"),
                         ("K9 walker chunks", "resid_chi2_kernel"),
                         ("K8/K9 segment sum", "lane_segments_sum_kernel")):
        for key in sorted(k for k in lines if kernel in k):  # each instantiation
            props = next(log[i + 1].strip() for i, line in enumerate(log)
                         if f"Function properties for {key}" in line)
            print(f"[{name}] {key}: ptxas: {lines[key]}; {props}")
            require(" 0 bytes spill stores" in props, f"{name} spills registers: {props}")


def check_k3(name, tgt, P, max_outside):
    """K3 against its plain version on the blend weights of walkers ``P``, renorm on and
    off, at ``tgt``'s dials; returns the max abs error."""
    from mcmc_spec_tpu_torch.inference.batched import _forward_small
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    Wcomb = _forward_small(P, tgt)[4]
    nT, nG, nd = tgt.D.shape
    args = (Wcomb, P[:, tgt.nspec].contiguous(), tgt.D.reshape(nT * nG, nd), tgt.ext_k_data,
            tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv, tgt.med_data)
    kw = dial_kwargs(dict(median_iters=tgt.median_iters, matmul_passes=tgt.matmul_passes,
                          recip_newton=tgt.recip_newton))
    err_max = 0.0
    for renorm in (True, False):
        got = ck.spectrum_chi2(*args, renorm=renorm, **kw)
        torch.cuda.synchronize()
        outside, rel, err = compare(got, ck.spectrum_chi2_reference(*args, renorm=renorm, **kw))
        err_max = max(err_max, err)
        print(f"[K3 {name} renorm={renorm}] {P.shape[0]} walkers: {outside} outside tolerance "
              f"(allowed {max_outside}), max rel err {rel:.3e}, max abs err {err:.3e}")
        require(outside <= max_outside, f"K3 {name} renorm={renorm}: {outside} walkers outside "
                "tolerance")
    return err_max


def kernels_phase(dev):
    from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
    from mcmc_spec_tpu_torch.inference.batched import _forward_small
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.ops.spec_segmented import LARGE_ND

    t0 = time.perf_counter()
    tgt, truth = build_bench_target(torch.float32, device=dev)
    print(f"[kernels] bench target packed in {time.perf_counter() - t0:.1f} s: "
          f"D {tuple(tgt.D.shape)}, nc {tgt.n_contrast}, npf {tgt.n_phot}, ndim {tgt.ndim}")
    warp_kernels_report(tgt)
    exact = dataclasses.replace(tgt, **EXACT)
    prod = dataclasses.replace(tgt, **PROD)
    nhalf = NWALK_BENCH // 2
    cloud = init_walker_batch(tgt, truth, nhalf)
    P = torch.cat([cloud, edge_walkers(truth, tgt)])

    err_k1 = check_k1("exact dials (31, 6, 0)", exact, P, 0)
    check_k1("production dials (14, 3, 2)", prod, P,
             int(PROD_MAX_OUTSIDE_FRAC * nhalf))
    err_k3 = check_k3("exact dials (31, 6, 0)", exact, P, 0)
    check_k3("production dials (14, 3, 2)", prod, P, int(PROD_MAX_OUTSIDE_FRAC * nhalf))

    small2, truth2 = build_bench_target(torch.float32, device=dev, nd=400, grid_step=8.0)
    # odd nd: the exact median's odd-row branch
    small3, truth3 = build_bench_target(torch.float32, device=dev, nd=401, grid_step=8.0, nspec=3)
    for name, t, tr in (("rad_prior", dataclasses.replace(small2, rad_prior=True, **EXACT), truth2),
                        ("triple nd=401", dataclasses.replace(small3, **EXACT), truth3),
                        ("nospec", dataclasses.replace(small2, spectrum_weight=0.0, **EXACT), truth2)):
        Ps = torch.cat([init_walker_batch(t, tr, 1024, seed=2), edge_walkers(tr, t)])
        check_k1(name, t, Ps, 0)
    # the odd whole-row median of the bench grid, and LARGE_ND (the largest row the
    # dispatch gives K1 and K3, the fewest walkers a block); at 8 walkers a block,
    # 1,024 + 5 walkers leave a ragged last block of 5
    for nd in (ND_EXP_ODD, LARGE_ND):
        t, tr = build_bench_target(torch.float32, device=dev, nd=nd)
        Pn = torch.cat([init_walker_batch(t, tr, 1024, seed=6), edge_walkers(tr, t)])
        for label, dials, allowed in (("exact dials", EXACT, 0),
                                      ("production dials", PROD,
                                       int(PROD_MAX_OUTSIDE_FRAC * 1024))):
            td = dataclasses.replace(t, **dials)
            e1 = check_k1(f"nd={nd} {label}", td, Pn, allowed)
            e3 = check_k3(f"nd={nd} {label}", td, Pn, allowed)
            if dials is EXACT:
                err_k1, err_k3 = max(err_k1, e1), max(err_k3, e3)

    # times at the bench shapes: one stage-2 half batch; K3 in its stage-1 mode
    # (the bounds are computed for the timed calls' inputs)
    _, _, _, _, Wcomb = _forward_small(cloud, exact)
    av = cloud[:, exact.nspec].contiguous()
    nT, nG, nd = exact.D.shape
    args = (Wcomb, av, exact.D.reshape(nT * nG, nd), exact.ext_k_data, exact.data_flux,
            exact.data_err, exact.V, exact.Vpinv, exact.med_data)
    k1_bytes = nbytes(cloud, *ck.kernel_tables(prod).values()) + 4 * nhalf
    k1_ops = spectrum_ops(Wcomb, av, nd, PROD["median_iters"]) + posterior_scalar_ops(nhalf, prod)
    k3_bytes = nbytes(Wcomb, av, *args[2:8]) + 4 * nhalf
    k3_ops = spectrum_ops(Wcomb, av, nd, 31, renorm=False)
    bounds = {"k1": bound(k1_bytes, k1_ops), "k3": bound(k3_bytes, k3_ops)}
    print(f"[bound K1 production] {nhalf} walkers: {bounds['k1'][0]:.5f} ms "
          f"({bounds['k1'][1]}: {k1_ops:.4g} ops, {k1_bytes:.4g} bytes)")
    print(f"[bound K3 renorm=False exact median] {nhalf} walkers: {bounds['k3'][0]:.5f} ms "
          f"({bounds['k3'][1]}: {k3_ops:.4g} ops, {k3_bytes:.4g} bytes)")
    times = {}
    for label, t in (("production", prod), ("exact", exact)):
        fn = lambda: ck.log_posterior_fused(cloud, t)
        k, r = cuda_ms(fn), cuda_ms(lambda: ck.log_posterior_fused_reference(cloud, t))
        times[("k1", label)] = (k, r)
        alone = fmt_ms(device_ms(fn, "log_posterior_fused_kernel"))
        print(f"[time K1 {label}] {nhalf} walkers: kernel {k:.4f} ms, plain {r:.4f} ms; "
              f"the kernel alone on the device {alone}")
    for nw in (nhalf, 3072):
        a3 = (Wcomb[:nw].contiguous(), av[:nw].contiguous()) + args[2:]
        fn = lambda: ck.spectrum_chi2(*a3, iters=31, mm_passes=6, recip=0, renorm=False)
        k = cuda_ms(fn)
        r = cuda_ms(lambda: ck.spectrum_chi2_reference(*a3, iters=31, mm_passes=6, recip=0,
                                                       renorm=False))
        times[("k3", nw)] = (k, r)
        b = bound(nbytes(*a3[:8]) + 4 * nw, spectrum_ops(a3[0], a3[1], nd, 31, renorm=False))
        print(f"[time K3 renorm=False exact median] {nw} walkers: kernel {k:.4f} ms, "
              f"plain {r:.4f} ms, bound {b[0]:.5f} ms ({b[1]}); the kernel alone on the device "
              f"{fmt_ms(device_ms(fn, 'spectrum_chi2_kernel'))}")
    return tgt, truth, {"k1_err": err_k1, "k3_err": err_k3, "times": times, "bounds": bounds}


def fit_phase(tgt, truth, dev):
    from mcmc_spec_tpu_torch.inference.anneal import init_walkers, run_anneal
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    nwalk, n_steps = 3072, 256
    gen = torch.Generator(device=dev).manual_seed(0)
    logp = lambda b: log_posterior_batch(b, tgt)
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    p0 = init_walkers(tgt, nwalk, plx=float(truth[-1]), plx_err=0.05e-3, generator=gen)
    params, chi, _ = run_anneal(tgt, p0, gen, steps=20)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    take = max(nwalk // 3, 2)
    seeds = params[torch.argsort(chi)[:take]]
    state = init_ensemble(seeds, logp, gen)
    state, chain, _ = run_ensemble(state, logp, n_steps, thin=8)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ck.LAUNCHES)

    acc = float(state.n_accept) / (take * n_steps)
    print(f"[fit] stage 1: {nwalk} walkers x 50*20 iterations in {t1 - t0:.2f} s, "
          f"best chi^2 {float(chi.min()):.2f}, median {float(chi.median()):.2f}")
    print(f"[fit] stage 2: {take} walkers x {n_steps} steps in {t2 - t1:.2f} s, "
          f"acceptance {acc:.3f}; launches {launches}")
    require(torch.isfinite(chi).all(), "stage 1: non-finite chi^2")
    require(torch.isfinite(state.log_prob).all(), "stage 2: non-finite log-probs")
    require(0.0 < acc < 1.0, f"stage 2: acceptance {acc} outside (0, 1)")
    for name in ("spectrum_chi2", "log_posterior_fused"):
        require(launches[name] > 0, f"{name} was not launched in the fit")
    med = chain[chain.shape[0] // 2:].reshape(-1, tgt.ndim).median(dim=0).values.cpu().numpy()
    for k, (m, t) in enumerate(zip(med, truth)):
        print(f"[fit] param {k}: posterior median {m:.6g}, truth {t:.6g}")
    return launches, t1 - t0


def throughput_phase(tgt, truth, dev, k1_ms):
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble

    rates = {}
    for label, dials in (("production", PROD), ("exact", EXACT)):
        t = dataclasses.replace(tgt, **dials)
        logp = lambda b: log_posterior_batch(b, t)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = init_ensemble(init_walker_batch(t, truth, NWALK_BENCH), logp, gen)
        state, _, _ = run_ensemble(state, logp, 16, thin=16)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, chain, _ = run_ensemble(state, logp, N_TIMED_STEPS, thin=N_TIMED_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(torch.isfinite(chain).all(), f"throughput {label}: non-finite chain")
        rate = N_TIMED_STEPS * NWALK_BENCH / dt
        step_ms = 1e3 * dt / N_TIMED_STEPS
        rates[label] = rate
        # two K1 launches per step, timed alone in the kernels phase
        print(f"[throughput {label}] {NWALK_BENCH} walkers x {N_TIMED_STEPS} steps: {dt:.4f} s, "
              f"{rate:.1f} evals/s; step {step_ms:.4f} ms, 2 x K1 alone "
              f"{2 * k1_ms[label]:.4f} ms")
    return rates


def build_fleet(dev):
    """(padded stacked fleet, unpadded singles, truth): target i has nd = 1792 - 48 i,
    2 contrasts for even i and 1 for odd i, and seed i."""
    from mcmc_spec_tpu_torch.bench_target import build_bench_target
    from mcmc_spec_tpu_torch.inference.fleet import stack_targets

    members, singles = [], []
    for i in range(NTGT):
        kw = dict(nd=1792 - 48 * i, seed=i, n_contrast=2 if i % 2 == 0 else 1)
        members.append(build_bench_target(torch.float32, device=dev, pad_nd=1792, pad_nc=2,
                                          **kw)[0])
        single, truth = build_bench_target(torch.float32, device=dev, **kw)
        singles.append(single)
    return stack_targets(members), singles, truth


def fleet_wcomb(P, fleet):
    """The fleet's blend weights [ntgt, nw, NO], as ``log_posterior_fleet`` forms them for K4."""
    from mcmc_spec_tpu_torch.inference.batched import _forward_small
    from mcmc_spec_tpu_torch.inference.fleet import target_views

    return torch.stack([_forward_small(p, t)[4] for p, t in zip(P, target_views(fleet))])


def check_fleet_kernels(name, fleet, P, max_outside):
    """K5 and K4 against their plain versions on the card; returns their max abs errors."""
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    got = ck.log_posterior_fleet_fused(P, fleet)
    torch.cuda.synchronize()
    ref = ck.log_posterior_fleet_fused_reference(P, fleet)
    outside5, rel5, err5 = compare(got.flatten(), ref.flatten())
    Wcomb, av = fleet_wcomb(P, fleet), P[..., fleet.nspec].contiguous()
    got = ck.spectrum_chi2_fleet(Wcomb, av, fleet)
    torch.cuda.synchronize()
    ref = ck.spectrum_chi2_fleet_reference(Wcomb, av, fleet)
    outside4, rel4, err4 = compare(got.flatten(), ref.flatten())
    n = P.shape[0] * P.shape[1]
    for k, outside, rel, err in (("K5", outside5, rel5, err5), ("K4", outside4, rel4, err4)):
        print(f"[{k} {name}] {n} walkers: {outside} outside tolerance (allowed {max_outside}), "
              f"max rel err {rel:.3e}, max abs err {err:.3e}")
        require(outside <= max_outside, f"{k} {name}: {outside} walkers outside tolerance")
    return err4, err5


def fleet_run(fleet, coords, dev, fused):
    """16 warm-up + 64 timed fleet steps on one route; returns the route's numbers."""
    from mcmc_spec_tpu_torch.inference.fleet import init_fleet_ensemble, run_fleet_ensemble
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    route = "fused (K5)" if fused else "composed (K4)"
    if fused:
        os.environ["MCMC_SPEC_FUSED_EVAL"] = "1"
    else:
        os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
    torch.cuda.synchronize()
    ck.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_fleet_ensemble(coords, fleet, gen)
    state, _, _ = run_fleet_ensemble(state, fleet, FLEET_WARMUP, thin=FLEET_WARMUP)
    acc0 = int(state.n_accept)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, chain, lps = run_fleet_ensemble(state, fleet, FLEET_TIMED, thin=FLEET_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    ntgt, nw, ndim = coords.shape
    rate = FLEET_TIMED * ntgt * nw / dt
    acc = (int(state.n_accept) - acc0) / (FLEET_TIMED * ntgt * nw)
    print(f"[fleet {route}] {ntgt} x {nw} walkers x {FLEET_TIMED} steps: {dt:.4f} s, "
          f"{rate:.1f} evals/s; step {1e3 * dt / FLEET_TIMED:.4f} ms; acceptance {acc:.3f}; "
          f"launches {launches}")
    require(chain.shape == (1, ntgt, nw, ndim), f"fleet {route}: chain shape {chain.shape}")
    require(torch.isfinite(chain).all() and torch.isfinite(lps).all(),
            f"fleet {route}: non-finite chain")
    require(0.0 < acc < 1.0, f"fleet {route}: acceptance {acc} outside (0, 1)")
    kernel = "log_posterior_fleet_fused" if fused else "spectrum_chi2_fleet"
    other = "spectrum_chi2_fleet" if fused else "log_posterior_fleet_fused"
    require(launches[kernel] > 0, f"fleet {route}: {kernel} was not launched")
    require(launches[other] == 0, f"fleet {route}: {other} was launched")
    busy, n_kernels, top, _ = device_busy(lambda: run_fleet_ensemble(state, fleet, 4, thin=4))
    share = "not measured (the profiler reported no device time)" if busy is None else \
        f"{busy:.3f}, {n_kernels / 4:.0f} kernel launches per step"
    print(f"[fleet {route}] device busy share under torch.profiler (4 steps): {share}; "
          f"top kernels (ms): {[(k, round(v, 4)) for k, v in top]}")
    os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
    return {"rate": rate, "step_ms": 1e3 * dt / FLEET_TIMED, "launches": launches[kernel],
            "busy": busy, "state": state}


def fleet_phase(dev):
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import try_fleet_grid_order as s6

    t0 = time.perf_counter()
    fleet, singles, truth = build_fleet(dev)
    print(f"[fleet] {NTGT} targets packed in {time.perf_counter() - t0:.1f} s: D "
          f"{tuple(fleet.D.shape)}, nd true {fleet.n_data_true.tolist()}, nc true "
          f"{fleet.n_contrast_true.tolist()}")
    cloud = torch.stack([init_walker_batch(t, truth, NW_FLEET, seed=1 + i)
                         for i, t in enumerate(singles)])
    P = torch.cat([cloud, torch.stack([edge_walkers(truth, t) for t in singles])], dim=1)
    exact, prod = dataclasses.replace(fleet, **EXACT), dataclasses.replace(fleet, **PROD)

    err4, err5 = check_fleet_kernels("exact dials (31, 6, 0)", exact, P, 0)
    check_fleet_kernels("production dials (14, 3, 2)", prod, P,
                        int(PROD_MAX_OUTSIDE_FRAC * NTGT * NW_FLEET))

    # padding is inert: K5 on the padded fleet against K1 on each unpadded target
    got = ck.log_posterior_fleet_fused(P, exact)
    ref = torch.stack([ck.log_posterior_fused(P[i], dataclasses.replace(s, **EXACT))
                       for i, s in enumerate(singles)])
    torch.cuda.synchronize()
    outside, rel, err = compare(got.flatten(), ref.flatten())
    print(f"[K5 padded vs K1 unpadded, exact dials] {P.shape[0] * P.shape[1]} walkers: "
          f"{outside} outside tolerance, max rel err {rel:.3e}, max abs err {err:.3e}")
    require(outside == 0, f"K5 padded vs K1 unpadded: {outside} walkers outside tolerance")

    # one half-step of the fleet at production dials, alone, and its bound
    half = cloud[:, : NW_FLEET // 2].contiguous()
    Wh, avh = fleet_wcomb(half, prod), half[..., fleet.nspec].contiguous()
    nh, nd = NTGT * NW_FLEET // 2, fleet.D.shape[-1]
    times = {
        "k4": (cuda_ms(lambda: ck.spectrum_chi2_fleet(Wh, avh, prod)),
               cuda_ms(lambda: ck.spectrum_chi2_fleet_reference(Wh, avh, prod), reps=5)),
        "k5": (cuda_ms(lambda: ck.log_posterior_fleet_fused(half, prod)),
               cuda_ms(lambda: ck.log_posterior_fleet_fused_reference(half, prod), reps=5)),
    }
    tabs = ck.fleet_kernel_tables(prod)
    k4_bytes = nbytes(Wh, avh, *(tabs[k] for k in ("D", "kd", "data", "inv_err", "VpinvT", "VT",
                                                  "scal", "ranks"))) + 4 * nh
    k4_ops = spectrum_ops(Wh, avh, nd, PROD["median_iters"])
    k5_bytes = nbytes(half, *tabs.values()) + 4 * nh
    k5_ops = k4_ops + posterior_scalar_ops(nh, prod)
    bounds = {"k4": bound(k4_bytes, k4_ops), "k5": bound(k5_bytes, k5_ops)}
    for k, name in (("k4", "K4"), ("k5", "K5")):
        print(f"[time {name} production] one half-step, {NTGT} x {NW_FLEET // 2} walkers: kernel "
              f"{times[k][0]:.4f} ms, plain {times[k][1]:.4f} ms, bound {bounds[k][0]:.5f} ms "
              f"({bounds[k][1]})")
    # K4 v1's body, one block per walker, on the same half-step: S6 in K4 v1's order
    v1 = cuda_ms(lambda: s6.spectrum_chi2_fleet_2d(Wh, avh, prod, "target_major"))
    alone = fmt_ms(device_ms(lambda: ck.spectrum_chi2_fleet(Wh, avh, prod),
                             "spectrum_chi2_fleet_kernel"))
    print(f"[time K4 production] one half-step: v2 (one warp per walker) {times['k4'][0]:.4f} ms, "
          f"v1's body (S6 target_major) {v1:.4f} ms, {v1 / times['k4'][0]:.2f}x; v2 alone on the "
          f"device {alone}")

    composed = fleet_run(prod, cloud, dev, fused=False)
    fused = fleet_run(prod, cloud, dev, fused=True)
    print(f"[fleet] step: composed {composed['step_ms']:.4f} ms (2 x K4 alone "
          f"{2 * times['k4'][0]:.4f} ms), fused {fused['step_ms']:.4f} ms (2 x K5 alone "
          f"{2 * times['k5'][0]:.4f} ms)")

    # the routes agree: the composed run's final log-probs against K5 on the same walkers
    st = composed["state"]
    outside, rel, err = compare(ck.log_posterior_fleet_fused(st.coords, prod).flatten(),
                                st.log_prob.flatten())
    print(f"[fleet routes] K5 on the composed run's final walkers: {outside} outside tolerance "
          f"(allowed {int(PROD_MAX_OUTSIDE_FRAC * NTGT * NW_FLEET)}), max rel err {rel:.3e}")
    require(outside <= int(PROD_MAX_OUTSIDE_FRAC * NTGT * NW_FLEET),
            f"fleet routes disagree on {outside} walkers")
    med = st.coords.median(dim=1).values.cpu().numpy()
    for i in (0, NTGT - 1):
        print(f"[fleet] target {i}: walker medians T1 {med[i, 0]:.1f}, T2 {med[i, 1]:.1f}, "
              f"plx {med[i, -1]:.6g} (truth {truth[0]:.0f}, {truth[1]:.0f}, {truth[-1]:.6g})")
    return {"errs": (err4, err5), "times": times, "bounds": bounds, "composed": composed,
            "fused": fused}


def largend_target(dev, nd):
    from mcmc_spec_tpu_torch.bench_target import build_bench_target

    return build_bench_target(torch.float32, device=dev, nd=nd, grid_step=8.0)


def lane_operands(tgt, P):
    """The segmented lane's arguments for walkers ``P``, as ``log_posterior_batch`` forms them."""
    from mcmc_spec_tpu_torch.inference.batched import _forward_small

    nT, nG, nd = tgt.D.shape
    return (_forward_small(P, tgt)[4], P[:, tgt.nspec].contiguous(), tgt.D.reshape(nT * nG, nd),
            tgt.ext_k_data, tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv, tgt.med_data,
            tgt.n_data_true)


def lane_model(tgt, P):
    """K6's model rows [walkers, nd] of walkers ``P``: K7's real rows."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    return seg.model_extinct(*lane_operands(tgt, P)[:4])


def dial_kwargs(dials):
    return dict(iters=dials["median_iters"], mm_passes=dials["matmul_passes"],
                recip=dials["recip_newton"])


def check_lane(name, tgt, P, dials, max_outside, eager):
    """K6-K9 and the composition against their plain versions on the same inputs (K7 bit
    for bit); with ``eager`` the composition also against the sort composition.
    Returns each kernel's max abs error."""
    from mcmc_spec_tpu_torch.inference.batched import (
        _spec_chi2_xla,
        _spec_chi2_xla_median_only,
    )
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    ops = lane_operands(tgt, P)
    Wcomb, av, D, kd, data, err, V, Vpinv, med_data, n_true = ops
    kw = dial_kwargs(dials)
    iters, recip = kw["iters"], kw["recip"]
    NW = P.shape[0]
    res = {}
    model = seg.model_extinct(Wcomb, av, D, kd)
    torch.cuda.synchronize()
    res["model_extinct"] = compare(model, seg.model_extinct_reference(Wcomb, av, D, kd))
    med = seg.median_nonneg(model, n_true, iters)
    torch.cuda.synchronize()
    med_ref = seg.median_nonneg_reference(model, n_true, iters)
    same = int((med.view(torch.int32) == med_ref.view(torch.int32)).sum())
    # one rank per row, as ragged targets would give them
    n_rows = (n_true - torch.arange(NW, device=P.device) % 3).to(torch.int32)
    rows = seg.median_nonneg(model, n_rows, iters)
    torch.cuda.synchronize()
    same_rows = int((rows.view(torch.int32)
                     == seg.median_nonneg_reference(model, n_rows, iters).view(torch.int32)).sum())
    print(f"[K7 {name}] {NW} rows: {same} bit-identical to the plain version; {same_rows} "
          "with per-row ranks")
    require(same == NW and same_rows == NW,
            f"K7 {name}: {NW - same} rows ({NW - same_rows} per-row) differ from the plain version")
    res["median_nonneg"] = (0, 0.0, float((med - med_ref).abs().max()))
    scale = med_data.to(torch.float32) / med
    res.update(check_stats(name, model, scale, data, err, V, Vpinv, recip))
    for renorm in (True, False):
        got = seg.spectrum_chi2_segmented(*ops, renorm=renorm, **kw)
        torch.cuda.synchronize()
        ref = seg.spectrum_chi2_segmented_reference(*ops, renorm=renorm, **kw)
        res[f"composition renorm={renorm}"] = compare(got, ref)
        if eager:
            sort = (_spec_chi2_xla if renorm else _spec_chi2_xla_median_only)(Wcomb, av, tgt)
            res[f"composition vs eager sort renorm={renorm}"] = compare(got, sort)
    for k, (outside, rel, err_abs) in res.items():
        print(f"[{k} {name}] {NW_STAGE2 if 'walkers' in k else NW} walkers: {outside} outside "
              f"tolerance (allowed {max_outside}), max rel err {rel:.3e}, max abs err "
              f"{err_abs:.3e}")
        require(outside <= max_outside, f"{k} {name}: {outside} walkers outside tolerance")
    errs = {k: res[k][2] for k in ("model_extinct", "median_nonneg", "renorm_partials")}
    errs["resid_chi2"] = max(res["resid_chi2 renorm=True"][2], res["resid_chi2 renorm=False"][2])
    return errs


def check_stats(name, model, scale, data, err, V, Vpinv, recip):
    """K8 and K9 (renorm on and off) against their plain versions on the same inputs, on
    every walker of ``model`` and on its last NW_STAGE2 (the fit's stage-2 half-step,
    with the edge walkers), each kernel called twice: the second call must give the
    first's bits, and no walker may lie outside the gate.  K9 takes K8's coefficients.
    Returns {kernel: (walkers outside, max rel err, max abs err)}."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    res = {}
    for label, rows in (("", slice(None)), (f" {NW_STAGE2} walkers", slice(-NW_STAGE2, None))):
        m, sc = model[rows].contiguous(), scale[rows].contiguous()
        coeffs = seg.renorm_partials(m, sc, data, Vpinv, recip)
        calls = {"renorm_partials": (
            lambda: seg.renorm_partials(m, sc, data, Vpinv, recip),
            lambda: seg.renorm_partials_reference(m, sc, data, Vpinv, recip))}
        for renorm in (True, False):
            calls[f"resid_chi2 renorm={renorm}"] = (
                lambda r=renorm: seg.resid_chi2(m, sc, coeffs, data, err, V, recip, r),
                lambda r=renorm: seg.resid_chi2_reference(m, sc, coeffs, data, err, V, recip, r))
        for k, (kern, ref) in calls.items():
            first, second = kern(), kern()
            torch.cuda.synchronize()
            same = torch.equal(first.view(torch.int32), second.view(torch.int32))
            res[k + label] = compare(first, ref())
            print(f"[{k}{label} {name}] a second call bit for bit the first: {same}")
            require(same, f"{k}{label} {name}: a second call gave other bits")
            require(res[k + label][0] == 0,
                    f"{k}{label} {name}: {res[k + label][0]} walkers outside tolerance")
    return res


def check_stats_at(name, tgt, P, dials):
    """check_stats on the model, median and scale of walkers ``P`` of target ``tgt``,
    with the results printed."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    Wcomb, av, D, kd, data, err, V, Vpinv, med_data, n_true = lane_operands(tgt, P)
    kw = dial_kwargs(dials)
    model = seg.model_extinct(Wcomb, av, D, kd)
    scale = med_data.to(torch.float32) / seg.median_nonneg(model, n_true, kw["iters"])
    for k, (outside, rel, err_abs) in check_stats(name, model, scale, data, err, V, Vpinv,
                                                  kw["recip"]).items():
        print(f"[{k} {name}] {P.shape[0] if 'walkers' not in k else NW_STAGE2} walkers: "
              f"{outside} outside tolerance, max rel err {rel:.3e}, max abs err {err_abs:.3e}")


def check_k6(name, Wcomb, av, D, kd):
    """K6 against its plain version on every element (the gate); returns the max abs error."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    got = seg.model_extinct(Wcomb, av, D, kd)
    torch.cuda.synchronize()
    outside, rel, err = compare(got, seg.model_extinct_reference(Wcomb, av, D, kd))
    (NW, NO), nd = Wcomb.shape, D.shape[1]
    print(f"[K6 {name}] {NW} walkers x nd={nd}, NO={NO} ({seg.model_tile_rows(NO)} rows staged): "
          f"{outside} walkers outside tolerance, max rel err {rel:.3e}, max abs err {err:.3e}")
    require(outside == 0, f"K6 {name}: {outside} walkers outside tolerance")
    return err


def k6_wide_grid_inputs(dev, NW=257, NO=300, nd=4095, seed=9):
    """K6's inputs past one block's staged rows: NO = 300 grid points (226 staged),
    numpy-seeded: 8 non-zero weights a walker at random grid points, av <= 0 on every
    fifth walker, one walker dense over all NO, one with a NaN weight."""
    rng = np.random.default_rng(seed)
    W = np.zeros((NW, NO), np.float32)
    for w in range(NW):
        W[w, rng.choice(NO, 8, replace=False)] = rng.uniform(0.05, 1.0, 8)
    W[1] = rng.uniform(0.0, 0.02, NO)
    W[2, 250] = np.nan
    av = rng.uniform(0.0, 2.0, NW).astype(np.float32)
    av[::5] = 0.0
    D = rng.uniform(0.1, 5.0, (NO, nd)).astype(np.float32)
    kd = rng.uniform(0.5, 3.0, nd).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (W, av, D, kd))


def k7_edge_rows(real):
    """K7's edge rows beside a real model row ``real`` [nd] (float32 on the card):
    ([rows, nd] float32, [rows] int32 true counts, names).  Zeros, a constant row and
    one bin holding 90 % of a row (its shared-memory atomics all on one address),
    negative patterns (-0.0, -1, a negative NaN), positive NaN and +inf, a row of NaN
    (the largest pattern too), subnormals, the whole bit range, five tied values, and
    the 1e30 sentinel above an odd and an even count of true points."""
    nd = real.shape[0]
    dev = real.device
    f = lambda bits: torch.as_tensor(np.asarray(bits, dtype=np.int64).astype(np.int32),
                                     device=dev).view(torch.float32)
    rng = np.random.RandomState(7)
    j = torch.arange(nd, device=dev)
    rows, counts, names = [], [], []

    def add(name, row, n=None):
        # each row twice: with an even and an odd count of true points
        for parity, count in (("even", n or nd & ~1), ("odd", (n or nd) - 1 | 1)):
            rows.append(row.to(torch.float32))
            counts.append(count)
            names.append(f"{name}, {parity} count")

    add("zeros", torch.zeros(nd, device=dev))
    add("constant", torch.full((nd,), K7_CONST, device=dev))
    one_bin = real.clone()
    one_bin[j % 10 != 0] = real[0]
    add("one bin holds 90 %", one_bin)
    neg = real.clone()
    neg[j % 3 == 0] = -0.0
    neg[j % 5 == 0] = -1.0
    neg[j % 7 == 0] = f([0xFFC00000])
    add("negative patterns", neg)
    nan = real.clone()
    nan[j % 10 == 0] = f([0x7FC00000])
    nan[j % 11 == 0] = float("inf")
    add("positive NaN and +inf", nan)
    add("every value NaN", f(np.full(nd, 0x7FC00000)))
    add("the largest pattern", f(np.full(nd, 0x7FFFFFFF)))
    add("subnormals", f(rng.permutation(nd) + 1))
    add("the whole bit range", f(rng.randint(0, 2**31 - 1, nd)))
    add("five tied values", f(np.int64(0x3F800000) + rng.randint(0, 5, nd)))
    pad = real.clone()
    pad[nd - nd // 3:] = 1e30
    add("the 1e30 sentinel above the true points", pad, (nd - nd // 3) & ~1)
    return torch.stack(rows), torch.tensor(counts, dtype=torch.int32, device=dev), names


def check_k7(name, model, n_true):
    """K7 bit for bit against its plain version on the real rows ``model`` [NW, nd] plus
    the edge rows of ``k7_edge_rows``, at every dial of K7_ITERS, with one count for all
    rows and with a count per row (the real rows: n_true - i % 3).  An even count's
    upper middle is a float mean, so two NaN results count as equal whatever their
    payload; every other result must have the same bits."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    edge, counts, names = k7_edge_rows(model[0])
    rows = torch.cat([model, edge]).contiguous()
    NW = model.shape[0]
    per_row = torch.cat([(int(n_true) - torch.arange(NW, device=model.device) % 3)
                         .to(torch.int32), counts])
    for iters in K7_ITERS:
        for label, n in (("one count", n_true), ("a count per row", per_row)):
            got = seg.median_nonneg(rows, n, iters)
            torch.cuda.synchronize()
            ref = seg.median_nonneg_reference(rows, n, iters)
            same = got.view(torch.int32) == ref.view(torch.int32)
            both_nan = torch.isnan(got) & torch.isnan(ref)
            bad = torch.nonzero(~(same | both_nan)).flatten().tolist()
            print(f"[K7 {name} iters={iters} {label}] {rows.shape[0]} rows: "
                  f"{int(same.sum())} bit-identical, {int((both_nan & ~same).sum())} NaN on "
                  f"both sides with other payloads, {len(bad)} differ")
            require(not bad, f"K7 {name} iters={iters} {label}: rows "
                    + ", ".join(f"{i} ({names[i - NW] if i >= NW else 'real'}: "
                                f"{float(got[i])!r} vs {float(ref[i])!r})" for i in bad[:5])
                    + " differ from the plain version")


def check_lane_boundary(dev):
    """At nd = LARGE_ND both lanes apply: the segmented composition against K3."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    tgt, truth = largend_target(dev, seg.LARGE_ND)
    P = torch.cat([init_walker_batch(tgt, truth, NW_LARGE, seed=3), edge_walkers(truth, tgt)])
    ops = lane_operands(tgt, P)
    check_k6(f"nd={seg.LARGE_ND}", *ops[:4])
    check_k7(f"nd={seg.LARGE_ND}", lane_model(tgt, P[:NW_LARGE]), tgt.n_data_true)
    # K8 and K9 also at recip 1, a dial neither dial set takes
    for label, dials in (("exact", EXACT), ("production", PROD),
                         ("recip 1", dict(PROD, recip_newton=1))):
        check_stats_at(f"nd={seg.LARGE_ND} {label} dials", tgt, P, dials)
    for renorm in (True, False):
        got = seg.spectrum_chi2_segmented(*ops, renorm=renorm, **dial_kwargs(EXACT))
        ref = ck.spectrum_chi2(*ops[:9], renorm=renorm, **dial_kwargs(EXACT))
        torch.cuda.synchronize()
        outside, rel, err = compare(got, ref)
        print(f"[lanes at nd={seg.LARGE_ND}, renorm={renorm}, exact dials] segmented vs K3, "
              f"{P.shape[0]} walkers: {outside} outside tolerance, max rel err {rel:.3e}")
        require(outside == 0, f"segmented vs K3 at nd={seg.LARGE_ND}: {outside} outside")


def largend_fit(tgt, truth, dev):
    """The two-stage fit at nd = ND_FIT through the user entry points: the main path
    of the segmented lane.  Returns the launch counts, the stage-1 wall time, K7's
    launches by median mode ({"exact": the annealer's, "fast" or "exact": stage 2's})
    and K9's by mode ({"raw": the annealer's, without renorm, "renorm": stage 2's})."""
    from mcmc_spec_tpu_torch.inference.anneal import init_walkers, run_anneal
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=dev).manual_seed(0)
    logp = lambda b: log_posterior_batch(b, tgt)
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    p0 = init_walkers(tgt, NW_LARGE, plx=float(truth[-1]), plx_err=0.05e-3, generator=gen)
    params, chi, _ = run_anneal(tgt, p0, gen, steps=LARGE_ANNEAL_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k7_stage1 = ck.LAUNCHES["median_nonneg"]  # the median-only scoring: the exact median
    k9_stage1 = ck.LAUNCHES["resid_chi2"]  # the median-only scoring: K9 without renorm
    take = NW_LARGE // 3
    state = init_ensemble(params[torch.argsort(chi)[:take]], logp, gen)
    state, chain, _ = run_ensemble(state, logp, LARGE_SAMPLE_STEPS, thin=8)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ck.LAUNCHES)
    acc = float(state.n_accept) / (take * LARGE_SAMPLE_STEPS)
    print(f"[largend fit nd={ND_FIT}] stage 1: {NW_LARGE} walkers x 50*{LARGE_ANNEAL_STEPS} "
          f"iterations in {t1 - t0:.2f} s, best chi^2 {float(chi.min()):.2f}, median "
          f"{float(chi.median()):.2f}")
    print(f"[largend fit nd={ND_FIT}] stage 2: {take} walkers x {LARGE_SAMPLE_STEPS} steps in "
          f"{t2 - t1:.2f} s, acceptance {acc:.3f}; launches {launches}")
    require(torch.isfinite(chi).all(), "largend stage 1: non-finite chi^2")
    require(torch.isfinite(state.log_prob).all(), "largend stage 2: non-finite log-probs")
    require(0.0 < acc < 1.0, f"largend stage 2: acceptance {acc} outside (0, 1)")
    for name in ("model_extinct", "median_nonneg", "renorm_partials", "resid_chi2"):
        require(launches[name] > 0, f"{name} was not launched in the large-nd fit")
    for name in ("log_posterior_fused", "spectrum_chi2"):
        require(launches[name] == 0, f"{name} was launched in the large-nd fit")
    stage2_mode = "exact" if tgt.median_iters >= 31 else "fast"
    k7_modes = {"exact": k7_stage1, "fast": 0}
    k7_modes[stage2_mode] += launches["median_nonneg"] - k7_stage1
    print(f"[largend fit nd={ND_FIT}] K7 launches: {k7_stage1} exact in stage 1, "
          f"{launches['median_nonneg'] - k7_stage1} {stage2_mode} in stage 2 (iters "
          f"{tgt.median_iters}); K9 launches: {k9_stage1} without renorm in stage 1 "
          f"({NW_LARGE} walkers), {launches['resid_chi2'] - k9_stage1} with renorm in stage 2 "
          f"({NW_STAGE2} or {take - NW_STAGE2} walkers); K8 launches: "
          f"{launches['renorm_partials']}, all in stage 2")
    k9_modes = {"raw": k9_stage1, "renorm": launches["resid_chi2"] - k9_stage1}
    med = chain[chain.shape[0] // 2:].reshape(-1, tgt.ndim).median(dim=0).values.cpu().numpy()
    for k, (m, t) in enumerate(zip(med, truth)):
        print(f"[largend fit] param {k}: posterior median {m:.6g}, truth {t:.6g}")
    return launches, t1 - t0, k7_modes, k9_modes


def lane_stats_inputs(tgt, P, dials):
    """K6's model rows of walkers ``P``, K7's medians, the scale and K8's coefficients as
    the lane forms them, and the lane's operands."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    ops = lane_operands(tgt, P)
    Wcomb, av, D, kd, data, err, V, Vpinv, med_data, n_true = ops
    kw = dial_kwargs(dials)
    model = seg.model_extinct(Wcomb, av, D, kd)
    med = seg.median_nonneg(model, n_true, kw["iters"])
    scale = med_data.to(torch.float32) / med
    coeffs = seg.renorm_partials(model, scale, data, Vpinv, kw["recip"])
    return model, med, scale, coeffs, ops


def stats_calls(model, scale, coeffs, data, err, V, Vpinv, recip):
    """{name: (kernel call, plain call)} of K8 and K9, where ``resid_chi2`` is K9 with
    renorm (stage 2's evaluation) and ``resid_chi2_raw`` without (the annealer's scoring)."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    return {
        "renorm_partials": (lambda: seg.renorm_partials(model, scale, data, Vpinv, recip),
                            lambda: seg.renorm_partials_reference(model, scale, data, Vpinv,
                                                                  recip)),
        "resid_chi2": (lambda: seg.resid_chi2(model, scale, coeffs, data, err, V, recip),
                       lambda: seg.resid_chi2_reference(model, scale, coeffs, data, err, V,
                                                        recip)),
        "resid_chi2_raw": (
            lambda: seg.resid_chi2(model, scale, None, data, err, V, recip, False),
            lambda: seg.resid_chi2_reference(model, scale, None, data, err, V, recip, False)),
    }


def lane_stats_times(tgt, P, dials):
    """K8 and K9 (renorm on and off) on walkers ``P``: ({name: (kernel ms, plain ms)},
    {name: bound}, {name: device ms alone, with the segment sum}), names as
    ``stats_calls``."""
    model, med, scale, coeffs, ops = lane_stats_inputs(tgt, P, dials)
    data, err, V, Vpinv = ops[4:8]
    NW, nd = model.shape
    calls = stats_calls(model, scale, coeffs, data, err, V, Vpinv, dial_kwargs(dials)["recip"])
    out = {k: (cuda_ms(kern), cuda_ms(ref, reps=5)) for k, (kern, ref) in calls.items()}
    kernel = {"renorm_partials": "renorm_partials_kernel", "resid_chi2": "resid_chi2_kernel",
              "resid_chi2_raw": "resid_chi2_kernel"}
    alone = {k: device_ms(calls[k][0], (kernel[k], "lane_segments_sum_kernel"))
             for k in calls}
    bounds = {
        # a multiply, a divide and three FMAs per point
        "renorm_partials": bound(nbytes(model, scale, data, Vpinv, coeffs), 8 * NW * nd),
        # the scale, the fit (a multiply and two FMAs), a divide, the residual, its square
        # sum; 1/err once a point
        "resid_chi2": bound(nbytes(model, scale, coeffs, data, err, V, med),
                            11 * NW * nd + nd),
        # without renorm: the scale, the residual, its square sum
        "resid_chi2_raw": bound(nbytes(model, scale, data, err, med), 5 * NW * nd + nd),
    }
    return out, bounds, alone


def lane_kernel_times(tgt, P, dials, plain=False):
    """CUDA-event ms of K6-K9 alone on walkers ``P`` (renorm on).  With ``plain``:
    ({name: (kernel ms, plain ms)}, {name: library ms}, {name: bound}, K7's other times
    {"exact": the exact median, "constant 14"/"constant 31": rows of one value}, K6's
    yardsticks {"matmul": ``torch.matmul(Wcomb, D)``, the product without the extinction,
    "fill": ``fill_`` of a model-sized buffer, the write alone; neither is a library call
    for K6}, {name: device ms alone} for K6, K8 and K9), where K8's and K9's entries
    (``resid_chi2_raw``: K9 without renorm, with its own bound) are ``lane_stats_times``'s."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    model, med, scale, coeffs, ops = lane_stats_inputs(tgt, P, dials)
    Wcomb, av, D, kd, data, err, V, Vpinv, med_data, n_true = ops
    iters = dial_kwargs(dials)["iters"]
    calls = {
        "model_extinct": (lambda: seg.model_extinct(Wcomb, av, D, kd),
                          lambda: seg.model_extinct_reference(Wcomb, av, D, kd)),
        "median_nonneg": (lambda: seg.median_nonneg(model, n_true, iters),
                          lambda: seg.median_nonneg_reference(model, n_true, iters)),
    }
    if not plain:
        stats = stats_calls(model, scale, coeffs, data, err, V, Vpinv,
                            dial_kwargs(dials)["recip"])
        calls.update((k, stats[k]) for k in ("renorm_partials", "resid_chi2"))
        return {k: cuda_ms(kern) for k, (kern, _) in calls.items()}
    NW, nd = model.shape
    r1 = (int(n_true) + 1) // 2
    out = {k: (cuda_ms(kern), cuda_ms(ref, reps=5)) for k, (kern, ref) in calls.items()}
    library = {"median_nonneg": cuda_ms(lambda: torch.kthvalue(model, r1, dim=1))}
    const = torch.full_like(model, K7_CONST)
    k7 = {"exact": cuda_ms(lambda: seg.median_nonneg(model, n_true, 31)),
          "constant 14": cuda_ms(lambda: seg.median_nonneg(const, n_true, 14)),
          "constant 31": cuda_ms(lambda: seg.median_nonneg(const, n_true, 31))}
    buf = torch.empty_like(model)
    yard = {"matmul": cuda_ms(lambda: torch.matmul(Wcomb, D)),
            "fill": cuda_ms(lambda: buf.fill_(1.0))}
    alone = {"model_extinct": device_ms(calls["model_extinct"][0], "model_extinct_kernel")}
    bounds = {
        "model_extinct": bound(nbytes(Wcomb, av, D, kd, model),
                               2 * int(torch.count_nonzero(Wcomb)) * nd
                               + 3 * int((av > 0).sum()) * nd),
        # the function's work, whatever computes it: the model read once, the medians out
        "median_nonneg": bound(nbytes(model, med) + 4, 0),
    }
    s_out, s_bounds, s_alone = lane_stats_times(tgt, P, dials)
    out.update(s_out)
    bounds.update(s_bounds)
    alone.update(s_alone)
    return out, library, bounds, k7, yard, alone


def largend_throughput(dev, targets):
    """2,048 walkers (half-step 1,024) at the production and the exact dials, per nd."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble

    rates = {}
    for nd, (tgt, truth) in targets.items():
        for label, dials in (("production", PROD), ("exact", EXACT)):
            t = dataclasses.replace(tgt, **dials)
            logp = lambda b: log_posterior_batch(b, t)
            gen = torch.Generator(device=dev).manual_seed(0)
            P = init_walker_batch(t, truth, 2 * NW_LARGE)
            state = init_ensemble(P, logp, gen)
            state, _, _ = run_ensemble(state, logp, LARGE_WARMUP, thin=LARGE_WARMUP)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, chain, _ = run_ensemble(state, logp, LARGE_TIMED, thin=LARGE_TIMED)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            require(torch.isfinite(chain).all(), f"largend throughput {nd} {label}: non-finite")
            step_ms = 1e3 * dt / LARGE_TIMED
            half = P[:NW_LARGE].contiguous()
            kern = lane_kernel_times(t, half, dials)
            xla = dataclasses.replace(t, spectrum_backend="xla")
            eager = cuda_ms(lambda: log_posterior_batch(half, xla), reps=5)
            rates[(nd, label)] = {"rate": LARGE_TIMED * 2 * NW_LARGE / dt, "step_ms": step_ms,
                                  "kernels": kern, "eager_ms": eager}
            print(f"[largend throughput nd={nd} {label}] {2 * NW_LARGE} walkers x {LARGE_TIMED} "
                  f"steps: {dt:.4f} s, {rates[(nd, label)]['rate']:.1f} evals/s; step "
                  f"{step_ms:.4f} ms, 2 x the four kernels alone {2 * sum(kern.values()):.4f} ms "
                  f"({', '.join(f'{k} {v:.4f}' for k, v in kern.items())}); eager sort "
                  f"composition, one {NW_LARGE}-walker evaluation {eager:.4f} ms")
            if nd == ND_FIT and label == "production":
                busy, n_kernels, top, every = device_busy(
                    lambda: run_ensemble(state, logp, 4, thin=4))
                share = ("not measured (the profiler reported no device time)" if busy is None
                         else f"{busy:.3f}, {n_kernels / 4:.0f} kernel launches per step")
                lane = sum(v for k, v in every.items()
                           if any(n in k for n in LANE_KERNEL_NAMES))
                shares = []
                for kname, kernel in (("K6", "model_extinct_kernel"),
                                      ("K7", "median_kary_kernel"),
                                      ("K8", "renorm_partials_kernel"),
                                      ("K9", "resid_chi2_kernel"),
                                      ("K8/K9 segment sum", "lane_segments_sum_kernel")):
                    kt = sum(v for k, v in every.items() if kernel in k)
                    shares.append(f"{kname} {kt:.4f} ms of {lane:.4f} ms in the lane's "
                                  f"kernels ({kt / lane:.3f}), of {sum(every.values()):.4f} ms "
                                  f"on the device ({kt / sum(every.values()):.3f})"
                                  if lane > 0 else f"{kname} not measured")
                print(f"[largend throughput nd={nd} {label}] device busy share under "
                      f"torch.profiler (4 steps): {share}; top kernels (ms): "
                      f"{[(k, round(v, 4)) for k, v in top]}; {'; '.join(shares)}")
    return rates


def largend_crossover(dev, targets):
    """1,024 walkers per nd at the production dials: the fused posterior K1 and the
    spectrum-chi^2 kernel K3 where their row fits shared memory, the segmented
    composition and the eager sort composition (the spectrum term, renorm on), and
    the log-posterior as the dispatch evaluates it."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.inference.batched import _spec_chi2_xla, log_posterior_batch
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    rows = {}
    for nd in CROSSOVER_ND:
        tgt, truth = targets[nd] if nd in targets else largend_target(dev, nd)
        t = dataclasses.replace(tgt, **PROD)
        P = init_walker_batch(t, truth, NW_LARGE, seed=5)
        ops = lane_operands(t, P)
        NO = ops[0].shape[1]
        wpb = {}
        for name, weight_rows in (("K1", 1 + t.nspec), ("K3", 0)):
            try:
                wpb[name] = ck.walkers_per_block(nd, NO, weight_rows)
            except ValueError:  # not one walker's row fits a block
                wpb[name] = None
        row = {
            "K1 posterior": cuda_ms(lambda: ck.log_posterior_fused(P, t)) if wpb["K1"] else None,
            "K3 spectrum": (cuda_ms(lambda: ck.spectrum_chi2(*ops[:9], **dial_kwargs(PROD)))
                            if wpb["K3"] else None),
            "segmented spectrum": cuda_ms(
                lambda: seg.spectrum_chi2_segmented(*ops, **dial_kwargs(PROD))),
            "eager spectrum": cuda_ms(lambda: _spec_chi2_xla(ops[0], ops[1], t), reps=5),
            "dispatched posterior": cuda_ms(lambda: log_posterior_batch(P, t)),
        }
        rows[nd] = row
        print(f"[largend crossover nd={nd}] {NW_LARGE} walkers, production dials, ms: "
              + ", ".join(f"{k} {'does not fit' if v is None else f'{v:.4f}'}"
                          for k, v in row.items())
              + f"; walkers per block K1 {wpb['K1']}, K3 {wpb['K3']}")
    return rows


def largend_checks(dev):
    """The kernel checks of the large-nd phase; returns the nd = ND_FIT target, its
    truth, the checked walkers and the exact-dial max abs errors."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch

    t0 = time.perf_counter()
    tgt, truth = largend_target(dev, ND_FIT)
    print(f"[largend] bench target nd={ND_FIT} packed in {time.perf_counter() - t0:.1f} s: D "
          f"{tuple(tgt.D.shape)}, model of {NW_LARGE} walkers "
          f"{4 * NW_LARGE * ND_FIT / 1e6:.1f} MB")
    P = torch.cat([init_walker_batch(tgt, truth, NW_LARGE), edge_walkers(truth, tgt)])
    errs = check_lane(f"nd={ND_FIT} exact dials (31, 6, 0)", tgt, P, EXACT, 0, eager=True)
    check_lane(f"nd={ND_FIT} production dials (14, 3, 2)", tgt, P, PROD,
               int(PROD_MAX_OUTSIDE_FRAC * NW_LARGE), eager=False)
    check_k7(f"nd={ND_FIT}", lane_model(tgt, P[:NW_LARGE]), tgt.n_data_true)
    odd, odd_truth = largend_target(dev, ND_ODD)
    Podd = torch.cat([init_walker_batch(odd, odd_truth, NW_LARGE, seed=2),
                      edge_walkers(odd_truth, odd)])
    check_lane(f"nd={ND_ODD} exact dials", odd, Podd, EXACT, 0, eager=True)
    check_lane(f"nd={ND_ODD} production dials", odd, Podd, PROD,
               int(PROD_MAX_OUTSIDE_FRAC * NW_LARGE), eager=False)
    check_k7(f"nd={ND_ODD}", lane_model(odd, Podd[:NW_LARGE]), odd.n_data_true)
    wide, wide_truth = largend_target(dev, ND_WIDE)
    Pw = torch.cat([init_walker_batch(wide, wide_truth, NW_LARGE), edge_walkers(wide_truth, wide)])
    check_k6(f"nd={ND_WIDE}", *lane_operands(wide, Pw)[:4])
    check_k7(f"nd={ND_WIDE}", lane_model(wide, Pw[:NW_LARGE]), wide.n_data_true)
    for label, dials in (("exact", EXACT), ("production", PROD)):
        check_stats_at(f"nd={ND_WIDE} {label} dials", wide, Pw, dials)
    check_k6("past the staged rows", *k6_wide_grid_inputs(dev))
    check_lane_boundary(dev)
    return tgt, truth, P, errs, (wide, wide_truth)


def largend_phase(dev):
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    tgt, truth, P, errs, wide = largend_checks(dev)
    t0 = time.perf_counter()
    launches, stage1_s, k7_modes, k9_modes = largend_fit(tgt, truth, dev)
    print(f"[largend] fit {time.perf_counter() - t0:.1f} s")
    rates = largend_throughput(dev, {ND_FIT: (tgt, truth), ND_WIDE: wide})

    # the kernel report: one half-step at nd = ND_FIT, production dials; K8 and K9 also
    # at the fit's stage-2 half-step
    prod = dataclasses.replace(tgt, **PROD)
    half = P[:NW_LARGE].contiguous()
    times, library, bounds, k7, yard, alone = lane_kernel_times(prod, half, PROD, plain=True)
    stage2 = lane_stats_times(prod, P[:NW_STAGE2].contiguous(), PROD)
    ops = lane_operands(prod, half)
    for k, (ms, plain_ms) in times.items():
        lib = library.get(k)
        print(f"[time {k} production] {NW_LARGE} walkers x nd={ND_FIT}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bounds[k][0]:.5f} ms ({bounds[k][1]})"
              + (f", library (torch.kthvalue) {lib:.4f} ms" if lib is not None else ""))
    print(f"[time model_extinct] {NW_LARGE} walkers x nd={ND_FIT}: kernel "
          f"{times['model_extinct'][0]:.4f} ms (alone on the device "
          f"{fmt_ms(alone['model_extinct'])}); "
          f"torch.matmul(Wcomb, D) alone, the same {4 * NW_LARGE * ND_FIT / 1e6:.0f} MB written "
          f"without the extinction (a yardstick for the row build) {yard['matmul']:.4f} ms; the "
          f"write alone (fill_ of a model-sized buffer) {yard['fill']:.4f} ms; bound "
          f"{bounds['model_extinct'][0]:.5f} ms: the kernel at "
          f"{bounds['model_extinct'][0] / times['model_extinct'][0]:.3f} of it")
    print(f"[time median_nonneg] {NW_LARGE} walkers x nd={ND_FIT}: fast (iters 14) "
          f"{times['median_nonneg'][0]:.4f} ms, exact {k7['exact']:.4f} ms; rows of one value "
          f"{k7['constant 14']:.4f} ms fast, {k7['constant 31']:.4f} ms exact; bound "
          f"{bounds['median_nonneg'][0]:.5f} ms: fast at "
          f"{bounds['median_nonneg'][0] / times['median_nonneg'][0]:.3f} of it, exact at "
          f"{bounds['median_nonneg'][0] / k7['exact']:.3f}")
    # K8 and K9 (with and without renorm) at both shapes: events, alone, share of the bound
    for nw, (t, b, al) in ((NW_LARGE, (times, bounds, alone)),
                           (NW_STAGE2, stage2)):
        for k in ("renorm_partials", "resid_chi2", "resid_chi2_raw"):
            share = "" if al[k] is None else f", alone at {b[k][0] / al[k]:.3f}"
            print(f"[time {k} production] {nw} walkers x nd={ND_FIT}: kernel {t[k][0]:.4f} ms "
                  f"(alone on the device {fmt_ms(al[k])}), plain {t[k][1]:.4f} ms, bound "
                  f"{b[k][0]:.5f} ms ({b[k][1]}): the kernel at {b[k][0] / t[k][0]:.3f} of "
                  f"it{share}")
    # K10, the composition of K6-K9, on the same half-step
    k10 = (cuda_ms(lambda: seg.spectrum_chi2_segmented(*ops, **dial_kwargs(PROD))),
           cuda_ms(lambda: seg.spectrum_chi2_segmented_reference(*ops, **dial_kwargs(PROD)),
                   reps=5))
    print(f"[time spectrum_chi2_segmented (K10) production] {NW_LARGE} walkers x nd={ND_FIT}: "
          f"composition {k10[0]:.4f} ms, plain {k10[1]:.4f} ms, bound (the sum of K6-K9's) "
          f"{sum(b[0] for k, b in bounds.items() if k != 'resid_chi2_raw'):.5f} ms")
    cross = largend_crossover(dev, {ND_FIT: (tgt, truth)})
    return {"errs": errs, "launches": launches, "stage1_s": stage1_s, "rates": rates,
            "times": times, "library": library, "bounds": bounds, "crossover": cross, "k10": k10,
            "k7": k7, "k7_modes": k7_modes, "k9_modes": k9_modes, "yardsticks": yard,
            "alone": alone, "stage2": stage2}


def experiments_checks(dev, tgt, truth):
    """S10, S11, S4 and S12 against their plain versions (and S11 against
    ``torch.kthvalue``, S4 against K3, S12's ``full`` against K1) on the card.
    Returns the max abs errors and the report's times and bounds."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.inference.batched import _forward_small
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import ablate_fused_sections as ab
    from mcmc_spec_tpu_torch.scripts import try_fast_recip as fr
    from mcmc_spec_tpu_torch.scripts import vpu_microbench as vb

    nd = tgt.D.shape[2]
    gen = torch.Generator(device=dev).manual_seed(7)
    same_bits = lambda a, b: int((a.view(torch.int32) == b.view(torch.int32)).all(dim=-1).sum())
    errs, times, bounds, library = {}, {}, {}, {}

    # S10: every element, bit for bit
    x = torch.rand((NWALK_BENCH, nd), generator=gen, device=dev) * 3.75 + 0.25
    for k in vb.CHAIN_K:
        got = vb.fma_chains(x, k)
        torch.cuda.synchronize()
        same = same_bits(got, vb.fma_chains_reference(x, k))
        print(f"[S10 fma_chains k={k}, lanes={vb.CHAIN_LANES}] {NWALK_BENCH} x {nd}: {same} rows "
              "bit-identical to the plain version")
        require(same == NWALK_BENCH, f"S10 k={k}: {NWALK_BENCH - same} rows differ")
    errs["fma_chains"] = 0.0
    k = vb.CHAIN_K[0]
    times["fma_chains"] = (cuda_ms(lambda: vb.fma_chains(x, k)),
                           cuda_ms(lambda: vb.fma_chains_reference(x, k), reps=5))
    bounds["fma_chains"] = bound(2 * nbytes(x), x.numel() * (k * vb.CHAIN_LANES
                                                             + vb.CHAIN_LANES - 1))

    # S11: every row, bit for bit; at 31 passes also the library's order statistics
    for n in (nd, ND_EXP_ODD):
        xm = torch.randn((NWALK_BENCH, n), generator=gen, device=dev).abs()
        xm[:, : n // 3] = xm[:, :1]  # ties
        r1 = (n + 1) // 2
        lib = library_median(xm)
        for iters in (31, 15):
            got = vb.median_only(xm, iters)
            torch.cuda.synchronize()
            same = same_bits(got, vb.median_only_reference(xm, iters))
            same_lib = same_bits(got, lib) if iters == 31 else NWALK_BENCH
            print(f"[S11 median_only nd={n}, iters={iters}] {NWALK_BENCH} rows: {same} "
                  "bit-identical to the plain version"
                  + (f", {same_lib} to torch.kthvalue" if iters == 31 else ""))
            require(same == NWALK_BENCH and same_lib == NWALK_BENCH,
                    f"S11 nd={n} iters={iters}: {NWALK_BENCH - same} rows differ from the plain "
                    f"version, {NWALK_BENCH - same_lib} from torch.kthvalue")
        if n == nd:
            times["median_only"] = (cuda_ms(lambda: vb.median_only(xm, 31)),
                                    cuda_ms(lambda: vb.median_only_reference(xm, 31), reps=5))
            library["median_only"] = cuda_ms(lambda: torch.kthvalue(xm, r1, dim=1))
            bounds["median_only"] = bound(nbytes(xm) + 4 * NWALK_BENCH,
                                          2 * xm.numel() * 32)  # 31 passes + the refinement
    errs["median_only"] = 0.0

    # S4: every dial against the plain version; recip 0 against K3 on the same inputs
    args = fr.synthetic_inputs(dev)
    medd, Wc, av, D, kd, data, ie, Vp, VT = args
    errs["spectrum_recip"] = 0.0
    for recip in (0, 1, 2):
        for noexp in (False, True):
            got = fr.spectrum_recip(*args, recip=recip, noexp=noexp)
            torch.cuda.synchronize()
            ref = fr.spectrum_recip_reference(*args, recip=recip, noexp=noexp)
            outside, rel, err = compare(got, ref)
            errs["spectrum_recip"] = max(errs["spectrum_recip"], err)
            print(f"[S4 spectrum_recip recip={recip} noexp={noexp}] {Wc.shape[0]} walkers: "
                  f"{outside} outside tolerance, max rel err {rel:.3e}, max abs err {err:.3e}")
            require(outside == 0, f"S4 recip={recip} noexp={noexp}: {outside} outside tolerance")
    err_k3 = 1.0 / ie[0]  # K3 takes errors; 1/err is then the same inverse error on both
    ie3 = (1.0 / err_k3)[None, :]
    k3 = ck.spectrum_chi2(Wc, av[:, 0].contiguous(), D, kd[0], data[0], err_k3, VT.T, Vp,
                          medd[0, 0], iters=fr.ITERS, mm_passes=3, recip=0, renorm=True)
    s4 = fr.spectrum_recip(medd, Wc, av, D, kd, data, ie3, Vp, VT, recip=0)
    torch.cuda.synchronize()
    # S4 keeps the block-per-walker body and K3 runs one warp per walker: the model row
    # and the median agree bit for bit, the renorm and chi^2 sums to rounding
    outside, rel, _ = compare(s4[:, 0], k3)
    same = same_bits(s4, k3[:, None])
    print(f"[S4 recip=0 vs K3, iters={fr.ITERS}, renorm on] {Wc.shape[0]} walkers: {outside} "
          f"outside tolerance, max rel diff {rel:.3e} ({same} bit-identical)")
    require(outside == 0, f"S4 vs K3: {outside} walkers outside tolerance")
    times["spectrum_recip"] = (cuda_ms(lambda: fr.spectrum_recip(*args, recip=0)),
                               cuda_ms(lambda: fr.spectrum_recip_reference(*args, recip=0),
                                       reps=5))
    bounds["spectrum_recip"] = bound(nbytes(*args) + 4 * Wc.shape[0],
                                     spectrum_ops(Wc, av, D.shape[1], fr.ITERS))

    # S12: every variant on 16,384 + 5 walkers at both dial sets; full = K1 bit for bit
    nhalf = NWALK_BENCH // 2
    P = torch.cat([init_walker_batch(tgt, truth, nhalf, seed=4), edge_walkers(truth, tgt)])
    errs["posterior_sections"] = 0.0
    for label, dials, allowed in (("exact dials (31, 6, 0)", EXACT, 0),
                                  ("production dials (14, 3, 2)", PROD,
                                   int(PROD_MAX_OUTSIDE_FRAC * nhalf))):
        t = dataclasses.replace(tgt, **dials)
        for variant in ab.VARIANTS:
            got = ab.posterior_sections(P, t, variant)
            torch.cuda.synchronize()
            outside, rel, err = compare(got, ab.posterior_sections_reference(P, t, variant))
            if dials is EXACT:
                errs["posterior_sections"] = max(errs["posterior_sections"], err)
            line = (f"[S12 {variant} {label}] {P.shape[0]} walkers: {outside} outside tolerance "
                    f"(allowed {allowed}), max rel err {rel:.3e}, max abs err {err:.3e}")
            if variant == "full":
                # S12 keeps the block-per-walker body, K1 runs one warp per walker: they
                # agree to rounding
                k1 = ck.log_posterior_fused(P, t)
                out_k, rel_k, _ = compare(got, k1)
                same = same_bits(got[:, None], k1[:, None])
                line += (f"; {out_k} outside tolerance of K1, max rel diff {rel_k:.3e} ({same} "
                         "bit-identical)")
                require(out_k == 0, f"S12 full {label}: {out_k} walkers outside tolerance of K1")
            print(line)
            require(outside <= allowed, f"S12 {variant} {label}: {outside} outside tolerance")
    prod = dataclasses.replace(tgt, **PROD)
    coords = init_walker_batch(prod, truth, NWALK_BENCH)
    times["posterior_sections"] = (
        cuda_ms(lambda: ab.posterior_sections(coords, prod, "full")),
        cuda_ms(lambda: ab.posterior_sections_reference(coords, prod, "full"), reps=5))
    Wcomb = _forward_small(coords, prod)[4]
    bounds["posterior_sections"] = bound(
        nbytes(coords, *ck.kernel_tables(prod).values()) + 4 * NWALK_BENCH,
        spectrum_ops(Wcomb, coords[:, prod.nspec], nd, PROD["median_iters"])
        + posterior_scalar_ops(NWALK_BENCH, prod))
    for name, (ms, plain_ms) in times.items():
        print(f"[time {name}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bounds[name][0]:.5f} ms ({bounds[name][1]})"
              + (f", library (torch.kthvalue) {library[name]:.4f} ms" if name in library else ""))
    return {"errs": errs, "times": times, "bounds": bounds, "library": library}


def experiments_phase(dev, tgt, truth):
    """The kernel checks, then the three experiments' ``main()`` at full size: the
    experiments' main path, with its launch counts."""
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import ablate_fused_sections as ab
    from mcmc_spec_tpu_torch.scripts import try_fast_recip as fr
    from mcmc_spec_tpu_torch.scripts import vpu_microbench as vb

    res = experiments_checks(dev, tgt, truth)
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    mains = {}
    for name, main in (("vpu_microbench", vb.main), ("try_fast_recip", fr.main),
                       ("ablate_fused_sections", ab.main)):
        t1 = time.perf_counter()
        print(f"[experiments] python -m mcmc_spec_tpu_torch.scripts.{name}", flush=True)
        mains[name] = main(device=dev)
        print(f"[experiments] {name}: {time.perf_counter() - t1:.1f} s", flush=True)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    print(f"[experiments] the three experiments in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    for name in ("fma_chains", "median_only", "spectrum_recip", "posterior_sections"):
        require(launches[name] > 0, f"{name} was not launched by the experiments")
    return {**res, "launches": launches, "mains": mains}


def redesign_checks(dev, tgt, truth):
    """S8, S9, S7 and S5 against their plain versions on the card (S8 also against
    K1, S9 and S7 against ``np.median`` semantics and S11, S5 ``baseline`` against S4).
    Returns the max abs errors and the report's times, bounds and library times."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.inference.batched import _forward_small
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import try_fast_recip as fr
    from mcmc_spec_tpu_torch.scripts import try_mxu_overlap as s5
    from mcmc_spec_tpu_torch.scripts import try_packed_median as s7
    from mcmc_spec_tpu_torch.scripts import try_transposed_epilogue as s8
    from mcmc_spec_tpu_torch.scripts import try_whileloop_median as s9
    from mcmc_spec_tpu_torch.scripts import vpu_microbench as vb

    nd = tgt.D.shape[2]
    bits = lambda a: a.contiguous().view(torch.int32)
    same_bits = lambda a, b: int((bits(a) == bits(b)).all(dim=-1).sum())
    errs, times, bounds, library = {}, {}, {}, {}

    # S8: 16,384 + 5 edge walkers at both dial sets, against its plain version and K1
    nhalf = NWALK_BENCH // 2
    P = torch.cat([init_walker_batch(tgt, truth, nhalf, seed=5), edge_walkers(truth, tgt)])
    for label, dials, allowed in (("exact dials (31, 6, 0)", EXACT, 0),
                                  ("production dials (14, 3, 2)", PROD,
                                   int(PROD_MAX_OUTSIDE_FRAC * nhalf))):
        t = dataclasses.replace(tgt, **dials)
        got = s8.posterior_transposed(P, t)
        torch.cuda.synchronize()
        out_p, rel_p, err_p = compare(got, s8.posterior_transposed_reference(P, t))
        out_k, rel_k, _ = compare(got, ck.log_posterior_fused(P, t))
        if dials is EXACT:
            errs["posterior_transposed"] = err_p
        n_fin = int(torch.isfinite(got).sum())
        print(f"[S8 posterior_transposed {label}] {P.shape[0]} walkers ({n_fin} finite): "
              f"{out_p} outside tolerance of the plain version (allowed {allowed}), max rel err "
              f"{rel_p:.3e}, max abs err {err_p:.3e}; {out_k} outside tolerance of K1, max rel "
              f"err {rel_k:.3e}")
        require(out_p <= allowed and out_k <= allowed,
                f"S8 {label}: {out_p} walkers outside tolerance of the plain version, {out_k} "
                "of K1")
    prod = dataclasses.replace(tgt, **PROD)
    coords = init_walker_batch(prod, truth, NWALK_BENCH)
    times["posterior_transposed"] = (
        cuda_ms(lambda: s8.posterior_transposed(coords, prod)),
        cuda_ms(lambda: s8.posterior_transposed_reference(coords, prod), reps=5))
    Wcomb = _forward_small(coords, prod)[4]
    bounds["posterior_transposed"] = bound(
        nbytes(coords, *ck.kernel_tables(prod).values()) + 4 * NWALK_BENCH,
        spectrum_ops(Wcomb, coords[:, prod.nspec], nd, PROD["median_iters"])
        + posterior_scalar_ops(NWALK_BENCH, prod))

    # S9: the script's rows at nd = 1792 and 1791; both variants bit for bit
    for n in (nd, ND_EXP_ODD):
        x = torch.from_numpy(s9.synthetic_rows(s9.NW, n)).to(dev)
        med, passes = s9.median_adaptive(x)
        torch.cuda.synchronize()
        ref, ref_passes = s9.median_adaptive_reference(x)
        fixed = vb.median_only(x, 31)
        want = library_median(x)
        same, same_fixed = same_bits(med, ref), same_bits(fixed, want)
        same_np = same_bits(med, want)
        same_passes = bool(torch.equal(passes, ref_passes))
        print(f"[S9 median_adaptive nd={n}] {x.shape[0]} rows: {same} bit-identical to the plain "
              f"version, {same_np} to np.median (torch.kthvalue; fixed31, S11: {same_fixed}); "
              f"passes per row {'equal to' if same_passes else 'DIFFER from'} the plain "
              f"version's, mean {float(passes.double().mean()):.3f}")
        require(same == same_np == same_fixed == x.shape[0] and same_passes,
                f"S9 nd={n}: {x.shape[0] - same} rows differ from the plain version, "
                f"{x.shape[0] - same_np} from np.median, fixed31 {x.shape[0] - same_fixed}; "
                f"passes equal {same_passes}")
        if n == nd:
            times["median_adaptive"] = (cuda_ms(lambda: s9.median_adaptive(x)),
                                        cuda_ms(lambda: s9.median_adaptive_reference(x), reps=5))
            library["median_adaptive"] = cuda_ms(
                lambda: torch.kthvalue(x, (n + 1) // 2, dim=1))
            # every sweep of this run's rows: a compare and a count (or min) per point
            bounds["median_adaptive"] = bound(nbytes(x) + 8 * x.shape[0],
                                              2 * x.numel() * s9.sweeps_per_row(passes, n))
    errs["median_adaptive"] = 0.0

    # S7: |N(0, 1)| * 1e-14 rows at nd = 1792 and 1791, bit for bit
    for n in (nd, ND_EXP_ODD):
        x = torch.from_numpy(s7.synthetic_rows(s7.NW, n)).to(dev)
        got = s7.median_packed(x)
        torch.cuda.synchronize()
        same = same_bits(got, s7.median_packed_reference(x))
        same_s11 = same_bits(got, vb.median_only(x, 31))
        same_lib = same_bits(got, library_median(x))
        print(f"[S7 median_packed nd={n}] {x.shape[0]} rows: {same} bit-identical to the plain "
              f"version, {same_s11} to S11 at 31 passes, {same_lib} to np.median (torch.kthvalue)")
        require(same == same_s11 == same_lib == x.shape[0],
                f"S7 nd={n}: {x.shape[0] - same} rows differ from the plain version, "
                f"{x.shape[0] - same_s11} from S11, {x.shape[0] - same_lib} from the library")
        if n == nd:
            times["median_packed"] = (cuda_ms(lambda: s7.median_packed(x)),
                                      cuda_ms(lambda: s7.median_packed_reference(x), reps=5))
            library["median_packed"] = cuda_ms(lambda: torch.kthvalue(x, (n + 1) // 2, dim=1))
            # 16 coarse passes (2 keys a word: subtract, mask, popcount, add), 16 fine
            # passes and the refinement, a compare and a count per point each
            bounds["median_packed"] = bound(nbytes(x) + 4 * x.shape[0],
                                            2 * x.numel() * (s7.COARSE_PASSES
                                                             + s7.FINE_PASSES + 1))
    errs["median_packed"] = 0.0

    # S5: every mode on the synthetic and the production inputs
    errs["spectrum_overlap"] = 0.0
    s4 = fr.synthetic_inputs(dev)
    for label, args in (("synthetic", s4), ("production", s5.production_inputs(prod, coords))):
        base = s5.spectrum_overlap(*args, mode="baseline")
        for mode in s5.MODES:
            got = s5.spectrum_overlap(*args, mode=mode)
            torch.cuda.synchronize()
            ref = s5.spectrum_overlap_reference(*args, mode=mode)
            if mode == "nomxu" and not bool(torch.isfinite(ref).any()):
                # the production weights put no walker on grid point 0: every nomxu row is
                # 0 and every chi^2 NaN, on both sides
                outside = int((torch.isfinite(got) != torch.isfinite(ref)).sum())
                line = (f"[S5 spectrum_overlap {mode} {label}] {got.shape[0]} walkers: no "
                        f"finite value (Wc[:, 0] = 0, a zero row); {outside} differ in finiteness")
            else:
                outside, rel, err = compare(got, ref)
                errs["spectrum_overlap"] = max(errs["spectrum_overlap"], err)
                line = (f"[S5 spectrum_overlap {mode} {label}] {got.shape[0]} walkers: {outside} "
                        f"outside tolerance, max rel err {rel:.3e}, max abs err {err:.3e}")
            if mode in ("stagger2", "stagger4"):
                same = same_bits(got, base)
                line += f"; {same} bit-identical to baseline"
                require(same == got.shape[0], f"S5 {mode} {label}: {got.shape[0] - same} "
                        "walkers differ from baseline")
            print(line)
            require(outside == 0, f"S5 {mode} {label}: {outside} walkers outside tolerance")
    base = s5.spectrum_overlap(*s4, mode="baseline")
    same = same_bits(base, fr.spectrum_recip(*s4, recip=s5.RECIP))
    print(f"[S5 baseline vs S4 recip={s5.RECIP}, iters={s5.ITERS}] {base.shape[0]} walkers: "
          f"{same} bit-identical")
    require(same == base.shape[0], f"S5 baseline vs S4: {base.shape[0] - same} walkers differ")
    times["spectrum_overlap"] = (
        cuda_ms(lambda: s5.spectrum_overlap(*s4, mode="baseline")),
        cuda_ms(lambda: s5.spectrum_overlap_reference(*s4, mode="baseline"), reps=5))
    bounds["spectrum_overlap"] = bound(nbytes(*s4) + 4 * s4[1].shape[0],
                                       spectrum_ops(s4[1], s4[2], nd, s5.ITERS))
    for name, (ms, plain_ms) in times.items():
        print(f"[time {name}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bounds[name][0]:.5f} ms ({bounds[name][1]})"
              + (f", library (torch.kthvalue) {library[name]:.4f} ms" if name in library else ""))
    return {"errs": errs, "times": times, "bounds": bounds, "library": library}


def redesign_phase(dev, tgt, truth):
    """The kernel checks, then the four experiments' ``main()`` at full size: their main
    path, with its launch counts."""
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import try_mxu_overlap as s5
    from mcmc_spec_tpu_torch.scripts import try_packed_median as s7
    from mcmc_spec_tpu_torch.scripts import try_transposed_epilogue as s8
    from mcmc_spec_tpu_torch.scripts import try_whileloop_median as s9

    res = redesign_checks(dev, tgt, truth)
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    mains = {}
    for name, main in (("try_transposed_epilogue", s8.main), ("try_whileloop_median", s9.main),
                       ("try_packed_median", s7.main), ("try_mxu_overlap", s5.main)):
        t1 = time.perf_counter()
        print(f"[redesign] python -m mcmc_spec_tpu_torch.scripts.{name}", flush=True)
        mains[name] = main(device=dev)
        print(f"[redesign] {name}: {time.perf_counter() - t1:.1f} s", flush=True)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    print(f"[redesign] the four experiments in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    for name in ("posterior_transposed", "median_adaptive", "median_packed", "spectrum_overlap"):
        require(launches[name] > 0, f"{name} was not launched by the experiments")
    return {**res, "launches": launches, "mains": mains}


def probes_checks(dev):
    """S6's two orders against each other (bit for bit) and their plain version, and K4
    v2 against S6 ``target_major`` (K4 v1's body), on the ragged fleet of phase 6; S1-S3
    against their plain versions at full size, every variant.  Returns the max abs
    errors, the report's times (graph and eager), bounds and library times."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import dma_probe as s1
    from mcmc_spec_tpu_torch.scripts import dma_probe_bisect as s2
    from mcmc_spec_tpu_torch.scripts import dma_probe_bisect2 as s3
    from mcmc_spec_tpu_torch.scripts import try_fleet_grid_order as s6
    from mcmc_spec_tpu_torch.scripts.timing import graph_timer

    bits = lambda a: a.contiguous().view(torch.int32)
    errs, times, bounds, library = {}, {}, {}, {}

    # S6: the ragged padded fleet, 9 x (4096 + 5 edge walkers), both dial sets and orders
    fleet, singles, truth = build_fleet(dev)
    cloud = torch.stack([init_walker_batch(t, truth, NW_FLEET, seed=1 + i)
                         for i, t in enumerate(singles)])
    P = torch.cat([cloud, torch.stack([edge_walkers(truth, t) for t in singles])], dim=1)
    W, av = fleet_wcomb(P, fleet), P[..., fleet.nspec].contiguous()
    n = P.shape[0] * P.shape[1]
    errs["spectrum_chi2_fleet_2d"] = 0.0
    for label, dials, allowed in (("exact dials (31, 6, 0)", EXACT, 0),
                                  ("production dials (14, 3, 2)", PROD,
                                   int(PROD_MAX_OUTSIDE_FRAC * NTGT * NW_FLEET))):
        fl = dataclasses.replace(fleet, **dials)
        ref = s6.spectrum_chi2_fleet_2d_reference(W, av, fl)
        got = {order: s6.spectrum_chi2_fleet_2d(W, av, fl, order) for order in s6.ORDERS}
        torch.cuda.synchronize()
        for order, out in got.items():
            same = int((bits(out) == bits(got["target_major"])).sum())
            outside, rel, err = compare(out.flatten(), ref.flatten())
            if dials is EXACT:
                errs["spectrum_chi2_fleet_2d"] = max(errs["spectrum_chi2_fleet_2d"], err)
            print(f"[S6 spectrum_chi2_fleet_2d {order} {label}] {n} walkers: {same} "
                  f"bit-identical to target_major; {outside} outside tolerance of the plain "
                  f"version (allowed {allowed}), max rel err {rel:.3e}, max abs err {err:.3e}")
            require(same == n, f"S6 {order} {label}: {n - same} walkers differ from "
                    "target_major")
            require(outside <= allowed, f"S6 {order} {label}: {outside} walkers outside "
                    "tolerance")
        # K4 v2 sums in another order than v1's body, so the gate and not the bits
        k4 = ck.spectrum_chi2_fleet(W, av, fl)
        torch.cuda.synchronize()
        outside, rel, err = compare(k4.flatten(), got["target_major"].flatten())
        print(f"[K4 v2 vs S6 target_major (K4 v1's body) {label}] {n} walkers: {outside} "
              f"outside tolerance (allowed {allowed}), max rel err {rel:.3e}, max abs err "
              f"{err:.3e}")
        require(outside <= allowed, f"K4 v2 vs S6 target_major {label}: {outside} walkers "
                "outside tolerance")
    # times at production dials on the 9 x 4096 cloud, K4 and the two orders in turns
    prod = dataclasses.replace(fleet, **PROD)
    Wc, avc = fleet_wcomb(cloud, prod), cloud[..., fleet.nspec].contiguous()
    fns = {"K4": lambda: ck.spectrum_chi2_fleet(Wc, avc, prod)}
    fns.update({o: (lambda o=o: s6.spectrum_chi2_fleet_2d(Wc, avc, prod, o)) for o in s6.ORDERS})
    order_ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        order_ms[k].append(cuda_ms(fns[k]))
    order_ms = {k: min(v) for k, v in order_ms.items()}
    print(f"[time S6 production] {NTGT} x {NW_FLEET} walkers, in turns K4 v2 (one warp per "
          f"walker), target_major and walker_major (K4 v1's body, one block per walker) and "
          f"back, least of two: " + ", ".join(
              f"{k} {v:.4f} ms ({100 * (v - order_ms['K4']) / order_ms['K4']:+.2f}% vs K4 v2)"
              for k, v in order_ms.items()))
    tabs = ck.fleet_kernel_tables(prod)
    nd = fleet.D.shape[-1]
    times["spectrum_chi2_fleet_2d"] = (
        order_ms["target_major"], None,
        cuda_ms(lambda: s6.spectrum_chi2_fleet_2d_reference(Wc, avc, prod), reps=5))
    bounds["spectrum_chi2_fleet_2d"] = bound(
        nbytes(Wc, avc, *(tabs[k] for k in ("D", "kd", "data", "inv_err", "VpinvT", "VT", "scal",
                                            "ranks"))) + 4 * NTGT * NW_FLEET,
        spectrum_ops(Wc, avc, nd, PROD["median_iters"]))

    # S1-S3: the scripts' own inputs at full size, every configuration of each
    graph_ms = lambda fn: 1e3 * graph_timer(dev)(fn)

    def gate_probe(name, label, got_fn, ref_fn, total=None):
        """The gate, then a tighter check.  ``total`` None: the kernel equals its plain
        version bit for bit (both sum each row, then add the table term, in one order).
        Else ``(p, plain table total)`` of a full read: the table total that the output
        gives back, ``out - row sum of p``, is within TOTAL_RTOL of the plain one, beside
        the rounding of ``out`` (2^-23 |out|)."""
        got = got_fn()
        torch.cuda.synchronize()
        ref = ref_fn()
        outside, rel, err = compare(got, ref)
        fin = bool(torch.isfinite(got).all())
        errs[name] = max(errs.get(name, 0.0), err)
        n = got.shape[0]
        if total is None:
            same = int((bits(got) == bits(ref)).sum())
            tight, ok = f"{same} of {n} bit-identical to the plain version", same == n
        else:
            p, want = total[0], total[1].double()
            back = got.double() - s1.row_sum_reference(p).double()
            slack = TOTAL_RTOL * want.abs() + 2.0 ** -23 * got.double().abs()
            worst = float(((back - want).abs() / slack).max())
            tight = (f"table total out - row sum: max rel err "
                     f"{float((back - want).abs().max() / want.abs()):.3e} against the plain "
                     f"{float(want):.7e}, {worst:.3f} of the slack (rtol {TOTAL_RTOL:g} + "
                     "the rounding of out)")
            ok = worst <= 1.0
        print(f"[{name} {label}] {n} walkers: {outside} outside tolerance, max rel err "
              f"{rel:.3e}, max abs err {err:.3e}, all finite {fin}; {tight}")
        require(outside == 0 and fin, f"{name} {label}: {outside} walkers outside tolerance, "
                f"all finite {fin}")
        require(ok, f"{name} {label}: {tight}")

    for nd1, block, ntab in ([(d, s1.BLOCK, k) for d in s1.ND_SWEEP for k in s1.NTAB_SWEEP]
                             + [(s1.ND_SWEEP[1], b, 6) for b in s1.BLOCK_SWEEP]):
        p, tables = s1.to_device(dev, *s1.trivial_arrays(nd1, ntab, s1.NW))
        gate_probe("trivial_probe", f"nd={nd1} ntab={ntab} block={block}",
                   lambda: s1.trivial_probe(p, tables, block),
                   lambda: s1.trivial_probe_reference(p, tables))
    p, _ = s1.to_device(dev, *s1.trivial_arrays(s1.ND_SWEEP[1], 0, s1.NW))
    times["trivial_probe"] = (graph_ms(lambda: s1.trivial_probe(p, [])),
                              cuda_ms(lambda: s1.trivial_probe(p, [])),
                              graph_ms(lambda: s1.trivial_probe_reference(p, [])))
    library["trivial_probe"] = graph_ms(lambda: torch.sum(p, 1))
    bounds["trivial_probe"] = bound(s1.trivial_bytes(s1.NW, 0), 8 * s1.NW)

    for variant in s2.VARIANTS:
        p, tables, scal, body = s2.bisect_inputs(dev, variant, s2.NW, s2.ND)
        gate_probe("bisect_probe", variant, lambda: s2.bisect_probe(p, tables, scal, body),
                   lambda: s2.bisect_probe_reference(p, tables, scal, body))
    times["bisect_probe"] = (graph_ms(lambda: s2.bisect_probe(p, tables, scal, body)),
                             cuda_ms(lambda: s2.bisect_probe(p, tables, scal, body)),
                             graph_ms(lambda: s2.bisect_probe_reference(p, tables, scal, body)))
    bounds["bisect_probe"] = bound(s2.bisect_bytes(s2.NW, p.shape[1]),
                                   s2.bisect_ops(s2.NW, body))

    runs = [(v, shapes, read, s3.BLOCK) for v, (shapes, read) in s3.variants(s3.ND).items()]
    for variant, shapes, read, block in runs + [("realmix", s3.realmix(s3.ND), "full", 1)]:
        p, tables = s1.to_device(dev, *s3.bisect2_arrays(shapes, s3.NW))
        gate_probe("bisect2_probe", f"{variant} block={block}",
                   lambda: s3.bisect2_probe(p, tables, read, block),
                   lambda: s3.bisect2_probe_reference(p, tables, read),
                   None if read == "peek" else (p, s3.table_total_reference(tables, read)))
    # the last run: realmix at one walker a block, K1's block count
    times["bisect2_probe"] = (graph_ms(lambda: s3.bisect2_probe(p, tables, "full", 1)),
                              cuda_ms(lambda: s3.bisect2_probe(p, tables, "full", 1)),
                              graph_ms(lambda: s3.bisect2_probe_reference(p, tables, "full")))
    nfloat = s3.table_floats(s3.realmix(s3.ND))
    bounds["bisect2_probe"] = bound(s3.bisect2_bytes(s3.NW, s3.realmix(s3.ND), "full"),
                                    nfloat + 9 * s3.NW)
    labels = {"spectrum_chi2_fleet_2d": f"target_major, {NTGT} x {NW_FLEET} production dials",
              "trivial_probe": "ntab=0, 256 walkers a block",
              "bisect_probe": "all, 256 walkers a block",
              "bisect2_probe": "realmix, one walker a block"}
    for name, (ms, eager, plain_ms) in times.items():
        print(f"[time {name}] {labels[name]}: kernel {ms:.5f} ms"
              + (" (CUDA graph, per launch)" if eager is not None else "")
              + (f", eager {eager:.5f} ms" if eager is not None else "")
              + f", plain {plain_ms:.5f} ms, bound {bounds[name][0]:.6f} ms ({bounds[name][1]})"
              + (f", library (torch.sum) {library[name]:.5f} ms" if name in library else ""))
    return {"errs": errs, "times": times, "bounds": bounds, "library": library}


def probes_phase(dev):
    """The checks, then the four scripts' ``main()`` at full size: their main path, with
    its launch counts.  The graph replays pass no wrapper: each ``main`` prints and
    returns them, and the kernel report gives them as ``graph_replays``."""
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import dma_probe as s1
    from mcmc_spec_tpu_torch.scripts import dma_probe_bisect as s2
    from mcmc_spec_tpu_torch.scripts import dma_probe_bisect2 as s3
    from mcmc_spec_tpu_torch.scripts import try_fleet_grid_order as s6

    t0 = time.perf_counter()
    res = probes_checks(dev)
    print(f"[probes] checks in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    mains = {}
    for name, main in (("try_fleet_grid_order", s6.main), ("dma_probe", s1.main),
                       ("dma_probe_bisect", s2.main), ("dma_probe_bisect2", s3.main)):
        t1 = time.perf_counter()
        print(f"[probes] python -m mcmc_spec_tpu_torch.scripts.{name}", flush=True)
        mains[name] = main(device=dev)
        print(f"[probes] {name}: {time.perf_counter() - t1:.1f} s", flush=True)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    print(f"[probes] the four scripts in {time.perf_counter() - t0:.1f} s; launches {launches}")
    for name in ("spectrum_chi2_fleet_2d", "trivial_probe", "bisect_probe", "bisect2_probe"):
        require(launches[name] > 0, f"{name} was not launched by the scripts")
    return {**res, "launches": launches, "mains": mains}


def main() -> int:
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    dev, smi = timed("device", device_phase)
    timed("build", build_phase)
    tgt, truth, kres = timed("kernels", kernels_phase, dev)
    launches, stage1_s = timed("fit", fit_phase, tgt, truth, dev)
    k1_ms = {label: kres["times"][("k1", label)][0] for label in ("production", "exact")}
    rates = timed("throughput", throughput_phase, tgt, truth, dev, k1_ms)
    fres = timed("fleet", fleet_phase, dev)
    lres = timed("large nd", largend_phase, dev)
    eres = timed("experiments", experiments_phase, dev, tgt, truth)
    rres = timed("redesign", redesign_phase, dev, tgt, truth)
    pres = timed("probes", probes_phase, dev)
    probes_s = phase_s["probes"]
    print(f"[probes] phase 10 in {probes_s:.1f} s (budget {PROBES_BUDGET_S} s"
          + (")" if probes_s <= PROBES_BUDGET_S else ", OVER BUDGET)"))
    lr = lres["rates"]
    print(f"[summary] {smi}: stage-2 {rates['production']:.1f} evals/s (production dials), "
          f"{rates['exact']:.1f} evals/s (exact dials); stage-1 wall {stage1_s:.2f} s; fleet "
          f"{NTGT} x {NW_FLEET}: composed (K4) {fres['composed']['rate']:.1f} evals/s, "
          f"fused (K5) {fres['fused']['rate']:.1f} evals/s; large nd: "
          + ", ".join(f"nd={nd} {label} {lr[(nd, label)]['rate']:.1f} evals/s"
                      for nd, label in lr))
    print(f"[summary] phase wall times (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; total {time.perf_counter() - t_start:.1f}")
    k1_ms_prod, k1_plain_prod = kres["times"][("k1", "production")]
    k3_ms, k3_plain = kres["times"][("k3", NWALK_BENCH // 2)]
    rows = [
        ("log_posterior_fused", "log_posterior_fused.cu", 743, launches["log_posterior_fused"],
         kres["k1_err"], k1_ms_prod, k1_plain_prod, kres["bounds"]["k1"]),
        ("spectrum_chi2", "spectrum_chi2.cu", 444, launches["spectrum_chi2"], kres["k3_err"],
         k3_ms, k3_plain, kres["bounds"]["k3"]),
        ("spectrum_chi2_fleet", "spectrum_chi2_fleet.cu", 345, fres["composed"]["launches"],
         fres["errs"][0], *fres["times"]["k4"], fres["bounds"]["k4"]),
        ("log_posterior_fleet_fused", "log_posterior_fleet_fused.cu", 1057,
         fres["fused"]["launches"], fres["errs"][1], *fres["times"]["k5"], fres["bounds"]["k5"]),
    ]
    rows = [(name, src, f"mcmc_spec_tpu/ops/pallas_kernels.py:{line}", n, err, ms, plain_ms, b,
             None)
            for name, src, line, n, err, ms, plain_ms, b in rows]
    # the segmented lane, mcmc_spec_tpu/ops/spec_segmented.py
    for name, src, line in (("model_extinct", "model_extinct.cu", 94),
                            ("median_nonneg", "median_kary.cu", 215),
                            ("renorm_partials", "segmented_stats.cu", 339),
                            ("resid_chi2", "segmented_stats.cu", 377)):
        rows.append((name, src, f"mcmc_spec_tpu/ops/spec_segmented.py:{line}",
                     lres["launches"][name],
                     lres["errs"][name], *lres["times"][name], lres["bounds"][name],
                     lres["library"].get(name)))
    # the cost-attribution experiments, scripts/
    for name, src, where in (("fma_chains", "microbench.cu", "vpu_microbench.py:74"),
                             ("median_only", "microbench.cu", "vpu_microbench.py:97"),
                             ("spectrum_recip", "spectrum_recip.cu", "try_fast_recip.py:105"),
                             ("posterior_sections", "posterior_sections.cu",
                              "ablate_fused_sections.py:42")):
        rows.append((name, src, f"scripts/{where}", eres["launches"][name], eres["errs"][name],
                     *eres["times"][name], eres["bounds"][name], eres["library"].get(name)))
    # the K1 redesign experiments, scripts/
    for name, src, where in (("posterior_transposed", "posterior_transposed.cu",
                              "try_transposed_epilogue.py:189"),
                             ("median_adaptive", "median_adaptive.cu",
                              "try_whileloop_median.py:111"),
                             ("median_packed", "median_packed.cu", "try_packed_median.py:119"),
                             ("spectrum_overlap", "spectrum_overlap.cu", "try_mxu_overlap.py:106")):
        rows.append((name, src, f"scripts/{where}", rres["launches"][name], rres["errs"][name],
                     *rres["times"][name], rres["bounds"][name], rres["library"].get(name)))
    # the fleet grid order and the launch-cost probes, scripts/; the probes' kernel time is
    # per launch in a CUDA graph (the eager times are printed above)
    for name, src, where in (("spectrum_chi2_fleet_2d", "fleet_grid_order.cu",
                              "try_fleet_grid_order.py:59"),
                             ("trivial_probe", "launch_probe.cu", "dma_probe.py:39"),
                             ("bisect_probe", "launch_probe.cu", "dma_probe_bisect.py:57"),
                             ("bisect2_probe", "launch_probe.cu", "dma_probe_bisect2.py:63")):
        ms, _, plain_ms = pres["times"][name]
        rows.append((name, src, f"scripts/{where}", pres["launches"][name], pres["errs"][name],
                     ms, plain_ms, pres["bounds"][name], pres["library"].get(name)))
    # `launches` counts where a wrapper launches; the probes' mains also replay CUDA graphs
    # of those launches, which no wrapper sees: `graph_replays` counts them
    replays = {name: pres["mains"][script]["replayed"]
               for name, script in (("trivial_probe", "dma_probe"),
                                    ("bisect_probe", "dma_probe_bisect"),
                                    ("bisect2_probe", "dma_probe_bisect2"))}
    report = [
        {"name": name, "route": "cuda", "source": f"mcmc_spec_tpu_torch/csrc/{src}",
         "replaces": where, "launches": n, "graph_replays": replays.get(name, 0),
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
         "library_ms": lib}
        for name, src, where, n, err, ms, plain_ms, b, lib in rows]
    # K7's launches by median mode in the large-nd fit (the annealer's exact scoring, stage
    # 2's fast median) and its exact time beside `ms`, the fast one
    k7 = next(r for r in report if r["name"] == "median_nonneg")
    k7.update({"launches_exact": lres["k7_modes"]["exact"],
               "launches_fast": lres["k7_modes"]["fast"], "ms_exact": lres["k7"]["exact"]})
    # K9 without renorm (the annealer's scoring), timed and bounded beside `ms`, which is
    # with renorm, and its launches by mode in the large-nd fit
    k9 = next(r for r in report if r["name"] == "resid_chi2")
    k9.update({"ms_raw": lres["times"]["resid_chi2_raw"][0],
               "bound_ms_raw": lres["bounds"]["resid_chi2_raw"][0],
               "launches_raw": lres["k9_modes"]["raw"],
               "launches_renorm": lres["k9_modes"]["renorm"]})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
