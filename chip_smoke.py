#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``mcmc_spec_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the kernels of ``mcmc_spec_tpu_torch/csrc`` with nvcc;
3. kernels vs plain: the fused-posterior (K1) and spectrum-chi^2 (K3) kernels
   against their plain PyTorch versions on the card, with CUDA-event times;
4. the two-stage fit on the koi2298-scale bench target: annealer (K3) on
   3,072 walkers, top third seeds the stretch sampler (K1), launch counts;
5. throughput: the bench workload, 32,768 walkers, 128 timed steps, at the
   production and the exact dials;
6. fleet: nine ragged koi2298-scale targets (nd 1792 ... 1408, 2 or 1
   contrasts) padded to (1792, 2) and stacked, 4,096 walkers each: the fleet
   spectrum-chi^2 (K4) and fused fleet posterior (K5) kernels against their
   plain versions and K5 against K1 on the unpadded targets, then
   ``run_fleet_ensemble`` (16 warm-up + 64 timed steps) on the composed
   default (K4) and with ``MCMC_SPEC_FUSED_EVAL=1`` (K5), with launch counts
   and the device busy share under ``torch.profiler``;
7. large nd: the segmented lane (K6 model with extinction, K7 k-ary median,
   K8 renorm partials, K9 chi^2 residual) on the bench target at nd = 65,536
   (the JAX package's ``largend`` cell) and 131,072: each kernel and the
   composition against their plain versions (K7 bit for bit) at 1,024 + 5
   walkers, again at the untileable odd nd = 65,535, the composition against
   K3 at nd = 4,096 where the dispatch switches lanes, the two-stage fit at
   nd = 65,536 through ``log_posterior_batch`` and ``optimizer_chi2_batch``,
   the throughput of 2,048 walkers (16 warm-up + 128 timed steps), and a
   crossover of the lanes at 1,024 walkers from nd = 4,096 to 65,536;
8. experiments: the cost-attribution kernels of ``mcmc_spec_tpu_torch.scripts``
   against their plain versions on the card (S10 multiply chains and S11 row
   median bit for bit, S11 also against ``torch.kthvalue``; S4 spectrum with
   the reciprocal dial at every dial, and bit for bit against K3 at recip 0;
   S12 fused-posterior sections, every variant on 16,384 + 5 walkers at both
   dial sets, and ``full`` bit for bit against K1), then the three
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
10. fleet order and launch probes: S6 (K4's body under an explicit grid order)
   on the ragged fleet of phase 6, both orders at both dial sets, bit for bit
   against K4 and within the gate of its plain version; S1-S3 (trivial
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
median count pass is a compare and an add per point and threshold.  The
multiply chains of S10 count one operation per multiply and per add, so their
bound holds them against 67 TFLOP/s, twice the rate of one multiply per FP32
lane per clock (S10 measures the latter).

The line before the last is the kernel report (JSON, twenty kernels); the last line is
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
    """(device busy share of the wall time, kernel launches, top kernels [(name, ms)]) of
    ``fn()`` under ``torch.profiler``; (None, 0, []) where it reports no device time."""
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
        return None, 0, []
    top = sorted(kernels, key=dev_us, reverse=True)[:4]
    return (total * 1e-6 / wall, sum(e.count for e in kernels),
            [(e.key[:60], dev_us(e) * 1e-3) for e in top])


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


def kernels_phase(dev):
    from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
    from mcmc_spec_tpu_torch.inference.batched import _forward_small
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    tgt, truth = build_bench_target(torch.float32, device=dev)
    print(f"[kernels] bench target packed in {time.perf_counter() - t0:.1f} s: "
          f"D {tuple(tgt.D.shape)}, nc {tgt.n_contrast}, npf {tgt.n_phot}, ndim {tgt.ndim}")
    exact = dataclasses.replace(tgt, **EXACT)
    prod = dataclasses.replace(tgt, **PROD)
    nhalf = NWALK_BENCH // 2
    cloud = init_walker_batch(tgt, truth, nhalf)
    P = torch.cat([cloud, edge_walkers(truth, tgt)])

    err_k1 = check_k1("exact dials (31, 6, 0)", exact, P, 0)
    check_k1("production dials (14, 3, 2)", prod, P,
             int(PROD_MAX_OUTSIDE_FRAC * nhalf))

    small2, truth2 = build_bench_target(torch.float32, device=dev, nd=400, grid_step=8.0)
    # odd nd: the exact median's odd-row branch
    small3, truth3 = build_bench_target(torch.float32, device=dev, nd=401, grid_step=8.0, nspec=3)
    for name, t, tr in (("rad_prior", dataclasses.replace(small2, rad_prior=True, **EXACT), truth2),
                        ("triple nd=401", dataclasses.replace(small3, **EXACT), truth3),
                        ("nospec", dataclasses.replace(small2, spectrum_weight=0.0, **EXACT), truth2)):
        Ps = torch.cat([init_walker_batch(t, tr, 1024, seed=2), edge_walkers(tr, t)])
        check_k1(name, t, Ps, 0)

    # K3 on the same walkers' blend weights
    _, _, _, _, Wcomb = _forward_small(cloud, exact)
    av = cloud[:, exact.nspec].contiguous()
    nT, nG, nd = exact.D.shape
    args = (Wcomb, av, exact.D.reshape(nT * nG, nd), exact.ext_k_data, exact.data_flux,
            exact.data_err, exact.V, exact.Vpinv, exact.med_data)
    err_k3 = 0.0
    for renorm in (True, False):
        got = ck.spectrum_chi2(*args, iters=31, mm_passes=6, recip=0, renorm=renorm)
        torch.cuda.synchronize()
        ref = ck.spectrum_chi2_reference(*args, iters=31, mm_passes=6, recip=0, renorm=renorm)
        outside, rel, err = compare(got, ref)
        err_k3 = max(err_k3, err)
        print(f"[K3 renorm={renorm}] {nhalf} walkers: {outside} outside tolerance, "
              f"max rel err {rel:.3e}, max abs err {err:.3e}")
        require(outside == 0, f"K3 renorm={renorm}: {outside} walkers outside tolerance")

    # times at the bench shapes: one stage-2 half batch; K3 in its stage-1 mode
    # (the bounds are computed for the timed calls' inputs)
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
        k = cuda_ms(lambda: ck.log_posterior_fused(cloud, t))
        r = cuda_ms(lambda: ck.log_posterior_fused_reference(cloud, t))
        times[("k1", label)] = (k, r)
        print(f"[time K1 {label}] {nhalf} walkers: kernel {k:.4f} ms, plain {r:.4f} ms")
    for nw in (nhalf, 3072):
        a3 = (Wcomb[:nw].contiguous(), av[:nw].contiguous()) + args[2:]
        k = cuda_ms(lambda: ck.spectrum_chi2(*a3, iters=31, mm_passes=6, recip=0, renorm=False))
        r = cuda_ms(lambda: ck.spectrum_chi2_reference(*a3, iters=31, mm_passes=6, recip=0,
                                                       renorm=False))
        times[("k3", nw)] = (k, r)
        print(f"[time K3 renorm=False exact median] {nw} walkers: kernel {k:.4f} ms, "
              f"plain {r:.4f} ms")
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
    busy, n_kernels, top = device_busy(lambda: run_fleet_ensemble(state, fleet, 4, thin=4))
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
    coeffs = seg.renorm_partials(model, scale, data, Vpinv, recip)
    torch.cuda.synchronize()
    res["renorm_partials"] = compare(
        coeffs, seg.renorm_partials_reference(model, scale, data, Vpinv, recip))
    for renorm in (True, False):
        got = seg.resid_chi2(model, scale, coeffs, data, err, V, recip, renorm)
        torch.cuda.synchronize()
        ref = seg.resid_chi2_reference(model, scale, coeffs, data, err, V, recip, renorm)
        res[f"resid_chi2 renorm={renorm}"] = compare(got, ref)
    for renorm in (True, False):
        got = seg.spectrum_chi2_segmented(*ops, renorm=renorm, **kw)
        torch.cuda.synchronize()
        ref = seg.spectrum_chi2_segmented_reference(*ops, renorm=renorm, **kw)
        res[f"composition renorm={renorm}"] = compare(got, ref)
        if eager:
            sort = (_spec_chi2_xla if renorm else _spec_chi2_xla_median_only)(Wcomb, av, tgt)
            res[f"composition vs eager sort renorm={renorm}"] = compare(got, sort)
    for k, (outside, rel, err_abs) in res.items():
        print(f"[{k} {name}] {NW} walkers: {outside} outside tolerance (allowed {max_outside}), "
              f"max rel err {rel:.3e}, max abs err {err_abs:.3e}")
        require(outside <= max_outside, f"{k} {name}: {outside} walkers outside tolerance")
    errs = {k: res[k][2] for k in ("model_extinct", "median_nonneg", "renorm_partials")}
    errs["resid_chi2"] = max(res["resid_chi2 renorm=True"][2], res["resid_chi2 renorm=False"][2])
    return errs


def check_lane_boundary(dev):
    """At nd = LARGE_ND both lanes apply: the segmented composition against K3."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    tgt, truth = largend_target(dev, seg.LARGE_ND)
    P = torch.cat([init_walker_batch(tgt, truth, NW_LARGE, seed=3), edge_walkers(truth, tgt)])
    ops = lane_operands(tgt, P)
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
    of the segmented lane.  Returns the launch counts and the stage-1 wall time."""
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
    med = chain[chain.shape[0] // 2:].reshape(-1, tgt.ndim).median(dim=0).values.cpu().numpy()
    for k, (m, t) in enumerate(zip(med, truth)):
        print(f"[largend fit] param {k}: posterior median {m:.6g}, truth {t:.6g}")
    return launches, t1 - t0


def kary_ops(NW, nd, iters, n_true):
    """Compares and counts of the k-ary median on [NW, nd]: 3 thresholds per round, the
    exact mode's single-bit count and, for an even n_true, the upper-middle pass."""
    if iters >= 31:
        per = 15 * 6 + 2 + (0 if n_true % 2 else 3)
    else:
        per = 6 * ((iters + 1) // 2)
    return NW * nd * per


def lane_kernel_times(tgt, P, dials, plain=False):
    """CUDA-event ms of K6-K9 alone on walkers ``P`` (renorm on).  With ``plain``:
    ({name: (kernel ms, plain ms)}, {name: library ms}, {name: bound})."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    Wcomb, av, D, kd, data, err, V, Vpinv, med_data, n_true = lane_operands(tgt, P)
    kw = dial_kwargs(dials)
    iters, recip = kw["iters"], kw["recip"]
    model = seg.model_extinct(Wcomb, av, D, kd)
    med = seg.median_nonneg(model, n_true, iters)
    scale = med_data.to(torch.float32) / med
    coeffs = seg.renorm_partials(model, scale, data, Vpinv, recip)
    calls = {
        "model_extinct": (lambda: seg.model_extinct(Wcomb, av, D, kd),
                          lambda: seg.model_extinct_reference(Wcomb, av, D, kd)),
        "median_nonneg": (lambda: seg.median_nonneg(model, n_true, iters),
                          lambda: seg.median_nonneg_reference(model, n_true, iters)),
        "renorm_partials": (lambda: seg.renorm_partials(model, scale, data, Vpinv, recip),
                            lambda: seg.renorm_partials_reference(model, scale, data, Vpinv,
                                                                  recip)),
        "resid_chi2": (lambda: seg.resid_chi2(model, scale, coeffs, data, err, V, recip),
                       lambda: seg.resid_chi2_reference(model, scale, coeffs, data, err, V,
                                                        recip)),
    }
    times = {k: cuda_ms(kern) for k, (kern, _) in calls.items()}
    if not plain:
        return times
    NW, nd = model.shape
    r1 = (int(n_true) + 1) // 2
    out = {k: (times[k], cuda_ms(ref, reps=5)) for k, (_, ref) in calls.items()}
    library = {"median_nonneg": cuda_ms(lambda: torch.kthvalue(model, r1, dim=1))}
    inv_err, VT = 1.0 / err, V.T.contiguous()
    bounds = {
        "model_extinct": bound(nbytes(Wcomb, av, D, kd, model),
                               2 * int(torch.count_nonzero(Wcomb)) * nd
                               + 3 * int((av > 0).sum()) * nd),
        "median_nonneg": bound(nbytes(model, med) + 4, kary_ops(NW, nd, iters, int(n_true))),
        # a multiply, a divide and three FMAs per point
        "renorm_partials": bound(nbytes(model, scale, data, Vpinv, coeffs), 8 * NW * nd),
        # the scale, the fit (a multiply and two FMAs), a divide, the residual, its square sum
        "resid_chi2": bound(nbytes(model, scale, coeffs, data, inv_err, VT, med), 11 * NW * nd),
    }
    return out, library, bounds


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
                busy, n_kernels, top = device_busy(lambda: run_ensemble(state, logp, 4, thin=4))
                share = ("not measured (the profiler reported no device time)" if busy is None
                         else f"{busy:.3f}, {n_kernels / 4:.0f} kernel launches per step")
                print(f"[largend throughput nd={nd} {label}] device busy share under "
                      f"torch.profiler (4 steps): {share}; top kernels (ms): "
                      f"{[(k, round(v, 4)) for k, v in top]}")
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
        fits = lambda weight_rows: 4 * (nd + weight_rows * NO) <= ck.ROW_SMEM_BYTES
        row = {
            "K1 posterior": cuda_ms(lambda: ck.log_posterior_fused(P, t)) if fits(3) else None,
            "K3 spectrum": (cuda_ms(lambda: ck.spectrum_chi2(*ops[:9], **dial_kwargs(PROD)))
                            if fits(1) else None),
            "segmented spectrum": cuda_ms(
                lambda: seg.spectrum_chi2_segmented(*ops, **dial_kwargs(PROD))),
            "eager spectrum": cuda_ms(lambda: _spec_chi2_xla(ops[0], ops[1], t), reps=5),
            "dispatched posterior": cuda_ms(lambda: log_posterior_batch(P, t)),
        }
        rows[nd] = row
        print(f"[largend crossover nd={nd}] {NW_LARGE} walkers, production dials, ms: "
              + ", ".join(f"{k} {'does not fit' if v is None else f'{v:.4f}'}"
                          for k, v in row.items()))
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
    odd, odd_truth = largend_target(dev, ND_ODD)
    Podd = torch.cat([init_walker_batch(odd, odd_truth, NW_LARGE, seed=2),
                      edge_walkers(odd_truth, odd)])
    check_lane(f"nd={ND_ODD} exact dials", odd, Podd, EXACT, 0, eager=True)
    check_lane(f"nd={ND_ODD} production dials", odd, Podd, PROD,
               int(PROD_MAX_OUTSIDE_FRAC * NW_LARGE), eager=False)
    check_lane_boundary(dev)
    return tgt, truth, P, errs


def largend_phase(dev):
    tgt, truth, P, errs = largend_checks(dev)
    t0 = time.perf_counter()
    launches, stage1_s = largend_fit(tgt, truth, dev)
    print(f"[largend] fit {time.perf_counter() - t0:.1f} s")
    wide = largend_target(dev, ND_WIDE)
    rates = largend_throughput(dev, {ND_FIT: (tgt, truth), ND_WIDE: wide})

    # the kernel report: one half-step at nd = ND_FIT, production dials
    times, library, bounds = lane_kernel_times(dataclasses.replace(tgt, **PROD),
                                               P[:NW_LARGE].contiguous(), PROD, plain=True)
    for k, (ms, plain_ms) in times.items():
        lib = library.get(k)
        print(f"[time {k} production] {NW_LARGE} walkers x nd={ND_FIT}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bounds[k][0]:.5f} ms ({bounds[k][1]})"
              + (f", library (torch.kthvalue) {lib:.4f} ms" if lib is not None else ""))
    # K10, the composition of K6-K9, on the same half-step
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    ops = lane_operands(dataclasses.replace(tgt, **PROD), P[:NW_LARGE].contiguous())
    k10 = (cuda_ms(lambda: seg.spectrum_chi2_segmented(*ops, **dial_kwargs(PROD))),
           cuda_ms(lambda: seg.spectrum_chi2_segmented_reference(*ops, **dial_kwargs(PROD)),
                   reps=5))
    print(f"[time spectrum_chi2_segmented (K10) production] {NW_LARGE} walkers x nd={ND_FIT}: "
          f"composition {k10[0]:.4f} ms, plain {k10[1]:.4f} ms, bound (the sum of K6-K9's) "
          f"{sum(b[0] for b in bounds.values()):.5f} ms")
    cross = largend_crossover(dev, {ND_FIT: (tgt, truth)})
    return {"errs": errs, "launches": launches, "stage1_s": stage1_s, "rates": rates,
            "times": times, "library": library, "bounds": bounds, "crossover": cross, "k10": k10}


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
    same = same_bits(s4, k3[:, None])
    print(f"[S4 recip=0 vs K3, iters={fr.ITERS}, renorm on] {Wc.shape[0]} walkers: {same} "
          "bit-identical")
    require(same == Wc.shape[0], f"S4 vs K3: {Wc.shape[0] - same} walkers differ")
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
                same = same_bits(got[:, None], ck.log_posterior_fused(P, t)[:, None])
                line += f"; {same} bit-identical to K1"
                require(same == P.shape[0], f"S12 full {label}: {P.shape[0] - same} walkers "
                        "differ from K1")
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
    """S6 against K4 (bit for bit) and its plain version on the ragged fleet of phase 6,
    S1-S3 against their plain versions at full size, every variant.  Returns the max abs
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
        k4 = ck.spectrum_chi2_fleet(W, av, fl)
        ref = s6.spectrum_chi2_fleet_2d_reference(W, av, fl)
        for order in s6.ORDERS:
            got = s6.spectrum_chi2_fleet_2d(W, av, fl, order)
            torch.cuda.synchronize()
            same = int((bits(got) == bits(k4)).sum())
            outside, rel, err = compare(got.flatten(), ref.flatten())
            if dials is EXACT:
                errs["spectrum_chi2_fleet_2d"] = max(errs["spectrum_chi2_fleet_2d"], err)
            print(f"[S6 spectrum_chi2_fleet_2d {order} {label}] {n} walkers: {same} "
                  f"bit-identical to K4; {outside} outside tolerance of the plain version "
                  f"(allowed {allowed}), max rel err {rel:.3e}, max abs err {err:.3e}")
            require(same == n, f"S6 {order} {label}: {n - same} walkers differ from K4")
            require(outside <= allowed, f"S6 {order} {label}: {outside} walkers outside "
                    "tolerance")
    # times at production dials on the 9 x 4096 cloud, K4 and the two orders in turns
    prod = dataclasses.replace(fleet, **PROD)
    Wc, avc = fleet_wcomb(cloud, prod), cloud[..., fleet.nspec].contiguous()
    fns = {"K4": lambda: ck.spectrum_chi2_fleet(Wc, avc, prod)}
    fns.update({o: (lambda o=o: s6.spectrum_chi2_fleet_2d(Wc, avc, prod, o)) for o in s6.ORDERS})
    order_ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        order_ms[k].append(cuda_ms(fns[k]))
    order_ms = {k: min(v) for k, v in order_ms.items()}
    print(f"[time S6 production] {NTGT} x {NW_FLEET} walkers, in turns K4, target_major, "
          f"walker_major and back, least of two: " + ", ".join(
              f"{k} {v:.4f} ms ({100 * (v - order_ms['K4']) / order_ms['K4']:+.2f}% vs K4)"
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
    dev, smi = device_phase()
    build_phase()
    tgt, truth, kres = kernels_phase(dev)
    launches, stage1_s = fit_phase(tgt, truth, dev)
    k1_ms = {label: kres["times"][("k1", label)][0] for label in ("production", "exact")}
    rates = throughput_phase(tgt, truth, dev, k1_ms)
    fres = fleet_phase(dev)
    t0 = time.perf_counter()
    lres = largend_phase(dev)
    largend_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eres = experiments_phase(dev, tgt, truth)
    experiments_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rres = redesign_phase(dev, tgt, truth)
    redesign_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pres = probes_phase(dev)
    probes_s = time.perf_counter() - t0
    print(f"[probes] phase 10 in {probes_s:.1f} s (budget {PROBES_BUDGET_S} s"
          + (")" if probes_s <= PROBES_BUDGET_S else ", OVER BUDGET)"))
    lr = lres["rates"]
    print(f"[summary] {smi}: stage-2 {rates['production']:.1f} evals/s (production dials), "
          f"{rates['exact']:.1f} evals/s (exact dials); stage-1 wall {stage1_s:.2f} s; fleet "
          f"{NTGT} x {NW_FLEET}: composed (K4) {fres['composed']['rate']:.1f} evals/s, "
          f"fused (K5) {fres['fused']['rate']:.1f} evals/s; large nd phase {largend_s:.1f} s: "
          + ", ".join(f"nd={nd} {label} {lr[(nd, label)]['rate']:.1f} evals/s"
                      for nd, label in lr)
          + f"; experiments phase {experiments_s:.1f} s; redesign phase {redesign_s:.1f} s; "
          f"probes phase {probes_s:.1f} s")
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
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"mcmc_spec_tpu_torch/csrc/{src}",
         "replaces": where, "launches": n, "graph_replays": replays.get(name, 0),
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
         "library_ms": lib}
        for name, src, where, n, err, ms, plain_ms, b, lib in rows]}))
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
