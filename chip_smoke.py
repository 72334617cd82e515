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
   and the device busy share under ``torch.profiler``.

Each kernel's ``bound_ms`` is the least time the card could take for the
work of the timed call: the larger of its bytes (each input read once, the
output written once) over 3.35 TB/s and its operations over the 67 TFLOP/s
float32 peak outside the tensor cores (H100 SXM data sheet).  Operations are
counted from this run's inputs: an add, multiply, compare, divide or exp is
one, an FMA two; the model row counts only the non-zero blend weights.

The line before the last is the kernel report (JSON); the last line is
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

    Outside = finiteness differs, or |got-ref| > atol + rtol*|ref| with
    atol = 1e-4 * max|ref| over the finite walkers (the JAX kernel gate)."""
    got = got.double().cpu().numpy()
    ref = ref.double().cpu().numpy()
    fin_g, fin_r = np.isfinite(got), np.isfinite(ref)
    fin = fin_g & fin_r
    require(fin.any(), "no finite walker to compare")
    atol = 1e-4 * np.abs(ref[fin]).max()
    diff = np.abs(got[fin] - ref[fin])
    outside = int((fin_g != fin_r).sum() + (diff > atol + rtol * np.abs(ref[fin])).sum())
    rel = float((diff / np.maximum(np.abs(ref[fin]), 1e-30)).max())
    return outside, rel, float(diff.max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def main() -> int:
    dev, smi = device_phase()
    build_phase()
    tgt, truth, kres = kernels_phase(dev)
    launches, stage1_s = fit_phase(tgt, truth, dev)
    k1_ms = {label: kres["times"][("k1", label)][0] for label in ("production", "exact")}
    rates = throughput_phase(tgt, truth, dev, k1_ms)
    fres = fleet_phase(dev)
    print(f"[summary] {smi}: stage-2 {rates['production']:.1f} evals/s (production dials), "
          f"{rates['exact']:.1f} evals/s (exact dials); stage-1 wall {stage1_s:.2f} s; fleet "
          f"{NTGT} x {NW_FLEET}: composed (K4) {fres['composed']['rate']:.1f} evals/s, "
          f"fused (K5) {fres['fused']['rate']:.1f} evals/s")
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
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"mcmc_spec_tpu_torch/csrc/{src}",
         "replaces": f"mcmc_spec_tpu/ops/pallas_kernels.py:{line}", "launches": n,
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
         "library_ms": None}
        for name, src, line, n, err, ms, plain_ms, b in rows]}))
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
