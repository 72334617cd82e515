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
   production and the exact dials.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
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
    return tgt, truth, {"k1_err": err_k1, "k3_err": err_k3, "times": times}


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


def main() -> int:
    dev, smi = device_phase()
    build_phase()
    tgt, truth, kres = kernels_phase(dev)
    launches, stage1_s = fit_phase(tgt, truth, dev)
    k1_ms = {label: kres["times"][("k1", label)][0] for label in ("production", "exact")}
    rates = throughput_phase(tgt, truth, dev, k1_ms)
    print(f"[summary] {smi}: stage-2 {rates['production']:.1f} evals/s (production dials), "
          f"{rates['exact']:.1f} evals/s (exact dials); stage-1 wall {stage1_s:.2f} s")
    k1_ms_prod, k1_plain_prod = kres["times"][("k1", "production")]
    k3_ms, k3_plain = kres["times"][("k3", NWALK_BENCH // 2)]
    print(json.dumps({"kernels": [
        {"name": "log_posterior_fused", "route": "cuda",
         "source": "mcmc_spec_tpu_torch/csrc/log_posterior_fused.cu",
         "replaces": "mcmc_spec_tpu/ops/pallas_kernels.py:743",
         "launches": launches["log_posterior_fused"], "max_abs_err": kres["k1_err"],
         "ms": k1_ms_prod, "plain_ms": k1_plain_prod},
        {"name": "spectrum_chi2", "route": "cuda",
         "source": "mcmc_spec_tpu_torch/csrc/spectrum_chi2.cu",
         "replaces": "mcmc_spec_tpu/ops/pallas_kernels.py:444",
         "launches": launches["spectrum_chi2"], "max_abs_err": kres["k3_err"],
         "ms": k3_ms, "plain_ms": k3_plain},
    ]}))
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
