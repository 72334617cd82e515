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
   the fused-posterior section variants of ``ablate_fused_sections`` on S13,
   every variant on 16,384 + 5 walkers at both dial sets, and ``full`` bit for
   bit K1), then the three
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
   its wall time against a 20 s budget;
11. the pipeline through its entry point: ``mcmc_spec_tpu_torch.testing``
   writes a fit directory in a fresh temporary directory (filter curves, an
   observation made by ``make_synthetic_observation`` at the bench truth,
   the grid cache, the param file) at the koi2298 widths (nd = 1,792, the
   14×4 ``synthetic`` grid, 2 contrasts, 6 bands, ``nspec 2``, ``res 1700``)
   with ``nwalk 3072``, ``nstep 20``, ``nburn 200``, ``nsteps 2000`` (depth
   cut from ``param_koi2298.txt``'s 400 / 301 / 15,001); ``cli.main(["-f",
   ..., "-o", "True", "-e", "True", "--noplots"])`` fits it on the card in
   float32: the artifact set, ``samples.txt`` finite with ``ndim`` columns,
   the acceptance fraction in (0.05, 0.95), and the ``LAUNCHES`` counters
   exactly K3 = 1 + the annealer's iterations and K1 = 1 + 2 × (burn-in +
   sampling steps), with no call of the torch composition (counted calls of
   ``batched._spec_chi2_xla``, ``_spec_chi2_xla_median_only`` and
   ``log_prior_batch``); the wall time of ``setup_context``, of each stage
   and of the CLI, and stage 2's evaluations per second in the pipeline
   beside ``run_ensemble`` alone on the same walkers and steps;
   ``report.composite.band_mag_posteriors`` on 2,000 of the fit's draws in
   float64 on the card against the CPU (relative 1e-12); K1 and K3
   against their plain versions at the pipeline's shapes; and resume: a
   ``run_mcmc_stage`` cut in its 3rd sampling chunk (``dump_coords`` raises)
   and resumed writes ``samples.txt`` byte for byte as an uninterrupted run;
12. the fleet pipeline through its entry point: ``testing.write_fleet_dirs``
   writes nine fit directories at the koi2298 widths, ragged as in phase 6
   (nd = 1,792 - 48 i, 2 contrasts for even i and 1 for odd), each
   observation at its own truth, over one grid cache, with ``nwalk 3072``,
   ``nstep 10``, ``nburn 100``, ``nsteps 300`` (depth cut from config 5's
   4,096 walkers and ``param_koi2298.txt``'s 400 / 301 / 15,001);
   ``cli.main`` with the nine ``-f`` files and ``--noplots`` fits them on the
   card in float32 on the default route: each target's artifact set, every
   ``samples.txt`` finite with 1,024 × 300 rows, the acceptance fraction in
   (0.05, 0.95), and the ``LAUNCHES`` counters exactly K3 = 9 × (1 + 500)
   (each target annealed on its unpadded context) and K4 = 1 + 2 × (100 +
   300), K1 = K5 = 0, with no call of the spectrum composition; the wall
   times of ``setup_fleet``, each stage and the CLI, stage 2's evaluations
   per second beside ``run_fleet_ensemble`` alone on the same walkers and
   steps, and the device busy share of 10 steps of the stage-2 call on the
   final walkers under ``torch.profiler``; the kernels held against their
   plain versions at the pipeline's own inputs, exact and production dials:
   K3 on each target's unpadded context with its 3,072 stage-1 walkers, K4
   and K5 on the padded fleet with stage 2's 9 × 512 half batch and the
   resume pair's 9 × 128; then the fused route's resume pair
   (``MCMC_SPEC_FUSED_EVAL=1``, 9 × 256 walkers, 400 steps cut in the 3rd
   chunk: every target's ``samples.txt`` byte for byte, K5's launches exact,
   K4 none); then the native grid reader: built on the machine, a 14×4
   BT-Settl directory read with and without it, bit for bit, both timed;
13. walker and spectral sharding: (a) K7d (``median_rounds.cu``, the k-ary
   median one 2-bit round a launch) over 2- and 4-way column slices of the
   lane's 1,024 + 5 rows at nd = 65,536, 65,535 (split unevenly, 32,767 +
   32,768: rows that are not 16-byte aligned) and 131,072 plus K7's edge
   rows, the slices' counts summed in this process through the reduce hooks,
   at the exact and production dials, with one count and a count per row:
   every round's counts and the refinement's count and minimum bit for bit
   the plain version's, the median bit for bit the plain version's and K7's
   (the report's ``max_abs_err`` of each is the largest difference found); a round, the refinement and the finish timed on a
   rank's share (CUDA events, alone under ``torch.profiler``, the plain
   version); (b) gloo worlds whose ranks all compute on this one card (their
   wall times are the check's, not a rate of several cards): a 2x2 world, the
   spec-sharded log-posterior of 1,024 walkers at nd = 65,536 and at 65,535
   (padded to 65,536 with inert sentinels, as the pipeline pads it) at both
   dial sets against the single-card K10 lane (the median bit for bit K7, the
   log-posterior inside the kernel gate, 9 all-reduces at the production
   dials and 19 and a min exact), then 16 steps of
   ``run_ensemble_spec_sharded``; a 2-rank world, 16 steps of the walker chain
   (K1) at the koi2298 widths, 4,096 walkers, bit for bit ``run_ensemble`` on
   the card; (c) the CLI under ``python -m torch.distributed.run --standalone
   --nproc-per-node 1`` with NCCL and ``--mesh 1x1`` on phase 11's fit
   directory (``nstep 10``, ``nburn 100``, ``nsteps 200``, depth cut from
   phase 11's 20 / 200 / 2,000): the artifact set, finite samples, and K6's,
   K7d's, K8's and K9's launches and the all-reduces exactly those of its
   evaluations (the annealer's exact median, stage 2's production one);
14. the fleet over a targets x walkers mesh, then the host modules: (a) gloo
   worlds whose ranks all compute on this card (their wall times are the
   check's, not a rate of several cards) run ``run_fleet_ensemble_sharded`` on
   phase 6's ragged nine targets, 4,096 walkers each, 16 steps at thin 8, on
   K4 and on K5: a world of 3 (3x1) and of 4 (1x4, and 2x2 on the first six
   targets), each rank on its block of the padded fleet; K5's chain bit for
   bit the one-card ``run_fleet_ensemble`` from the same generator, K4's
   initial log-probs inside the kernel gate (its chain is bit for bit where
   the walkers are not split; where they are, ``scripts/batch_rows.py``
   prints the ops whose rows change with the batch), the census (32 gathers and one
   sum a rank) and 32 launches a rank; (b) ``run_fleet_mcmc`` in the world of
   4 (2x2) on six targets x 1,024 walkers, burn-in 100 and 200 steps at nthin
   100, on K5: every ``samples.txt`` byte for byte the one-card run's; (c)
   ``EnsembleSampler`` on the bench target, 4,096 walkers, two ``run_mcmc``
   blocks, bit for bit ``run_ensemble``, K1's launches exact; (d) both
   examples (``fit_synthetic_binary --noplots``: K3 and K1, depth cut to 40
   annealer steps and 1,000 steps; ``spec_sharded_fit 2 2`` in a gloo world
   on this card, depth cut to 2 annealer steps and 60 steps: K6, K7d, K8,
   K9);
   (e) ``python -m mcmc_spec_tpu_torch.analysis --no-plots`` over three
   result directories in a process of its own, on this machine's packages;
15. the accuracy tools (``mcmc_spec_tpu_torch/scripts``): ``card_validation
   --shapes-only`` in full (K3 and K1 at 600, 520 and 256 walkers for nd =
   1,792 and 3,584, K4 and K5 on a padded fleet at 12 and 520 walkers, all at
   the exact dials in the kernel gate of the torch composition), a hard gate;
   ``median_tempering_bound`` at 4,096 walkers with the burn-in cut from 4,000
   to 500 steps (dL per pass count on K1, the rates per pass count; K1's
   launches exact); the recovery matrix's first fixture (3850, 3025) built
   and fitted through the two-stage pipeline with ``nburn`` cut from 1,000 to
   200 and ``nsteps`` from 10,000 to 2,000 (finite samples, K3's launches
   exact, K1's counted);
16. the attribution tools' kernels and instruments (``mcmc_spec_tpu_torch/scripts``):
   S13 ``posterior_ablate`` (K1 v2 with its four sections gated at compile time:
   the 16 masks of the 2^4 matrix and ``empty``, the launch floor) and S15
   ``posterior_pair`` (K1 v2, two walkers a warp) on 1,024 + 5 bench walkers, an
   odd count, S14 ``fleet_sections`` (K4 v2's modes; ``no_matmul`` on weights
   whose grid point 0 holds each walker's largest, so that its stub rows are
   finite) on phase 6's ragged fleet at 1,024 + 5 walkers a target and
   ``scalar_rank`` on the bench target x 3, at both
   dial sets in the kernel gate of their plain versions, with S13 ``1111`` and S15
   bit for bit K1 and S14 ``full`` and ``scalar_rank`` bit for bit K4; then the
   tools' timed run, with its launch counts: every S13 variant, S15 and K1 at
   32,768 walkers, S14's modes on a half-step of the fleet cell,
   ``utils.profiling.device_loop_time`` on K1 at 8,192 walkers (50 calls in one
   CUDA graph, within 25 % of K1 alone under ``torch.profiler``, and the
   composition's capture refused at its host read), and ``scripts.op_table`` over
   4 stretch steps of 8,192 walkers (exactly 8 K1 launches).
17. the kernel build cache (``MCMC_SPEC_COMPILE_CACHE``): one child process
   with the variable set to phase 2's build directory by its path (the
   "directory" form) finds the library built there, with nvcc made to raise if
   it were asked for, launches K1 once on 1,024 bench walkers at nd = 1,808 at
   the production dials and holds it against its plain version
   (``scripts.compile_cache_micro``'s arm); the child's wall time and the
   library's name are printed (budget ~15 s; the cold build is the receipts').

Each kernel's ``bound_ms`` is the least time the card could take for the
work of the timed call: the larger of its bytes (each input read once, the
output written once) over 3.35 TB/s and its operations over the 67 TFLOP/s
float32 peak outside the tensor cores (H100 SXM data sheet).  Operations are
counted from this run's inputs: an add, multiply, compare, divide or exp is
one, an FMA two; the model row counts only the non-zero blend weights; a
median count pass is a compare and an add per point and threshold.  K7's
bound is its function's bytes alone (the model read once, the medians
written), whatever algorithm computes the median; its report entry also
carries ``launches_exact``, ``launches_fast`` and ``ms_exact``; K1's and
K3's carry ``launches_pipeline``, their counts in phase 11; K3's, K4's and
K5's carry ``launches_fleet_pipeline``, their counts in phase 12 (K5's in its
resume pair); K4's and K5's carry ``launches_fleet_mesh``, their counts on
rank 0 of phase 14's 1x4 world, and K5's ``launches_fleet_mesh_pipeline``;
K1's carries ``launches_sampler``; K1's and K3's ``launches_example``, their
counts in ``fit_synthetic_binary``; K1's, K3's, K4's and K5's
``launches_accuracy``, their counts in phase 15.  K9's entry
(``ms`` with renorm) carries ``ms_raw`` and ``bound_ms_raw`` without renorm,
and ``launches_raw`` and ``launches_renorm``.  The
multiply chains of S10 count one operation per multiply and per add, so their
bound holds them against 67 TFLOP/s, twice the rate of one multiply per FP32
lane per clock (S10 measures the latter).

The phases' wall times are printed with the summary.  The line before the last
is the kernel report (JSON, twenty-six kernels; K7d's three carry ``ms_alone``,
``ms_4way``, ``ms_alone_4way`` and ``bound_ms_4way`` beside their 2-way times); the
last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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


def k3_pair(tgt, P, renorm):
    """K3 and its plain version on the blend weights of walkers ``P`` at ``tgt``'s dials."""
    from mcmc_spec_tpu_torch.inference.batched import _forward_small
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    Wcomb = _forward_small(P, tgt)[4]
    nT, nG, nd = tgt.D.shape
    args = (Wcomb, P[:, tgt.nspec].contiguous(), tgt.D.reshape(nT * nG, nd), tgt.ext_k_data,
            tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv, tgt.med_data)
    kw = dial_kwargs(dict(median_iters=tgt.median_iters, matmul_passes=tgt.matmul_passes,
                          recip_newton=tgt.recip_newton))
    got = ck.spectrum_chi2(*args, renorm=renorm, **kw)
    torch.cuda.synchronize()
    return got, ck.spectrum_chi2_reference(*args, renorm=renorm, **kw)


def check_k3(name, tgt, P, max_outside):
    """K3 against its plain version on the blend weights of walkers ``P``, renorm on and
    off, at ``tgt``'s dials; returns the max abs error."""
    err_max = 0.0
    for renorm in (True, False):
        outside, rel, err = compare(*k3_pair(tgt, P, renorm))
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
    """S10, S11, S4 and the section variants (on S13) against their plain versions (and
    S11 against ``torch.kthvalue``, S4 against K3, the ``full`` variant against K1) on the
    card.  Returns the max abs errors and the report's times and bounds."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
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

    # the section variants of ablate_fused_sections, each an S13 mask: every variant on
    # 16,384 + 5 walkers at both dial sets; full = K1 bit for bit
    nhalf = NWALK_BENCH // 2
    P = torch.cat([init_walker_batch(tgt, truth, nhalf, seed=4), edge_walkers(truth, tgt)])
    errs["posterior_ablate"] = 0.0
    for label, dials, allowed in (("exact dials (31, 6, 0)", EXACT, 0),
                                  ("production dials (14, 3, 2)", PROD,
                                   int(PROD_MAX_OUTSIDE_FRAC * nhalf))):
        t = dataclasses.replace(tgt, **dials)
        k1 = ck.log_posterior_fused(P, t)
        for variant in ab.VARIANTS:
            got = ab.posterior_sections(P, t, variant)
            torch.cuda.synchronize()
            outside, rel, err = compare(got, ab.posterior_sections_reference(P, t, variant))
            if dials is EXACT:
                errs["posterior_ablate"] = max(errs["posterior_ablate"], err)
            same = int(((got.view(torch.int32) == k1.view(torch.int32))
                        | (torch.isnan(got) & torch.isnan(k1))).sum())
            print(f"[sections {variant} (S13 {ab._mask(variant)}) {label}] {P.shape[0]} walkers: "
                  f"{outside} outside tolerance (allowed {allowed}), max rel err {rel:.3e}, max "
                  f"abs err {err:.3e}; {same} bit for bit K1")
            require(outside <= allowed, f"sections {variant} {label}: {outside} outside tolerance")
            require(variant != "full" or same == P.shape[0],
                    f"sections full {label}: {P.shape[0] - same} walkers differ from K1")
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
    for name in ("fma_chains", "median_only", "spectrum_recip", "posterior_ablate"):
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


# phase 11: the pipeline through the CLI, at the koi2298 widths (BASELINE.md config 2) with the
# depth cut from param_koi2298.txt (nstep 400, nburn 301, nsteps 15001) to fit the time limit
PIPE_ND = 1792
PIPE_NWALK = 3072  # stage 1; stage 2 runs the top third, 1,024 walkers
PIPE_NSTEP = 20
PIPE_NBURN = 200
PIPE_NSTEPS = 2000
PIPE_NTHIN = 100  # run_mcmc_stage's default
RESUME_NSTEPS = 500  # the resume pair: 5 sampling chunks, cut in the 3rd
RECORD_THIN = 500  # run_optimize_stage's default


class _Counted:
    """A callable that counts its calls: the composition's functions, which the
    pipeline on the card must never reach."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def expected_artifacts(fname, nwalk, nburn, nthin, n_chunks):
    names = {"optimize_res.txt", "optimize_cs.txt", "run_log.jsonl", "samples.txt", "plots",
             f"{fname}_autocorr.txt"}
    names |= {f"{k}{w}.txt" for k in ("params", "chisq") for w in range(nwalk)}
    names |= {f"{fname}_{n * nthin}_burnin.txt" for n in range(max(nburn // nthin, 1))}
    names |= {f"{fname}_{n * nthin}_results.txt" for n in range(n_chunks)}
    return names


def pipeline_resume(cfg_of, p0):
    """An uninterrupted run of ``run_mcmc_stage`` beside one cut in its 3rd sampling chunk
    (``dump_coords`` raises on its 3rd ``results`` call) and resumed: ``samples.txt`` must
    be the same bytes."""
    from mcmc_spec_tpu_torch import pipeline
    from mcmc_spec_tpu_torch.io import results as results_io

    def run(dirname, resume):
        ctx = pipeline.setup_context(cfg_of(dirname, nsteps=RESUME_NSTEPS))
        return pipeline.run_mcmc_stage(ctx, p0=p0, nthin=PIPE_NTHIN, check_convergence=False,
                                       resume=resume)

    t0 = time.perf_counter()
    run("resume_full", resume=False)
    real_dump, calls = results_io.dump_coords, {"n": 0}

    def exploding_dump(dirname, fname, step, coords, stage="results"):
        if stage == "results":
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("simulated crash")
        return real_dump(dirname, fname, step, coords, stage=stage)

    results_io.dump_coords = exploding_dump
    try:
        run("resume_cut", resume=False)
        raise PhaseError("the interrupted run was not interrupted")
    except RuntimeError as e:
        require(str(e) == "simulated crash", f"the interrupted run failed otherwise: {e}")
    finally:
        results_io.dump_coords = real_dump
    ck = results_io.maybe_load_checkpoint("resume_cut/chain_checkpoint.npz")
    require(ck is not None and ck.step == 2 * PIPE_NTHIN,
            "no checkpoint after 2 sampling chunks of the interrupted run")
    run("resume_cut", resume=True)
    with open("resume_full/samples.txt", "rb") as a, open("resume_cut/samples.txt", "rb") as b:
        full, resumed = a.read(), b.read()
    print(f"[pipeline resume] {p0.shape[0]} walkers x {RESUME_NSTEPS} steps, cut after 2 of "
          f"{RESUME_NSTEPS // PIPE_NTHIN} chunks and resumed: samples.txt {len(resumed)} bytes, "
          f"{'identical' if resumed == full else 'DIFFERENT'} to the uninterrupted run's "
          f"({time.perf_counter() - t0:.1f} s)")
    require(resumed == full, "the resumed run's samples.txt differs from the uninterrupted one")


def pipeline_phase(dev, smi, root):
    """The single-target pipeline through its entry point, ``cli.main``, on the card in
    float32, in the fit directory it writes under ``root`` (phase 13 fits it again);
    returns its launch counts and the fit directory."""
    from mcmc_spec_tpu_torch import cli, pipeline, testing
    from mcmc_spec_tpu_torch.inference import batched
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.utils.config import FitConfig
    from mcmc_spec_tpu_torch.utils.runlog import read_run_log

    cwd = os.getcwd()
    try:
        t0 = time.perf_counter()
        fd = testing.write_fit_dir(root, nd=PIPE_ND, nwalk=PIPE_NWALK, nstep=PIPE_NSTEP,
                                   nburn=PIPE_NBURN, nsteps=PIPE_NSTEPS)
        print(f"[pipeline] fit directory (filter curves, synthetic observation at the truth "
              f"{[float(x) for x in fd['truth']]}, grid cache, param file) in {time.perf_counter() - t0:.1f} s")
        os.chdir(root)
        walls, ctxs = {}, []

        def timed_stage(name, fn):
            def wrapped(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t
                if name == "setup_context":
                    ctxs.append(out)
                return out
            return wrapped

        composed = {name: _Counted(getattr(batched, name)) for name in
                    ("_spec_chi2_xla", "_spec_chi2_xla_median_only", "log_prior_batch")}
        real = {name: getattr(cli, name) for name in
                ("setup_context", "run_optimize_stage", "run_mcmc_stage")}
        for name, fn in composed.items():
            setattr(batched, name, fn)
        for name, fn in real.items():
            setattr(cli, name, timed_stage(name, fn))
        try:
            torch.cuda.synchronize()
            ck.reset_launches()
            t = time.perf_counter()
            cli.main(["cli", "-f", fd["paramfile"], "-o", "True", "-e", "True", "--noplots"])
            torch.cuda.synchronize()
            walls["cli"] = time.perf_counter() - t
            launches = dict(ck.LAUNCHES)
        finally:
            for name, fn in {**real}.items():
                setattr(cli, name, fn)
            for name, fn in composed.items():
                setattr(batched, name, fn.fn)
        ctx = ctxs[0]
        tgt, cfg = ctx.target, ctx.cfg
        require(tgt.device.type == "cuda" and tgt.D.dtype == torch.float32,
                f"the CLI packed its target on {tgt.device} in {tgt.D.dtype}")
        require(batched._fusable(tgt), "the CLI's target is not one the fused kernel takes")

        end = next(e for e in read_run_log(cfg.dirname) if e["event"] == "mcmc.end")
        nw, n_done, af = end["n_walkers"], end["n_steps"], end["acceptance_fraction"]
        burn = max(PIPE_NBURN // PIPE_NTHIN, 1) * PIPE_NTHIN
        n_iters = 50 * PIPE_NSTEP // RECORD_THIN * RECORD_THIN
        want = {"spectrum_chi2": 1 + n_iters, "log_posterior_fused": 1 + 2 * (burn + n_done)}
        print(f"[pipeline launches] K3 spectrum_chi2 {launches['spectrum_chi2']} (the "
              f"annealer's 1 + {n_iters} evaluations: {want['spectrum_chi2']}), K1 "
              f"log_posterior_fused {launches['log_posterior_fused']} (1 + 2 x ({burn} burn-in "
              f"+ {n_done} sampling steps): {want['log_posterior_fused']}); the composition "
              "(counted calls of inference.batched): "
              + ", ".join(f"{k} {v.calls}" for k, v in composed.items()))
        for name, n in want.items():
            require(launches[name] == n, f"{name}: {launches[name]} launches in the pipeline, "
                    f"expected {n}")
        for name, fn in composed.items():
            require(fn.calls == 0, f"the pipeline reached the torch composition ({name})")
        other = {k: v for k, v in launches.items() if k not in want and v}
        require(not other, f"the pipeline launched other kernels: {other}")

        got_names = set(os.listdir(cfg.dirname))
        want_names = expected_artifacts(cfg.fname, cfg.nwalk, cfg.nburn, PIPE_NTHIN,
                                        n_done // PIPE_NTHIN)
        require(got_names == want_names, "artifacts: missing "
                f"{sorted(want_names - got_names)[:5]}, unexpected {sorted(got_names - want_names)[:5]}")
        samples = np.loadtxt(os.path.join(cfg.dirname, "samples.txt"))
        require(samples.shape == (nw * n_done, cfg.ndim) and np.isfinite(samples).all(),
                f"samples.txt: shape {samples.shape}, expected ({nw * n_done}, {cfg.ndim}), "
                "finite")
        print(f"[pipeline] {len(got_names)} artifacts in {cfg.dirname} (the expected set); "
              f"samples.txt {samples.shape}, finite; acceptance fraction {af}")
        require(0.05 < af < 0.95, f"acceptance fraction {af} outside (0.05, 0.95)")
        med, sd = np.median(samples, axis=0), samples.std(axis=0)
        for k, (m, s, t) in enumerate(zip(med, sd, fd["truth"])):
            print(f"[pipeline] param {k}: posterior median {m:.6g} +- {s:.3g}, truth {t:.6g}")

        # the report's posterior band magnitudes (2,000 draws, as the reference's Kepler/Gaia
        # blocks take) in float64 on the card, held against the same call on the CPU
        from mcmc_spec_tpu_torch.report import composite

        curves, zps = ctx.bank.phot_passbands(cfg.pfilt)
        draws = samples[:: max(len(samples) // 2000, 1)][:2000]
        mags = [composite.band_mag_posteriors(ctx.grid, ctx.mist, draws, curves,
                                              ["photon"] * len(curves), zps, nspec=cfg.nspec,
                                              device=d) for d in (dev, "cpu")]
        rel = float(np.max(np.abs(mags[0] - mags[1]) / np.abs(mags[1])))
        print(f"[pipeline band mags] band_mag_posteriors on {dev}, {mags[0].shape}: max relative "
              f"difference to the CPU {rel:.3g} (tolerance 1e-12)")
        require(np.isfinite(mags[0]).all() and rel <= 1e-12,
                "band_mag_posteriors on the card disagrees with the CPU")

        # stage 2 alone: run_ensemble on the same walkers for the same steps
        p0 = pipeline.seed_from_optimize(ctx)
        require(p0.shape[0] == nw, f"stage 2 ran {nw} walkers, the seeds are {p0.shape[0]}")
        logp = lambda b: batched.log_posterior_batch(b, tgt)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = init_ensemble(torch.as_tensor(p0, dtype=torch.float32, device=dev), logp, gen)
        state, _, _ = run_ensemble(state, logp, burn + n_done, thin=PIPE_NTHIN)
        torch.cuda.synchronize()
        alone = time.perf_counter() - t
        evals = nw * (1 + burn + n_done)
        rate_pipe, rate_alone = evals / walls["run_mcmc_stage"], evals / alone
        print(f"[pipeline times] {smi}: setup_context {walls['setup_context']:.3f} s, stage 1 "
              f"(run_optimize_stage, {cfg.nwalk} walkers x {n_iters} iterations) "
              f"{walls['run_optimize_stage']:.3f} s, stage 2 (run_mcmc_stage, {nw} walkers x "
              f"{burn} + {n_done} steps) {walls['run_mcmc_stage']:.3f} s, the whole CLI "
              f"{walls['cli']:.3f} s")
        print(f"[pipeline stage 2] {smi}: {rate_pipe:.1f} evals/s in the pipeline "
              f"({walls['run_mcmc_stage']:.3f} s) against {rate_alone:.1f} evals/s for "
              f"run_ensemble alone on the same {nw} walkers and {burn + n_done} steps "
              f"({alone:.3f} s): host overhead {walls['run_mcmc_stage'] - alone:.3f} s")

        # the two gate checks at the pipeline's own shapes: K3 on stage 1's walkers, K1 on
        # stage 2's half batch
        gen1 = torch.Generator(device=dev).manual_seed(cfg.seed)
        from mcmc_spec_tpu_torch.inference.anneal import init_walkers

        P1 = init_walkers(tgt, cfg.nwalk, cfg.plx, cfg.plx_err, gen1)
        P2 = torch.as_tensor(p0[: nw // 2], dtype=torch.float32, device=dev)
        ck.reset_launches()
        for label, dials, allowed in (("exact dials", EXACT, 0),
                                      ("production dials", PROD,
                                       int(PROD_MAX_OUTSIDE_FRAC * cfg.nwalk))):
            td = dataclasses.replace(tgt, **dials)
            check_k3(f"pipeline target, stage 1's {cfg.nwalk} walkers, {label}", td, P1, allowed)
            check_k1(f"pipeline target, stage 2's {nw // 2}-walker half batch, {label}", td, P2,
                     0 if dials is EXACT else int(PROD_MAX_OUTSIDE_FRAC * nw) + 1)

        def cfg_of(dirname, **kw):
            c = FitConfig.from_file(fd["paramfile"])
            c.dirname = dirname
            for k, v in kw.items():
                setattr(c, k, v)
            return c

        pipeline_resume(cfg_of, p0)
        return {"launches": launches, "walls": walls, "rates": (rate_pipe, rate_alone),
                "fit": fd}
    finally:
        os.chdir(cwd)


# phase 12: the fleet pipeline through the CLI, 9 targets at the koi2298 widths, ragged as in
# phase 6 (nd = 1,792 - 48 i, 2 contrasts for even i and 1 for odd), each observation at its
# own truth, over the shared 14x4 synthetic grid. Depth cut from config 5's 4,096 walkers and
# param_koi2298.txt's nstep 400, nburn 301, nsteps 15,001 to bound the rows written (phase
# 11's stage 2 spent 16.4 of 17.4 s in host file work).
FLEET_PIPE_ND = tuple(1792 - 48 * i for i in range(NTGT))
FLEET_PIPE_NC = tuple(2 if i % 2 == 0 else 1 for i in range(NTGT))
FLEET_PIPE_NWALK = 3072  # stage 1; stage 2 the top third, 1,024 walkers a target
FLEET_PIPE_NSTEP = 10
FLEET_PIPE_NBURN = 100
FLEET_PIPE_NSTEPS = 300
FLEET_RESUME_NW = 256  # the resume pair's walkers a target: cut only to bound the bytes written
FLEET_RESUME_NSTEPS = 400  # 4 sampling chunks, cut in the 3rd
BTSETTL_STEP = 2.0  # the written BT-Settl spectra's wavelength step (A)
# steps of the stage-2 call profiled after the run (torch.profiler's own host time over a
# 100-step chunk of the composed route, ~4,800 kernels a step, was most of stage 2's wall)
FLEET_PROFILE_STEPS = 10


class _FleetSteps:
    """``run_fleet_ensemble`` wrapped: records each call's steps and thin and the last
    state."""

    def __init__(self, fn):
        self.fn, self.calls, self.state = fn, [], None

    def __call__(self, state, fleet, n_steps, thin=1, **kwargs):
        out = self.fn(state, fleet, n_steps, thin=thin, **kwargs)
        self.calls.append((n_steps, thin))
        self.state = out[0]
        return out


def fleet_pipeline_resume(ctxs, p0s):
    """The fused fleet route (K5, ``MCMC_SPEC_FUSED_EVAL=1``) through ``run_fleet_mcmc``:
    an uninterrupted run beside one cut in its 3rd sampling chunk (``dump_coords`` raises
    on that chunk's first ``results`` dump) and resumed; every target's ``samples.txt``
    must be the same bytes. Returns the runs' launch counts."""
    from mcmc_spec_tpu_torch import fleet_pipeline
    from mcmc_spec_tpu_torch.io import results as results_io
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    def run(tag, resume):
        rctxs = [dataclasses.replace(c, cfg=dataclasses.replace(
            c.cfg, dirname=f"{tag}{i}", nsteps=FLEET_RESUME_NSTEPS)) for i, c in enumerate(ctxs)]
        for c in rctxs:
            os.makedirs(c.cfg.dirname, exist_ok=True)
        fleet_pipeline.run_fleet_mcmc(rctxs, p0s=p0s, nthin=PIPE_NTHIN, check_convergence=False,
                                      resume=resume, return_samples=False)
        return [c.cfg.dirname for c in rctxs]

    t0 = time.perf_counter()
    os.environ["MCMC_SPEC_FUSED_EVAL"] = "1"
    real_dump = results_io.dump_coords

    def exploding_dump(dirname, fname, step, coords, stage="results"):
        if stage == "results" and step == 2 * PIPE_NTHIN:
            raise RuntimeError("simulated crash")
        return real_dump(dirname, fname, step, coords, stage=stage)

    try:
        torch.cuda.synchronize()
        ck.reset_launches()
        full = run("fresume_full", resume=False)
        results_io.dump_coords = exploding_dump
        try:
            run("fresume_cut", resume=False)
            raise PhaseError("the interrupted fleet run was not interrupted")
        except RuntimeError as e:
            require(str(e) == "simulated crash", f"the interrupted fleet run failed otherwise: {e}")
        finally:
            results_io.dump_coords = real_dump
        ckpt = results_io.maybe_load_checkpoint("fresume_cut0/fleet_chain_checkpoint.npz")
        require(ckpt is not None and ckpt.step == 2 * PIPE_NTHIN,
                "no fleet checkpoint after 2 sampling chunks of the interrupted run")
        cut = run("fresume_cut", resume=True)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
    finally:
        results_io.dump_coords = real_dump
        os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
    same = []
    for a, b in zip(full, cut):
        with open(os.path.join(a, "samples.txt"), "rb") as fa, \
                open(os.path.join(b, "samples.txt"), "rb") as fb:
            same.append(fa.read() == fb.read())
    burn = max(FLEET_PIPE_NBURN // PIPE_NTHIN, 1) * PIPE_NTHIN
    # full: init + burn-in + 4 chunks; cut: init + burn-in + 3 chunks (the 3rd ran before
    # the crash); resumed: chunks 3-4 from the checkpoint's log-probs, no init
    want = (1 + 2 * (burn + FLEET_RESUME_NSTEPS)) + (1 + 2 * (burn + 3 * PIPE_NTHIN)) \
        + 2 * 2 * PIPE_NTHIN
    nbytes_ = os.path.getsize(os.path.join(cut[0], "samples.txt"))
    print(f"[fleet pipeline resume] fused route (K5), {len(p0s)} x {FLEET_RESUME_NW} walkers x "
          f"{FLEET_RESUME_NSTEPS} steps, cut after 2 of {FLEET_RESUME_NSTEPS // PIPE_NTHIN} "
          f"chunks and resumed: {sum(same)} of {len(same)} targets' samples.txt identical to the "
          f"uninterrupted run's (target 0: {nbytes_} bytes); K5 {launches['log_posterior_fleet_fused']}"
          f" launches (expected {want}), K4 {launches['spectrum_chi2_fleet']} "
          f"({time.perf_counter() - t0:.1f} s)")
    require(all(same), "a resumed fleet target's samples.txt differs from the uninterrupted one")
    require(launches["log_posterior_fleet_fused"] == want,
            f"K5: {launches['log_posterior_fleet_fused']} launches in the resume pair, "
            f"expected {want}")
    other = {k: v for k, v in launches.items() if k != "log_posterior_fleet_fused" and v}
    require(not other, f"the fused fleet resume pair launched other kernels: {other}")
    return launches


def fleet_pipeline_checks(solo, fleet, p0, dev):
    """The gate checks at the fleet pipeline's own inputs, at the exact dials (0 walkers
    outside tolerance) and the production dials (the usual allowance): K3 on each target's
    unpadded context with its stage-1 walkers, K4 and K5 on the padded fleet with stage 2's
    half batch and with the resume pair's. Returns the exact dials' max abs errors."""
    from mcmc_spec_tpu_torch.inference.anneal import init_walkers

    errs = {"spectrum_chi2": 0.0, "spectrum_chi2_fleet": 0.0, "log_posterior_fleet_fused": 0.0}
    P1s = []
    for c in solo:
        gen = torch.Generator(device=dev).manual_seed(c.cfg.seed)
        P1s.append(init_walkers(c.target, c.cfg.nwalk, c.cfg.plx, c.cfg.plx_err, gen))
    for label, dials in (("exact dials", EXACT), ("production dials", PROD)):
        exact = dials is EXACT
        for i, (c, P1) in enumerate(zip(solo, P1s)):
            err = check_k3(f"fleet target {i} (nd {c.target.n_data}), stage 1's {len(P1)} "
                           f"walkers, {label}", dataclasses.replace(c.target, **dials), P1,
                           0 if exact else int(PROD_MAX_OUTSIDE_FRAC * len(P1)))
            if exact:
                errs["spectrum_chi2"] = max(errs["spectrum_chi2"], err)
        fd = dataclasses.replace(fleet, **dials)
        for what, nw in (("stage 2's half batch", p0.shape[1] // 2),
                         ("the resume pair's half batch", FLEET_RESUME_NW // 2)):
            P = p0[:, :nw].contiguous()
            err4, err5 = check_fleet_kernels(
                f"fleet pipeline, {what}, {label}", fd, P,
                0 if exact else int(PROD_MAX_OUTSIDE_FRAC * NTGT * nw) + 1)
            if exact:
                errs["spectrum_chi2_fleet"] = max(errs["spectrum_chi2_fleet"], err4)
                errs["log_posterior_fleet_fused"] = max(errs["log_posterior_fleet_fused"], err5)
    against_float64(solo, fleet, P1s, p0[:, : p0.shape[1] // 2].contiguous())
    return errs


def against_float64(solo, fleet, P1s, P2):
    """Where the exact dials' differences sit: K3 (renorm on) on each target's stage-1
    walkers ``P1s``, K4 and K5 on stage 2's half batch ``P2``, and their float32 plain
    versions, each against the torch composition in float64 on the same walkers (the
    target packed again in float64 on the card), beside that reference's range."""
    from mcmc_spec_tpu_torch.inference.batched import (
        _forward_small,
        _spec_chi2_xla,
        log_posterior_batch,
    )
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.pipeline import pack_context

    fx = dataclasses.replace(fleet, **EXACT)
    Wc, av = fleet_wcomb(P2, fx), P2[..., fx.nspec].contiguous()
    k4 = (ck.spectrum_chi2_fleet(Wc, av, fx), ck.spectrum_chi2_fleet_reference(Wc, av, fx))
    k5 = (ck.log_posterior_fleet_fused(P2, fx), ck.log_posterior_fleet_fused_reference(P2, fx))
    torch.cuda.synchronize()
    for i, (c, P1) in enumerate(zip(solo, P1s)):
        t64 = dataclasses.replace(pack_context(c, dtype=torch.float64, device=P1.device),
                                  **EXACT)
        parts = []
        for name, P, (got, plain), ref_fn in (
                ("K3", P1, k3_pair(dataclasses.replace(c.target, **EXACT), P1, True),
                 lambda P: _spec_chi2_xla(_forward_small(P, t64)[4], P[:, t64.nspec], t64)),
                ("K4", P2[i], (k4[0][i], k4[1][i]),
                 lambda P: _spec_chi2_xla(_forward_small(P, t64)[4], P[:, t64.nspec], t64)),
                ("K5", P2[i], (k5[0][i], k5[1][i]), lambda P: log_posterior_batch(P, t64))):
            ref = ref_fn(P.double())
            fin = torch.isfinite(ref)
            rel = [float(((x.double() - ref).abs() / ref.abs())[fin].max()) for x in (got, plain)]
            mag = ref[fin].abs()
            parts.append(f"{name} {rel[0]:.3e}, plain {rel[1]:.3e} (|ref| {float(mag.min()):.4g}"
                         f" to {float(mag.max()):.4g})")
        print(f"[fleet pipeline against float64, exact dials] target {i}: max rel err "
              + "; ".join(parts))


def native_loader_check(root, smi):
    """The native grid reader: built on this machine, a 14x4 BT-Settl directory read with
    and without it, bit for bit; both reads timed."""
    from mcmc_spec_tpu_torch import testing
    from mcmc_spec_tpu_torch.models.grid import SpectralGrid, _read_two_columns_py
    from mcmc_spec_tpu_torch.runtime import native_loader

    t = time.perf_counter()
    reader = native_loader.maybe_reader()
    build_s = time.perf_counter() - t
    require(reader is not None, "the native grid reader did not build on this machine "
            f"(compiler {native_loader.find_compiler()})")
    grid_dir = os.path.join(root, "BT-Settl_M-0.0a+0.0")
    temps = np.arange(3000.0, 5601.0, 200.0)
    t = time.perf_counter()
    paths = testing.write_btsettl_dir(grid_dir, temps, step=BTSETTL_STEP)
    write_s = time.perf_counter() - t
    lo, hi = 3000.0 - 100.0, 30000.0 + 100.0
    t = time.perf_counter()
    native_reads = reader.read_many(paths, lo, hi)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    py_reads = [_read_two_columns_py(p, lo, hi) for p in paths]
    py_s = time.perf_counter() - t
    same_reads = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                     for a, b in zip(native_reads, py_reads))
    args = (grid_dir, (3000, 5600), (4.0, 5.5), (3000.0, 30000.0), (6450.0, 8400.0), 1700)
    grids, grid_s = {}, {}
    for use_native in (False, True, False, True):  # in turns; the second of each is kept
        t = time.perf_counter()
        grids[use_native] = SpectralGrid.from_btsettl_dir(*args, use_native=use_native)
        grid_s[use_native] = time.perf_counter() - t
    same_grid = all(np.array_equal(getattr(grids[True], k), getattr(grids[False], k))
                    for k in ("temps", "loggs", "wl", "flux"))
    rows = sum(len(r[0]) for r in native_reads)
    print(f"[native loader] {smi}: built/loaded in {build_s:.2f} s "
          f"({native_loader.library_path().name}); {len(paths)} BT-Settl files, {rows} rows, "
          f"written in {write_s:.1f} s; read_many {native_s:.4f} s against the Python reader "
          f"{py_s:.4f} s ({py_s / native_s:.1f}x), reads {'identical' if same_reads else 'DIFFERENT'}"
          f"; from_btsettl_dir native {grid_s[True]:.3f} s, Python {grid_s[False]:.3f} s, grid "
          f"{tuple(grids[True].flux.shape)} {'bit for bit' if same_grid else 'DIFFERENT'}")
    require(same_reads, "the native reader's rows differ from the Python reader's")
    require(same_grid, "from_btsettl_dir(use_native=True) differs from use_native=False")
    return {"build_s": build_s, "read_s": (native_s, py_s), "grid_s": grid_s}


def fleet_pipeline_phase(dev, smi):
    """The fleet pipeline through its entry point, ``cli.main`` with nine ``-f`` files, on
    the card in float32 on the default route (K4); then the fused route's resume pair
    (K5) and the native grid reader. Returns the launch counts and times."""
    import shutil
    import tempfile

    from mcmc_spec_tpu_torch import cli, fleet_pipeline, pipeline, testing
    from mcmc_spec_tpu_torch.inference import batched
    from mcmc_spec_tpu_torch.inference.fleet import (
        init_fleet_ensemble,
        run_fleet_ensemble,
        stack_targets,
    )
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    cwd, root = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        t0 = time.perf_counter()
        fds = testing.write_fleet_dirs(root, FLEET_PIPE_ND, FLEET_PIPE_NC,
                                       nwalk=FLEET_PIPE_NWALK, nstep=FLEET_PIPE_NSTEP,
                                       nburn=FLEET_PIPE_NBURN, nsteps=FLEET_PIPE_NSTEPS)
        print(f"[fleet pipeline] {NTGT} fit directories (nd {list(FLEET_PIPE_ND)}, contrasts "
              f"{list(FLEET_PIPE_NC)}, one grid cache) in {time.perf_counter() - t0:.1f} s")
        os.chdir(root)
        walls, ctxs, solo = {}, [], []

        def timed_stage(name, fn):
            def wrapped(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t
                if name == "setup_fleet":
                    ctxs.extend(out)
                if name == "run_fleet_optimize":
                    solo.extend(out)
                return out
            return wrapped

        composed = {name: _Counted(getattr(batched, name)) for name in
                    ("_spec_chi2_xla", "_spec_chi2_xla_median_only")}
        real = {name: getattr(fleet_pipeline, name) for name in
                ("setup_fleet", "run_fleet_optimize", "run_fleet_mcmc", "run_fleet_ensemble")}
        steps = _FleetSteps(real["run_fleet_ensemble"])
        for name, fn in composed.items():
            setattr(batched, name, fn)
        for name in ("setup_fleet", "run_fleet_optimize", "run_fleet_mcmc"):
            setattr(fleet_pipeline, name, timed_stage(name, real[name]))
        fleet_pipeline.run_fleet_ensemble = steps
        argv = ["cli"]
        for fd in fds:
            argv += ["-f", fd["paramfile"]]
        try:
            torch.cuda.synchronize()
            ck.reset_launches()
            t = time.perf_counter()
            cli.main(argv + ["-o", "True", "-e", "True", "--noplots"])
            torch.cuda.synchronize()
            walls["cli"] = time.perf_counter() - t
            launches = dict(ck.LAUNCHES)
        finally:
            for name, fn in real.items():
                setattr(fleet_pipeline, name, fn)
            for name, fn in composed.items():
                setattr(batched, name, fn.fn)
        require(len(ctxs) == NTGT and all(c.target.device.type == "cuda"
                                          and c.target.D.dtype == torch.float32 for c in ctxs),
                "the CLI did not pack its fleet on the card in float32")
        require(len(solo) == NTGT and all(batched._fusable(c.target) for c in solo),
                "stage 1 did not anneal every target on an unpadded target K3 takes")

        burn = max(FLEET_PIPE_NBURN // PIPE_NTHIN, 1) * PIPE_NTHIN
        n_done = sum(n for n, thin in steps.calls if thin == 1)
        p0s = [pipeline.seed_from_optimize(c) for c in ctxs]
        nw = min(len(p) for p in p0s) // 2 * 2
        n_iters = 50 * FLEET_PIPE_NSTEP // RECORD_THIN * RECORD_THIN
        want = {"spectrum_chi2": NTGT * (1 + n_iters),
                "spectrum_chi2_fleet": 1 + 2 * (burn + FLEET_PIPE_NSTEPS)}
        print(f"[fleet pipeline launches] K3 spectrum_chi2 {launches['spectrum_chi2']} ({NTGT} "
              f"targets x (1 + {n_iters}): {want['spectrum_chi2']}), K4 spectrum_chi2_fleet "
              f"{launches['spectrum_chi2_fleet']} (1 + 2 x ({burn} burn-in + {n_done} sampling "
              f"steps): {want['spectrum_chi2_fleet']}), K1 {launches['log_posterior_fused']}, K5 "
              f"{launches['log_posterior_fleet_fused']}; the spectrum composition (counted calls "
              "of inference.batched): " + ", ".join(f"{k} {v.calls}" for k, v in composed.items()))
        require(n_done == FLEET_PIPE_NSTEPS, f"stage 2 ran {n_done} sampling steps, expected "
                f"{FLEET_PIPE_NSTEPS} (the gate stopped the chain)")
        for name, n in want.items():
            require(launches[name] == n, f"{name}: {launches[name]} launches in the fleet "
                    f"pipeline, expected {n}")
        for name, fn in composed.items():
            require(fn.calls == 0, f"the fleet pipeline reached the spectrum composition ({name})")
        other = {k: v for k, v in launches.items() if k not in want and v}
        require(not other, f"the fleet pipeline launched other kernels: {other}")

        for i, c in enumerate(ctxs):
            cfg = c.cfg
            got_names = set(os.listdir(cfg.dirname))
            want_names = expected_artifacts(cfg.fname, cfg.nwalk, cfg.nburn, PIPE_NTHIN,
                                            n_done // PIPE_NTHIN)
            require(got_names == want_names, f"target {i} artifacts: missing "
                    f"{sorted(want_names - got_names)[:5]}, unexpected "
                    f"{sorted(got_names - want_names)[:5]}")
            samples = np.loadtxt(os.path.join(cfg.dirname, "samples.txt"))
            require(samples.shape == (nw * n_done, cfg.ndim) and np.isfinite(samples).all(),
                    f"target {i} samples.txt: shape {samples.shape}, expected "
                    f"({nw * n_done}, {cfg.ndim}), finite")
            if i in (0, NTGT - 1):
                med = np.median(samples, axis=0)
                print(f"[fleet pipeline] target {i}: posterior medians "
                      f"{[float(f'{m:.6g}') for m in med]}, truth "
                      f"{[float(f'{x:.6g}') for x in fds[i]['truth']]}")
        af = float(steps.state.n_accept) / (NTGT * nw * n_done)
        print(f"[fleet pipeline] {NTGT} x {len(got_names)} artifacts (the expected sets, no "
              f"fleet checkpoint or chunk store left); samples.txt {NTGT} x ({nw * n_done}, 6), "
              f"finite; acceptance fraction {af:.4f}")
        require(0.05 < af < 0.95, f"fleet acceptance fraction {af} outside (0.05, 0.95)")

        # stage 2 alone: run_fleet_ensemble on the same walkers for the same steps
        fleet = stack_targets([c.target for c in ctxs])
        p0 = torch.as_tensor(np.stack([p[:nw] for p in p0s]), dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(ctxs[0].cfg.seed + 1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = init_fleet_ensemble(p0, fleet, gen)
        state, _, _ = run_fleet_ensemble(state, fleet, burn + n_done, thin=PIPE_NTHIN)
        torch.cuda.synchronize()
        alone = time.perf_counter() - t
        evals = NTGT * nw * (1 + burn + n_done)
        rate_pipe, rate_alone = evals / walls["run_fleet_mcmc"], evals / alone
        # the pipeline's stage-2 call (thin 1) on its final walkers, under torch.profiler
        busy, n_kernels, top, _ = device_busy(
            lambda: run_fleet_ensemble(steps.state, fleet, FLEET_PROFILE_STEPS, thin=1))
        share = "not measured (the profiler reported no device time)" if busy is None else \
            f"{busy:.4f}, {n_kernels / FLEET_PROFILE_STEPS:.0f} kernel launches a step"
        print(f"[fleet pipeline times] {smi}: setup_fleet {walls['setup_fleet']:.3f} s, stage 1 "
              f"(run_fleet_optimize, {NTGT} x {FLEET_PIPE_NWALK} walkers x {n_iters} iterations) "
              f"{walls['run_fleet_optimize']:.3f} s, stage 2 (run_fleet_mcmc, {NTGT} x {nw} "
              f"walkers x {burn} + {n_done} steps) {walls['run_fleet_mcmc']:.3f} s, the whole "
              f"CLI {walls['cli']:.3f} s")
        print(f"[fleet pipeline stage 2] {smi}: {rate_pipe:.1f} evals/s in the pipeline "
              f"({walls['run_fleet_mcmc']:.3f} s) against {rate_alone:.1f} evals/s for "
              f"run_fleet_ensemble alone on the same walkers and {burn + n_done} steps "
              f"({alone:.3f} s); device busy share of the stage-2 call on the final walkers "
              f"({FLEET_PROFILE_STEPS} steps, thin 1) under torch.profiler: {share}; top "
              f"kernels (ms): "
              f"{[(k, round(v, 4)) for k, v in top]}")

        errs = fleet_pipeline_checks(solo, fleet, p0, dev)
        resume = fleet_pipeline_resume(ctxs, [p[:FLEET_RESUME_NW] for p in p0s])
        native = native_loader_check(root, smi)
        return {"launches": launches, "walls": walls, "rates": (rate_pipe, rate_alone),
                "busy": busy, "resume_launches": resume, "native": native, "errs": errs}
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


# phase 13: walker and spectral sharding.  (a) K7d's gate in one process, over 2- and 4-way
# column slices of the lane's rows; (b) gloo worlds of 2 and 4 ranks that all compute on this
# one card (their wall times say how long the check took, not a rate of several cards); (c) the
# CLI under torchrun with NCCL at one rank, --mesh 1x1, on phase 11's fit directory, its depth
# cut from phase 11's nstep 20 / nburn 200 / nsteps 2,000 to 10 / 100 / 200.
SHARD_ND = (65536, 65535, 131072)  # 65,535: rows split unevenly, not 16-byte aligned
SHARD_SPLITS = (2, 4)
SHARD_STEPS, SHARD_THIN = 16, 8
SHARD_NW_WALKERS = 4096  # the 2-rank walker chain, at the koi2298 widths
SHARD_CLI_NSTEP, SHARD_CLI_NBURN, SHARD_CLI_NSTEPS = 10, 100, 200
K7D_PARTS = (("median_round", "median_round_kernel"), ("median_refine", "median_refine_kernel"),
             ("median_finish", "median_finish_kernel"))
# the JAX search and refinement K7d's kernels replace, mcmc_spec_tpu/ops/spec_segmented.py
K7D_REPLACES = {"median_round": 183, "median_refine": 262, "median_finish": 215}


def _recorder(log):
    """A reduce hook that keeps what it is given ([rows, k]) and returns it: the in-process
    stand-in for an all-reduce over one rank."""
    def hook(t):
        log.append(t.reshape(t.shape[0], -1).clone())
        return t
    return hook


def same_bits(got, ref):
    """(rows bit for bit or NaN on both sides, rows that differ)."""
    same = (got.view(torch.int32) == ref.view(torch.int32)) | (torch.isnan(got) & torch.isnan(ref))
    return int(same.sum()), torch.nonzero(~same).flatten().tolist()


def split_widths(nd, S):
    """``S`` slice widths that add up to ``nd``, as even as they go: the last ``nd % S`` one
    wider (65,535 in two: 32,767 + 32,768, rows that are not 16-byte aligned)."""
    return [nd // S + (s >= S - nd % S) for s in range(S)]


def max_diff(got, ref):
    """The largest |got - ref| over the entries, 0 where both hold the same value (NaN on
    both sides included)."""
    got, ref = got.reshape(-1), ref.reshape(-1)
    if got.numel() == 0:
        return 0.0
    same = got == ref
    if got.dtype.is_floating_point:
        same |= torch.isnan(got) & torch.isnan(ref)
    d = (got.double() - ref.double()).abs()
    return float(torch.where(same, torch.zeros_like(d), d).max())


def check_k7d(name, rows, counts):
    """K7d over 2- and 4-way column slices of ``rows`` at the exact and production dials, for
    each of ``counts`` ({label: n_true}): every round's counts, summed over the slices in this
    process, bit for bit the plain version's over the whole rows, and the median bit for bit
    the plain version's and the single-card K7's.  Returns the largest |K7d - plain| of each
    kernel ({part: err}): the round's counts; the refinement's count and upper-middle
    candidate; the finish's median, against the plain version and K7."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    nd = rows.shape[1]
    errs = {part: 0.0 for part, _ in K7D_PARTS}
    for iters in (31, 14):
        exact = seg._exact(iters)
        for label, n in counts.items():
            ref_counts, ref_mins = [], []
            ref = seg.median_nonneg_reference(rows, n, iters, reduce=_recorder(ref_counts),
                                              reduce_min=_recorder(ref_mins))
            k7 = seg.median_nonneg(rows, n, iters)
            for S in SHARD_SPLITS:
                widths = split_widths(nd, S)
                slices = list(torch.split(rows, widths, dim=1))
                got_counts, got_mins = [], []
                got = seg.median_nonneg_rounds(slices, n, iters, reduce=_recorder(got_counts),
                                               reduce_min=_recorder(got_mins))
                torch.cuda.synchronize()
                rounds_ok = len(got_counts) == len(ref_counts) and all(
                    torch.equal(a.to(torch.int64), b.to(torch.int64))
                    for a, b in zip(got_counts, ref_counts))
                n_same, bad = same_bits(got, ref)
                n_k7, bad_k7 = same_bits(got, k7)
                # exact: the last count each side reduces is the refinement's
                diffs = [max_diff(a, b) for a, b in zip(got_counts, ref_counts)]
                n_rounds = len(diffs) - 1 if exact else len(diffs)
                errs["median_round"] = max(errs["median_round"], *diffs[:n_rounds], 0.0)
                errs["median_refine"] = max(
                    errs["median_refine"], *diffs[n_rounds:],
                    *(max_diff(a, b) for a, b in zip(got_mins, ref_mins)), 0.0)
                errs["median_finish"] = max(errs["median_finish"], max_diff(got, ref),
                                            max_diff(got, k7))
                print(f"[K7d {name} {S} slices of {widths} points, iters={iters} {label}] "
                      f"{rows.shape[0]} rows: {len(got_counts)} reduced counts (the plain "
                      f"version {len(ref_counts)}), {'all' if rounds_ok else 'NOT all'} bit "
                      f"for bit; the median {n_same} rows bit for bit the plain version, "
                      f"{n_k7} K7")
                require(rounds_ok, f"K7d {name} {S} slices iters={iters} {label}: the summed "
                        "counts differ from the plain version's")
                require(len(got_mins) == len(ref_mins) and all(
                    same_bits(a.reshape(-1), b.reshape(-1))[1] == []
                    for a, b in zip(got_mins, ref_mins)),
                    f"K7d {name} {S} slices iters={iters} {label}: the minimised upper-middle "
                    "candidates differ from the plain version's")
                require(not bad and not bad_k7,
                        f"K7d {name} {S} slices iters={iters} {label}: rows "
                        f"{(bad or bad_k7)[:5]} differ (plain {bad[:5]}, K7 {bad_k7[:5]})")
    return errs


def k7d_times(model, n_true):
    """One round, the refinement and the finish of K7d on a rank's share of ``model`` at each
    split: {S: {part: (event ms, alone ms, plain ms, bound)}}."""
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg

    dev = model.device
    NW, nd = model.shape
    n = torch.as_tensor(n_true, device=dev).to(torch.int32).reshape(-1)
    r1 = (n.to(torch.int64) + 1) // 2
    out = {}
    for S in SHARD_SPLITS:
        share = model[:, :nd // S].contiguous()
        mi, ndl = share.view(torch.int32), share.shape[1]
        lo = torch.zeros(NW, dtype=torch.int32, device=dev)
        one = torch.zeros((NW, 1), dtype=torch.int32, device=dev)
        c3 = torch.empty((NW, 3), dtype=torch.int32, device=dev)
        cnt = torch.empty(NW, dtype=torch.int32, device=dev)
        mn = torch.empty(NW, dtype=torch.float32, device=dev)
        med = torch.empty(NW, dtype=torch.float32, device=dev)
        lo2, q = lo[:, None], 1 << 29
        x1 = share[:, :1]
        calls = {
            # the first 2-bit round (lo = 0, quarters of 2^29): every round reads the share once
            "median_round": (
                lambda: seg._round_launch(share, n, 0, lo, None, 3, 0, c3, 29, 3),
                lambda: torch.cat([(mi <= lo2 + (k * q - 1)).sum(dim=1, keepdim=True,
                                                                  dtype=torch.int32)
                                   for k in (1, 2, 3)], dim=1)),
            "median_refine": (
                lambda: seg._refine_launch(share, n, 0, lo, one, 1, 0, cnt, mn),
                lambda: ((mi <= lo2).sum(dim=1, dtype=torch.int32),
                         torch.where(mi > lo2, share, torch.full_like(share, float("inf")))
                         .min(dim=1).values)),
            "median_finish": (
                lambda: seg._finish_launch(n, 0, lo, None, 1, 0, cnt, mn, med, -1),
                lambda: torch.where(n % 2 == 1, x1[:, 0], 0.5 * (x1[:, 0] + torch.where(
                    cnt >= r1 + 1, x1[:, 0], mn)))),
        }
        bounds = {
            "median_round": bound(nbytes(share, lo, c3), 6 * NW * ndl),
            "median_refine": bound(nbytes(share, lo, cnt, mn), 4 * NW * ndl),
            "median_finish": bound(nbytes(n, lo, cnt, mn, med), 6 * NW),
        }
        out[S] = {}
        for part, kernel in K7D_PARTS:
            fn, plain = calls[part]
            lo.zero_()
            # the profiler now and then reports no device time for a window: ask once more
            alone = device_ms(fn, kernel)
            if alone is None:
                alone = device_ms(fn, kernel)
            out[S][part] = (cuda_ms(fn), alone, cuda_ms(plain, reps=5), bounds[part])
    return out


def _port_fields(tgt):
    """A target's fields as host numpy (the meta as they are): what a rank rebuilds it from."""
    from mcmc_spec_tpu_torch.inference.target import DATA_FIELDS, META_FIELDS

    fields = {k: getattr(tgt, k).cpu().numpy() for k in DATA_FIELDS}
    fields.update({k: getattr(tgt, k) for k in META_FIELDS})
    return fields


def _rank_target(fields, device):
    import types

    from mcmc_spec_tpu_torch.inference.target import target_from_jax

    return target_from_jax(types.SimpleNamespace(**fields), device=device)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _spec_rank(rank, cases, device):
    """A rank of the 2x2 world on ``device`` (the card's, every rank): for each of ``cases``
    ({name: (target fields, walkers)}) the spec-sharded log-posterior and this rank's
    walkers' median at both dial sets, a target whose nd the spec ranks do not divide
    padded with inert sentinels as the pipeline pads it; then 16 steps of the
    spectral-sharded chain on the first case's target."""
    from mcmc_spec_tpu_torch.inference.batched import _forward_small
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg
    from mcmc_spec_tpu_torch.parallel import mesh as pm
    from mcmc_spec_tpu_torch.parallel import spec_shard

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pm.make_mesh(2, 2, device=dev)
    out = {}
    for name, (fields, P) in cases.items():
        tgt = _rank_target(fields, "cpu")  # packed on the host: each rank moves its slice
        tgt = spec_shard.pad_packed_target_nd(tgt, -(-tgt.n_data // mesh.spec) * mesh.spec)
        Pd = torch.as_tensor(P, device=dev)
        nwl = Pd.shape[0] // mesh.walkers
        mine = Pd[mesh.w_index * nwl:(mesh.w_index + 1) * nwl]
        out[name] = {}
        for label, dials in (("exact", EXACT), ("production", PROD)):
            t = spec_shard.shard_target_over_spec(dataclasses.replace(tgt, **dials), mesh)
            _sync(dev)
            ck.reset_launches()
            pm.reset_collectives()
            t0 = time.perf_counter()
            logp = spec_shard.make_spec_logpost(t, mesh, walker_sharded=True)(Pd)
            _sync(dev)
            wall = time.perf_counter() - t0
            launches, census = dict(ck.LAUNCHES), pm.collective_counts()
            ndl = t.D.shape[2]
            model = seg.model_extinct(_forward_small(mine, t)[4],
                                      mine[:, t.nspec].contiguous(), t.D.reshape(-1, ndl),
                                      t.ext_k_data)
            med = seg.median_nonneg_distributed(model, t.n_data_true, dials["median_iters"],
                                                mesh.spec_group)
            out[name][label] = {"logp": logp.cpu().numpy(), "median": med.cpu().numpy(),
                                "launches": launches, "census": census, "wall": wall,
                                "ndl": ndl, "padded": tgt.n_data - fields["D"].shape[-1]}
        if len(out) == 1:
            chain_case = (tgt, Pd)
    tgt, Pd = chain_case
    t = spec_shard.shard_target_over_spec(dataclasses.replace(tgt, **PROD), mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    _sync(dev)
    t0 = time.perf_counter()
    state = spec_shard.shard_spec_ensemble_state(Pd, t, gen, mesh)
    ck.reset_launches()
    pm.reset_collectives()
    state, _, logps = spec_shard.run_ensemble_spec_sharded(state, t, mesh, SHARD_STEPS,
                                                            thin=SHARD_THIN)
    _sync(dev)
    out["chain"] = {"finite": bool(torch.isfinite(logps).all()), "n_accept": int(state.n_accept),
                    "wall": time.perf_counter() - t0, "launches": dict(ck.LAUNCHES),
                    "census": pm.collective_counts()}
    return out


def _walker_rank(rank, fields, P, device):
    """A rank of the 2-rank walker world on ``device``: ``run_ensemble_sharded`` (K1)."""
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.parallel import mesh as pm
    from mcmc_spec_tpu_torch.parallel import sharding

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tgt = _rank_target(fields, dev)
    mesh = pm.make_mesh(2, 1, device=dev, axis_names=("walkers",))
    logp = lambda b: log_posterior_batch(b, tgt)
    state = sharding.shard_ensemble_state(torch.as_tensor(P, device=dev), logp,
                                          torch.Generator(device=dev).manual_seed(11), mesh)
    ck.reset_launches()
    pm.reset_collectives()
    _sync(dev)
    t0 = time.perf_counter()
    state, chain, _ = sharding.run_ensemble_sharded(state, logp, mesh, SHARD_STEPS,
                                                    thin=SHARD_THIN)
    chain = sharding.gather_walkers(chain, mesh, dim=2)
    _sync(dev)
    return {"chain": chain.reshape(chain.shape[0], -1, chain.shape[-1]).cpu().numpy(),
            "n_accept": int(state.n_accept), "wall": time.perf_counter() - t0,
            "launches": dict(ck.LAUNCHES), "census": pm.collective_counts()}


def cli_rank(out_path, argv):
    """A rank of phase 13's torchrun: ``cli.main(argv)`` in this process with every count set
    to 0 before it, then the counts and the wall time to ``out_path``."""
    from mcmc_spec_tpu_torch import cli
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    ck.reset_launches()
    pm.reset_collectives()
    t0 = time.perf_counter()
    cli.main(["cli", *argv])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with open(out_path, "w") as f:
        json.dump({"launches": dict(ck.LAUNCHES), "collectives": pm.collective_counts(),
                   "wall": time.perf_counter() - t0}, f)


def sharding_cli(fit, dev):
    """(c): the CLI under ``torch.distributed.run`` with NCCL at one rank, ``--mesh 1x1``, on
    phase 11's fit directory; returns its launch counts.  (On the CPU, as a rehearsal, gloo
    with ``--device cpu``.)"""
    import re

    from mcmc_spec_tpu_torch.utils.config import FitConfig
    from mcmc_spec_tpu_torch.utils.runlog import read_run_log

    root = fit["root"]
    text = open(fit["paramfile"]).read().replace("dirname run", "dirname shard_run")
    for key, val in (("nstep", SHARD_CLI_NSTEP), ("nburn", SHARD_CLI_NBURN),
                     ("nsteps", SHARD_CLI_NSTEPS)):
        text = re.sub(rf"^{key} .*$", f"{key} {val}", text, flags=re.M)
    param = os.path.join(root, "param_shard.txt")
    with open(param, "w") as f:
        f.write(text)
    counts_path = os.path.join(root, "shard_counts.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", os.path.abspath(__file__), "--cli-rank", counts_path, "-f", param, "-o", "True",
           "-e", "True", "--noplots", "--mesh", "1x1",
           *(["--device", "cpu"] if dev.type == "cpu" else [])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines()[-12:]:
        print(f"[sharding cli] {line}")
    require(proc.returncode == 0, f"the torchrun CLI failed ({proc.returncode}): "
            f"{proc.stderr[-3000:]}")
    with open(counts_path) as f:
        got = json.load(f)
    require("spectral-sharded annealer over mesh {'walkers': 1, 'spec': 1}" in proc.stdout
            and "over mesh {'walkers': 1, 'spec': 1}" in proc.stdout.split("[mcmc]")[-1],
            "the CLI did not run both stages on the 1x1 mesh")
    cfg = FitConfig.from_file(param)
    dirname = os.path.join(root, cfg.dirname)
    end = next(e for e in read_run_log(dirname) if e["event"] == "mcmc.end")
    nw, n_done = end["n_walkers"], end["n_steps"]
    n_iters = 50 * SHARD_CLI_NSTEP // RECORD_THIN * RECORD_THIN
    burn = max(SHARD_CLI_NBURN // PIPE_NTHIN, 1) * PIPE_NTHIN
    e1, e2 = 1 + n_iters, 1 + 2 * (burn + n_done)  # annealer and sampler evaluations
    want = {"model_extinct": e1 + e2, "median_round": 16 * e1 + 7 * e2, "median_refine": e1,
            "median_finish": e1 + e2, "renorm_partials": e2, "resid_chi2": e1 + e2}
    L, C = got["launches"], got["collectives"]
    print(f"[sharding cli] torchrun --nproc-per-node 1, NCCL, --mesh 1x1: {nw} walkers, stage 1 "
          f"{e1} evaluations (exact median), stage 2 {e2} (production): launches "
          + ", ".join(f"{k} {L[k]} (expected {v})" for k, v in want.items())
          + f"; collectives {C}; the CLI {got['wall']:.2f} s in the rank, {wall:.2f} s with "
          "torchrun")
    for k, v in want.items():
        require(L[k] == v, f"the 1x1 CLI launched {k} {L[k]} times, expected {v}")
    other = {k: v for k, v in L.items() if k not in want and v}
    require(not other, f"the 1x1 CLI launched other kernels: {other}")
    # and the accept count's sum, once a sampler call (the burn-in's and each chunk's)
    sums = 18 * e1 + 9 * e2 + burn // PIPE_NTHIN + n_done // PIPE_NTHIN
    require(C["all_reduce_sum"] == sums and C["all_reduce_min"] == e1,
            f"the 1x1 CLI's all-reduces {C}: expected {sums} sums and {e1} mins")
    names = set(os.listdir(dirname))
    want_names = expected_artifacts(cfg.fname, cfg.nwalk, cfg.nburn, PIPE_NTHIN,
                                    n_done // PIPE_NTHIN)
    require(names == want_names, f"1x1 artifacts: missing {sorted(want_names - names)[:5]}, "
            f"unexpected {sorted(names - want_names)[:5]}")
    samples = np.loadtxt(os.path.join(dirname, "samples.txt"))
    require(samples.shape == (nw * n_done, cfg.ndim) and np.isfinite(samples).all(),
            f"1x1 samples.txt {samples.shape}, expected ({nw * n_done}, {cfg.ndim}), finite")
    print(f"[sharding cli] {len(names)} artifacts (the expected set), samples.txt "
          f"{samples.shape} finite, acceptance fraction {end['acceptance_fraction']}")
    return {"launches": L, "collectives": C, "wall": wall}


def sharding_phase(dev, smi, fit):
    """Phase 13: K7d's gate and times, the gloo worlds on this card, the CLI at 1x1."""
    from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
    from mcmc_spec_tpu_torch.ops import spec_segmented as seg
    from mcmc_spec_tpu_torch.testing import run_world

    walls = {}
    # (a) K7d in one process: the lane's rows and K7's edge rows, split 2 and 4 ways
    t0 = time.perf_counter()
    targets, gate_errs = {}, {}
    for nd in SHARD_ND:
        tgt, truth = largend_target(dev, nd)
        P = torch.cat([init_walker_batch(tgt, truth, NW_LARGE), edge_walkers(truth, tgt)])
        model = lane_model(tgt, P)
        edge, counts, _ = k7_edge_rows(model[0])
        rows = torch.cat([model, edge]).contiguous()
        per_row = torch.cat([(int(tgt.n_data_true) - torch.arange(model.shape[0], device=dev)
                              % 3).to(torch.int32), counts])
        errs = check_k7d(f"nd={nd}", rows, {"one count": tgt.n_data_true,
                                            "a count per row": per_row})
        gate_errs = {k: max(v, gate_errs.get(k, 0.0)) for k, v in errs.items()}
        targets[nd] = (tgt, truth, P, model)
    print(f"[K7d gate] the largest |K7d - plain| over every row, split and dial: {gate_errs}")
    tgt, truth, P, model = targets[ND_FIT]
    times = k7d_times(model[:NW_LARGE], tgt.n_data_true)
    for S, parts in times.items():
        for part, (ms, alone, plain_ms, b) in parts.items():
            print(f"[time {part}] {smi}: {NW_LARGE} walkers x nd={ND_FIT} split {S} ways "
                  f"({ND_FIT // S} points a rank): kernel {ms:.4f} ms (alone on the device "
                  f"{fmt_ms(alone)}), plain {plain_ms:.4f} ms, bound {b[0]:.5f} ms ({b[1]}); "
                  "library: none (no single PyTorch call computes it)")
    walls["gate"] = time.perf_counter() - t0

    # (b) gloo worlds on this one card: the kernels are built, each rank loads them.  The
    # 2x2 world at nd = 65,536 and at 65,535, which the two spec ranks do not divide: its
    # last shard runs K6-K9 and K7d over a 1e30 sentinel
    t0 = time.perf_counter()
    cases = {}
    for nd in (ND_FIT, ND_ODD):
        tgt_nd, truth_nd = targets[nd][:2]
        cases[nd] = (tgt_nd, init_walker_batch(tgt_nd, truth_nd, NW_LARGE))
    spec = run_world(_spec_rank, 4, {nd: (_port_fields(t), Pw.cpu().numpy())
                                     for nd, (t, Pw) in cases.items()}, str(dev))
    walls["2x2 world"] = time.perf_counter() - t0
    nwl = NW_LARGE // 2
    for (nd, (tgt_nd, Pw)), (label, dials) in itertools.product(
            cases.items(), (("exact", EXACT), ("production", PROD))):
        td = dataclasses.replace(tgt_nd, **dials)
        ref = log_posterior_batch(Pw, td)
        # K7 on the model of each walker shard's own batch: the blend weights of a batch
        # (torch's products) may round otherwise at another batch size
        ref_med = torch.cat([seg.median_nonneg(lane_model(td, Pw[w * nwl:(w + 1) * nwl]),
                                               td.n_data_true, dials["median_iters"])
                             for w in range(2)])
        full_med = seg.median_nonneg(lane_model(td, Pw), td.n_data_true, dials["median_iters"])
        for rank, out in enumerate(spec):
            o = out[nd][label]
            w = rank // 2
            outside, rel, _ = compare(torch.as_tensor(o["logp"], device=dev), ref)
            n_same, bad = same_bits(torch.as_tensor(o["median"], device=dev),
                                    ref_med[w * nwl:(w + 1) * nwl])
            n_full, _ = same_bits(torch.as_tensor(o["median"], device=dev),
                                  full_med[w * nwl:(w + 1) * nwl])
            if rank == 0:
                print(f"[sharding 2x2 nd={nd} {label}] rank 0 of 4 on {smi}: {NW_LARGE} "
                      f"walkers x nd={nd} ({o['ndl']} points a rank, the last rank's last "
                      f"{o['padded']} padding): log-posterior {outside} walkers outside the gate of the "
                      f"single-card K10 lane (max rel {rel:.3g}); median {n_same} of {nwl} "
                      f"rows bit for bit K7 on the shard's batch ({n_full} K7 on the whole "
                      f"batch's model); one evaluation {o['wall'] * 1e3:.1f} ms, collectives "
                      f"{o['census']}, launches "
                      + str({k: v for k, v in o["launches"].items() if v}))
            require(outside == 0, f"2x2 nd={nd} {label} rank {rank}: {outside} walkers "
                    "outside the gate of the single-card lane")
            require(not bad, f"2x2 nd={nd} {label} rank {rank}: median rows {bad[:5]} differ "
                    "from K7")
            want = (9, 0) if label == "production" else (19, 1)
            got = (o["census"]["all_reduce_sum"], o["census"]["all_reduce_min"])
            require(got == want, f"2x2 nd={nd} {label} rank {rank}: all-reduces {got}, "
                    f"expected {want}")
        require(spec[-1][nd][label]["padded"] == nd % 2, f"2x2 nd={nd}: the last shard holds "
                f"{spec[-1][nd][label]['padded']} padding points, expected {nd % 2}")
    chain = spec[0]["chain"]
    print(f"[sharding 2x2 chain] {SHARD_STEPS} steps of run_ensemble_spec_sharded, "
          f"{NW_LARGE} walkers, production dials: log-probs finite {chain['finite']}, "
          f"{chain['n_accept']} moves accepted, {chain['wall']:.2f} s on rank 0 (4 ranks on one "
          f"card through gloo: the time of the check, not a rate), collectives "
          f"{chain['census']}, launches " + str({k: v for k, v in chain["launches"].items() if v}))
    require(all(o["chain"]["finite"] for o in spec), "the 2x2 chain's log-probs are not finite")
    require(len({o["chain"]["n_accept"] for o in spec}) == 1, "the 2x2 ranks disagree on the "
            "accepted moves")

    t0 = time.perf_counter()
    btgt, btruth = build_bench_target(torch.float32, device=dev)
    Pk = init_walker_batch(btgt, btruth, SHARD_NW_WALKERS)
    walker = run_world(_walker_rank, 2, _port_fields(btgt), Pk.cpu().numpy(), str(dev))
    walls["walker world"] = time.perf_counter() - t0
    logp = lambda b: log_posterior_batch(b, btgt)
    state = init_ensemble(Pk, logp, torch.Generator(device=dev).manual_seed(11))
    state, ref_chain, _ = run_ensemble(state, logp, SHARD_STEPS, thin=SHARD_THIN)
    ref_chain = ref_chain.cpu().numpy()
    for rank, out in enumerate(walker):
        same = np.array_equal(out["chain"], ref_chain)
        if rank == 0:
            print(f"[sharding walkers] 2 ranks on {smi}, {SHARD_NW_WALKERS} walkers x "
                  f"nd={btgt.n_data}, {SHARD_STEPS} steps: the chain "
                  f"{'bit for bit' if same else 'DIFFERENT from'} run_ensemble on one card, "
                  f"{out['n_accept']} moves accepted (one card {int(state.n_accept)}), "
                  f"{out['wall']:.2f} s, collectives {out['census']}, launches "
                  + str({k: v for k, v in out["launches"].items() if v}))
        require(same and out["n_accept"] == int(state.n_accept),
                f"walker rank {rank}: the chain differs from run_ensemble's")

    # (c) the CLI under torchrun, NCCL, one rank, --mesh 1x1
    t0 = time.perf_counter()
    cli_res = sharding_cli(fit, dev)
    walls["cli"] = time.perf_counter() - t0
    print(f"[sharding] {smi}: wall times (s) " + ", ".join(f"{k} {v:.1f}"
                                                          for k, v in walls.items()))
    return {"times": times, "cli": cli_res, "walls": walls, "errs": gate_errs}


# phase 14: the fleet over a targets x walkers mesh, then the host modules.  (a) and (b) run in
# gloo worlds whose ranks all compute on this one card (their wall times say how long the check
# took, not a rate of several cards).  (a) the ragged nine targets of phase 6 at the koi2298
# widths, 4,096 walkers each, 16 steps at thin 8 on K4 and on K5: a world of 3 (3x1), a world
# of 4 (1x4, and 2x2 on the first six targets); (b) run_fleet_mcmc in the world of 4 (2x2) on
# six targets x 1,024 walkers, burn-in 100 and 200 steps at nthin 100 (depth cut from phase
# 12's 100 / 300 to fit the time limit), on K5; (c) EnsembleSampler on the bench target, 4,096
# walkers, two run_mcmc blocks; (d) both examples (depth cut: fit_synthetic_binary's 200
# annealer steps and 3,000 steps to 40 and 1,000, spec_sharded_fit's 100 and 500 to 2 and 60);
# (e) the population analysis's CLI over three result directories, in a process of its own
MESH_STEPS, MESH_THIN = 16, 8
MESH_WORLDS = {3: ((3, 1, 9),), 4: ((1, 4, 9), (2, 2, 6))}  # (targets, walkers, fleet targets)
MESH_PIPE_NTGT, MESH_PIPE_NW = 6, 1024
MESH_PIPE_NBURN, MESH_PIPE_NSTEPS = 100, 200
MESH_ROUTES = (("K4", "spectrum_chi2_fleet"), ("K5", "log_posterior_fleet_fused"))
SAMPLER_NW, SAMPLER_BLOCKS, SAMPLER_THIN = 4096, (24, 16), 8
EXAMPLE_SHARD_ARGS = ["2", "2", "--anneal-steps", "2", "--steps", "60"]
# fit_synthetic_binary's depth cut from 200 annealer steps (10,000 iterations, host-bound)
# and 3,000 sampler steps to fit the time limit
EXAMPLE_FIT_KW = dict(anneal_steps=40, nsteps=1000)
ANALYSIS_SYSTEMS = ("2298", "0268", "0042")


def _route(route):
    if route == "K5":
        os.environ["MCMC_SPEC_FUSED_EVAL"] = "1"
    else:
        os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)


def _rank_fleet(fields, ntgt, device):
    from mcmc_spec_tpu_torch.inference.target import DATA_FIELDS

    return _rank_target({k: (v[:ntgt] if k in DATA_FIELDS else v) for k, v in fields.items()},
                        device)


def _fleet_mesh_rank(rank, fields, P, device, pipe=None):
    """A rank of a phase-14 world on ``device`` (the card's, every rank): for each of its
    world's meshes and each route, ``run_fleet_ensemble_sharded`` on its block, the chain
    and the first log-probs gathered to every rank; then, given ``pipe`` (the fit root, the
    param files, the seeds), ``run_fleet_mcmc`` on the 2x2 mesh."""
    import torch.distributed as dist

    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.parallel import mesh as pm
    from mcmc_spec_tpu_torch.parallel import sharding

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for T, W, ntgt in MESH_WORLDS[dist.get_world_size()]:
        mesh = pm.make_fleet_mesh(T, W, device=dev)
        block = sharding.fleet_block(_rank_fleet(fields, ntgt, dev), mesh)
        for route, _ in MESH_ROUTES:
            _route(route)
            _sync(dev)
            t0 = time.perf_counter()
            st = sharding.shard_fleet_state(torch.as_tensor(P[:ntgt], device=dev), block,
                                            torch.Generator(device=dev).manual_seed(5), mesh)
            lp0 = sharding.gather_fleet(st.log_prob, mesh)
            ck.reset_launches()
            pm.reset_collectives()
            st, chain, _ = sharding.run_fleet_ensemble_sharded(st, block, mesh, MESH_STEPS,
                                                               thin=MESH_THIN)
            _sync(dev)
            launches, census = dict(ck.LAUNCHES), pm.collective_counts()
            out[(T, W, route)] = {
                "chain": sharding.gather_fleet(chain, mesh, dim=2).cpu().numpy(),
                "lp0": lp0.cpu().numpy(), "n_accept": int(st.n_accept), "launches": launches,
                "census": census, "wall": time.perf_counter() - t0,
                "block": tuple(block.D.shape)}
    os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
    if pipe is not None:
        out["pipeline"] = _mesh_pipeline(pipe, "mesh", dev)
    return out


def _mesh_pipeline(pipe, tag, dev):
    """``run_fleet_mcmc`` on the six targets of ``pipe`` with dirnames ``{tag}{i}``, on K5;
    returns the launch counts, the census and the wall time."""
    from mcmc_spec_tpu_torch import fleet_pipeline
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.parallel import mesh as pm
    from mcmc_spec_tpu_torch.utils.config import FitConfig

    cwd = os.getcwd()
    os.chdir(pipe["root"])
    _route("K5")
    try:
        cfgs = []
        for i, param in enumerate(pipe["params"]):
            cfg = FitConfig.from_file(param)
            cfg.dirname = f"{tag}{i}"
            cfgs.append(cfg)
        ctxs = fleet_pipeline.setup_fleet(cfgs, dtype=torch.float32, device=dev)
        _sync(dev)
        ck.reset_launches()
        pm.reset_collectives()
        t0 = time.perf_counter()
        fleet_pipeline.run_fleet_mcmc(ctxs, p0s=pipe["p0s"], nthin=PIPE_NTHIN,
                                      return_samples=False)
        _sync(dev)
        return {"launches": dict(ck.LAUNCHES), "census": pm.collective_counts(),
                "wall": time.perf_counter() - t0}
    finally:
        os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
        os.chdir(cwd)


def fleet_mesh_phase(dev, smi, fit):
    """Phase 14 (a) and (b): the fleet chain on the 3x1, 1x4 and 2x2 worlds on this card
    against the one-card chain, and run_fleet_mcmc's samples.txt on the 2x2 world against
    the one-card run's; then (c), (d) and (e) (``host_modules_checks``)."""
    from mcmc_spec_tpu_torch import testing
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.inference.fleet import init_fleet_ensemble, run_fleet_ensemble
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.testing import run_world

    t_phase = time.perf_counter()
    fleet, singles, truth = build_fleet(dev)
    P = torch.stack([init_walker_batch(t, truth, NW_FLEET, seed=1 + i)
                     for i, t in enumerate(singles)])
    fields, P_host = _port_fields(fleet), P.cpu().numpy()
    # the one-card chains: 16 steps at thin 8 from the same generator, nine and six targets
    ref, ref_launches = {}, {}
    for ntgt in (NTGT, MESH_PIPE_NTGT):
        f = _rank_fleet(fields, ntgt, dev)
        for route, kernel in MESH_ROUTES:
            _route(route)
            st = init_fleet_ensemble(P[:ntgt], f, torch.Generator(device=dev).manual_seed(5))
            lp0 = st.log_prob
            ck.reset_launches()
            st, chain, _ = run_fleet_ensemble(st, f, MESH_STEPS, thin=MESH_THIN)
            _sync(dev)
            ref[(ntgt, route)] = (chain.cpu().numpy(), lp0.cpu().numpy(), int(st.n_accept))
            ref_launches[(ntgt, route)] = ck.LAUNCHES[kernel]
    os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)

    # (b)'s fit directories beside phase 11's, over its grid cache; the one-card run
    fds = testing.write_fleet_dirs(fit["root"], FLEET_PIPE_ND[:MESH_PIPE_NTGT],
                                   FLEET_PIPE_NC[:MESH_PIPE_NTGT], nwalk=3 * MESH_PIPE_NW,
                                   nburn=MESH_PIPE_NBURN, nsteps=MESH_PIPE_NSTEPS)
    scale = np.array([40.0, 40.0, 0.01, 0.01, 0.01, 0.02e-3])
    pipe = {"root": fit["root"], "params": [fd["paramfile"] for fd in fds],
            "p0s": [fd["truth"] + scale * np.random.RandomState(i).randn(MESH_PIPE_NW, 6)
                    for i, fd in enumerate(fds)]}
    one = _mesh_pipeline(pipe, "one", dev)

    walls = {}
    worlds = {}
    for n in MESH_WORLDS:
        t0 = time.perf_counter()
        worlds[n] = run_world(_fleet_mesh_rank, n, fields, P_host, str(dev),
                              pipe if n == 4 else None)
        walls[f"world of {n}"] = time.perf_counter() - t0

    report = {"launches": {}, "walls": walls, "k4": {}}
    for n, meshes in MESH_WORLDS.items():
        for T, W, ntgt in meshes:
            for route, kernel in MESH_ROUTES:
                chain, lp0, n_acc = ref[(ntgt, route)]
                for rank, out in enumerate(worlds[n]):
                    o = out[(T, W, route)]
                    same = np.array_equal(o["chain"], chain) and o["n_accept"] == n_acc
                    moved = int((o["chain"][-1] != chain[-1]).any(axis=-1).sum())
                    outside, rel, _ = compare(torch.as_tensor(o["lp0"]).flatten(),
                                              torch.as_tensor(lp0).flatten())
                    want = {"all_gather": 2 * MESH_STEPS, "all_reduce_sum": 1,
                            "all_reduce_min": 0, "barrier": 0}
                    if rank == 0:
                        print(f"[fleet mesh {T}x{W} {route}] rank 0 of {n} on {smi}: {ntgt} "
                              f"targets x {NW_FLEET} walkers (block {o['block'][0]} targets), "
                              f"{MESH_STEPS} steps at thin {MESH_THIN}: the chain "
                              + ("bit for bit the one-card run_fleet_ensemble" if same else
                                 f"differs from the one-card chain ({moved} of {ntgt * NW_FLEET} "
                                 "final walkers)")
                              + f", {o['n_accept']} moves accepted (one card {n_acc}); initial "
                              f"log-probs {outside} walkers outside the kernel gate (max rel "
                              f"{rel:.3g}); {kernel} {o['launches'][kernel]} launches a rank "
                              f"(one card {ref_launches[(ntgt, route)]}); collectives "
                              f"{o['census']}; {o['wall']:.2f} s")
                    require(o["census"] == want, f"fleet mesh {T}x{W} {route} rank {rank}: "
                            f"collectives {o['census']}, expected {want}")
                    require(o["launches"][kernel] == 2 * MESH_STEPS,
                            f"fleet mesh {T}x{W} {route} rank {rank}: {kernel} launched "
                            f"{o['launches'][kernel]} times, expected {2 * MESH_STEPS}")
                    require(outside == 0, f"fleet mesh {T}x{W} {route} rank {rank}: {outside} "
                            "initial log-probs outside the kernel gate")
                    # K5 computes each walker's whole posterior in its warp: bit for bit on any
                    # mesh.  K4's route computes the blend weights with torch ops on the rank's
                    # batch, whose rows cuBLAS may round otherwise at another batch size
                    require(same or route == "K4", f"fleet mesh {T}x{W} {route} rank {rank}: "
                            "the chain differs from the one-card chain")
                    report["launches"][(T, W, route)] = o["launches"][kernel]
                    if route == "K4" and rank == 0:
                        report["k4"][(T, W)] = (same, moved, rel)
    if not all(v[0] for v in report["k4"].values()):
        # the composed route's ops whose rows change with the batch on the card
        from mcmc_spec_tpu_torch.scripts import batch_rows

        rows = batch_rows.main(str(dev))
        report["k4_ops"] = {op: c for op, c in rows.items() if any(c.values())}
        found = [op + " (" + ", ".join(f"{r} of {b} rows in {n} shares"
                                       for (b, n), r in c.items() if r) + ")"
                 for op, c in report["k4_ops"].items()]
        print("[fleet mesh K4] the ops whose rows a share of the one card's batch rounds "
              "otherwise: " + "; ".join(found))

    # (b) every target's samples.txt byte for byte
    same = []
    for i in range(MESH_PIPE_NTGT):
        with open(os.path.join(fit["root"], f"one{i}", "samples.txt"), "rb") as a, \
                open(os.path.join(fit["root"], f"mesh{i}", "samples.txt"), "rb") as b:
            same.append(a.read() == b.read())
    mp = worlds[4][0]["pipeline"]
    k5 = "log_posterior_fleet_fused"
    print(f"[fleet mesh pipeline] run_fleet_mcmc on K5, {MESH_PIPE_NTGT} targets x "
          f"{MESH_PIPE_NW} walkers, burn-in {MESH_PIPE_NBURN} and {MESH_PIPE_NSTEPS} steps, on "
          f"the 2x2 world: {sum(same)} of {len(same)} samples.txt identical to the one-card "
          f"run's; K5 {mp['launches'][k5]} launches on rank 0 (one card {one['launches'][k5]}), "
          f"collectives {mp['census']}; {mp['wall']:.2f} s on rank 0, {one['wall']:.2f} s on "
          "one card")
    require(all(same), "a target's samples.txt on the 2x2 world differs from the one-card run's")
    chunks = max(MESH_PIPE_NBURN // PIPE_NTHIN, 1) + MESH_PIPE_NSTEPS // PIPE_NTHIN
    want = {"all_gather": chunks * (2 * PIPE_NTHIN + 2), "all_reduce_sum": chunks,
            "all_reduce_min": 0, "barrier": 2}
    require(mp["census"] == want, f"the 2x2 run_fleet_mcmc's collectives {mp['census']}, "
            f"expected {want}")
    # the one card evaluates the whole fleet each half-step, a 2x2 rank its block
    require(mp["launches"][k5] == one["launches"][k5] > 0, "the 2x2 run_fleet_mcmc's K5 "
            f"launches {mp['launches'][k5]}, the one card's {one['launches'][k5]}")
    report["pipeline"] = {"one": one, "mesh": mp}
    walls["(a) and (b)"] = time.perf_counter() - t_phase
    report["host"] = host_modules_checks(dev, smi, fit, walls)
    walls["phase"] = time.perf_counter() - t_phase
    print(f"[fleet mesh] {smi}: wall times (s) " + ", ".join(f"{k} {v:.1f}"
                                                            for k, v in walls.items()))
    return report


def host_modules_checks(dev, smi, fit, walls):
    """Phase 14 (c)-(e): EnsembleSampler against run_ensemble, both examples, the analysis
    CLI; returns their launch counts."""
    from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
    from mcmc_spec_tpu_torch.examples import fit_synthetic_binary, spec_sharded_fit
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.inference.sampler_api import EnsembleSampler
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    out = {}
    # (c) the sampler facade on the bench target (koi2298 widths), two blocks
    t0 = time.perf_counter()
    tgt, truth = build_bench_target(torch.float32, device=dev)
    P = init_walker_batch(tgt, truth, SAMPLER_NW)
    logp = lambda b: log_posterior_batch(b, tgt)
    torch.cuda.synchronize()
    ck.reset_launches()
    s = EnsembleSampler(SAMPLER_NW, 6, logp, seed=9, device=dev)
    s.run_mcmc(P.cpu().numpy(), SAMPLER_BLOCKS[0], thin_by=SAMPLER_THIN)
    s.run_mcmc(None, SAMPLER_BLOCKS[1], thin_by=SAMPLER_THIN)
    torch.cuda.synchronize()
    k1 = ck.LAUNCHES["log_posterior_fused"]
    state = init_ensemble(P, logp, torch.Generator(device=dev).manual_seed(9))
    chains = []
    for n in SAMPLER_BLOCKS:
        state, chain, _ = run_ensemble(state, logp, n, thin=SAMPLER_THIN)
        chains.append(chain.cpu().numpy())
    same = np.array_equal(s.get_chain(), np.concatenate(chains))
    af = s.acceptance_fraction[0]
    steps = sum(SAMPLER_BLOCKS)
    print(f"[EnsembleSampler] {smi}: {SAMPLER_NW} walkers x nd={tgt.n_data}, run_mcmc blocks "
          f"{SAMPLER_BLOCKS} at thin {SAMPLER_THIN}: the chain "
          f"{'bit for bit' if same else 'DIFFERENT from'} run_ensemble from the same seed, "
          f"acceptance {af:.3f} (run_ensemble {int(state.n_accept) / (SAMPLER_NW * steps):.3f}),"
          f" K1 {k1} launches (expected {1 + 2 * steps}); {time.perf_counter() - t0:.2f} s")
    require(same and int(state.n_accept) == round(af * SAMPLER_NW * steps),
            "EnsembleSampler's chain differs from run_ensemble's")
    require(k1 == 1 + 2 * steps, f"EnsembleSampler launched K1 {k1} times, expected "
            f"{1 + 2 * steps}")
    out["sampler"] = {"log_posterior_fused": k1}
    walls["(c) sampler"] = time.perf_counter() - t0

    # (d) the examples through their mains
    t0 = time.perf_counter()
    ck.reset_launches()
    outdir = os.path.join(fit["root"], "example_out")
    ex = fit_synthetic_binary.main(outdir, noplots=True, device=str(dev), **EXAMPLE_FIT_KW)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    flat = ex.get_chain(flat=True)
    print(f"[example fit_synthetic_binary --noplots] {smi}: {flat.shape[0]} samples, finite "
          f"{bool(np.isfinite(flat).all())}, acceptance {ex.acceptance_fraction[0]:.3f}, launches "
          f"{launches}; {time.perf_counter() - t0:.2f} s")
    require(np.isfinite(flat).all() and 0.05 < ex.acceptance_fraction[0] < 0.95,
            "fit_synthetic_binary: non-finite samples or acceptance outside (0.05, 0.95)")
    require(launches.get("spectrum_chi2", 0) > 0 and launches.get("log_posterior_fused", 0) > 0
            and set(launches) == {"spectrum_chi2", "log_posterior_fused"},
            f"fit_synthetic_binary launched {launches}, expected K3 and K1 only")
    out["fit_example"] = launches
    walls["(d) fit_synthetic_binary"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = spec_sharded_fit.main(EXAMPLE_SHARD_ARGS)
    lanes = {k: v for k, v in res["launches"].items() if v}
    print(f"[example spec_sharded_fit {' '.join(EXAMPLE_SHARD_ARGS)}] {smi}: a 2x2 gloo world "
          f"on this card: best chi2 {res['chi2']:.2f}, acceptance {res['acceptance']:.2f}, max "
          f"|sharded - single-card| log-posterior {res['max_logp_err']:.3g}, rank 0's launches "
          f"{lanes}; {time.perf_counter() - t0:.2f} s")
    want = {"model_extinct", "median_round", "median_refine", "median_finish", "renorm_partials",
            "resid_chi2"}
    require(set(lanes) == want, f"spec_sharded_fit launched {sorted(lanes)}, expected "
            f"{sorted(want)}")
    require(0.05 < res["acceptance"] < 0.95 and np.isfinite(res["medians"]).all(),
            "spec_sharded_fit: acceptance outside (0.05, 0.95) or non-finite medians")
    out["shard_example"] = lanes
    walls["(d) spec_sharded_fit"] = time.perf_counter() - t0

    # (e) the analysis CLI in a process of its own, on result directories and catalogs written
    # here (without pandas, which this machine may not have)
    t0 = time.perf_counter()
    from mcmc_spec_tpu_torch.analysis.table import Table
    from mcmc_spec_tpu_torch.testing import write_result_dir

    root = os.path.join(fit["root"], "analysis")
    os.makedirs(root)
    for i, name in enumerate(ANALYSIS_SYSTEMS):
        write_result_dir(root, name, seed=i)
    Table({"system": np.array(ANALYSIS_SYSTEMS, dtype=object),
           "kep_teff": np.array([5100.0, 6000.0, 4700.0]), "kep_teff_err": np.full(3, 90.0),
           "kep_rstar": np.array([0.9, 1.2, 0.72]), "kep_rstar_err": np.full(3, 0.05),
           "kep_mstar": np.array([0.85, 1.1, 0.76])}).to_csv(os.path.join(root, "stars.csv"))
    Table({"system": np.array(["2298", "2298", "0268", "0042"], dtype=object),
           "pname": np.array(["2298.01", "2298.02", "268.01", "42.01"], dtype=object),
           "radius": np.array([2.1, 1.1, 3.0, 1.6]), "radius_err": np.full(4, 0.15),
           "teq": np.array([700.0, 500.0, 900.0, 650.0]),
           "period": np.array([0.0274, 0.1, 0.01, 0.0605]), "period_err": np.full(4, 5e-5)}
          ).to_csv(os.path.join(root, "planets.csv"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "mcmc_spec_tpu_torch.analysis", "--results",
         os.path.join(root, "koi*"), "--star-catalog", os.path.join(root, "stars.csv"),
         "--planet-catalog", os.path.join(root, "planets.csv"), "--out",
         os.path.join(root, "out"), "--no-plots"],
        capture_output=True, text=True, env=env, timeout=300)
    require(proc.returncode == 0, f"the analysis CLI failed: {proc.stderr[-3000:]}")
    ds = Table.read_csv(os.path.join(root, "out", "derived_star.csv"))
    dp = Table.read_csv(os.path.join(root, "out", "derived_planet.csv"))
    missing = [m for m in ("pandas", "sklearn", "matplotlib")
               if subprocess.run([sys.executable, "-c", f"import {m}"],
                                 capture_output=True).returncode]
    print(f"[analysis] python -m mcmc_spec_tpu_torch.analysis --no-plots on this machine (not "
          f"importable here: {missing or 'none of pandas, sklearn, matplotlib'}): "
          f"derived_star.csv {len(ds)} rows, derived_planet.csv {len(dp)} rows, finite revised "
          f"radii {bool(np.isfinite(dp['rp']).all())}; {time.perf_counter() - t0:.2f} s")
    require(len(ds) == 3 and len(dp) == 4 and np.isfinite(dp["rp"]).all(),
            "the analysis CLI's tables are not the expected 3 stars and 4 planets")
    walls["(e) analysis"] = time.perf_counter() - t0
    return out


# phase 15: the accuracy tools.  median_tempering_bound at its 4,096 walkers with the
# burn-in cut from 4,000 to 500 steps; the recovery matrix's first fixture with nburn cut
# from 1,000 to 200 and nsteps from 10,000 to 2,000 (the time limit)
ACC_NBURN = 500
RECOVERY_PAIR = (3850, 3025)
RECOVERY_CUT = dict(nburn=200, nsteps=2000)


def accuracy_phase(dev, smi, fit):
    """Phase 15: ``card_validation --shapes-only`` (a hard gate), ``median_tempering_bound``
    (depth cut) and the recovery matrix's first fixture through the pipeline (depth cut),
    in ``fit``'s root, whose grid cache it shares; returns the kernels' launches."""
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import card_validation
    from mcmc_spec_tpu_torch.scripts import median_tempering_bound as mtb
    from mcmc_spec_tpu_torch.scripts import recovery_fixtures as rf
    from mcmc_spec_tpu_torch.scripts import synth_recovery_matrix as sm

    launches, walls = {}, {}
    nonzero = lambda: {k: v for k, v in ck.LAUNCHES.items() if v}

    # (a) the shape sweep of K1, K3, K4 and K5 at the exact dials
    t0 = time.perf_counter()
    rc = card_validation.main(["--shapes-only"], device=str(dev))
    torch.cuda.synchronize()
    launches["shapes"] = nonzero()
    print(f"[card_validation --shapes-only] {smi}: exit {rc}, launches {launches['shapes']}; "
          f"{time.perf_counter() - t0:.2f} s")
    require(rc == 0, "card_validation --shapes-only: a kernel outside the gate")
    want = {"spectrum_chi2": 6, "log_posterior_fused": 6, "spectrum_chi2_fleet": 2,
            "log_posterior_fleet_fused": 2}
    require(launches["shapes"] == want, f"the shape sweep launched {launches['shapes']}, "
            f"expected {want}")
    walls["(a) shapes"] = time.perf_counter() - t0

    # (b) the tempering bound on K1: equilibrium at the exact dials, dL per pass count, rates
    t0 = time.perf_counter()
    out = mtb.main(device=str(dev), nburn=ACC_NBURN)
    torch.cuda.synchronize()
    launches["tempering"] = out["launches"]
    k1 = (1 + 2 * ACC_NBURN + 1 + len(mtb.PASSES)
          + len(mtb.RATE_PASSES) * (1 + 4 * mtb.RATE_STEPS))
    std14 = out["dL"][14]["dL_std"]
    print(f"[median_tempering_bound] {smi}: {mtb.NWALK} walkers, burn-in {ACC_NBURN} (cut from "
          f"{mtb.NBURN}): dL std at k=14 {std14:.4g}, rates (M evals/s) "
          + ", ".join(f"{k}: {r:.2f}" for k, r in out["rate_Mevals"].items())
          + f"; launches {out['launches']} (K1 expected {k1}); {time.perf_counter() - t0:.2f} s")
    require(out["launches"] == {"log_posterior_fused": k1},
            f"median_tempering_bound launched {out['launches']}, expected K1 {k1} only")
    require(all(np.isfinite(r["dL_std"]) for r in out["dL"].values()) and 0 < std14 < 1,
            f"median_tempering_bound: dL std at k=14 {std14} not finite in (0, 1)")
    walls["(b) tempering"] = time.perf_counter() - t0

    # (c) the matrix's first fixture through the two-stage pipeline
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="recovery_", dir=fit["root"])
    os.symlink(os.path.join(fit["root"], ".grid_cache"), os.path.join(work, ".grid_cache"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        ref = rf.write_reference(os.path.join(work, "reference"))
        t1, t2 = RECOVERY_PAIR
        fx = sm.matrix_fixture(0, t1, t2, work, ref, str(dev))
        ck.reset_launches()
        ctx, samples = rf.fit(fx, str(dev), **RECOVERY_CUT)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    launches["recovery"] = nonzero()
    _, sig, z = rf.z_scores(samples, fx.truth)
    k3 = 1 + 50 * ctx.cfg.nstep // RECORD_THIN * RECORD_THIN
    print(f"[synth_recovery_matrix fixture {t1}/{t2}] {smi}: nburn {RECOVERY_CUT['nburn']}, "
          f"nsteps {RECOVERY_CUT['nsteps']} (cut from 1,000 / 10,000): {samples.shape[0]} "
          f"samples, z " + " ".join(f"{lab}={v:+.2f}" for lab, v in zip(sm.LABELS, z))
          + f"; launches {launches['recovery']} (K3 expected {k3}); "
          f"{time.perf_counter() - t0:.2f} s")
    require(np.isfinite(samples).all() and samples.shape[1] == 6 and (sig > 0).all(),
            "the recovery fixture's samples are not finite with 6 columns")
    require(set(launches["recovery"]) == {"spectrum_chi2", "log_posterior_fused"}
            and launches["recovery"]["spectrum_chi2"] == k3,
            f"the recovery fixture launched {launches['recovery']}, expected K3 {k3} and K1")
    walls["(c) recovery fixture"] = time.perf_counter() - t0
    print("[accuracy] " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    total = {}
    for part in launches.values():
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


# phase 16: the attribution tools' kernels and instruments (mcmc_spec_tpu_torch/scripts)
ATTR_NW = 1024  # S13-S15's gate: 1,024 + 5 edge walkers, an odd count
ATTR_LOOP_NW = 8192  # device_loop_time on K1, profile_breakdown's batch
ATTR_LOOP_REP = 50
ATTR_LOOP_TOL = 0.25  # the perturbation and the sum add a few small launches a call
ATTR_STEPS = 4  # op_table over stretch steps: two K1 launches a step
ATTR_ALONE_CALLS = 20  # K1 alone under the profiler, beside device_loop_time
ATTR_TRACE_TRIES = 3  # profiler traces taken while one holds no device op at all
ATTR_KERNELS = (("posterior_ablate", "posterior_ablate.cu", "ablate_fused_sections.py:42"),
                ("fleet_sections", "fleet_sections.cu", "trace_fleet_step.py:126"),
                ("posterior_pair", "posterior_pair.cu", "try_two_blocks.py:36"))


def traced(fn, n):
    """``op_table.trace_calls(fn, n)``, traced again (``ATTR_TRACE_TRIES`` in all) while the
    profiler returns a trace without any device op: a profiler that reported nothing,
    not a count to check (the counts of a trace that holds device ops are checked as
    they are)."""
    from mcmc_spec_tpu_torch.scripts import op_table

    for _ in range(ATTR_TRACE_TRIES):
        tab = op_table.trace_calls(fn, n=n)
        if tab["kernels"]:
            break
    return tab


def attribution_checks(dev, tgt, truth):
    """S13 (every mask and the launch floor) and S15 (an odd walker count) on 1,024 + 5
    bench walkers, S14 (every mode) on the ragged fleet of phase 6 and ``scalar_rank`` on
    the bench target x 3, each at both dial sets against its plain version in the kernel
    gate; S13 ``1111`` and S15 bit for bit K1, S14 ``full`` and ``scalar_rank`` bit for bit
    K4.  Returns the max abs errors at the exact dials."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.inference.fleet import stack_targets
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts.trace_fleet_step import finite_stub

    errs = {name: 0.0 for name, _, _ in ATTR_KERNELS}
    P = torch.cat([init_walker_batch(tgt, truth, ATTR_NW, seed=11), edge_walkers(truth, tgt)])
    fleet, singles, _ = build_fleet(dev)
    PF = torch.stack([torch.cat([init_walker_batch(s, truth, ATTR_NW, seed=12 + i),
                                 edge_walkers(truth, s)]) for i, s in enumerate(singles)])
    frozen = stack_targets([tgt] * 3)
    PZ = torch.stack([torch.cat([init_walker_batch(tgt, truth, ATTR_NW, seed=30 + i),
                                 edge_walkers(truth, tgt)]) for i in range(3)])
    for label, dials in (("exact dials (31, 6, 0)", EXACT), ("production dials (14, 3, 2)", PROD)):
        exact = dials is EXACT
        allowed = 0 if exact else int(PROD_MAX_OUTSIDE_FRAC * P.shape[0])
        t = dataclasses.replace(tgt, **dials)
        k1 = ck.log_posterior_fused(P, t)
        lines = []
        for v in ck.ABLATE_VARIANTS:
            got = ck.posterior_ablate(P, t, v)
            torch.cuda.synchronize()
            outside, rel, err = compare(got, ck.posterior_ablate_reference(P, t, v))
            same = same_bits(got, k1)[0]
            lines.append(f"{v} {outside} out, rel {rel:.2e}, {same} = K1")
            require(outside <= allowed, f"S13 {v} {label}: {outside} walkers outside tolerance")
            require(v != "1111" or same == P.shape[0],
                    f"S13 1111 {label}: {P.shape[0] - same} walkers differ from K1")
            if exact:
                errs["posterior_ablate"] = max(errs["posterior_ablate"], err)
        print(f"[S13 posterior_ablate {label}] {P.shape[0]} walkers (allowed {allowed}), mask "
              "PRSW: " + "; ".join(lines))
        got = ck.posterior_pair(P, t)
        torch.cuda.synchronize()
        outside, rel, err = compare(got, ck.log_posterior_fused_reference(P, t))
        same = same_bits(got, k1)[0]
        print(f"[S15 posterior_pair {label}] {P.shape[0]} walkers: {outside} outside tolerance, "
              f"max rel err {rel:.3e}; {same} bit for bit K1")
        require(outside <= allowed and same == P.shape[0],
                f"S15 {label}: {outside} outside tolerance, {P.shape[0] - same} differ from K1")
        if exact:
            errs["posterior_pair"] = err
        for name, fl, PP, modes in (
                ("the ragged fleet", fleet, PF, ck.FLEET_SECTION_MODES[:-1]),
                ("the bench target x 3", frozen, PZ, ("full", "scalar_rank"))):
            fl = dataclasses.replace(fl, **dials)
            W, av = fleet_wcomb(PP, fl).contiguous(), PP[..., fl.nspec].contiguous()
            k4 = ck.spectrum_chi2_fleet(W, av, fl)
            # no_matmul's stub row is grid point 0's weight: put each walker's largest there
            Ws = {m: finite_stub(W) if m == "no_matmul" else W for m in modes}
            n = PP.shape[0] * PP.shape[1]
            allowed_f = 0 if exact else int(PROD_MAX_OUTSIDE_FRAC * n)
            lines = []
            for m in modes:
                got = ck.fleet_sections(Ws[m], av, fl, m)
                torch.cuda.synchronize()
                outside, rel, err = compare(got.flatten(),
                                            ck.fleet_sections_reference(Ws[m], av, fl, m).flatten())
                same = same_bits(got.flatten(), k4.flatten())[0]
                lines.append(f"{m} {outside} out, rel {rel:.2e}, {same} = K4")
                require(outside <= allowed_f,
                        f"S14 {m} on {name} {label}: {outside} walkers outside tolerance")
                require(m not in ("full", "scalar_rank") or same == n,
                        f"S14 {m} on {name} {label}: {n - same} walkers differ from K4")
                if exact:
                    errs["fleet_sections"] = max(errs["fleet_sections"], err)
            print(f"[S14 fleet_sections {label}] {name}, {n} walkers (allowed {allowed_f}): "
                  + "; ".join(lines))
    return errs


def attribution_phase(dev, smi, tgt, truth):
    """Phase 16: the kernel checks, then the tools' timed run, with its launch counts: S13's
    masks, S15 and K1 at the bench shape (32,768 walkers, production dials), S14's modes
    on a half-step of the fleet cell, ``device_loop_time`` on K1 (within 25 % of K1 alone,
    and a capture refused at the composition's host read), ``op_table`` over stretch
    steps (exactly two K1 launches a step)."""
    from mcmc_spec_tpu_torch.bench_target import init_walker_batch
    from mcmc_spec_tpu_torch.inference import batched
    from mcmc_spec_tpu_torch.inference.fleet import stack_targets
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
    from mcmc_spec_tpu_torch.scripts import op_table
    from mcmc_spec_tpu_torch.scripts.trace_fleet_step import finite_stub
    from mcmc_spec_tpu_torch.utils.profiling import CaptureError, device_loop_time

    walls = {}
    t0 = time.perf_counter()
    errs = attribution_checks(dev, tgt, truth)
    walls["checks"] = time.perf_counter() - t0

    prod = dataclasses.replace(tgt, **PROD)
    coords = init_walker_batch(prod, truth, NWALK_BENCH)
    fleet, singles, _ = build_fleet(dev)
    fleet = dataclasses.replace(fleet, **PROD)
    half = torch.stack([init_walker_batch(s, truth, NW_FLEET // 2, seed=1 + i)
                        for i, s in enumerate(singles)])
    Wh, avh = fleet_wcomb(half, fleet).contiguous(), half[..., fleet.nspec].contiguous()
    frozen = dataclasses.replace(stack_targets([tgt] * NTGT), **PROD)
    halfz = torch.stack([init_walker_batch(tgt, truth, NW_FLEET // 2, seed=40 + i)
                         for i in range(NTGT)])
    Wz, avz = fleet_wcomb(halfz, frozen).contiguous(), halfz[..., frozen.nspec].contiguous()
    P8 = coords[:ATTR_LOOP_NW].contiguous()
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    s13 = {v: cuda_ms(lambda v=v: ck.posterior_ablate(coords, prod, v)) for v in ck.ABLATE_VARIANTS}
    k1_ms = cuda_ms(lambda: ck.log_posterior_fused(coords, prod))
    s15 = cuda_ms(lambda: ck.posterior_pair(coords, prod))
    Whs = {m: finite_stub(Wh) if m == "no_matmul" else Wh for m in ck.FLEET_SECTION_MODES[:-1]}
    s14 = {m: cuda_ms(lambda m=m: ck.fleet_sections(Whs[m], avh, fleet, m))
           for m in ck.FLEET_SECTION_MODES[:-1]}
    s14z = {m: cuda_ms(lambda m=m: ck.fleet_sections(Wz, avz, frozen, m))
            for m in ("full", "scalar_rank")}
    loop_ms = 1e3 * device_loop_time(lambda q: ck.log_posterior_fused(q, prod), P8,
                                     rep=ATTR_LOOP_REP)
    alone_tab = traced(lambda: ck.log_posterior_fused(P8, prod), ATTR_ALONE_CALLS)
    n_alone = op_table.launches(alone_tab, "log_posterior_fused_kernel")
    alone = (op_table.device_ms(alone_tab, "log_posterior_fused_kernel") / n_alone
             if n_alone else None)
    refused = None
    comp = dataclasses.replace(prod, spectrum_backend="xla")
    try:
        device_loop_time(lambda q: batched.log_posterior_batch(q, comp), P8, rep=2)
    except CaptureError as e:
        refused = str(e)
    logp = lambda q: batched.log_posterior_batch(q, prod)
    state = [init_ensemble(P8, logp, torch.Generator(device=dev).manual_seed(0))]

    def steps():
        state[0] = run_ensemble(state[0], logp, n_steps=ATTR_STEPS, thin=ATTR_STEPS)[0]

    tab = traced(steps, 1)
    torch.cuda.synchronize()
    launches = {name: ck.LAUNCHES[name] for name, _, _ in ATTR_KERNELS}
    walls["timed run"] = time.perf_counter() - t0
    k1_steps = op_table.launches(tab, "log_posterior_fused_kernel")

    print(f"[S13 posterior_ablate] {smi}: {NWALK_BENCH} walkers, production dials, ms by mask "
          "PRSW: " + ", ".join(f"{v} {ms:.4f}" for v, ms in s13.items())
          + f"; K1 {k1_ms:.4f} ms")
    print(f"[S15 posterior_pair] {NWALK_BENCH} walkers: {s15:.4f} ms (K1 {k1_ms:.4f} ms)")
    print(f"[S14 fleet_sections] one half-step of the fleet cell, {NTGT} x {NW_FLEET // 2} "
          "walkers, production dials, ms: " + ", ".join(f"{m} {ms:.4f}" for m, ms in s14.items())
          + f"; on the bench target x {NTGT}: full {s14z['full']:.4f}, scalar_rank "
          f"{s14z['scalar_rank']:.4f}")
    print(f"[device_loop_time] K1 on {ATTR_LOOP_NW} walkers, {ATTR_LOOP_REP} calls in one CUDA "
          f"graph: {loop_ms:.4f} ms a call; K1 alone under torch.profiler {fmt_ms(alone)}")
    print(f"[device_loop_time] the composition's capture: "
          f"{'refused: ' + refused if refused else 'captured (expected a refusal)'}")
    op_table.print_table(tab, f"op_table, {ATTR_STEPS} stretch steps of {ATTR_LOOP_NW} walkers",
                         top=6, per=ATTR_STEPS)
    print(f"[attribution] {smi}: launches {launches}; op_table counts {k1_steps} K1 launches "
          f"(expected {2 * ATTR_STEPS}); wall times (s) "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    require(alone is not None and abs(loop_ms / alone - 1.0) <= ATTR_LOOP_TOL,
            f"device_loop_time {loop_ms:.4f} ms not within {ATTR_LOOP_TOL:.0%} of K1 alone "
            f"{fmt_ms(alone)}")
    require(refused is not None and "batched.py" in refused,
            f"device_loop_time did not refuse the composition's host read: {refused}")
    require(k1_steps == 2 * ATTR_STEPS,
            f"op_table counted {k1_steps} K1 launches over {ATTR_STEPS} steps")
    for name, _, _ in ATTR_KERNELS:
        require(launches[name] > 0, f"{name} was not launched in the tools' timed run")

    # the report's numbers: S13 and S15 at the bench shape (K1's bound), S14 on the half-step
    nd = prod.D.shape[2]
    Wcomb = batched._forward_small(coords, prod)[4]
    k1_bound = bound(nbytes(coords, *ck.kernel_tables(prod).values()) + 4 * NWALK_BENCH,
                     spectrum_ops(Wcomb, coords[:, prod.nspec], nd, PROD["median_iters"])
                     + posterior_scalar_ops(NWALK_BENCH, prod))
    tabs = ck.fleet_kernel_tables(fleet)
    k4_bound = bound(nbytes(Wh, avh, *(tabs[k] for k in ("D", "kd", "data", "inv_err", "VpinvT",
                                                         "VT", "scal", "ranks")))
                     + 4 * Wh.shape[0] * Wh.shape[1],
                     spectrum_ops(Wh, avh, nd, PROD["median_iters"]))
    times = {
        "posterior_ablate": (s13["1111"], cuda_ms(
            lambda: ck.posterior_ablate_reference(coords, prod, "1111"), reps=3)),
        "fleet_sections": (s14["full"], cuda_ms(
            lambda: ck.fleet_sections_reference(Wh, avh, fleet, "full"), reps=3)),
        "posterior_pair": (s15, cuda_ms(lambda: ck.log_posterior_fused_reference(coords, prod),
                                        reps=3)),
    }
    bounds = {"posterior_ablate": k1_bound, "fleet_sections": k4_bound, "posterior_pair": k1_bound}
    for name, (ms, plain_ms) in times.items():
        print(f"[time {name}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bounds[name][0]:.5f} ms ({bounds[name][1]})")
    return {"errs": errs, "times": times, "bounds": bounds, "launches": launches,
            "s13": s13, "s14": s14, "loop_ms": loop_ms, "alone_ms": alone}


# phase 17: the kernel build cache, one arm of scripts/compile_cache_micro.py in a child process
CACHE_BUDGET_S = 15


def cache_phase(smi):
    """Phase 17: a child process with ``MCMC_SPEC_COMPILE_CACHE`` set to this run's build
    directory by its path loads the library that phase 2 built, without nvcc, and holds
    one K1 launch against its plain version at the production dials."""
    from mcmc_spec_tpu_torch.runtime import cuda_build
    from mcmc_spec_tpu_torch.scripts import compile_cache_micro as micro

    lib = cuda_build.library_path()
    require(lib.exists(), f"phase 2's library {lib} is missing")
    try:
        rec = micro.run_arm("cache", lib.parent, forbid_nvcc=True)
    except RuntimeError as e:  # the child failed: nvcc asked for, or K1 not launched
        raise PhaseError(f"phase 17's child: {e}") from None
    print(f"[cache] {smi}: MCMC_SPEC_COMPILE_CACHE={lib.parent}: the child found {lib.name} "
          f"(loaded in {rec['library_s']:.3f} s, no nvcc), K1 on {rec['walkers']} walkers at "
          f"nd = {micro.ND}: {rec['outside']} outside the gate (max rel {rec['max_rel_err']}); "
          f"child wall {rec['wall_s']:.3f} s (budget {CACHE_BUDGET_S} s)")
    require(rec["lib"] == str(lib) and rec["built"] is False,
            f"the child did not load phase 2's library: {rec['lib']}, built {rec['built']}")
    require(rec["launches"] == 1, f"the child launched K1 {rec['launches']} times, not once")
    require(micro.in_gate(rec), f"the child's K1 left its gate: {rec['outside']} walkers outside")
    return rec


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
    fit_root = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        pipe = timed("pipeline", pipeline_phase, dev, smi, fit_root)
        fpipe = timed("fleet pipeline", fleet_pipeline_phase, dev, smi)
        shard = timed("sharding", sharding_phase, dev, smi, pipe["fit"])
        mesh = timed("fleet mesh and host modules", fleet_mesh_phase, dev, smi, pipe["fit"])
        acc = timed("accuracy", accuracy_phase, dev, smi, pipe["fit"])
    finally:
        shutil.rmtree(fit_root, ignore_errors=True)
    attr = timed("attribution", attribution_phase, dev, smi, tgt, truth)
    timed("cache", cache_phase, smi)
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
    print(f"[summary] pipeline (CLI, koi2298 widths): stage 2 {pipe['rates'][0]:.1f} evals/s "
          f"in the pipeline, {pipe['rates'][1]:.1f} evals/s alone; whole CLI "
          f"{pipe['walls']['cli']:.2f} s; fleet pipeline ({NTGT} targets): stage 2 "
          f"{fpipe['rates'][0]:.1f} evals/s in the pipeline, {fpipe['rates'][1]:.1f} alone; "
          f"whole CLI {fpipe['walls']['cli']:.2f} s")
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
    # K7d, the spectral-sharded lane's median: a round and the refinement on a rank's share
    # of 1,024 rows x nd = 65,536 split 2 ways (4 ways beside it), launches in phase 13's CLI
    for part, _ in K7D_PARTS:
        ms, _, plain_ms, b = shard["times"][2][part]
        rows.append((part, "median_rounds.cu",
                     f"mcmc_spec_tpu/ops/spec_segmented.py:{K7D_REPLACES[part]}",
                     shard["cli"]["launches"][part], shard["errs"][part], ms, plain_ms, b,
                     None))
    # the cost-attribution experiments, scripts/
    for name, src, where in (("fma_chains", "microbench.cu", "vpu_microbench.py:74"),
                             ("median_only", "microbench.cu", "vpu_microbench.py:97"),
                             ("spectrum_recip", "spectrum_recip.cu", "try_fast_recip.py:105")):
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
    # the attribution tools' kernels, scripts/ (phase 16)
    for name, src, where in ATTR_KERNELS:
        rows.append((name, src, f"scripts/{where}", attr["launches"][name], attr["errs"][name],
                     *attr["times"][name], attr["bounds"][name], None))
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
    # K1's and K3's launches in the pipeline phase (the CLI run), beside the fit phase's
    for r in report:
        if r["name"] in ("log_posterior_fused", "spectrum_chi2"):
            r["launches_pipeline"] = pipe["launches"][r["name"]]
    # K3's and K4's launches in the fleet pipeline (phase 12's CLI run), K5's in its resume pair
    for r in report:
        if r["name"] in ("spectrum_chi2", "spectrum_chi2_fleet"):
            r["launches_fleet_pipeline"] = fpipe["launches"][r["name"]]
        if r["name"] == "log_posterior_fleet_fused":
            r["launches_fleet_pipeline"] = fpipe["resume_launches"][r["name"]]
        if r["name"] in fpipe["errs"]:  # at the fleet pipeline's own inputs, exact dials
            r["max_abs_err_fleet_pipeline"] = fpipe["errs"][r["name"]]
    # K7d's times alone on the device and at the 4-way split, beside the 2-way `ms`
    for r in report:
        if r["name"] in shard["times"][2]:
            r.update({"ms_alone": shard["times"][2][r["name"]][1],
                      "ms_4way": shard["times"][4][r["name"]][0],
                      "ms_alone_4way": shard["times"][4][r["name"]][1],
                      "bound_ms_4way": shard["times"][4][r["name"]][3][0]})
    # phase 14: K4's and K5's launches on rank 0 of the 1x4 world and K5's in the 2x2
    # run_fleet_mcmc; K1's in the sampler facade, K1's and K3's in fit_synthetic_binary
    for r in report:
        for route, kernel in MESH_ROUTES:
            if r["name"] == kernel:
                r["launches_fleet_mesh"] = mesh["launches"][(1, 4, route)]
        if r["name"] == "log_posterior_fleet_fused":
            r["launches_fleet_mesh_pipeline"] = \
                mesh["pipeline"]["mesh"]["launches"]["log_posterior_fleet_fused"]
        if r["name"] == "log_posterior_fused":
            r["launches_sampler"] = mesh["host"]["sampler"]["log_posterior_fused"]
        if r["name"] in ("log_posterior_fused", "spectrum_chi2"):
            r["launches_example"] = mesh["host"]["fit_example"][r["name"]]
        # phase 15: the shape sweep, the tempering bound and the recovery fixture
        if r["name"] in acc:
            r["launches_accuracy"] = acc[r["name"]]
        # phase 10: the section variants of ablate_fused_sections, checked and run on S13
        if r["name"] == "posterior_ablate":
            r["launches_experiments"] = eres["launches"][r["name"]]
            r["max_abs_err_experiments"] = eres["errs"][r["name"]]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:  # a rank of phase 13's torchrun
        cli_rank(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
