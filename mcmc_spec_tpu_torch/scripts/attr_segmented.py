"""Stage attribution of the large-nd segmented lane (counterpart of
``scripts/attr_segmented.py``).

The lane's composition K10 (``ops/spec_segmented.spectrum_chi2_segmented``) runs
K6 (the model with extinction), K7 (the k-ary median), K8 (the renorm partials)
and K9 (the chi^2 residual).  At 1,024 walkers on the bench target at nd =
65,536 (``grid_step`` 8, the JAX ``largend`` cell), at the production (14, 3, 2)
and the exact (31, 6, 0) dials, it times the composition prefix by prefix (K6,
+K7, +K8, +K9 = the whole composition) and each stage alone on a model made
beforehand, each as CUDA events (20 calls, the best of three means) and alone on
the device (the summed device time of a call's ops in a ``torch.profiler``
trace of 20 calls), so each stage's marginal cost is on record both ways.

    python -m mcmc_spec_tpu_torch.scripts.attr_segmented
"""
from __future__ import annotations

import dataclasses
import json

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference.batched import _forward_small
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.ops import spec_segmented as seg
from mcmc_spec_tpu_torch.scripts import op_table
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

B = 1024
ND = 65536
N_CALLS = 20
DIAL_SETS = (("production", dict(median_iters=14, matmul_passes=3, recip_newton=2)),
             ("exact", dict(median_iters=31, matmul_passes=6, recip_newton=0)))
STAGES = ("K6", "+K7", "+K8", "+K9")


def lane_calls(tgt, P):
    """({prefix: fn}, {stage alone on a premade model: fn}) of the lane on walkers ``P``."""
    iters, mm, recip = ck.resolve_dials(tgt)
    nT, nG, nd = tgt.D.shape
    Wcomb = _forward_small(P, tgt)[4].contiguous()
    av = P[:, tgt.nspec].contiguous()
    D_flat = tgt.D.reshape(nT * nG, nd)
    kd, data, err, V, Vpinv = tgt.ext_k_data, tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv
    n_true, med_data = tgt.n_data_true, tgt.med_data

    def k6():
        return seg.model_extinct(Wcomb, av, D_flat, kd)

    def k7(model=None):
        model = k6() if model is None else model
        return model, seg.median_nonneg(model, n_true, iters)

    def k8(model=None):
        model, med = k7(model)
        scale = torch.as_tensor(med_data, device=model.device).to(torch.float32) / med
        return model, scale, seg.renorm_partials(model, scale, data, Vpinv, recip)

    def k9():
        return seg.spectrum_chi2_segmented(Wcomb, av, D_flat, kd, data, err, V, Vpinv, med_data,
                                           n_true, iters=iters, mm_passes=mm, recip=recip)

    model = k6()
    _, scale, coeffs = k8(model)
    prefixes = {"K6": k6, "+K7": k7, "+K8": k8, "+K9": k9}
    alone = {"K6": k6,
             "K7": lambda: seg.median_nonneg(model, n_true, iters),
             "K8": lambda: seg.renorm_partials(model, scale, data, Vpinv, recip),
             "K9": lambda: seg.resid_chi2(model, scale, coeffs, data, err, V, recip)}
    return prefixes, alone


def time_both(fn, time_fn):
    """(CUDA-event ms, device ms alone or None) of one call of ``fn``."""
    ms = time_fn(fn) * 1e3
    tab = op_table.trace_calls(fn, n=N_CALLS)
    return ms, (tab["device_ms"] / N_CALLS if tab["kernels"] else None)


def main(device="cuda", nwalk=B, nd=ND, grid_step=8.0):
    dev = resolve_device(device)
    time_fn = timer(dev)
    tgt0, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step)
    P = init_walker_batch(tgt0, truth, nwalk)
    nT, nG, _ = tgt0.D.shape
    print(f"[env] {describe(dev)}; nd={nd} NW={nwalk} NO={nT * nG} model bytes="
          f"{nwalk * nd * 4 / 1e6:.0f} MB", flush=True)
    out = {}
    for label, dials in DIAL_SETS:
        tgt = dataclasses.replace(tgt0, **dials)
        prefixes, alone = lane_calls(tgt, P)
        rows = {}
        for name, fn in prefixes.items():
            rows[name] = time_both(fn, time_fn)
        for name, fn in alone.items():
            rows[f"{name} alone"] = time_both(fn, time_fn)
        prev = (0.0, 0.0)
        for name in STAGES:
            ms, dev_ms = rows[name]
            print(json.dumps({"dials": label, "prefix": name, "ms_per_call": round(ms, 4),
                              "marginal_ms": round(ms - prev[0], 4),
                              "device_ms": None if dev_ms is None else round(dev_ms, 4),
                              "marginal_device_ms":
                              None if dev_ms is None else round(dev_ms - prev[1], 4)}),
                  flush=True)
            prev = (ms, dev_ms or 0.0)
        for name in ("K6", "K7", "K8", "K9"):
            ms, dev_ms = rows[f"{name} alone"]
            print(json.dumps({"dials": label, "stage_alone": name, "ms_per_call": round(ms, 4),
                              "device_ms": None if dev_ms is None else round(dev_ms, 4)}),
                  flush=True)
        acct = sum(rows[f"{n} alone"][0] for n in ("K6", "K7", "K8", "K9"))
        print(f"[{label}] sum of the stages alone {acct:.4f} ms vs the composition "
              f"{rows['+K9'][0]:.4f} ms (CUDA events)", flush=True)
        out[label] = rows
    return out


if __name__ == "__main__":
    main()
