"""The large-nd lane's kernels of this checkout against another checkout's, on the card.

    python -m mcmc_spec_tpu_torch.scripts.lane_against_checkout <other checkout> [kernel]

``kernel`` is one of ``KERNELS``: ``model_extinct`` (K6), ``renorm_partials`` (K8),
``resid_chi2`` (K9 with renorm, stage 2's evaluation) or ``resid_chi2_raw`` (K9
without renorm, the annealer's scoring); all four where it is left out.  The other
checkout is, for example, the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists.

The script makes the inputs once, on the bench target at nd = 65,536
(``grid_step`` 8) with 1,024 walkers around the truth, and saves them: K6's (the
blend weights ``Wcomb``, ``av``, ``D`` and ``kd``, as ``log_posterior_batch`` forms them) and K8's and K9's (the model, the scale
``med_data / median`` at the production median dial, the data rows and K8's
coefficients), each from this checkout's plain versions, so that no kernel of
either side shapes the other's inputs.  Then it runs a child process in each
checkout, in turns (other, this, this, other): each builds its own kernels with
its own ``runtime.cuda_build``, loads the inputs, calls its own wrappers at both
shapes (all 1,024 walkers, and the first 171: the fit's stage-2 half-step) at the
production reciprocal dial, times each with CUDA events (the median of 20 calls
after 3) and alone on the device (the call's kernels under ``torch.profiler``, the
mean of 20 calls: without the wrapper's host time, which the events also see) and
saves the outputs, in a directory of the build that the script removes at the end.
It prints each time and, per kernel and shape, the least of each side's two times
and their ratio, as events and alone.  K6's outputs are compared bit
for bit (rows the same); K8's and K9's, which a redesign may sum in another order,
by the kernel gate (a walker is outside where its finiteness differs or |this -
other| > 1e-4 max|other| + 5e-5 |other|): the count outside and the largest
relative difference.  On the CPU (``main(other, device="cpu", ...)``) both
checkouts run the plain versions, the times are the host clock's and none is
taken alone.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference.batched import _forward_small
from mcmc_spec_tpu_torch.ops import spec_segmented as seg
from mcmc_spec_tpu_torch.runtime import cuda_build
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NW, ND = 1024, 65536  # the JAX largend cell's evaluation batch and width
NW_STAGE2 = 171  # the larger half-step of the fit's stage 2 (341 walkers)
ITERS, RECIP = 14, 2  # the production median and reciprocal dials
KERNELS = ("model_extinct", "renorm_partials", "resid_chi2", "resid_chi2_raw")
RTOL = 5e-5  # the kernel gate (chip_smoke.compare)
HERE = Path(__file__).resolve().parents[2]

# run in a checkout's root: its own package, its own build.  argv: inputs, outputs,
# device, the kernels (comma-separated), the walker counts (comma-separated)
_CHILD = """
import json, statistics, sys, time
import torch
from mcmc_spec_tpu_torch.ops import spec_segmented as seg
dev = torch.device(sys.argv[3])
x = {k: v.to(dev) for k, v in torch.load(sys.argv[1]).items()}
recip = int(x["recip"])
def calls(n):
    m, sc = x["model"][:n].contiguous(), x["scale"][:n].contiguous()
    c = x["coeffs"][:n].contiguous()
    W, av = x["Wcomb"][:n].contiguous(), x["av"][:n].contiguous()
    return {
        "model_extinct": lambda: seg.model_extinct(W, av, x["D"], x["kd"]),
        "renorm_partials": lambda: seg.renorm_partials(m, sc, x["data"], x["Vpinv"], recip),
        "resid_chi2": lambda: seg.resid_chi2(m, sc, c, x["data"], x["err"], x["V"], recip, True),
        "resid_chi2_raw": lambda: seg.resid_chi2(m, sc, None, x["data"], x["err"], x["V"], recip,
                                                 False),
    }
def ms(fn):
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        return a.elapsed_time(b)
    t0 = time.perf_counter(); fn()
    return 1e3 * (time.perf_counter() - t0)
def alone(fn):
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(us(e) for e in ev) * 1e-3 / 20 if ev else None
outs, times, alones = {}, {}, {}
for n in map(int, sys.argv[5].split(",")):
    fns = calls(n)
    for k in sys.argv[4].split(","):
        outs[f"{k} {n}"] = fns[k]().cpu()
        t = [ms(fns[k]) for _ in range(23)][3:]
        times[f"{k} {n}"] = statistics.median(t)
        alones[f"{k} {n}"] = alone(fns[k])
torch.save(outs, sys.argv[2])
print(json.dumps({"events": times, "alone": alones}))
"""


def lane_inputs(dev, nw=NW, nd=ND) -> dict:
    """K6-K9's inputs for ``nw`` walkers on the bench target at ``nd`` points, from the
    plain versions (K8's and K9's at the production dials)."""
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=8.0)
    P = init_walker_batch(tgt, truth, nw)
    nT, nG, _ = tgt.D.shape
    W, av = _forward_small(P, tgt)[4], P[:, tgt.nspec].contiguous()
    D = tgt.D.reshape(nT * nG, nd)
    model = seg.model_extinct_reference(W, av, D, tgt.ext_k_data)
    med = seg.median_nonneg_reference(model, tgt.n_data_true, ITERS)
    scale = tgt.med_data.to(torch.float32) / med
    coeffs = seg.renorm_partials_reference(model, scale, tgt.data_flux, tgt.Vpinv, RECIP)
    return {"Wcomb": W, "av": av, "D": D, "kd": tgt.ext_k_data, "model": model,
            "scale": scale, "coeffs": coeffs, "data": tgt.data_flux, "err": tgt.data_err,
            "V": tgt.V, "Vpinv": tgt.Vpinv, "recip": torch.tensor(RECIP)}


def gate(a, b) -> tuple:
    """(walkers outside the kernel gate, largest relative difference) of ``a`` against
    ``b``, [walkers] or [walkers, k]."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    fin = torch.isfinite(a) & torch.isfinite(b)
    mag = torch.where(fin, b.abs(), torch.zeros_like(b))
    diff = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
    bad = (torch.isfinite(a) != torch.isfinite(b)) | (diff > 1e-4 * mag.max() + RTOL * mag)
    return int(bad.any(dim=1).sum()), float((diff / mag.clamp(min=1e-30)).max())


def run_child(checkout: Path, inputs: Path, out: Path, dev, kernels, shapes) -> dict:
    """{"events": {"<kernel> <walkers>": median ms}, "alone": {the same: device ms, None
    off the card}} in ``checkout`` on the saved inputs; the outputs go to ``out``."""
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(inputs), str(out), str(dev),
                           ",".join(kernels), ",".join(map(str, shapes))],
                          cwd=checkout, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"the lane in {checkout} failed:\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(other, kernel=None, device="cuda", nw=NW, nd=ND, nw_stage2=NW_STAGE2):
    dev = resolve_device(device)
    kernels = KERNELS if kernel is None else (kernel,)
    if not set(kernels) <= set(KERNELS):
        raise ValueError(f"kernel {kernel!r} is not one of {KERNELS}")
    shapes = (nw, nw_stage2)
    other = Path(other).resolve()
    print(f"[env] {describe(dev)}", flush=True)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="lane_against_checkout.", dir=cuda_build.BUILD_DIR))
    try:
        inputs = work / "inputs.pt"
        torch.save({k: v.cpu() for k, v in lane_inputs(dev, nw, nd).items()}, inputs)
        outs = {"this": work / "this.pt", "other": work / "other.pt"}
        where = {"this": HERE, "other": other}
        times = {"this": [], "other": []}
        for side in ("other", "this", "this", "other"):
            times[side].append(run_child(where[side], inputs, outs[side], dev, kernels, shapes))
            alone = times[side][-1]["alone"]
            print(f"[time] {side} ({where[side]}): "
                  + ", ".join(f"{k} {v:.4f} ms" + ("" if alone[k] is None
                                                    else f" (alone {alone[k]:.4f})")
                              for k, v in times[side][-1]["events"].items()), flush=True)
        a, b = torch.load(outs["this"]), torch.load(outs["other"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res = {}
    for key in a:
        side = lambda s, kind: [t[kind][key] for t in times[s]]
        t_this, t_other = side("this", "events"), side("other", "events")
        r = {"this_ms": t_this, "other_ms": t_other, "speedup": min(t_other) / min(t_this),
             "this_alone_ms": side("this", "alone"), "other_alone_ms": side("other", "alone")}
        head = (f"[{key} walkers x nd={nd}] this {min(t_this):.4f} ms, other "
                f"{min(t_other):.4f} ms (least of two in turns), {r['speedup']:.2f}x; ")
        if None not in r["this_alone_ms"] + r["other_alone_ms"]:
            a_this, a_other = min(r["this_alone_ms"]), min(r["other_alone_ms"])
            r["speedup_alone"] = a_other / a_this
            head += (f"alone this {a_this:.4f} ms, other {a_other:.4f} ms, "
                     f"{r['speedup_alone']:.2f}x; ")
        if key.startswith("model_extinct"):
            same = (a[key].view(torch.int32) == b[key].view(torch.int32)).all(dim=1)
            r.update(rows_same=int(same.sum()), rows=a[key].shape[0])
            print(head + f"{r['rows_same']} of {r['rows']} rows bit-identical to the other "
                  "checkout's", flush=True)
        else:
            r["outside"], r["max_rel_diff"] = gate(a[key], b[key])
            print(head + f"{r['outside']} of {a[key].shape[0]} walkers outside the kernel gate "
                  f"of the other checkout's, largest relative difference "
                  f"{r['max_rel_diff']:.3e}", flush=True)
        res[key] = r
    return res


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit("usage: python -m mcmc_spec_tpu_torch.scripts.lane_against_checkout "
                 f"<checkout> [{'|'.join(KERNELS)}]")
    main(sys.argv[1], *sys.argv[2:])
