"""K6 of this checkout against K6 of another checkout, on the card: bits and times.

    python -m mcmc_spec_tpu_torch.scripts.k6_against_checkout <other checkout>

The other checkout is, for example, the parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists.  The script makes the
large-nd lane's K6 inputs once (the bench target at nd = 65,536, ``grid_step``
8, 1,024 walkers around the truth: the blend weights ``Wcomb``, ``av``, ``D``
and ``kd``, as ``log_posterior_batch`` forms them) and saves them beside the
build.  Then it runs a child process in each checkout, in turns (other, this,
this, other): each builds its own kernels with its own ``runtime.cuda_build``,
loads the same inputs, calls its ``spec_segmented.model_extinct``, times it
with CUDA events (the median of 20 calls after 3) and saves its output.  It
prints each time, whether the two outputs are the same bit for bit, and, where
they are not, how many rows differ, the first differing element and the
largest difference.  On the CPU (``main(other, device="cpu", ...)``) both
checkouts run the plain version and the times are the host clock's.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference.batched import _forward_small
from mcmc_spec_tpu_torch.runtime import cuda_build
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NW, ND = 1024, 65536  # the JAX largend cell's evaluation batch and width
HERE = Path(__file__).resolve().parents[2]

# run in a checkout's root: its own package, its own build
_CHILD = """
import json, statistics, sys
import torch
from mcmc_spec_tpu_torch.ops import spec_segmented as seg
dev = torch.device(sys.argv[3])
W, av, D, kd = (x.to(dev) for x in torch.load(sys.argv[1]))
fn = lambda: seg.model_extinct(W, av, D, kd)
out = fn()
times = []
for i in range(23):
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); ms = a.elapsed_time(b)
    else:
        import time
        t0 = time.perf_counter(); fn(); ms = 1e3 * (time.perf_counter() - t0)
    if i >= 3:
        times.append(ms)
torch.save(out.cpu(), sys.argv[2])
print(json.dumps({"ms": statistics.median(times)}))
"""


def k6_inputs(dev, nw=NW, nd=ND):
    """(Wcomb, av, D, kd) of ``nw`` walkers on the bench target at ``nd`` points."""
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=8.0)
    P = init_walker_batch(tgt, truth, nw)
    nT, nG, _ = tgt.D.shape
    return (_forward_small(P, tgt)[4], P[:, tgt.nspec].contiguous(), tgt.D.reshape(nT * nG, nd),
            tgt.ext_k_data)


def run_child(checkout: Path, inputs: Path, out: Path, dev) -> float:
    """K6's median ms in ``checkout`` on the saved inputs; its output goes to ``out``."""
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(inputs), str(out), str(dev)],
                          cwd=checkout, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"K6 in {checkout} failed:\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["ms"]


def main(other, device="cuda", nw=NW, nd=ND):
    dev = resolve_device(device)
    other = Path(other).resolve()
    print(f"[env] {describe(dev)}", flush=True)
    work = cuda_build.BUILD_DIR / "k6_against_checkout"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "inputs.pt"
    torch.save([x.cpu() for x in k6_inputs(dev, nw, nd)], inputs)
    outs = {"this": work / "this.pt", "other": work / "other.pt"}
    where = {"this": HERE, "other": other}
    times = {"this": [], "other": []}
    for side in ("other", "this", "this", "other"):
        times[side].append(run_child(where[side], inputs, outs[side], dev))
        print(f"[time] {side} ({where[side]}): {times[side][-1]:.4f} ms", flush=True)
    a, b = torch.load(outs["this"]), torch.load(outs["other"])
    same_rows = (a.view(torch.int32) == b.view(torch.int32)).all(dim=1)
    res = {"this_ms": times["this"], "other_ms": times["other"],
           "rows_same": int(same_rows.sum()), "rows": a.shape[0]}
    print(f"[K6] {nw} walkers x nd={nd}: {res['rows_same']} of {res['rows']} rows bit-identical "
          f"to the other checkout's; this {min(times['this']):.4f} ms, other "
          f"{min(times['other']):.4f} ms (least of two in turns), "
          f"{min(times['other']) / min(times['this']):.2f}x", flush=True)
    if res["rows_same"] < res["rows"]:
        diff = a.view(torch.int32) != b.view(torch.int32)
        w, j = (int(i) for i in diff.nonzero()[0])
        res["max_abs_diff"] = float((a - b).abs().nan_to_num(nan=0.0).max())
        print(f"[K6] first difference at walker {w}, point {j}: {float(a[w, j])!r} here, "
              f"{float(b[w, j])!r} there; {int(diff.sum())} elements differ, max abs "
              f"difference {res['max_abs_diff']:.3e}", flush=True)
    return res


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m mcmc_spec_tpu_torch.scripts.k6_against_checkout <checkout>")
    main(sys.argv[1])
