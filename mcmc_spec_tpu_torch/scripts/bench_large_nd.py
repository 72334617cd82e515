"""The large-nd spectrum paths side by side (counterpart of ``scripts/bench_large_nd.py``).

At 1,024 walkers on the bench target at nd = 65,536 and 131,072 (``grid_step``
8), each timed with CUDA events over 20 calls (the best of three means; the
composed route 5 calls, 2 above nd = 131,072):

1. the segmented lane: ``log_posterior_batch``, whose dispatch takes K6-K9 for a
   CUDA float32 target wider than ``LARGE_ND`` (on the CPU the composition);
2. the composed route: the target's ``spectrum_backend`` set to ``"xla"``, whose
   median is a ``torch.sort`` of the model (``inference/batched.py:127``); an
   out-of-memory is reported as JAX reports it and the other rows are kept;
3. ``parallel/spec_shard.make_spec_logpost`` on a 1x1 mesh of one rank, in a
   process group of one (NCCL on the card, gloo on the CPU): the sharding's
   structure without a second card.

Then the parity lines: the lane against the composed route and the 1x1 mesh
against the lane, as the largest relative difference over the finite walkers.

    python -m mcmc_spec_tpu_torch.scripts.bench_large_nd [nd ...]
"""
from __future__ import annotations

import dataclasses
import json
import sys

import torch
import torch.distributed as dist

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.parallel.mesh import free_port, make_mesh
from mcmc_spec_tpu_torch.parallel.spec_shard import make_spec_logpost, shard_target_over_spec
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device, timer

B = 1024
NDS = (65536, 131072)


def max_rel(a, b):
    """The largest |a - b| / max(|b|, 1e-6) over the walkers finite in both."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return float("nan")
    a, b = a[fin].double(), b[fin].double()
    return float(((a - b).abs() / b.abs().clamp(min=1e-6)).max())


def one_rank_group(dev) -> bool:
    """Initialise a process group of one rank unless one exists; True if it made one."""
    if dist.is_initialized():
        return False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    return True


def main(device="cuda", nwalk=B, nds=NDS, grid_step=8.0):
    dev = resolve_device(device)
    time_fn = timer(dev)
    print(f"[env] {describe(dev)}; {nwalk} walkers", flush=True)
    made = one_rank_group(dev)
    out = {}
    try:
        mesh = make_mesh(1, 1, device=dev)
        for nd in nds:
            tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd, grid_step=grid_step)
            coords = init_walker_batch(tgt, truth, nwalk)
            rows = {}
            k6 = ck.LAUNCHES["model_extinct"]
            a = log_posterior_batch(coords, tgt)
            lane = "K6-K9" if ck.LAUNCHES["model_extinct"] > k6 else "the plain composition"
            rows["segmented"] = time_fn(lambda: log_posterior_batch(coords, tgt))
            rel = float("nan")
            try:
                tgt_x = dataclasses.replace(tgt, spectrum_backend="xla")
                reps = 5 if nd <= 131072 else 2
                rows["xla"] = time_fn(lambda: log_posterior_batch(coords, tgt_x), n=reps,
                                      warmup=1, reps=1)
                rel = max_rel(a, log_posterior_batch(coords, tgt_x))
            except torch.cuda.OutOfMemoryError as e:  # the sort's temporaries: keep the rows
                print(json.dumps({"metric": "largend_xla_failed", "nd": nd,
                                  "error": str(e)[:200]}), flush=True)
                torch.cuda.empty_cache()
            tgt_sp = shard_target_over_spec(tgt, mesh)
            fsp = make_spec_logpost(tgt_sp, mesh)
            rows["sp_S1"] = time_fn(lambda: fsp(coords))
            rel_sp = max_rel(fsp(coords), a)
            for name, dt in rows.items():
                print(json.dumps({"metric": f"largend_{name}", "nd": nd, "walkers": nwalk,
                                  "ms_per_eval_batch": round(dt * 1e3, 4),
                                  "evals_per_sec": round(nwalk / dt, 1)}), flush=True)
            print(json.dumps({"metric": "largend_parity", "nd": nd, "lane": lane,
                              "seg_vs_xla_rel": rel, "sp1_vs_seg_rel": rel_sp}), flush=True)
            out[nd] = {"ms": {k: v * 1e3 for k, v in rows.items()}, "lane": lane,
                       "seg_vs_xla_rel": rel, "sp1_vs_seg_rel": rel_sp}
    finally:
        if made:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main(nds=tuple(int(a) for a in sys.argv[1:]) or NDS)
