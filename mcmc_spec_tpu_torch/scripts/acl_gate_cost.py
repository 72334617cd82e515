"""Cost of the autocorrelation gate: geometric against per-chunk cadence (counterpart of ``scripts/acl_gate_cost.py``).

The pipeline's stage 2 runs the emcee estimator ``integrated_time`` over the
chain kept so far.  Re-running it after every chunk costs O(n^2) over a run;
the pipeline gates on a geometrically growing interval instead
(``pipeline.next_acl_gate``, ``ACL_GATE_GROWTH``).  This measures both
cadences over a config-5-scale sub-chain: 150 chunks of [100, 256, 6], the
gate's accumulator (``pipeline.ACL_MAX_WALKERS`` walkers, not the whole
4,096-walker chain), seed 0, as the JAX script.  It is host numpy (FFTs on
the CPU): no card takes part.  Run it on a quiet host:

    python -m mcmc_spec_tpu_torch.scripts.acl_gate_cost
"""
from __future__ import annotations

import time

import numpy as np

from mcmc_spec_tpu_torch.inference.autocorr import integrated_time
from mcmc_spec_tpu_torch.pipeline import next_acl_gate
from mcmc_spec_tpu_torch.scripts.timing import describe_host


def run(chunks, gated):
    """(seconds in the estimator, gates run) over ``chunks``, gated or every chunk."""
    acl_kept, next_gate, t_total, n_gates = [], 1, 0.0, 0
    for n, c in enumerate(chunks):
        acl_kept.append(c)
        if gated and n + 1 < next_gate:
            continue
        t0 = time.perf_counter()
        integrated_time(np.concatenate(acl_kept, axis=0))
        t_total += time.perf_counter() - t0
        n_gates += 1
        next_gate = next_acl_gate(n + 1)
    return t_total, n_gates


def main(n_chunks=150, shape=(100, 256, 6)):
    print(describe_host(), flush=True)
    rng = np.random.RandomState(0)
    chunks = [rng.randn(*shape).astype(np.float32) for _ in range(n_chunks)]
    t_geo, g_geo = run(chunks, gated=True)
    print(f"geometric gating:  {g_geo} gates, {t_geo:.3f} s total", flush=True)
    t_every, g_every = run(chunks, gated=False)
    print(f"per-chunk gating:  {g_every} gates, {t_every:.3f} s total "
          f"({t_every / t_geo:.2f}x more)", flush=True)
    return (t_geo, g_geo), (t_every, g_every)


if __name__ == "__main__":
    main()
