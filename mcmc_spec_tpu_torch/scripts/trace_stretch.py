"""A device trace of the bench stretch loop, printed as its op table (counterpart of
``scripts/trace_stretch.py``).

The bench target at the production dials, 8,192 walkers: 64 steps of
``run_ensemble`` to warm up, then 64 traced steps.  The table splits K1 (two
launches a step, one a half-step) from the sampler's small launches (the
proposals, the acceptance and the bookkeeping), with the busy share of the
window and the longest idle gaps with the host op in each.

    python -m mcmc_spec_tpu_torch.scripts.trace_stretch
"""
from __future__ import annotations

import torch

from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu_torch.scripts import ablate_matrix as am
from mcmc_spec_tpu_torch.scripts import op_table
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device

NWALK = 8192
N_STEPS = 64
K1 = "log_posterior_fused_kernel"


def main(device="cuda", nwalk=NWALK, nd=am.ND, grid_step=1.0, n_steps=N_STEPS):
    dev = resolve_device(device)
    print(f"[env] {describe(dev)}", flush=True)
    tgt, coords = am.prepare(dev, nwalk, nd, grid_step)
    logp = lambda batch: log_posterior_batch(batch, tgt)
    state = init_ensemble(coords, logp, torch.Generator(device=dev).manual_seed(0))
    holder = [state]

    def steps():
        holder[0] = run_ensemble(holder[0], logp, n_steps=n_steps, thin=n_steps)[0]

    tab = op_table.trace_calls(steps, n=1)
    op_table.print_table(tab, f"stretch loop, {nwalk} walkers, {n_steps} steps", top=40,
                         per=n_steps)
    k1 = op_table.launches(tab, K1)
    other = sum(k["launches"] for k in tab["kernels"]) - k1
    k1_ms = op_table.device_ms(tab, K1)
    print(f"a step: K1 {k1 / n_steps:.1f} launches, {k1_ms / n_steps:.4f} ms device; the other "
          f"ops {other / n_steps:.1f} launches, {(tab['device_ms'] - k1_ms) / n_steps:.4f} ms "
          f"device; window {tab['window_ms'] / n_steps:.4f} ms, busy "
          f"{100 * tab['busy_share']:.1f} %", flush=True)
    return {"table": tab, "k1_launches": k1, "other_launches": other}


if __name__ == "__main__":
    main()
