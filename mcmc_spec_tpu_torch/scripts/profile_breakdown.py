"""One 8,192-walker evaluation split into its pieces, each timed without its dispatch
(counterpart of ``scripts/profile_breakdown.py``).

Each piece is timed with ``utils.profiling.device_loop_time`` (its ``rep``
calls captured in one CUDA graph and replayed): the log-posterior through the
dispatch (K1), the composition's pieces (``log_prior_batch``,
``_forward_small``, the composition's spectrum chi^2 and the whole composed
log-posterior, the target's ``spectrum_backend`` set to ``"xla"``), K3 on
precomputed blend weights, the model product alone (``torch.matmul`` in full
float32), and a whole stretch step.  A piece that cannot be captured (an op in
it synchronises with the host, or draws from a generator the graph does not
know) is reported by the op that blocks the capture, not by a time.  The
stretch step is also timed as the JAX script times it: 128 steps of
``run_ensemble`` by the host clock, the card synchronised.

    python -m mcmc_spec_tpu_torch.scripts.profile_breakdown [nwalk]
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from mcmc_spec_tpu_torch.inference import batched
from mcmc_spec_tpu_torch.inference.stretch import EnsembleState, init_ensemble, run_ensemble
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck
from mcmc_spec_tpu_torch.scripts import ablate_matrix as am
from mcmc_spec_tpu_torch.scripts.timing import describe, resolve_device
from mcmc_spec_tpu_torch.utils.profiling import CaptureError, device_loop_time

NWALK = 8192
REP = 30
N_STEPS = 128


def main(device="cuda", nwalk=NWALK, nd=am.ND, grid_step=1.0, rep=REP, n_steps=N_STEPS):
    dev = resolve_device(device)
    tgt, p = am.prepare(dev, nwalk, nd, grid_step)
    nT, nG, nd = tgt.D.shape
    print(f"[env] {describe(dev)}; nwalk={nwalk} NO={nT * nG} nd={nd}", flush=True)
    rows, blocked = {}, {}

    def t(name, fn, *args):
        try:
            dt = device_loop_time(fn, *args, rep=rep)
        except CaptureError as e:
            blocked[name] = str(e)
            print(f"{name:28s} not captured: {e}", flush=True)
            return
        rows[name] = dt * 1e3
        print(f"{name:28s} {dt * 1e3:8.4f} ms", flush=True)

    comp = dataclasses.replace(tgt, spectrum_backend="xla")
    t("log_posterior_batch (K1)", lambda q: batched.log_posterior_batch(q, tgt), p)
    t("log_prior_batch", lambda q: batched.log_prior_batch(q, tgt), p)
    t("forward_small", lambda q: batched._forward_small(q, tgt)[0], p)
    _, _, _, _, Wcomb = batched._forward_small(p, tgt)
    av = p[:, tgt.nspec].contiguous()
    D_flat = tgt.D.reshape(nT * nG, nd)
    it, mm, rn = ck.resolve_dials(tgt)
    # the extinctions go first: a perturbed blend weight would no longer be zero, and the
    # kernel's row build would take every grid point
    t("spectrum_chi2 (K3)", lambda a: ck.spectrum_chi2(
        Wcomb, a, D_flat, tgt.ext_k_data, tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv,
        tgt.med_data, iters=it, mm_passes=mm, recip=rn), av)
    t("composition spectrum chi2", lambda a: batched._spec_chi2_xla(Wcomb, a, comp), av)
    t("composed log_posterior", lambda q: batched.log_posterior_batch(q, comp), p)
    t("matmul_only_f32", lambda W: torch.matmul(W, D_flat), Wcomb)

    logp = lambda q: batched.log_posterior_batch(q, tgt)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_ensemble(p, logp, gen)
    t("stretch_step", lambda q: run_ensemble(
        EnsembleState(q, state.log_prob, gen, state.n_accept), logp, 1)[0].coords, p)

    state = run_ensemble(state, logp, n_steps=n_steps, thin=n_steps)[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state = run_ensemble(state, logp, n_steps=n_steps, thin=n_steps)[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    per_step = (time.perf_counter() - t0) / n_steps
    rows["stretch_step (host clock)"] = per_step * 1e3
    print(f"{'stretch_step (host clock)':28s} {per_step * 1e3:8.4f} ms "
          f"({nwalk / per_step / 1e6:.2f}M evals/s)", flush=True)
    print(json.dumps({"ms": rows, "not_captured": blocked}))
    return {"ms": rows, "not_captured": blocked}


if __name__ == "__main__":
    main(nwalk=int(sys.argv[1]) if len(sys.argv) > 1 else NWALK)
