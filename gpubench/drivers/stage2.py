"""Stage 2 of one target: ``run_ensemble`` over ``log_posterior_batch``, a chunk of
``chunk`` steps emitting only its last state (``thin = chunk``).  The sampler calls the
benchmark's callable (``packing.Evaluation``), which keeps the last batch it evaluated."""
from __future__ import annotations

import torch

from gpubench.drivers.packing import Evaluation, pack


class Stage2:
    def __init__(self, cell, cfg, inputs, device):
        from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
        from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble

        (inp, _), = inputs["targets"]
        self.tgt = pack(inp, device)
        self.log_prob = Evaluation(log_posterior_batch, self.tgt)
        self._run = run_ensemble
        gen = torch.Generator(device=device).manual_seed(inputs["sampler_seed"])
        self.state = init_ensemble(inputs["walkers"][0], self.log_prob, gen)
        self.steps_per_chunk, self.a = cell["chunk"], cfg["stretch_a"]
        nw = self.state.coords.shape[0]
        self.evals_per_chunk = self.steps_per_chunk * nw
        self.half_batch = nw // 2
        self.chunk_state = self.chunk_start = None
        self.layout = "single"

    def chunk(self):
        self.chunk_state = self.state.generator.get_state()
        self.chunk_start = self.state.coords
        self.log_prob.last = None
        self.state, _, _ = self._run(self.state, self.log_prob, self.steps_per_chunk,
                                     thin=self.steps_per_chunk, a=self.a)

    def final(self):
        return self.state.coords[None], self.state.log_prob[None]

    def last_eval(self):
        """The last chunk's last evaluation: its proposals and log-posteriors, [1, m, ndim]
        and [1, m]; None where the chunk evaluated nothing."""
        if self.log_prob.last is None:
            return None
        x, out = self.log_prob.last
        return x[None], out[None]


def build(cell, cfg, inputs, device):
    return Stage2(cell, cfg, inputs, device)
