"""Stage 2 of a fleet of targets: ``run_fleet_ensemble`` over the stacked, padded
fleet, a chunk of ``chunk`` steps emitting only its last state (``thin = chunk``).  The
route (the composed default, or the fused kernel under ``MCMC_SPEC_FUSED_EVAL=1``) is
the cell's ``env``.  The fleet's sampler calls the module's ``log_posterior_fleet`` by
name, so the driver puts the benchmark's ``packing.Evaluation`` around it there, which
keeps the last batch it evaluated."""
from __future__ import annotations

import torch

from gpubench.drivers.packing import Evaluation, pack


class Fleet:
    def __init__(self, cell, cfg, inputs, device):
        from mcmc_spec_tpu_torch.inference import fleet

        targets = [inp for inp, _ in inputs["targets"]]
        pad_nd = max(len(t["data_flux"]) for t in targets)
        pad_nc = max(len(t["cmag"]) for t in targets)
        self.fleet = fleet.stack_targets([pack(t, device, pad_nd, pad_nc) for t in targets])
        fn = fleet.log_posterior_fleet
        self.evaluation = Evaluation(fn.fn if isinstance(fn, Evaluation) else fn)
        fleet.log_posterior_fleet = self.evaluation
        self._run = fleet.run_fleet_ensemble
        gen = torch.Generator(device=device).manual_seed(inputs["sampler_seed"])
        self.state = fleet.init_fleet_ensemble(inputs["walkers"], self.fleet, gen)
        self.steps_per_chunk, self.a = cell["chunk"], cfg["stretch_a"]
        ntgt, nw, _ = self.state.coords.shape
        self.evals_per_chunk = self.steps_per_chunk * ntgt * nw
        self.half_batch = ntgt * (nw // 2)
        self.chunk_state = self.chunk_start = None
        self.layout = "fleet"

    def chunk(self):
        self.chunk_state = self.state.generator.get_state()
        self.chunk_start = self.state.coords
        self.evaluation.last = None
        self.state, _, _ = self._run(self.state, self.fleet, self.steps_per_chunk,
                                     thin=self.steps_per_chunk, a=self.a)

    def final(self):
        return self.state.coords, self.state.log_prob

    def last_eval(self):
        """The last chunk's last evaluation: its proposals and log-posteriors, [ntgt, m,
        ndim] and [ntgt, m]; None where the chunk evaluated nothing."""
        return self.evaluation.last


def build(cell, cfg, inputs, device):
    return Fleet(cell, cfg, inputs, device)
