"""emcee-style sampler facade over the ensemble (port of ``mcmc_spec_tpu.inference.sampler_api``).

The reference drives ``emcee.EnsembleSampler(nwalkers, ndim, logposterior,
threads=nwalkers)`` (``mft6.py:1491``).  This class offers the familiar
surface (``run_mcmc``, ``sample`` iteration, ``get_chain``,
``get_autocorr_time``, ``acceptance_fraction``, ``get_last_sample``,
``reset``) over the batched stretch-move ensemble (``inference.stretch``), on
``device``: the card unless the caller asks for the CPU.  A fit target's
batched posterior on the card is the fused-posterior kernel (K1).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mcmc_spec_tpu_torch.inference.autocorr import integrated_time
from mcmc_spec_tpu_torch.inference.stretch import EnsembleState, init_ensemble, run_ensemble


class EnsembleSampler:
    """Drop-in-feeling ensemble sampler (chains kept on the host, state on the device).

    Args:
        nwalkers, ndim: ensemble shape.
        log_prob_fn: batched log-probability ``[n, ndim] -> [n]`` of torch tensors
            (``lambda b: log_posterior_batch(b, target)`` for a fit target).
        a: stretch parameter (Goodman & Weare 2010), default 2.
        seed: seed of the ``torch.Generator`` on ``device``; a new initial state
            starts from it again, as JAX's key does.
        device: where the ensemble lives (``"cuda"`` unless asked otherwise).
        dtype: the walkers' dtype (float32: the fit target's on the card).
    """

    def __init__(self, nwalkers: int, ndim: int, log_prob_fn: Callable, a: float = 2.0,
                 seed: int = 0, device="cuda", dtype=torch.float32):
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.log_prob_fn = log_prob_fn
        self.a = float(a)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self._state: Optional[EnsembleState] = None
        self._chain_blocks = []
        self._logp_blocks = []
        self._n_steps = 0

    # ------------------------------------------------------------- emcee API
    def run_mcmc(self, initial_state, nsteps: int, thin_by: int = 1, progress=False):
        """Advance the ensemble ``nsteps`` steps (storing every ``thin_by``-th)."""
        if initial_state is not None:
            coords = torch.as_tensor(np.asarray(initial_state), dtype=self.dtype,
                                     device=self.device)
            if tuple(coords.shape) != (self.nwalkers, self.ndim):
                raise ValueError(f"initial state must be [{self.nwalkers}, {self.ndim}]")
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self._state = init_ensemble(coords, self.log_prob_fn, gen)
        elif self._state is None:
            raise ValueError("no initial state")
        self._state, chain, logps = run_ensemble(
            self._state, self.log_prob_fn, n_steps=nsteps, thin=thin_by, a=self.a)
        self._chain_blocks.append(chain.cpu().numpy())
        self._logp_blocks.append(logps.cpu().numpy())
        self._n_steps += nsteps
        return self.get_last_sample()

    def sample(self, initial_state, iterations: int, thin_by: int = 1, block: int = 100):
        """Generator over states every ``block`` steps (for dump/convergence loops)."""
        state = initial_state
        done = 0
        while done < iterations:
            n = min(block, iterations - done)
            self.run_mcmc(state if done == 0 else None, n, thin_by=thin_by)
            state = None
            done += n
            yield self.get_last_sample()

    def get_chain(self, flat: bool = False, discard: int = 0, thin: int = 1):
        if not self._chain_blocks:
            chain = np.zeros((0, self.nwalkers, self.ndim))
        else:
            chain = np.concatenate(self._chain_blocks, axis=0)[discard::thin]
        if flat:
            return chain.reshape(-1, self.ndim)
        return chain

    def get_log_prob(self, flat: bool = False):
        if not self._logp_blocks:
            lp = np.zeros((0, self.nwalkers))
        else:
            lp = np.concatenate(self._logp_blocks, axis=0)
        return lp.reshape(-1) if flat else lp

    def get_last_sample(self):
        return self._state.coords.cpu().numpy()

    def get_autocorr_time(self, quiet: bool = True, c: float = 5.0):
        taus = integrated_time(self.get_chain(), c=c)
        if not quiet and np.any(taus * 50 > self._n_steps):
            raise RuntimeError("chain is shorter than 50 autocorrelation times")
        return taus

    @property
    def acceptance_fraction(self):
        """Mean acceptance fraction (scalar; emcee returns per-walker)."""
        af = float(self._state.n_accept) / (self.nwalkers * max(self._n_steps, 1))
        return np.full(self.nwalkers, af)

    @property
    def chain(self):
        """[nwalkers, nsteps, ndim] (emcee's legacy layout)."""
        return np.swapaxes(self.get_chain(), 0, 1)

    def reset(self):
        self._chain_blocks = []
        self._logp_blocks = []
        self._n_steps = 0
        if self._state is not None:
            self._state.n_accept = torch.zeros_like(self._state.n_accept)
