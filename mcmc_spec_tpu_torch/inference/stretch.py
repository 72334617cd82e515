"""Affine-invariant ensemble MCMC (Goodman & Weare stretch move).

Port of ``mcmc_spec_tpu.inference.stretch``.  The ensemble is updated
red-black: the first half proposes against the current second half, then the
second half against the updated first half (emcee's scheme).  The two halves
are carried as separate tensors, and the stretch / partner / acceptance draws
for each emitted chunk of ``thin`` steps are made at once by ``_draw_chunk``
from one ``torch.Generator``.  So at a fixed ``thin`` a run is invariant to
how it is split across calls: ``run(40) == run(20) + run(20)``.

The JAX version runs the whole chain in one ``lax.scan``; here the steps are
a Python loop of launches on the walker batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class EnsembleState:
    coords: torch.Tensor  # [nw, ndim]
    log_prob: torch.Tensor  # [nw]
    generator: torch.Generator
    n_accept: torch.Tensor  # [] total accepted moves (int64, on the walkers' device)


def _stretch_z(u, a):
    """g(z) ~ 1/sqrt(z) on [1/a, a] from uniforms: z = ((a-1)u + 1)^2 / a."""
    return ((a - 1.0) * u + 1.0) ** 2 / a


def _draw_chunk(gen, thin, nh, a, dtype, device):
    """(z, partner_idx, log_u), each [thin, 2, nh]: one chunk's draws."""
    shape = (thin, 2, nh)
    z = _stretch_z(torch.rand(shape, generator=gen, device=device, dtype=dtype), a)
    partner_idx = torch.randint(0, nh, shape, generator=gen, device=device)
    log_u = torch.log(torch.rand(shape, generator=gen, device=device, dtype=dtype))
    return z, partner_idx, log_u


def _draw_half(gen, m, n_comp, a, dtype, device):
    """(z, partner_idx, log_u), each [m]: one half-step's draws (odd ensembles)."""
    z = _stretch_z(torch.rand(m, generator=gen, device=device, dtype=dtype), a)
    partner_idx = torch.randint(0, n_comp, (m,), generator=gen, device=device)
    log_u = torch.log(torch.rand(m, generator=gen, device=device, dtype=dtype))
    return z, partner_idx, log_u


def _propose_accept(cur, lp_cur, other, z, idx, log_u, log_prob_fn):
    """One half's stretch proposal and accept/reject; returns (cur, lp, n_accepted).

    ``cur`` [..., m, ndim] proposes against the partners ``other[..., idx, :]``;
    ``z``, ``idx`` and ``log_u`` are [..., m].  A leading axis, such as the
    fleet's target axis, is carried through.
    """
    ndim = cur.shape[-1]
    partners = torch.take_along_dim(other, idx[..., None], dim=-2)
    proposal = partners + z[..., None] * (cur - partners)
    logp_new = log_prob_fn(proposal)
    accept = log_u < (ndim - 1) * torch.log(z) + logp_new - lp_cur
    cur = torch.where(accept[..., None], proposal, cur)
    lp_cur = torch.where(accept, logp_new, lp_cur)
    return cur, lp_cur, accept.sum()


def init_ensemble(coords, log_prob_fn: Callable, generator: torch.Generator) -> EnsembleState:
    """Initialise the ensemble; ``log_prob_fn`` maps [n, ndim] -> [n]."""
    coords = torch.as_tensor(coords)
    return EnsembleState(coords, log_prob_fn(coords), generator,
                         torch.zeros((), dtype=torch.int64, device=coords.device))


def run_ensemble(state: EnsembleState, log_prob_fn: Callable, n_steps: int, thin: int = 1,
                 a: float = 2.0):
    """Run ``n_steps`` stretch moves.

    Returns ``(final_state, chain [n_steps//thin, nw, ndim], logps [n_steps//thin, nw])``;
    with ``thin > 1`` only every ``thin``-th state is emitted.
    """
    nw, ndim = state.coords.shape
    if nw % 2:
        return _run_ensemble_generic(state, log_prob_fn, n_steps, thin, a)
    nh = nw // 2
    gen, dev = state.generator, state.coords.device
    c0, c1 = state.coords[:nh], state.coords[nh:]
    lp0, lp1 = state.log_prob[:nh], state.log_prob[nh:]
    n_acc = state.n_accept
    chain, logps = [], []
    for _ in range(n_steps // thin):
        z, idx, log_u = _draw_chunk(gen, thin, nh, a, c0.dtype, dev)
        for s in range(thin):
            c0, lp0, k0 = _propose_accept(c0, lp0, c1, z[s, 0], idx[s, 0], log_u[s, 0], log_prob_fn)
            c1, lp1, k1 = _propose_accept(c1, lp1, c0, z[s, 1], idx[s, 1], log_u[s, 1], log_prob_fn)
            n_acc = n_acc + k0 + k1
        chain.append(torch.cat([c0, c1]))
        logps.append(torch.cat([lp0, lp1]))
    state = EnsembleState(torch.cat([c0, c1]), torch.cat([lp0, lp1]), gen, n_acc)
    return state, _stack(chain, (0, nw, ndim), c0), _stack(logps, (0, nw), lp0)


def _stack(items, empty_shape, like):
    if items:
        return torch.stack(items)
    return torch.empty(empty_shape, dtype=like.dtype, device=like.device)


def _run_ensemble_generic(state, log_prob_fn, n_steps, thin, a):
    """Per-half-step path for odd walker counts (halves of nw//2 and nw - nw//2)."""
    nw, ndim = state.coords.shape
    nh = nw // 2
    gen, dev = state.generator, state.coords.device
    coords, logp, n_acc = state.coords, state.log_prob, state.n_accept
    chain, logps = [], []
    for _ in range(n_steps // thin):
        for _ in range(thin):
            for sl, co in ((slice(0, nh), slice(nh, nw)), (slice(nh, nw), slice(0, nh))):
                cur, other = coords[sl], coords[co]
                z, idx, log_u = _draw_half(gen, cur.shape[0], other.shape[0], a, coords.dtype, dev)
                new, new_lp, k = _propose_accept(cur, logp[sl], other, z, idx, log_u, log_prob_fn)
                coords, logp = coords.clone(), logp.clone()
                coords[sl], logp[sl] = new, new_lp
                n_acc = n_acc + k
        chain.append(coords)
        logps.append(logp)
    state = EnsembleState(coords, logp, gen, n_acc)
    return state, _stack(chain, (0, nw, ndim), coords), _stack(logps, (0, nw), logp)


def acceptance_fraction(state: EnsembleState, n_steps: int) -> torch.Tensor:
    nw = state.coords.shape[0]
    return state.n_accept / (nw * max(n_steps, 1))
