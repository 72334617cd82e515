"""The stretch move (Goodman & Weare 2010, emcee's red-black scheme) as the
configuration states it, for judging an update of the program's ensemble.

The ensemble's first half proposes against the second, then the second against the
updated first; a walker x with partner y proposes y + z (x - y), z drawn from
g(z) ~ 1/sqrt(z) on [1/a, a], and accepts when log u < (ndim - 1) log z + L(new) -
L(x).  Each chunk of ``thin`` steps takes its draws at once from the chain's
``torch.Generator``: uniforms for z, the partners' indices, then uniforms for u
(``draws``), or for a fleet per target, the two halves' partners apart
(``fleet_draws``).  Given the generator's state at the start of the chunk, the same
calls give the same numbers.
"""
from __future__ import annotations

import torch


def stretch_z(u, a):
    return ((a - 1.0) * u + 1.0) ** 2 / a


def generator_at(state, device):
    """A generator on ``device`` in the state ``state``."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def draws(gen, thin: int, nh: int, a: float):
    """(z, partner, log_u), each [thin, 2, nh], of one chunk of a single ensemble."""
    device = gen.device
    shape = (thin, 2, nh)
    z = stretch_z(torch.rand(shape, generator=gen, device=device, dtype=torch.float32), a)
    idx = torch.randint(0, nh, shape, generator=gen, device=device)
    log_u = torch.log(torch.rand(shape, generator=gen, device=device, dtype=torch.float32))
    return z, idx, log_u


def fleet_draws(gen, thin: int, ntgt: int, nw: int, a: float):
    """One chunk of a fleet: z and log_u [thin, 2, ntgt, nw - nw//2], the first half's
    partners [thin, ntgt, nw//2] and the second's [thin, ntgt, nw - nw//2]."""
    device = gen.device
    nh = nw // 2
    shape = (thin, 2, ntgt, nw - nh)
    z = stretch_z(torch.rand(shape, generator=gen, device=device, dtype=torch.float32), a)
    idx0 = torch.randint(0, nw - nh, (thin, ntgt, nh), generator=gen, device=device)
    idx1 = torch.randint(0, nh, (thin, ntgt, nw - nh), generator=gen, device=device)
    log_u = torch.log(torch.rand(shape, generator=gen, device=device, dtype=torch.float32))
    return z, (idx0, idx1), log_u


def update_mismatch(first, second, proposal, z, idx, log_u, log_prob):
    """Walkers of the second half whose update in the chunk's last half-step differs
    from the stretch move's ([m1] bool).

    ``first`` [m0, ndim] is the first half after its last update, ``second`` [m1, ndim]
    the second half after its own, ``proposal`` [m1, ndim] the program's proposals of that
    half-step, ``z``, ``idx``, ``log_u`` [m1] its draws.  A walker accepted when it sits at
    its proposal, and rejected when its proposal is ``y + z (x - y)`` from where it sits
    (y its partner; the same floating-point operations give the same bits); a walker that
    is neither differs.  Otherwise the reference decides again from its own
    log-posteriors at the proposal and at the start of the move (for an accepted walker
    ``y + (x' - y) / z``) and a walker differs where the decisions do.
    """
    partner = first[idx]
    accepted = (second == proposal).all(dim=1)
    stayed = (partner + z[:, None] * (second - partner) == proposal).all(dim=1)
    start = torch.where(accepted[:, None], partner + (proposal - partner) / z[:, None], second)
    logz = (second.shape[1] - 1) * torch.log(z)
    decide = log_u < logz + log_prob(proposal) - log_prob(start)
    return ~(accepted | stayed) | (accepted != decide)


def _update(cur, lp_cur, other, z, idx, log_u, log_prob):
    partners = torch.take_along_dim(other, idx[..., None], dim=-2)
    proposal = partners + z[..., None] * (cur - partners)
    lp_new = log_prob(proposal)
    accept = log_u < (cur.shape[-1] - 1) * torch.log(z) + lp_new - lp_cur
    return torch.where(accept[..., None], proposal, cur), torch.where(accept, lp_new, lp_cur)


def run_chunk(coords, lp, gen, thin: int, a: float, log_prob, layout: str):
    """``thin`` stretch steps of ``coords`` [ntgt, nw, ndim] (log-posteriors ``lp``
    [ntgt, nw]) with the draws of the generator ``gen``; ``log_prob`` maps [ntgt, m,
    ndim] to [ntgt, m].  ``layout`` ``single`` (ntgt = 1) or ``fleet``."""
    ntgt, nw, _ = coords.shape
    nh = nw // 2
    if layout == "single":
        z, idx, log_u = draws(gen, thin, nh, a)
        halves = [((z[s, 0][None], idx[s, 0][None], log_u[s, 0][None]),
                   (z[s, 1][None], idx[s, 1][None], log_u[s, 1][None])) for s in range(thin)]
    else:
        z, (idx0, idx1), log_u = fleet_draws(gen, thin, ntgt, nw, a)
        halves = [((z[s, 0, :, :nh], idx0[s], log_u[s, 0, :, :nh]),
                   (z[s, 1], idx1[s], log_u[s, 1])) for s in range(thin)]
    c0, c1, lp0, lp1 = coords[:, :nh], coords[:, nh:], lp[:, :nh], lp[:, nh:]
    for first, second in halves:
        c0, lp0 = _update(c0, lp0, c1, *first, log_prob)
        c1, lp1 = _update(c1, lp1, c0, *second, log_prob)
    return torch.cat([c0, c1], dim=1), torch.cat([lp0, lp1], dim=1)

