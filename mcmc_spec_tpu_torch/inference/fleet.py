"""Fleet mode: many targets x many walkers in one program (port of ``mcmc_spec_tpu.inference.fleet``).

Targets are ragged (different data lengths, contrast-filter counts), so each
is packed with ``pad_nd``/``pad_nc`` to the fleet maxima (padded entries are
inert by construction) and the per-target tensors are stacked on a leading
axis (``stack_targets``).  Where JAX ``vmap``s the batched posterior over
that axis, the port loops over per-target views of the stacked fleet
(``target.target_views``), except on the card, where the fleet kernels run
all targets in one launch:

* ``MCMC_SPEC_FUSED_EVAL=1`` with contrast and photometry blocks: the fused
  fleet posterior (K5, ``ops.cuda_kernels.log_posterior_fleet_fused``);
* a spectrum term on CUDA float32: the blend weights per target, the fleet
  spectrum chi^2 (K4) over all targets in one launch, then the rest of the
  batched posterior per target;
* otherwise the per-target composition.

The fleet kernels hold a target's model row in a block's shared memory, so on
the card a fleet whose rows do not fit raises before any launch
(``_require_row_fits``); single-target fits of such targets take the
segmented large-nd lane.

``run_fleet_ensemble`` stretch-moves every target's ensemble at once; its
stretch, partner and acceptance draws are made per emitted chunk from the
state's ``torch.Generator``, so ``run(40) == run(20) + run(20)`` at a fixed
``thin``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from mcmc_spec_tpu_torch.inference import batched
from mcmc_spec_tpu_torch.inference.stretch import (
    EnsembleState,
    _propose_accept,
    _stack,
    _stretch_z,
)
from mcmc_spec_tpu_torch.inference.target import (
    DATA_FIELDS,
    META_FIELDS,
    PackedTarget,
    common_dtype,
    target_views,
)
from mcmc_spec_tpu_torch.ops import cuda_kernels
from mcmc_spec_tpu_torch.ops.spec_segmented import LARGE_ND
from mcmc_spec_tpu_torch.utils import flags


def stack_targets(targets: Sequence[PackedTarget]) -> PackedTarget:
    """Stack identically-shaped targets on a new leading axis.

    All targets must share their configuration, pack-time dials, shapes,
    dtype and device (pack them with matching ``pad_nd``/``pad_nc``); a
    mismatch raises, as JAX's ``tree.map`` over them would.  The fleet takes
    the composition's spectrum backend (``"xla"``) whatever its members had.
    """
    t0 = targets[0]
    for i, t in enumerate(targets[1:], start=1):
        for name in META_FIELDS:
            if name != "spectrum_backend" and getattr(t, name) != getattr(t0, name):
                raise ValueError(f"mixed fleet configs: target {i} has {name}="
                                 f"{getattr(t, name)!r}, target 0 {getattr(t0, name)!r}")
        for name in DATA_FIELDS:
            a, b = getattr(t, name), getattr(t0, name)
            if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
                raise ValueError(
                    f"mixed fleet shapes: target {i} has {name} {tuple(a.shape)} {a.dtype} on "
                    f"{a.device}, target 0 {tuple(b.shape)} {b.dtype} on {b.device}")
    return dataclasses.replace(
        t0, spectrum_backend="xla",
        **{name: torch.stack([getattr(t, name) for t in targets]) for name in DATA_FIELDS})


def _require_row_fits(fleet: PackedTarget, fused: bool) -> None:
    """Raise unless a fleet kernel's row fits a block's shared memory: both run one
    warp per walker, which holds its row and its compact list, and for K5 also its 1 +
    nspec rows of weights (``cuda_kernels.warp_max_nd``)."""
    nT, nG, nd = fleet.D.shape[-3:]
    max_nd = cuda_kernels.warp_max_nd(nT * nG, 1 + fleet.nspec if fused else 0)
    if nd > max_nd:
        kernel = "log_posterior_fleet_fused (K5)" if fused else "spectrum_chi2_fleet (K4)"
        raise ValueError(
            f"fleet nd={nd} is too wide for {kernel}: its row holds at most nd={max_nd} "
            f"points in {cuda_kernels.ROW_SMEM_BYTES} bytes of shared memory per block; "
            f"fit these targets one at a time instead, where nd > {LARGE_ND} takes the "
            "segmented large-nd lane")


def log_posterior_fleet(params, fleet: PackedTarget):
    """[ntgt, nw, ndim] -> [ntgt, nw] log posteriors (dispatch in the module docstring)."""
    params, fleet = common_dtype(params, fleet)
    on_card = batched._on_cuda_f32(params)
    if flags.fused_eval_forced() and fleet.n_contrast > 0 and fleet.n_phot > 0:
        if on_card:
            _require_row_fits(fleet, fused=True)
        return cuda_kernels.log_posterior_fleet_fused(params, fleet)
    views = target_views(fleet)
    if fleet.spectrum_weight != 0.0 and on_card:
        _require_row_fits(fleet, fused=False)
        Wcomb = torch.stack([batched._forward_small(p, t)[4] for p, t in zip(params, views)])
        chi_spec = cuda_kernels.spectrum_chi2_fleet(Wcomb, params[..., fleet.nspec], fleet)
        return torch.stack([batched.log_posterior_batch(p, t, chi_spec=cs)
                            for p, t, cs in zip(params, views, chi_spec)])
    return torch.stack([batched.log_posterior_batch(p, t) for p, t in zip(params, views)])


def optimizer_chi2_fleet(params, fleet: PackedTarget):
    """[ntgt, nw, ndim] -> [ntgt, nw] stage-1 chi^2, target by target."""
    params, fleet = common_dtype(params, fleet)
    return torch.stack([batched.optimizer_chi2_batch(p, t)
                        for p, t in zip(params, target_views(fleet))])


def init_fleet_ensemble(coords, fleet: PackedTarget, generator: torch.Generator) -> EnsembleState:
    """coords [ntgt, nw, ndim] -> an ``EnsembleState`` with a leading target axis."""
    coords = torch.as_tensor(coords)
    return EnsembleState(coords, log_posterior_fleet(coords, fleet), generator,
                         torch.zeros((), dtype=torch.int64, device=coords.device))


def _draw_fleet_chunk(gen, thin, ntgt, nw, a, dtype, device):
    """One emitted chunk's draws: (z, log_u) each [thin, 2, ntgt, nw - nw//2],
    and the partner indices of each half, [thin, ntgt, nw//2] into the
    second half and [thin, ntgt, nw - nw//2] into the first.  Half 0 uses the
    first nw//2 columns of z and log_u."""
    nh = nw // 2
    shape = (thin, 2, ntgt, nw - nh)
    z = _stretch_z(torch.rand(shape, generator=gen, device=device, dtype=dtype), a)
    idx0 = torch.randint(0, nw - nh, (thin, ntgt, nh), generator=gen, device=device)
    idx1 = torch.randint(0, nh, (thin, ntgt, nw - nh), generator=gen, device=device)
    log_u = torch.log(torch.rand(shape, generator=gen, device=device, dtype=dtype))
    return z, (idx0, idx1), log_u


def _fleet_half_update(cur, lp_cur, other, z, partner_idx, log_u, fleet):
    """One half's stretch move for every target: returns (cur, lp_cur, n_accepted).

    ``cur`` [ntgt, m, ndim] proposes against partners drawn from ``other``
    [ntgt, n_comp, ndim]; ``z``, ``partner_idx`` and ``log_u`` are [ntgt, m].
    """
    return _propose_accept(cur, lp_cur, other, z, partner_idx, log_u,
                           lambda proposal: log_posterior_fleet(proposal, fleet))


def run_fleet_ensemble(state: EnsembleState, fleet: PackedTarget, n_steps: int, thin: int = 1,
                       a: float = 2.0):
    """Stretch-move every fleet ensemble for ``n_steps`` steps.

    Returns ``(state, chain [n_keep, ntgt, nw, ndim], logps [n_keep, ntgt, nw])``
    with ``n_keep = n_steps // thin``.
    """
    ntgt, nw, ndim = state.coords.shape
    nh = nw // 2
    gen, dev = state.generator, state.coords.device
    c0, c1 = state.coords[:, :nh], state.coords[:, nh:]
    lp0, lp1 = state.log_prob[:, :nh], state.log_prob[:, nh:]
    n_acc = state.n_accept
    chain, logps = [], []
    for _ in range(n_steps // thin):
        z, (idx0, idx1), log_u = _draw_fleet_chunk(gen, thin, ntgt, nw, a, c0.dtype, dev)
        for s in range(thin):
            c0, lp0, k0 = _fleet_half_update(c0, lp0, c1, z[s, 0, :, :nh], idx0[s],
                                             log_u[s, 0, :, :nh], fleet)
            c1, lp1, k1 = _fleet_half_update(c1, lp1, c0, z[s, 1], idx1[s], log_u[s, 1], fleet)
            n_acc = n_acc + k0 + k1
        chain.append(torch.cat([c0, c1], dim=1))
        logps.append(torch.cat([lp0, lp1], dim=1))
    state = EnsembleState(torch.cat([c0, c1], dim=1), torch.cat([lp0, lp1], dim=1), gen, n_acc)
    return (state, _stack(chain, (0, ntgt, nw, ndim), c0),
            _stack(logps, (0, ntgt, nw), lp0))
