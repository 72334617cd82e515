"""CUDA kernels of the likelihood hot path (counterpart of ``ops/pallas_kernels.py``).

Four kernels, hand-written in CUDA C++ for ``sm_90a`` (``csrc/``), built by
``runtime.cuda_build``:

* ``log_posterior_fused`` (K1, ``csrc/log_posterior_fused.cu``) evaluates the
  whole batched log-posterior of one unpadded target, one thread block per
  walker: the stage-2 sampler's evaluation.
* ``spectrum_chi2`` (K3, ``csrc/spectrum_chi2.cu``) evaluates the spectrum
  block alone, ``renorm`` on or off: the stage-1 annealer's scoring.
* ``spectrum_chi2_fleet`` (K4, ``csrc/spectrum_chi2_fleet.cu``) evaluates the
  spectrum block of every walker of a stacked, padded fleet in one launch:
  the fleet's default spectrum term.
* ``log_posterior_fleet_fused`` (K5, ``csrc/log_posterior_fleet_fused.cu``)
  is K1 for a stacked, padded fleet: the fleet's opt-in fused evaluation.

All four share the spectrum-statistics body K2 (``csrc/spectrum_block.cuh``):
the ``Wcomb @ D`` model row with extinction, the sort-free radix median, the
degree-2 continuum renorm and the chi^2.  K1 and K3 take the median of the
whole row and the mean chi^2; K4 and K5 take per-target median ranks and
``sum * 1/n_true``, so padded points are inert.  K1 and K5 share the
posterior body (``csrc/posterior_body.cuh``).

Beside each kernel is its plain PyTorch version (``*_reference``): f32, the
same pack-time dials, the arithmetic of the Pallas kernel, on the same
operand tables.  A wrapper runs the plain version only when it is given CPU
tensors; given CUDA tensors it launches the kernel or raises.  ``LAUNCHES``
counts each wrapper's kernel launches.  The segmented large-nd lane
(``ops.spec_segmented``, K6-K9) shares this library, its checks and its
counts.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from mcmc_spec_tpu_torch.models.mist import LSUN as _LSUN
from mcmc_spec_tpu_torch.models.mist import RSUN as _RSUN
from mcmc_spec_tpu_torch.models.mist import SIGMA_SB as _SIGMA_SB
from mcmc_spec_tpu_torch.runtime import cuda_build

LN10 = 2.302585092994046
LN10_04 = -0.4 * LN10
_F32_INF_BITS = 0x7F800000
_RECIP_MAGIC = 0x7EF311C3
_RSUN_CM = 6.957e10
_PC_CM = 3.086e18
_F32 = torch.float32

# kernel launches per wrapper, for showing that a run went through the kernels
LAUNCHES = {"log_posterior_fused": 0, "spectrum_chi2": 0, "spectrum_chi2_fleet": 0,
            "log_posterior_fleet_fused": 0, "model_extinct": 0, "median_nonneg": 0,
            "renorm_partials": 0, "resid_chi2": 0,
            # the cost-attribution experiments (mcmc_spec_tpu_torch.scripts)
            "fma_chains": 0, "median_only": 0, "spectrum_recip": 0, "posterior_sections": 0,
            # the K1 redesign experiments (mcmc_spec_tpu_torch.scripts)
            "posterior_transposed": 0, "median_adaptive": 0, "median_packed": 0,
            "spectrum_overlap": 0,
            # the fleet grid order and the launch-cost probes (mcmc_spec_tpu_torch.scripts)
            "spectrum_chi2_fleet_2d": 0, "trivial_probe": 0, "bisect_probe": 0,
            "bisect2_probe": 0}
# the dynamic shared memory a Hopper block may opt into (227 KB), less a margin
# for the kernels' static shared memory: the one-block-per-walker kernels hold
# a model row of nd floats and their blend weights in it
ROW_SMEM_BYTES = 232448 - 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# dials


def resolve_dials(tgt) -> tuple:
    """(median_iters, matmul_passes, recip_newton) pack-time statics off a target.

    An unset dial raises: targets come from ``pack_target`` (or
    ``target_from_jax``), which stamp them.
    """
    it = getattr(tgt, "median_iters", 0)
    mm = getattr(tgt, "matmul_passes", 0)
    rn = getattr(tgt, "recip_newton", -1)
    if it <= 0 or mm not in (1, 3, 6) or rn < 0:
        raise ValueError(
            "PackedTarget accuracy dials unset "
            f"(median_iters={it}, matmul_passes={mm}, recip_newton={rn}): "
            "targets must come from pack_target(), which stamps the dials")
    return it, mm, rn


def _require_dials(iters, mm_passes, recip) -> tuple:
    """Validate explicitly passed kernel dials; None or out of range raises."""
    if iters is None or mm_passes is None or recip is None:
        raise ValueError(
            "spectrum kernels require explicit accuracy dials "
            f"(got iters={iters}, mm_passes={mm_passes}, recip={recip})")
    iters, mm_passes, recip = int(iters), int(mm_passes), int(recip)
    if iters <= 0 or mm_passes not in (1, 3, 6) or recip < 0:
        raise ValueError(
            "spectrum kernel dials out of range "
            f"(iters={iters}, mm_passes={mm_passes}, recip={recip})")
    return iters, mm_passes, recip


# ---------------------------------------------------------------------------
# device helpers, plain PyTorch (the kernels' __device__ twins are in csrc/)


def _fast_recip(x: torch.Tensor, newton: int) -> torch.Tensor:
    """Integer-magic reciprocal seed + ``newton`` Newton steps (f32).

    The seed ``0x7EF311C3 - bits(x)`` is formed in int64 and wrapped to
    int32 explicitly, so negative ``x`` keeps its sign as under the JAX
    version's two's-complement wrap.
    """
    xi = x.contiguous().view(torch.int32).to(torch.int64)
    r = _RECIP_MAGIC - xi
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(_F32)
    for _ in range(newton):
        r = r * (2.0 - x * r)
    return r


def _div(num, den, recip: int):
    """num/den, exact (recip=0) or via the magic-seed reciprocal."""
    if recip == 0:
        return num / den
    return num * _fast_recip(den, recip)


def _row_order_stat_bits(mi, rank, iters: int = 31, midpoint: bool = False, lo=None, hi=None):
    """Smallest int32 bit value v per row with count(mi <= v) >= rank.

    ``mi``: [B, nd] int32 bit patterns of non-negative f32 (or any int32 keys
    with a bracket).  The search starts from the bracket [``lo``, ``hi``]
    ([B, 1] int32; by default [0, +inf's pattern]), where 31 bisection passes
    cover the bit range exactly; fewer leave a bracket whose upper end (or,
    with ``midpoint``, its midpoint) is returned.
    """
    B = mi.shape[0]
    if lo is None:
        lo = torch.zeros((B, 1), dtype=torch.int32, device=mi.device)
    if hi is None:
        hi = torch.full((B, 1), _F32_INF_BITS, dtype=torch.int32, device=mi.device)
    for _ in range(iters):
        mid = lo + ((hi - lo) >> 1)
        ge = (mi <= mid).sum(dim=1, keepdim=True) >= rank
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    if midpoint:
        return lo + ((hi - lo) >> 1)
    return hi


def _row_median_nonneg(model, iters: int = 31):
    """``np.median`` along axis 1 of non-negative f32 rows, sort-free ([B, 1]).

    31 passes are exact; fewer return the bracket midpoint of the lower
    middle order statistic (no upper-middle refinement).
    """
    nd = model.shape[1]
    r1 = (nd + 1) // 2
    return _row_median_ranks(model, r1, 0 if nd % 2 else r1 + 1, iters)


def _row_median_ranks(model, r1: int, r2: int, iters: int):
    """Order statistic ``r1`` of each row, refined to the mean with order
    statistic ``r2`` (1-based; ``r2 = 0``: no refinement) ([B, 1]).

    The fleet kernels take the ranks of the true data points, so the padded
    sentinels above them never count.  31 passes are exact; fewer return the
    bracket midpoint of rank ``r1``.
    """
    mi = model.contiguous().view(torch.int32)
    v1 = _row_order_stat_bits(mi, r1, iters, midpoint=iters < 31)
    if iters < 31:
        return v1.view(_F32)
    return _refine_upper(model, mi, v1, r2)


def _refine_upper(model, mi, v1, r2: int):
    """The order statistic with bit pattern ``v1`` [B, 1] of each row of ``model``
    (``mi`` its patterns), refined to its mean with the order statistic ``r2``
    (1-based; ``r2 = 0``: no refinement) by a count and a masked min ([B, 1])."""
    x1 = v1.view(_F32)
    if r2 <= 0:
        return x1
    cnt1 = (mi <= v1).sum(dim=1, keepdim=True)
    bigger = torch.where(mi > v1, model, torch.full_like(model, math.inf))
    x2 = torch.where(cnt1 >= r2, x1, bigger.min(dim=1, keepdim=True).values)
    return 0.5 * (x1 + x2)


def _tent_consts(nodes: torch.Tensor) -> torch.Tensor:
    """[..., 4, n] f32 (A, invB, C, invD) tent constants with the +-1e30/1e-30 edge sentinels."""
    nodes = nodes.to(_F32)
    prev = torch.cat([nodes[..., :1] - 1.0, nodes[..., :-1]], dim=-1)
    nxt = torch.cat([nodes[..., 1:], nodes[..., -1:] + 1.0], dim=-1)
    A, invB = prev.clone(), 1.0 / (nodes - prev)
    C, invD = nxt.clone(), 1.0 / (nxt - nodes)
    A[..., 0], invB[..., 0], C[..., -1], invD[..., -1] = -1e30, 1e-30, 1e30, 1e-30
    return torch.stack([A, invB, C, invD], dim=-2)


def _tent_w(tc, q):
    """Tent weights [B, n] for queries ``q`` [B, 1] given [4, n] constants."""
    left = (q - tc[0][None, :]) * tc[1][None, :]
    right = (tc[2][None, :] - q) * tc[3][None, :]
    return torch.clamp(torch.minimum(left, right), 0.0, 1.0)


def _spectrum_block(Wcomb, av, D, kd, data, inv_err, VpinvT, VT, med_data, iters,
                    renorm=True, recip=0, fleet_stat=None, noexp=False):
    """K2: model, extinction, median match, continuum renorm, chi^2 ([B, 1]).

    ``av`` is [B, 1]; the data-axis operands are [nd] or [3, nd].  The model
    product is the full f32 matmul whatever the matmul-passes dial.  Without
    ``fleet_stat`` the median is the whole row's and the chi^2 the mean (K1,
    K3); with ``fleet_stat = (r1, r2, inv_n)`` the median takes those ranks
    and the chi^2 is ``sum * inv_n`` (K4, K5).  ``noexp`` (the experiment S4
    only) swaps the extinction exp for the linear term ``1 + LN10_04*av*kd``.
    """
    model = Wcomb @ D
    ext = LN10_04 * av * kd[None, :]
    trans = torch.where(av > 0, 1.0 + ext if noexp else torch.exp(ext),
                        torch.ones((), dtype=_F32, device=model.device))
    model = model * trans
    if fleet_stat is None:
        med = _row_median_nonneg(model, iters=iters)
    else:
        med = _row_median_ranks(model, fleet_stat[0], fleet_stat[1], iters)
    model = model * (med_data / med)
    if renorm:
        frac = _div(data[None, :], model, recip)
        c0 = (frac * VpinvT[0][None, :]).sum(dim=1, keepdim=True)
        c1 = (frac * VpinvT[1][None, :]).sum(dim=1, keepdim=True)
        c2 = (frac * VpinvT[2][None, :]).sum(dim=1, keepdim=True)
        fitted = c0 * VT[0][None, :] + c1 * VT[1][None, :] + c2 * VT[2][None, :]
        data_renorm = _div(data[None, :], fitted, recip)
    else:
        data_renorm = data[None, :]
    resid = (model - data_renorm) * inv_err[None, :]  # padded points: * 0 -> 0
    if fleet_stat is None:
        return (resid * resid).mean(dim=1, keepdim=True)
    return (resid * resid).sum(dim=1, keepdim=True) * fleet_stat[2]


# ---------------------------------------------------------------------------
# ctypes binding


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "log_posterior_fused_launch": [_P] * 20 + [_I] * 14 + [_F] * 3 + [_P],
    "spectrum_chi2_launch": [_P] * 10 + [_I] * 6 + [_P],
    "spectrum_chi2_fleet_launch": [_P] * 11 + [_I] * 6 + [_P],
    "log_posterior_fleet_fused_launch": [_P] * 21 + [_I] * 15 + [_F] * 2 + [_P],
    # the segmented large-nd lane (ops.spec_segmented)
    "model_extinct_launch": [_P] * 5 + [_I] * 3 + [_P],
    "median_kary_launch": [_P] * 3 + [_I] * 4 + [_P],
    "renorm_partials_launch": [_P] * 5 + [_I] * 3 + [_P],
    "resid_chi2_launch": [_P] * 7 + [_I] * 4 + [_P],
    # the cost-attribution experiments (mcmc_spec_tpu_torch.scripts)
    "fma_chains_launch": [_P] * 2 + [ctypes.c_longlong] + [_I] + [_P],
    "median_only_launch": [_P] * 2 + [_I] * 3 + [_P],
    "spectrum_recip_launch": [_P] * 10 + [_I] * 6 + [_P],
    "posterior_sections_launch": [_P] * 20 + [_I] * 14 + [_F] * 2 + [_I] + [_P],
    # the K1 redesign experiments (mcmc_spec_tpu_torch.scripts)
    "posterior_transposed_launch": [_P] * 20 + [_I] * 14 + [_F] * 2 + [_P],
    "median_adaptive_launch": [_P] * 3 + [_I] * 2 + [_P],
    "median_packed_launch": [_P] * 2 + [_I] * 2 + [_P],
    "spectrum_overlap_launch": [_P] * 10 + [_I] * 6 + [_P],
    # the fleet grid order and the launch-cost probes (mcmc_spec_tpu_torch.scripts); a
    # probe's tables go as a C array of pointers and one of sizes
    "fleet_grid_order_launch": [_P] * 11 + [_I] * 7 + [_P],
    "trivial_probe_launch": [_P] * 3 + [_I] + [_P] + [_I] * 2 + [_P],
    "bisect_probe_launch": [_P, _I, _P, _P, _I, _F, _F, _I, _I, _P, _I, _I, _P],
    "bisect2_probe_launch": [_P] * 3 + [_I] * 2 + [_P] + [_I] * 2 + [_P],
}


@functools.lru_cache(maxsize=1)
def _lib():
    lib = cuda_build.load()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, device: torch.device, shape: tuple, dtype=_F32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _launch(fn_name: str, counter: str, *args):
    rc = getattr(_lib(), fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")
    LAUNCHES[counter] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are not supported (cpu or cuda)")


# ---------------------------------------------------------------------------
# K3: spectrum chi^2


def spectrum_chi2_reference(Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V, Vpinv,
                            med_data, iters, mm_passes, renorm=True, recip=0):
    """Plain PyTorch version of ``spectrum_chi2``: [NW] mean spectrum chi^2 (f32)."""
    iters, _, recip = _require_dials(iters, mm_passes, recip)
    dev = Wcomb.device
    f = lambda x: torch.as_tensor(x, device=dev).to(_F32)
    return _spectrum_block(
        f(Wcomb), f(av)[:, None], f(D_flat), f(ext_k_data), f(data_flux),
        1.0 / f(data_err), f(Vpinv), f(V).T, f(med_data), iters, renorm=renorm,
        recip=recip)[:, 0]


def spectrum_chi2(Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V, Vpinv, med_data,
                  iters=None, mm_passes=None, renorm=True, recip=None):
    """Fused per-walker spectrum chi^2 (mean over data points), K3.

    Args:
        Wcomb: [NW, NO] combined grid-point weights (scales folded in).
        av: [NW] extinction values.
        D_flat: [NO, nd] grid projected onto the data wavelengths.
        ext_k_data: [nd] CCM89 A/Av at the data wavelengths.
        data_flux, data_err: [nd].
        V: [nd, 3] scaled-domain Vandermonde; Vpinv: [3, nd].
        med_data: median of data_flux (0-d tensor or float).
        iters/mm_passes/recip: required accuracy dials.
        renorm: False is the annealer's median-only scoring.
    Returns: [NW] float32.
    """
    iters, mm_passes, recip = _require_dials(iters, mm_passes, recip)
    if Wcomb.device.type == "cpu":
        return spectrum_chi2_reference(Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V,
                                       Vpinv, med_data, iters, mm_passes, renorm, recip)
    _require_cuda(Wcomb, "spectrum_chi2")
    dev = Wcomb.device
    NW, NO = Wcomb.shape
    nd = D_flat.shape[1]
    Wcomb, av = Wcomb.contiguous(), av.contiguous()
    D_flat, ext_k_data, data_flux = D_flat.contiguous(), ext_k_data.contiguous(), data_flux.contiguous()
    inv_err = 1.0 / data_err
    VpinvT, VT = Vpinv.contiguous(), V.T.contiguous()
    med = torch.as_tensor(med_data, dtype=_F32, device=dev).reshape(1)
    for t, name, shape in ((Wcomb, "Wcomb", (NW, NO)), (av, "av", (NW,)),
                           (D_flat, "D_flat", (NO, nd)), (ext_k_data, "ext_k_data", (nd,)),
                           (data_flux, "data_flux", (nd,)), (inv_err, "1/data_err", (nd,)),
                           (VpinvT, "Vpinv", (3, nd)), (VT, "V.T", (3, nd))):
        _check(t, name, dev, shape)
    out = torch.empty(NW, dtype=_F32, device=dev)
    if NW == 0:
        return out
    _launch("spectrum_chi2_launch", "spectrum_chi2",
            Wcomb.data_ptr(), av.data_ptr(), D_flat.data_ptr(), ext_k_data.data_ptr(),
            data_flux.data_ptr(), inv_err.data_ptr(), VpinvT.data_ptr(), VT.data_ptr(),
            med.data_ptr(), out.data_ptr(), NW, NO, nd, iters, int(bool(renorm)), recip,
            _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K1: fused log-posterior


def _operand_tables(tgt) -> dict:
    """The f32 operand tables of the posterior kernels, for one target or, with
    a leading target axis, a stacked fleet.

    Mirrors the operands ``pallas_kernels.log_posterior_fused`` and
    ``log_posterior_fleet_fused`` pass their kernels.
    """
    lead = tgt.D.shape[:-3]
    nT, nG, nd = tgt.D.shape[-3:]
    NO = nT * nG
    f = lambda x: x.to(_F32).contiguous()
    rows = lambda *xs: f(torch.stack(xs, dim=-2))
    return {
        "D": f(tgt.D.reshape(*lead, NO, nd)),
        "kd": f(tgt.ext_k_data),
        "data": f(tgt.data_flux),
        "inv_err": f(1.0 / tgt.data_err.to(_F32)),  # padded err = inf -> 0
        "VpinvT": f(tgt.Vpinv),
        "VT": f(tgt.V.transpose(-1, -2)),
        # o = t*nG + g, as jnp.repeat / jnp.tile lay them out
        "tentT": f(torch.repeat_interleave(_tent_consts(tgt.temps), nG, dim=-1)),
        "tentG": f(_tent_consts(tgt.loggs).repeat(*([1] * (len(lead) + 1)), nT)),
        "mist_tent": f(_tent_consts(tgt.mist_teff_nodes)),
        "mist_vals": rows(tgt.mist_logg_nodes, tgt.mist_lum_nodes),
        "av_tent": f(_tent_consts(tgt.av_logd_nodes)),
        "av_vals": rows(tgt.av_mu_nodes, tgt.av_sig_nodes),
        "Fc": f(tgt.Fc.reshape(*lead, NO, tgt.Fc.shape[-1])),
        "Fp": f(tgt.Fp.reshape(*lead, NO, tgt.Fp.shape[-1])),
        "cobs": rows(tgt.cmag, tgt.cerr),
        "pobs": rows(tgt.pmag, tgt.perr, tgt.phot_zp, tgt.ext_k_cwl),
        "prior": rows(tgt.prior_mu, tgt.prior_sig),
    }


def kernel_tables(tgt) -> dict:
    """The fused kernel's f32 operand tables for one target, built once.

    ``scal`` is (tmin, tmax, med_data); cached on the target
    (``dataclasses.replace`` drops the cache).
    """
    if tgt.D.dim() != 3:
        raise ValueError(f"kernel_tables: one target expected, got D {tuple(tgt.D.shape)}")
    if tgt._kernel_tables is None:
        scal = torch.stack([tgt.tmin, tgt.tmax, tgt.med_data]).to(_F32).contiguous()
        tgt._kernel_tables = {"scal": scal, **_operand_tables(tgt)}
    return tgt._kernel_tables


def _chi2_weight(tgt) -> float:
    """Spectrum chi^2 weight: (nc + npf) with a parallax, nc without."""
    nc, npf = tgt.cmag.shape[0], tgt.pmag.shape[0]
    return float(nc + npf) if tgt.fit_plx else float(nc)


def log_posterior_fused_reference(p, tgt):
    """Plain PyTorch version of ``log_posterior_fused``: [B] log-posterior (f32).

    The arithmetic of ``pallas_kernels._posterior_kernel``, on the same
    operand tables the kernel reads.
    """
    iters, _, recip = resolve_dials(tgt)
    t = kernel_tables(tgt)
    p = p.to(device=tgt.device, dtype=_F32)
    return _posterior_plain(p, tgt, t, t["scal"][0], t["scal"][1], t["scal"][2],
                            tgt.spectrum_weight * _chi2_weight(tgt), iters, recip)


ALL_SECTIONS = (True, True, True, True)


def _posterior_plain(p, cfg, t, tmin, tmax, med_data, spec_scale, iters, recip, fleet_stat=None,
                     sections=ALL_SECTIONS):
    """The posterior kernels' arithmetic for walkers ``p`` [B, ndim] of one target.

    ``cfg`` carries the static configuration (nspec, fit_plx, ...), ``t`` the
    target's operand tables.  K1: ``spec_scale`` is the spectrum weight times
    the filter count and ``fleet_stat`` is None; one target of K5: the
    per-target ``spec_scale`` and ``fleet_stat = (r1, r2, inv_n)``.
    ``sections`` = (phot, priors, spectrum, W) switches sections off for the
    cost ablation S12 (``scripts.ablate_fused_sections``), each replaced by
    the stub of ``posterior_body.cuh``; K1 and K5 keep them all on.
    """
    do_phot, do_priors, do_spectrum, do_w = sections
    n = cfg.nspec
    nc = t["cobs"].shape[1]
    tiny = torch.finfo(_F32).tiny
    neg_inf = torch.tensor(-math.inf, dtype=_F32, device=p.device)

    teffs = [p[:, s : s + 1] for s in range(n)]
    av = p[:, n : n + 1]
    if cfg.fit_plx:
        r1 = p[:, n + 1 : n + 2]
        ratios = [p[:, n + 1 + s : n + 2 + s] for s in range(1, n)]
        plx = p[:, 2 * n + 1 : 2 * n + 2]
        base = (r1 * _RSUN_CM * plx / _PC_CM) ** 2
        scales = [base] + [base * r**2 for r in ratios]
    else:
        r1 = torch.ones_like(av)
        ratios = [p[:, n + s : n + 1 + s] for s in range(1, n)]
        plx = torch.zeros_like(av)
        scales = [torch.ones_like(r1)] + [r**2 for r in ratios]

    Wcomb, cmags, mrads = None, [], []
    for s in range(n):
        if do_w:
            wm = _tent_w(t["mist_tent"], teffs[s])
            logg_s = (wm * t["mist_vals"][0][None, :]).sum(dim=1, keepdim=True)
            Wk = _tent_w(t["tentT"], teffs[s]) * _tent_w(t["tentG"], logg_s)
        else:  # stub: every grid point weighted
            Wk = teffs[s] * torch.full((1, t["tentT"].shape[1]), 1e-4, dtype=_F32, device=p.device)
        sWk = scales[s] * Wk
        Wcomb = sWk if Wcomb is None else Wcomb + sWk
        cmags.append(-2.5 / LN10 * torch.log(torch.clamp(sWk @ t["Fc"], min=tiny)))
        if cfg.rad_prior:
            lum_s = (wm * t["mist_vals"][1][None, :]).sum(dim=1, keepdim=True)
            mrads.append(torch.sqrt(lum_s * _LSUN / (4.0 * math.pi * _SIGMA_SB * teffs[s] ** 4))
                         / _RSUN)

    if n == 1:
        contrasts = torch.zeros((p.shape[0], nc), dtype=_F32, device=p.device)
    elif n == 2:
        contrasts = cmags[1] - cmags[0]
    else:
        # the split is on the (padded) contrast count, as in the Pallas kernels
        first = torch.arange(nc, device=p.device)[None, :] < nc // 2
        contrasts = torch.where(first, cmags[1] - cmags[0], cmags[2] - cmags[0])

    cobs, pobs = t["cobs"], t["pobs"]
    phot = -2.5 / LN10 * torch.log(torch.clamp((Wcomb @ t["Fp"]) / pobs[2][None, :], min=tiny))
    phot = torch.where(av > 0, phot + av * pobs[3][None, :], phot)
    chi_c = (((contrasts - cobs[0][None, :]) / cobs[1][None, :]) ** 2).sum(dim=1, keepdim=True)
    chi_p = (((phot - pobs[0][None, :]) / pobs[1][None, :]) ** 2).sum(dim=1, keepdim=True)
    if not do_phot:  # stub: no band terms
        chi_c = chi_p = torch.zeros_like(av)

    if not do_spectrum:  # stub: the blend weights' sum
        chi_spec = Wcomb.sum(dim=1, keepdim=True)
    elif cfg.spectrum_weight != 0.0:
        chi_spec = _spectrum_block(Wcomb, av, t["D"], t["kd"], t["data"], t["inv_err"],
                                   t["VpinvT"], t["VT"], med_data, iters, recip=recip,
                                   fleet_stat=fleet_stat)
    else:
        chi_spec = torch.zeros_like(chi_c)
    if not cfg.fit_plx:
        chi_p = torch.zeros_like(chi_p)
    cs = spec_scale * chi_spec + chi_c + chi_p
    ll = torch.where(torch.isnan(cs), neg_inf, -0.5 * cs)

    lp = torch.zeros_like(av)
    if not do_priors:  # stub: no priors and no bounds
        return torch.where(torch.isfinite(lp), lp + ll, neg_inf)[:, 0]
    if cfg.fit_plx:
        dist_pc = 1.0 / torch.clamp(plx, min=1e-12)
        wav = _tent_w(t["av_tent"], torch.log(torch.clamp(dist_pc, min=1e-3)))
        mu = (wav * t["av_vals"][0][None, :]).sum(dim=1, keepdim=True)
        sig = (wav * t["av_vals"][1][None, :]).sum(dim=1, keepdim=True)
        lp = lp + -0.5 * ((av - mu) / sig) ** 2
    pmu, psig = t["prior"][0][None, :], t["prior"][1][None, :]
    gauss = -0.5 * ((p - pmu) / psig) ** 2
    lp = lp + torch.where(pmu != 0, gauss, torch.zeros_like(gauss)).sum(dim=1, keepdim=True)
    if cfg.rad_prior:
        m1 = mrads[0]
        model_vals = [m1] + [m / m1 for m in mrads[1:]]
        rvals = [r1] + ratios if cfg.fit_plx else ratios
        if not cfg.fit_plx:
            model_vals = model_vals[1:]
        for rv, mv in zip(rvals, model_vals):
            lp = lp + -0.5 * ((rv - mv) / (cfg.rad_sigma_frac * mv)) ** 2

    ok = av >= 0
    for te in teffs:
        ok = ok & (te <= tmax) & (te >= tmin)
    for r in ratios:
        ok = ok & (r >= 0.05)
    if cfg.fit_plx:
        ok = ok & (r1 >= 0.05)
        if cfg.dist_fit:
            plx_hi = 0.01 if cfg.spectrum_weight == 0.0 else 0.25
            if n <= 2:
                ok = ok & (r1 <= 1.5) & (plx >= 1.0 / 3000.0) & (plx <= plx_hi)
            else:
                ok = ok & (plx >= 1.0 / 1000.0) & (plx <= plx_hi)
    lp = torch.where(ok, lp, neg_inf)
    return torch.where(torch.isfinite(lp), lp + ll, neg_inf)[:, 0]


def log_posterior_fused(p, tgt):
    """Fused ``log_posterior_batch`` of one unpadded target, K1: [B] float32.

    Requires ``tgt.n_contrast > 0`` and ``tgt.n_phot > 0`` and the target's
    tensors on ``p``'s device (the dispatch in ``inference.batched`` checks
    eligibility).
    """
    resolve_dials(tgt)
    if p.device.type == "cpu":
        return log_posterior_fused_reference(p, tgt)
    _require_cuda(p, "log_posterior_fused")
    out, args = posterior_launch_args(p, tgt, "log_posterior_fused")
    if args:
        _launch("log_posterior_fused_launch", "log_posterior_fused", *args,
                float(tgt.rad_sigma_frac), _stream(p.device))
    return out


def posterior_launch_args(p, tgt, kernel: str):
    """(out, args) of a one-target posterior kernel over walkers ``p`` (CUDA) on
    ``tgt``'s tables: ``out`` the [B] result, ``args`` the launch arguments from
    ``scal`` to the spectrum scale that K1 and the section ablation S12
    (``scripts.ablate_fused_sections``) share, None when B is 0.  Each caller
    appends its own last scalar and the stream."""
    iters, _, recip = resolve_dials(tgt)
    dev = p.device
    t = kernel_tables(tgt)
    B, ndim = p.shape
    nT, nG, nd = tgt.D.shape
    NO = nT * nG
    nc, npf = tgt.cmag.shape[0], tgt.pmag.shape[0]
    nm, nav = tgt.mist_teff_nodes.shape[0], tgt.av_logd_nodes.shape[0]
    if ndim != tgt.ndim:
        raise ValueError(f"{kernel}: p has {ndim} parameters, target needs {tgt.ndim}")
    p = p.contiguous()
    _check(p, "p", dev, (B, ndim))
    # in the pointer order of the launch functions, between p and out
    tables = {"D": (NO, nd), "kd": (nd,), "data": (nd,), "inv_err": (nd,),
              "VpinvT": (3, nd), "VT": (3, nd), "tentT": (4, NO), "tentG": (4, NO),
              "mist_tent": (4, nm), "mist_vals": (2, nm), "av_tent": (4, nav),
              "av_vals": (2, nav), "Fc": (NO, nc), "Fp": (NO, npf), "cobs": (2, nc),
              "pobs": (4, npf), "prior": (2, ndim)}
    _check(t["scal"], "scal", dev, (3,))
    for name, shape in tables.items():
        _check(t[name], name, dev, shape)
    out = torch.empty(B, dtype=_F32, device=dev)
    if B == 0:
        return out, None
    return out, (t["scal"].data_ptr(), p.data_ptr(), *(t[k].data_ptr() for k in tables),
                 out.data_ptr(), B, ndim, NO, nd, nm, nav, nc, npf, tgt.nspec,
                 int(tgt.fit_plx), int(tgt.dist_fit), int(tgt.rad_prior), iters, recip,
                 float(tgt.spectrum_weight), tgt.spectrum_weight * _chi2_weight(tgt))


# ---------------------------------------------------------------------------
# fleet: K4 (spectrum chi^2) and K5 (fused posterior) on a stacked, padded fleet


def fleet_kernel_tables(fleet) -> dict:
    """The fleet kernels' f32 operand tables for a stacked fleet, built once.

    Each table is the per-target table of ``kernel_tables`` with a leading
    target axis, as ``pallas_kernels.log_posterior_fleet_fused`` stacks them.
    Per-target scalars stay per target: ``scal`` [ntgt, 5] holds (tmin, tmax,
    med_data, 1/n_data_true, spectrum weight x (nc_true + np_true, or nc_true
    without a parallax)) and ``ranks`` [ntgt, 2] int32 the 1-based median
    ranks of the true data points.  Cached on the fleet.
    """
    if fleet.D.dim() != 4:
        raise ValueError(f"fleet_kernel_tables: a stacked fleet expected, got D "
                         f"{tuple(fleet.D.shape)}")
    if fleet._kernel_tables is not None:
        return fleet._kernel_tables
    n_true = fleet.n_data_true.to(torch.int32)
    nc_t, np_t = fleet.n_contrast_true.to(_F32), fleet.n_phot_true.to(_F32)
    weight = nc_t + np_t if fleet.fit_plx else nc_t
    # an f32 product, as the Pallas kernel's weakly-typed spectrum_weight * weight
    spec_scale = torch.tensor(fleet.spectrum_weight, dtype=_F32, device=fleet.device) * weight
    scal = torch.stack([fleet.tmin.to(_F32), fleet.tmax.to(_F32), fleet.med_data.to(_F32),
                        1.0 / n_true.to(_F32), spec_scale], dim=1)
    ranks = torch.stack([(n_true + 1) // 2, n_true // 2 + 1], dim=1).to(torch.int32)
    fleet._kernel_tables = {"scal": scal.contiguous(), "ranks": ranks.contiguous(),
                            **_operand_tables(fleet)}
    return fleet._kernel_tables


def _fleet_stat(t: dict, i: int) -> tuple:
    """(r1, r2, inv_n) of target ``i``: the plain versions' per-target median ranks and 1/n."""
    r1, r2 = (int(r) for r in t["ranks"][i])
    return r1, r2, t["scal"][i, 3]


def spectrum_chi2_fleet_reference(Wcomb, av, fleet):
    """Plain PyTorch version of ``spectrum_chi2_fleet``: [ntgt, nw] spectrum chi^2 (f32)."""
    iters, _, recip = resolve_dials(fleet)
    t = fleet_kernel_tables(fleet)
    dev = t["D"].device
    Wcomb, av = Wcomb.to(device=dev, dtype=_F32), av.to(device=dev, dtype=_F32)
    return torch.stack([
        _spectrum_block(Wcomb[i], av[i][:, None], t["D"][i], t["kd"][i], t["data"][i],
                        t["inv_err"][i], t["VpinvT"][i], t["VT"][i], t["scal"][i, 2], iters,
                        recip=recip, fleet_stat=_fleet_stat(t, i))[:, 0]
        for i in range(Wcomb.shape[0])])


def spectrum_chi2_fleet(Wcomb, av, fleet):
    """Fleet spectrum chi^2 (sum over the true points / n_true), K4: [ntgt, nw] float32.

    Args:
        Wcomb: [ntgt, nw, NO] combined grid-point weights (scales folded in).
        av: [ntgt, nw] extinction values.
        fleet: the stacked fleet (``inference.fleet.stack_targets``); its
            pack-time dials select the median passes and the reciprocal.
    """
    iters, _, recip = resolve_dials(fleet)
    if Wcomb.device.type == "cpu":
        return spectrum_chi2_fleet_reference(Wcomb, av, fleet)
    _require_cuda(Wcomb, "spectrum_chi2_fleet")
    dev = Wcomb.device
    t = fleet_kernel_tables(fleet)
    ntgt, nw, NO = Wcomb.shape
    nd = t["D"].shape[2]
    Wcomb, av = Wcomb.contiguous(), av.contiguous()
    for x, name, shape in ((Wcomb, "Wcomb", (ntgt, nw, NO)), (av, "av", (ntgt, nw)),
                           (t["D"], "D", (ntgt, NO, nd)), (t["kd"], "kd", (ntgt, nd)),
                           (t["data"], "data", (ntgt, nd)), (t["inv_err"], "inv_err", (ntgt, nd)),
                           (t["VpinvT"], "VpinvT", (ntgt, 3, nd)), (t["VT"], "VT", (ntgt, 3, nd)),
                           (t["scal"], "scal", (ntgt, 5))):
        _check(x, name, dev, shape)
    _check(t["ranks"], "ranks", dev, (ntgt, 2), torch.int32)
    out = torch.empty((ntgt, nw), dtype=_F32, device=dev)
    if ntgt * nw == 0:
        return out
    _launch("spectrum_chi2_fleet_launch", "spectrum_chi2_fleet",
            Wcomb.data_ptr(), av.data_ptr(), t["D"].data_ptr(), t["kd"].data_ptr(),
            t["data"].data_ptr(), t["inv_err"].data_ptr(), t["VpinvT"].data_ptr(),
            t["VT"].data_ptr(), t["scal"].data_ptr(), t["ranks"].data_ptr(), out.data_ptr(),
            ntgt, nw, NO, nd, iters, recip, _stream(dev))
    return out


def log_posterior_fleet_fused_reference(params, fleet):
    """Plain PyTorch version of ``log_posterior_fleet_fused``: [ntgt, nw] (f32).

    The arithmetic of ``pallas_kernels._fleet_posterior_kernel``, target by
    target on the fleet's operand tables.
    """
    iters, _, recip = resolve_dials(fleet)
    t = fleet_kernel_tables(fleet)
    params = params.to(device=t["D"].device, dtype=_F32)
    rows = []
    for i in range(params.shape[0]):
        ti = {k: v[i] for k, v in t.items()}
        rows.append(_posterior_plain(params[i], fleet, ti, ti["scal"][0], ti["scal"][1],
                                     ti["scal"][2], ti["scal"][4], iters, recip,
                                     fleet_stat=_fleet_stat(t, i)))
    return torch.stack(rows)


def log_posterior_fleet_fused(params, fleet):
    """Fused fleet evaluation, K5: [ntgt, nw, ndim] -> [ntgt, nw] float32.

    The padding-aware counterpart of ``log_posterior_fused``: per-target
    median ranks, ``sum * 1/n_true`` spectrum chi^2 and per-target (nc_true +
    np_true) weights.  Requires ``n_contrast > 0`` and ``n_phot > 0`` (the
    dispatch in ``inference.fleet`` checks).
    """
    iters, _, recip = resolve_dials(fleet)
    if params.device.type == "cpu":
        return log_posterior_fleet_fused_reference(params, fleet)
    _require_cuda(params, "log_posterior_fleet_fused")
    dev = params.device
    t = fleet_kernel_tables(fleet)
    ntgt, nw, ndim = params.shape
    _, NO, nd = t["D"].shape
    nc, npf = t["cobs"].shape[2], t["pobs"].shape[2]
    nm, nav = t["mist_tent"].shape[2], t["av_tent"].shape[2]
    if ndim != fleet.ndim:
        raise ValueError(
            f"log_posterior_fleet_fused: params have {ndim} parameters, fleet needs {fleet.ndim}")
    params = params.contiguous()
    _check(params, "params", dev, (ntgt, nw, ndim))
    _check(t["scal"], "scal", dev, (ntgt, 5))
    _check(t["ranks"], "ranks", dev, (ntgt, 2), torch.int32)
    # in the pointer order of log_posterior_fleet_fused_launch, between params and out
    tables = {"D": (NO, nd), "kd": (nd,), "data": (nd,), "inv_err": (nd,),
              "VpinvT": (3, nd), "VT": (3, nd), "tentT": (4, NO), "tentG": (4, NO),
              "mist_tent": (4, nm), "mist_vals": (2, nm), "av_tent": (4, nav),
              "av_vals": (2, nav), "Fc": (NO, nc), "Fp": (NO, npf), "cobs": (2, nc),
              "pobs": (4, npf), "prior": (2, ndim)}
    for name, shape in tables.items():
        _check(t[name], name, dev, (ntgt,) + shape)
    out = torch.empty((ntgt, nw), dtype=_F32, device=dev)
    if ntgt * nw == 0:
        return out
    _launch("log_posterior_fleet_fused_launch", "log_posterior_fleet_fused",
            t["scal"].data_ptr(), t["ranks"].data_ptr(), params.data_ptr(),
            *(t[name].data_ptr() for name in tables), out.data_ptr(),
            ntgt, nw, ndim, NO, nd, nm, nav, nc, npf, fleet.nspec, int(fleet.fit_plx),
            int(fleet.dist_fit), int(fleet.rad_prior), iters, recip,
            float(fleet.spectrum_weight), float(fleet.rad_sigma_frac), _stream(dev))
    return out
