"""The segmented large-nd lane (counterpart of ``mcmc_spec_tpu/ops/spec_segmented.py``).

Above ``LARGE_ND`` data points a walker's model row no longer fits the
shared memory of the one-block-per-walker kernels (K1-K5, ``ops.cuda_kernels``).
This lane computes the same spectrum chi^2 from a ``[NW, nd]`` model held in
device memory, in four kernels hand-written in CUDA C++ for ``sm_90a``
(``csrc/``), built by ``runtime.cuda_build``:

* ``model_extinct`` (K6, ``csrc/model_extinct.cu``): ``Wcomb @ D`` with CCM89
  extinction, written once: a block stages a tile of D's points in shared
  memory and serves a chunk of walkers from it, each walker over its
  non-zero weights;
* ``median_nonneg`` (K7, ``csrc/median_kary.cu``): the exact or fast rank
  median of the k-ary count search over the bit pattern, computed by a
  histogram select (one pass over the row at the production dial, three
  exact), one block per row;
* ``renorm_partials`` (K8, ``csrc/segmented_stats.cu``): the continuum
  projection partials ``[NW, 3]``;
* ``resid_chi2`` (K9, ``csrc/segmented_stats.cu``): the chi^2 residual sum.

K8 and K9 share a layout (``lane_stats_layout``): a block takes a chunk of
``LANE_W`` walkers over one segment of the points, reads the shared rows of a
step once for all of them and each walker's row by 16-byte loads; a second
kernel sums the segments in order.

``spectrum_chi2_segmented`` (K10) composes them: the mean spectrum chi^2 of
``batched._spec_chi2_xla`` (renorm) or ``_spec_chi2_xla_median_only``,
over the ``n_data_true`` real points.  Beside each kernel is its plain
PyTorch version (``*_reference``) with the JAX function's arithmetic.  As in
``ops.cuda_kernels``, whose library, launch counts and checks these wrappers
share, a wrapper runs its plain version only when given CPU tensors; given
CUDA tensors it launches its kernel or raises.  Non-finite values propagate
through K9, as in the Pallas kernel and K1-K5 (the JAX XLA fallback zeroes
them): a NaN chi^2 becomes a -inf log-likelihood in ``inference.batched``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcmc_spec_tpu_torch.ops.cuda_kernels import (
    LN10_04,
    ROW_SMEM_BYTES,
    _check,
    _div,
    _launch,
    _one_cpu_thread,
    _require_cuda,
    _require_dials,
    _stream,
)

# the one-block-per-walker kernels hold a [nd] row in shared memory; above
# this nd the dispatch (inference.batched) takes this lane, as in JAX
LARGE_ND = 4096
_F32 = torch.float32
# K6's tiling (kTileP and kChunkW in csrc/model_extinct.cu): a block stages the rows of
# D over MODEL_TILE_P points and serves MODEL_CHUNK_W walkers from them
MODEL_TILE_P, MODEL_CHUNK_W = 256, 128


# K8's and K9's layout (kLaneThreads and kLaneW in csrc/segmented_stats.cu): a block of
# LANE_THREADS threads covers LANE_STEP points a step (four a thread) for a chunk of LANE_W
# walkers
LANE_THREADS = 128
LANE_STEP = 4 * LANE_THREADS
LANE_W = 4
# the blocks a launch of K8 or K9 aims for (32 on each of an H100's 132 SMs), and the
# fewest steps a segment takes where that would cut the points finer
LANE_BLOCKS = 32 * 132
LANE_MIN_STEPS = 6


def _exact(iters) -> bool:
    """The median dial's exact setting: None, 0 or >= 31 (the f32 pass count)."""
    return iters is None or iters == 0 or iters >= 31


# ---------------------------------------------------------------------------
# K6: model with extinction


@_one_cpu_thread
def model_extinct_reference(Wcomb, av, D_flat, ext_k_data):
    """Plain PyTorch version of ``model_extinct``: [NW, nd] float32 (on the CPU on one
    thread, as ``cuda_kernels._spectrum_block``)."""
    f = lambda x: x.to(_F32)
    model = f(Wcomb) @ f(D_flat)
    av = f(av)[:, None]
    trans = torch.where(av > 0, torch.exp(LN10_04 * av * f(ext_k_data)[None, :]),
                        torch.ones((), dtype=_F32, device=model.device))
    return model * trans


def model_tile_rows(NO: int) -> int:
    """The rows of D that a block of K6 stages over its ``MODEL_TILE_P`` points: all NO
    where they fit ``ROW_SMEM_BYTES`` (56 KB at NO = 56), else as many as fit; the
    kernel reads the others from device memory where a weight needs them."""
    return min(NO, ROW_SMEM_BYTES // (4 * MODEL_TILE_P))


def model_extinct(Wcomb, av, D_flat, ext_k_data):
    """Extincted model spectra ``(Wcomb @ D) * 10^(-0.4 av k)``, K6: [NW, nd] float32.

    Args:
        Wcomb: [NW, NO] combined grid-point weights (scales folded in).
        av: [NW] extinction values (none applied where ``av <= 0``).
        D_flat: [NO, nd] grid projected onto the data wavelengths.
        ext_k_data: [nd] CCM89 A/Av at the data wavelengths.
    """
    if Wcomb.device.type == "cpu":
        return model_extinct_reference(Wcomb, av, D_flat, ext_k_data)
    _require_cuda(Wcomb, "model_extinct")
    dev = Wcomb.device
    NW, NO = Wcomb.shape
    nd = D_flat.shape[1]
    Wcomb, av, D_flat, ext_k_data = (x.contiguous() for x in (Wcomb, av, D_flat, ext_k_data))
    for t, name, shape in ((Wcomb, "Wcomb", (NW, NO)), (av, "av", (NW,)),
                           (D_flat, "D_flat", (NO, nd)), (ext_k_data, "ext_k_data", (nd,))):
        _check(t, name, dev, shape)
    out = torch.empty((NW, nd), dtype=_F32, device=dev)
    if NW * nd == 0:
        return out
    _launch("model_extinct_launch", "model_extinct", Wcomb.data_ptr(), av.data_ptr(),
            D_flat.data_ptr(), ext_k_data.data_ptr(), out.data_ptr(), NW, NO, nd,
            model_tile_rows(NO), _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K7: k-ary rank median


def _kary_order_stat_bits(mi, rank, total_bits: int, iters=None):
    """Smallest bit value v per row with count(mi <= v) >= rank ([B, 1]).

    2-bit rounds over the power-of-two interval [lo, lo + 2^shift), which
    starts at [0, 2^total_bits): the thresholds ``lo + k 2^(shift-2) - 1``
    split it exactly, so ceil(total_bits / 2) rounds resolve it.  ``iters``
    (None or >= total_bits: exact) resolves at least ``iters`` bits and
    returns the midpoint of the remaining interval.  ``mi``: [B, n] int bit
    patterns of non-negative floats; ``rank``: [B, 1], 1-based.
    """
    lo = torch.zeros((mi.shape[0], 1), dtype=mi.dtype, device=mi.device)
    exact = iters is None or iters >= total_bits
    stop = 0 if exact else total_bits - 2 * ((iters + 1) // 2)
    shift = total_bits
    while shift >= 2 and shift > stop:
        q = 1 << (shift - 2)
        below = sum(((mi <= lo + (k * q - 1)).sum(dim=1, keepdim=True) < rank).to(mi.dtype)
                    for k in (1, 2, 3))
        lo = lo + below * q
        shift -= 2
    if not exact:
        return lo + (1 << (shift - 1))
    if shift == 1:
        lo = torch.where((mi <= lo).sum(dim=1, keepdim=True) >= rank, lo, lo + 1)
    return lo


def median_nonneg_reference(model, n_true, iters=None):
    """Plain PyTorch version of ``median_nonneg`` ([NW], the dtype of ``model``).

    ``model`` is float32, or float64 with the JAX convention for the dial: the
    int64 pattern has 63 bits, and a fast setting resolves ``iters + 3`` of
    them, so the relative bracket width matches float32's.
    """
    if model.dtype == torch.float64:
        itype, total_bits = torch.int64, 63
    else:
        model, itype, total_bits = model.to(_F32), torch.int32, 31
    exact = _exact(iters)
    eff_iters = None if exact else (iters if total_bits == 31 else iters + 3)
    mi = model.contiguous().view(itype)
    n = torch.as_tensor(n_true, device=model.device).to(torch.int64).reshape(-1)
    n = n.expand(model.shape[0])[:, None]
    r1 = (n + 1) // 2
    v1 = _kary_order_stat_bits(mi, r1, total_bits, eff_iters)
    x1 = v1.view(model.dtype)
    if not exact:
        return x1[:, 0]
    # upper middle (even n_true): x1 again if it repeats past rank r1, else the
    # next larger element
    cnt1 = (mi <= v1).sum(dim=1, keepdim=True)
    bigger = torch.where(mi > v1, model, torch.full_like(model, math.inf))
    x2 = torch.where(cnt1 >= r1 + 1, x1, bigger.min(dim=1, keepdim=True).values)
    return torch.where(n % 2 == 1, x1, 0.5 * (x1 + x2))[:, 0]


def median_nonneg(model, n_true, iters=None):
    """``np.median`` over the first ``n_true`` ranks of non-negative rows, K7: [NW].

    Args:
        model: [NW, nd] float32, non-negative; padding above the true points
            (the 1e30 sentinel) never counts.
        n_true: the count of real points, one for all rows or one per row
            (0-d or [NW] integer tensor, or int).
        iters: the fast-median dial, None/0/31 = exact; below 31 the midpoint
            of the bracket after ceil(iters / 2) rounds, without refinement.
    """
    if model.device.type == "cpu":
        return median_nonneg_reference(model, n_true, iters)
    _require_cuda(model, "median_nonneg")
    dev = model.device
    NW, nd = model.shape
    model = model.contiguous()
    _check(model, "model", dev, (NW, nd))
    n = torch.as_tensor(n_true, device=dev).to(torch.int32).reshape(-1).contiguous()
    if n.numel() not in (1, NW):
        raise ValueError(f"median_nonneg: n_true has {n.numel()} entries for {NW} rows")
    out = torch.empty(NW, dtype=_F32, device=dev)
    if NW * nd == 0:
        return out
    _launch("median_kary_launch", "median_nonneg", model.data_ptr(), n.data_ptr(),
            out.data_ptr(), 0 if n.numel() == 1 else 1, NW, nd,
            31 if _exact(iters) else int(iters), _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K8 and K9: the layout


class LaneLayout(NamedTuple):
    """The grid of K8 and K9: ``chunks`` chunks of ``LANE_W`` walkers (``groups``
    classes of walkers whose rows share their offset within 16 bytes) times
    ``n_seg`` segments of ``seg_len`` points (the last one shorter)."""
    groups: int
    chunks: int
    seg_len: int
    n_seg: int

    @property
    def blocks(self) -> int:
        return self.chunks * self.n_seg


def lane_groups(nd: int) -> int:
    """``4 / gcd(nd, 4)``: rows ``w`` and ``w + G`` of a ``[NW, nd]`` float32 model start
    at the same offset within 16 bytes (``lane_groups`` in the kernel's source)."""
    return 1 if nd % 4 == 0 else (4 if nd % 2 else 2)


def lane_stats_layout(NW: int, nd: int) -> LaneLayout:
    """The layout of K8 and K9 for ``NW`` walkers of ``nd`` points.

    A chunk holds ``LANE_W`` walkers of one class ``w mod G`` (``lane_groups``),
    so its rows share their alignment.  The points are cut into segments of whole
    steps (``LANE_STEP`` points), enough that the chunks times the segments reach
    ``LANE_BLOCKS``, but none shorter than ``LANE_MIN_STEPS`` steps where the
    row has that many: at nd = 65,536, 1,024 walkers (256 chunks) take 16
    segments of 4,096 points, the 171 of the fit's stage 2 (43 chunks) 22 of
    3,072.
    """
    cdiv = lambda a, b: -(-a // b)
    G = lane_groups(nd)
    chunks = G * cdiv(cdiv(NW, G), LANE_W)
    steps = cdiv(nd, LANE_STEP)
    n_seg = max(1, min(cdiv(LANE_BLOCKS, chunks), cdiv(steps, LANE_MIN_STEPS)))
    seg_len = cdiv(steps, n_seg) * LANE_STEP
    return LaneLayout(G, chunks, seg_len, cdiv(nd, seg_len))


def lane_stats_block(layout: LaneLayout, NW: int, nd: int, b: int, offset: int = 0):
    """Block ``b``'s share of the work, the Python twin of ``lane_block`` in
    ``csrc/segmented_stats.cu``: (its walkers, ``lo``, ``hi``, ``a``, ``nq``) with the
    segment ``[lo, hi)``, its scalar head ``[lo, a)``, its body of ``nq`` float4 from
    ``a`` and its scalar tail ``[a + 4 nq, hi)``.  ``offset`` is the model's own
    offset in floats from a 16-byte boundary."""
    k, s = divmod(b, layout.n_seg)
    G, W = layout.groups, LANE_W
    first = k % G + G * W * (k // G)
    walkers = list(range(first, min(NW, first + G * W), G))
    lo = s * layout.seg_len
    hi = min(nd, lo + layout.seg_len)
    off = (offset + first * nd + lo) & 3
    a = min(hi, lo + ((4 - off) & 3))
    return walkers, lo, hi, a, (hi - a) >> 2


def _lane_scratch(layout: LaneLayout, shape: tuple, dev):
    """The segments' partial sums ``[n_seg, *shape]``, or None where one segment
    writes the result itself."""
    return (torch.empty((layout.n_seg, *shape), dtype=_F32, device=dev)
            if layout.n_seg > 1 else None)


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K8: continuum projection partials


def renorm_partials_reference(model, scale, data_flux, Vpinv, recip):
    """Plain PyTorch version of ``renorm_partials``: [NW, 3] float32."""
    f = lambda x: x.to(_F32)
    frac = _div(f(data_flux)[None, :], f(scale)[:, None] * f(model), recip)
    Vp = f(Vpinv)
    return torch.stack([(frac * Vp[k][None, :]).sum(dim=1) for k in range(3)], dim=1)


def renorm_partials(model, scale, data_flux, Vpinv, recip):
    """Continuum projection partials ``div(data, scale * model) @ Vpinv.T``, K8: [NW, 3].

    Args:
        model: [NW, nd] float32 model spectra; scale: [NW] median-match factors.
        data_flux: [nd]; Vpinv: [3, nd]; recip: the reciprocal dial (0 = divide).
    """
    if model.device.type == "cpu":
        return renorm_partials_reference(model, scale, data_flux, Vpinv, recip)
    _require_cuda(model, "renorm_partials")
    return _renorm_partials_launch(model, scale, data_flux, Vpinv, recip)


def _renorm_partials_launch(model, scale, data_flux, Vpinv, recip):
    """K8's checks, buffers and launch on the tensors' device (the wrapper's CUDA path)."""
    dev = model.device
    NW, nd = model.shape
    model, scale, data_flux, Vpinv = (x.contiguous() for x in (model, scale, data_flux, Vpinv))
    for t, name, shape in ((model, "model", (NW, nd)), (scale, "scale", (NW,)),
                           (data_flux, "data_flux", (nd,)), (Vpinv, "Vpinv", (3, nd))):
        _check(t, name, dev, shape)
    out = torch.empty((NW, 3), dtype=_F32, device=dev)
    if NW * nd == 0:
        return out.zero_()
    lay = lane_stats_layout(NW, nd)
    part = _lane_scratch(lay, (NW, 3), dev)
    _launch("renorm_partials_launch", "renorm_partials", model.data_ptr(), scale.data_ptr(),
            data_flux.data_ptr(), Vpinv.data_ptr(), _ptr(part), out.data_ptr(), NW, nd,
            int(recip), lay.seg_len, lay.n_seg, _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K9: chi^2 residual sum


def resid_chi2_reference(model, scale, coeffs, data_flux, data_err, V, recip, renorm=True):
    """Plain PyTorch version of ``resid_chi2``: [NW] float32, non-finite values kept."""
    f = lambda x: x.to(_F32)
    m = f(scale)[:, None] * f(model)
    data = f(data_flux)[None, :]
    if renorm:
        c, VT = f(coeffs), f(V).T
        fitted = c[:, 0:1] * VT[0][None, :] + c[:, 1:2] * VT[1][None, :] + c[:, 2:3] * VT[2][None, :]
        data = _div(data, fitted, recip)
    resid = (m - data) * (1.0 / f(data_err))[None, :]
    return (resid * resid).sum(dim=1)


def resid_chi2(model, scale, coeffs, data_flux, data_err, V, recip, renorm=True):
    """Chi^2 residual sum over nd, K9: [NW] float32.

    ``sum(((scale * model - target) / data_err)^2)`` with ``target = div(data,
    coeffs @ V.T)`` under ``renorm`` and the raw data without (``coeffs`` and
    ``V`` are then not read).  Padded points carry ``data_err = inf`` and add 0.
    """
    if model.device.type == "cpu":
        return resid_chi2_reference(model, scale, coeffs, data_flux, data_err, V, recip, renorm)
    _require_cuda(model, "resid_chi2")
    return _resid_chi2_launch(model, scale, coeffs, data_flux, data_err, V, recip, renorm)


def _resid_chi2_launch(model, scale, coeffs, data_flux, data_err, V, recip, renorm):
    """K9's checks, buffers and launch on the tensors' device (the wrapper's CUDA path).

    ``data_err`` and ``V`` ([nd, 3]) go to the kernel as they are (made contiguous
    if they are not), which takes ``1 / data_err`` and reads V's rows itself."""
    dev = model.device
    NW, nd = model.shape
    model, scale, data_flux, data_err = (x.contiguous() for x in (model, scale, data_flux,
                                                                  data_err))
    checks = [(model, "model", (NW, nd)), (scale, "scale", (NW,)),
              (data_flux, "data_flux", (nd,)), (data_err, "data_err", (nd,))]
    if renorm:
        coeffs, V = coeffs.contiguous(), V.contiguous()
        checks += [(coeffs, "coeffs", (NW, 3)), (V, "V", (nd, 3))]
    else:
        coeffs = V = None
    for t, name, shape in checks:
        _check(t, name, dev, shape)
    out = torch.empty(NW, dtype=_F32, device=dev)
    if NW * nd == 0:
        return out.zero_()
    lay = lane_stats_layout(NW, nd)
    part = _lane_scratch(lay, (NW,), dev)
    _launch("resid_chi2_launch", "resid_chi2", model.data_ptr(), scale.data_ptr(), _ptr(coeffs),
            data_flux.data_ptr(), data_err.data_ptr(), _ptr(V), _ptr(part), out.data_ptr(), NW,
            nd, int(recip), int(bool(renorm)), lay.seg_len, lay.n_seg,
            _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K10: the composition


def _segmented(kernels, Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V, Vpinv, med_data,
               n_data_true, iters, mm_passes, recip, renorm):
    iters, _, recip = _require_dials(iters, mm_passes, recip)
    model_fn, median_fn, partials_fn, resid_fn = kernels
    model = model_fn(Wcomb, av, D_flat, ext_k_data)
    # the annealer's median-only scoring has no alpha^2 protection: exact median
    med = median_fn(model, n_data_true, iters if renorm else 31)
    scale = torch.as_tensor(med_data, device=model.device).to(_F32) / med
    coeffs = partials_fn(model, scale, data_flux, Vpinv, recip) if renorm else None
    total = resid_fn(model, scale, coeffs, data_flux, data_err, V, recip, renorm)
    return total / torch.as_tensor(n_data_true, device=model.device).to(_F32)


def spectrum_chi2_segmented_reference(Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V,
                                      Vpinv, med_data, n_data_true, iters=None, mm_passes=None,
                                      recip=None, renorm=True):
    """Plain PyTorch version of ``spectrum_chi2_segmented`` (the plain K6-K9): [NW] float32."""
    return _segmented(
        (model_extinct_reference, median_nonneg_reference, renorm_partials_reference,
         resid_chi2_reference),
        Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V, Vpinv, med_data, n_data_true,
        iters, mm_passes, recip, renorm)


def spectrum_chi2_segmented(Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V, Vpinv,
                            med_data, n_data_true, iters=None, mm_passes=None, recip=None,
                            renorm=True):
    """Mean spectrum chi^2 for large nd through K6-K9, K10: [NW] float32.

    The semantics of ``batched._spec_chi2_xla`` (renorm) and
    ``_spec_chi2_xla_median_only``: the rank median over the ``n_data_true``
    real points matched to ``med_data``, the degree-2 continuum renorm of the
    data, the residual sum over ``n_data_true``.  ``iters``, ``mm_passes`` and
    ``recip`` are the required pack-time dials; the median runs with ``iters``
    under renorm and exact without.  Arguments as ``cuda_kernels.spectrum_chi2``.
    """
    return _segmented((model_extinct, median_nonneg, renorm_partials, resid_chi2),
                      Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V, Vpinv, med_data,
                      n_data_true, iters, mm_passes, recip, renorm)
