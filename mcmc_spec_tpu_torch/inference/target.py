"""PackedTarget: everything one fit target needs, as torch tensors.

Port of ``mcmc_spec_tpu.inference.target``.  ``pack_target`` precomputes, in
host numpy, every linear projection of the model grid the posterior needs
(the grid on the data wavelengths ``D``, per-gridpoint filter fluxes ``Fc``
and ``Fp``, CCM89 ``k(lambda)``, the continuum-renorm matrices and the
lookup-table nodes) and places them on one device.

``target_from_jax`` is the bridge from the JAX package: it takes a JAX
``PackedTarget`` (any field ``np.asarray`` accepts), single or a stacked
fleet, and returns this port's target with identical fields and meta,
without importing JAX.

Targets live on the card unless the caller asks for the CPU
(``device="cpu"``).  ``promoted`` gives a target's float fields in a wider
dtype, the way JAX promotes a float32 target against float64 walkers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from mcmc_spec_tpu_torch.models.dust import AvProfile
from mcmc_spec_tpu_torch.models.grid import SpectralGrid
from mcmc_spec_tpu_torch.models.mist import MistTable
from mcmc_spec_tpu_torch.ops.continuum import polyfit_renorm_matrix
from mcmc_spec_tpu_torch.ops.extinction import ccm89
from mcmc_spec_tpu_torch.ops.interp import interp1d_weights
from mcmc_spec_tpu_torch.ops.photometry import FilterCurve, contrast_weights, photon_flux_weights
from mcmc_spec_tpu_torch.utils import flags

RSUN_CM = 6.957e10
PC_CM = 3.086e18

DATA_FIELDS = (
    "temps", "loggs", "D", "data_flux", "data_err", "ext_k_data", "V", "Vpinv",
    "Fc", "cmag", "cerr", "Fp", "phot_zp", "ext_k_cwl", "pmag", "perr",
    "mist_teff_nodes", "mist_logg_nodes", "mist_lum_nodes",
    "av_logd_nodes", "av_mu_nodes", "av_sig_nodes",
    "tmin", "tmax", "prior_mu", "prior_sig",
    "med_data", "n_data_true", "n_contrast_true", "n_phot_true",
)
INT_FIELDS = ("n_data_true", "n_contrast_true", "n_phot_true")
META_FIELDS = (
    "nspec", "dist_fit", "rad_prior", "fit_plx", "spectrum_weight",
    "spectrum_backend", "median_iters", "eval_block", "matmul_passes",
    "recip_newton", "rad_sigma_frac",
)


@dataclasses.dataclass
class PackedTarget:
    """Device-resident fit target: the JAX package's fields, as torch tensors.

    Fields are treated as immutable once packed: derive a variant with
    ``dataclasses.replace``, which also drops the kernel-table cache.
    """

    # --- static config
    nspec: int
    dist_fit: bool
    rad_prior: bool
    fit_plx: bool  # p carries a parallax entry (ndim = 2*nspec+2)
    spectrum_weight: float  # 1.0 reference, 0.0 = photometry-only (nospec)
    spectrum_backend: str  # "auto" | "xla" (padded targets force the composition)

    # --- grid axes
    temps: Any  # [nT]
    loggs: Any  # [nG]

    # --- spectrum block
    D: Any  # [nT, nG, nd] grid on the data wavelength grid
    data_flux: Any  # [nd]
    data_err: Any  # [nd]
    ext_k_data: Any  # [nd] CCM89 A/Av at data wavelengths
    V: Any  # [nd, 3] scaled-domain Vandermonde
    Vpinv: Any  # [3, nd]

    # --- contrast block
    Fc: Any  # [nT, nG, nc]
    cmag: Any  # [nc]
    cerr: Any  # [nc]

    # --- photometry block
    Fp: Any  # [nT, nG, npf]
    phot_zp: Any  # [npf]
    ext_k_cwl: Any  # [npf]
    pmag: Any  # [npf]
    perr: Any  # [npf]

    # --- lookup-table nodes (tent interpolation)
    mist_teff_nodes: Any
    mist_logg_nodes: Any
    mist_lum_nodes: Any
    av_logd_nodes: Any
    av_mu_nodes: Any
    av_sig_nodes: Any

    # --- prior scalars
    tmin: Any
    tmax: Any
    prior_mu: Any  # [ndim] gaussian prior means (0 = disabled)
    prior_sig: Any  # [ndim]

    # --- padding-aware statistics (0-d tensors)
    med_data: Any
    n_data_true: Any
    n_contrast_true: Any
    n_phot_true: Any

    # --- pack-time dials (0 / -1 = unset; the kernel wrappers raise on unset)
    median_iters: int = 0
    eval_block: int = 0  # JAX walker-block size; the port has no walker blocks
    matmul_passes: int = 0
    recip_newton: int = -1
    rad_sigma_frac: float = 0.02

    # f32 kernel operand tables, built on first kernel use (ops.cuda_kernels)
    _kernel_tables: Optional[dict] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # targets derived from this one without copying data: promoted dtypes,
    # a fleet's per-target views
    _derived: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def ndim(self) -> int:
        return 2 * self.nspec + 2 if self.fit_plx else 2 * self.nspec

    @property
    def n_contrast(self) -> int:
        return self.cmag.shape[-1]

    @property
    def n_phot(self) -> int:
        return self.pmag.shape[-1]

    @property
    def n_data(self) -> int:
        return self.data_flux.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.D.device


def pad_nd_arrays(D, data_flux, data_err, ext_k_data, V, Vpinv, extra: int):
    """Inert sentinel padding of the data-wavelength axis (host numpy).

    Padded points carry ``err=inf``, zero data, zero ``Vpinv`` columns,
    ``V`` rows [1, 0, 0] and model sentinel 1e30, so rank-based medians,
    the renorm fit and the residual sum are unchanged.
    """
    nT, nG, _ = D.shape
    D = np.concatenate([D, np.full((nT, nG, extra), 1e30, dtype=D.dtype)], axis=2)
    data_flux = np.concatenate([data_flux, np.zeros(extra, dtype=data_flux.dtype)])
    data_err = np.concatenate([data_err, np.full(extra, np.inf, dtype=data_err.dtype)])
    ext_k_data = np.concatenate([ext_k_data, np.zeros(extra, dtype=ext_k_data.dtype)])
    V = np.concatenate(
        [V, np.tile(np.asarray([[1.0, 0.0, 0.0]], dtype=V.dtype), (extra, 1))], axis=0)
    Vpinv = np.concatenate([Vpinv, np.zeros((3, extra), dtype=Vpinv.dtype)], axis=1)
    return D, data_flux, data_err, ext_k_data, V, Vpinv


def pack_target(
    grid: SpectralGrid,
    data_wl_um: np.ndarray,
    data_flux: np.ndarray,
    data_err: np.ndarray,
    contrast_filters: Sequence[FilterCurve],
    cmag: Sequence[float],
    cerr: Sequence[float],
    phot_filters: Sequence[FilterCurve],
    phot_zero_flux: Sequence[float],
    pmag: Sequence[float],
    perr: Sequence[float],
    mist: MistTable,
    av_profile: AvProfile,
    nspec: int = 2,
    dist_fit: bool = True,
    rad_prior: bool = False,
    fit_plx: bool = True,
    spectrum_weight: float = 1.0,
    prior_mu: Optional[np.ndarray] = None,
    prior_sig: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device="cuda",
    pad_nd: Optional[int] = None,
    pad_nc: Optional[int] = None,
    rad_sigma_frac: Optional[float] = None,
) -> PackedTarget:
    """Precompute every linear projection and lookup table for one target.

    ``data_*`` must already be masked, windowed and median-normalised.
    ``pad_nd``/``pad_nc`` pad the data/contrast axes with inert sentinels and
    force the torch composition (``spectrum_backend="xla"``).
    """
    data_wl_aa = np.asarray(data_wl_um, dtype=np.float64) * 1e4

    idx, w = interp1d_weights(grid.wl, data_wl_aa)
    D = grid.flux[:, :, idx] * (1.0 - w) + grid.flux[:, :, idx + 1] * w

    nT, nG, _ = grid.flux.shape
    flat = grid.flux.reshape(nT * nG, -1)
    Fc_cols = [flat @ contrast_weights(grid.wl, fc.wl, fc.tr) for fc in contrast_filters]
    Fc = np.stack(Fc_cols, axis=-1).reshape(nT, nG, -1) if Fc_cols else np.zeros((nT, nG, 0))
    Fp_cols, cwls = [], []
    for fp in phot_filters:
        Wp, _ = photon_flux_weights(grid.wl, fp.wl, fp.tr)
        Fp_cols.append(flat @ Wp)
        cwls.append(fp.cwl)
    Fp = np.stack(Fp_cols, axis=-1).reshape(nT, nG, -1) if Fp_cols else np.zeros((nT, nG, 0))

    V, Vpinv = polyfit_renorm_matrix(data_wl_aa, deg=2)
    mist_teff, mist_logg, mist_lum = mist.device_nodes(dtype, device)
    av_logd, av_mu, av_sig = av_profile.device_nodes(dtype, device)

    ndim = 2 * nspec + 2 if fit_plx else 2 * nspec
    if prior_mu is None:
        prior_mu = np.zeros(ndim)
    if prior_sig is None:
        prior_sig = np.ones(ndim)

    n_data_true = len(np.asarray(data_flux))
    n_contrast_true = len(contrast_filters)
    n_phot_true = len(phot_filters)
    med_data = float(np.median(np.asarray(data_flux)))
    data_flux = np.asarray(data_flux, dtype=np.float64)
    data_err = np.asarray(data_err, dtype=np.float64)
    ext_k_data = np.asarray(ccm89(data_wl_aa, 1.0), dtype=np.float64)
    cmag = np.asarray(cmag, dtype=np.float64)
    cerr = np.asarray(cerr, dtype=np.float64)
    backend = "auto"
    if pad_nd is not None and pad_nd > n_data_true:
        backend = "xla"
        D, data_flux, data_err, ext_k_data, V, Vpinv = pad_nd_arrays(
            D, data_flux, data_err, ext_k_data, V, Vpinv, pad_nd - n_data_true)
    if pad_nc is not None and pad_nc > n_contrast_true:
        extra = pad_nc - n_contrast_true
        backend = "xla"
        Fc = np.concatenate([Fc, np.ones((nT, nG, extra))], axis=2)
        cmag = np.concatenate([cmag, np.zeros(extra)])
        cerr = np.concatenate([cerr, np.full(extra, np.inf)])

    as_dev = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    as_int = lambda x: torch.as_tensor(x, dtype=torch.int32, device=device)
    ext_k_cwl = ccm89(np.asarray(cwls, dtype=np.float64), 1.0) if cwls else np.zeros(0)
    return PackedTarget(
        nspec=int(nspec),
        dist_fit=bool(dist_fit),
        rad_prior=bool(rad_prior),
        fit_plx=bool(fit_plx),
        spectrum_weight=float(spectrum_weight),
        spectrum_backend=backend,
        median_iters=flags.median_iters(),
        matmul_passes=flags.matmul_passes(),
        recip_newton=flags.recip_newton(),
        rad_sigma_frac=float(rad_sigma_frac) if rad_sigma_frac is not None else 0.02,
        temps=as_dev(grid.temps),
        loggs=as_dev(grid.loggs),
        D=as_dev(D),
        data_flux=as_dev(data_flux),
        data_err=as_dev(data_err),
        ext_k_data=as_dev(ext_k_data),
        V=as_dev(V),
        Vpinv=as_dev(Vpinv),
        Fc=as_dev(Fc),
        cmag=as_dev(cmag),
        cerr=as_dev(cerr),
        Fp=as_dev(Fp),
        phot_zp=as_dev(phot_zero_flux),
        ext_k_cwl=as_dev(ext_k_cwl),
        pmag=as_dev(pmag),
        perr=as_dev(perr),
        mist_teff_nodes=mist_teff,
        mist_logg_nodes=mist_logg,
        mist_lum_nodes=mist_lum,
        av_logd_nodes=av_logd,
        av_mu_nodes=av_mu,
        av_sig_nodes=av_sig,
        tmin=as_dev(float(grid.temps.min())),
        tmax=as_dev(float(grid.temps.max())),
        prior_mu=as_dev(prior_mu),
        prior_sig=as_dev(prior_sig),
        med_data=as_dev(med_data),
        n_data_true=as_int(n_data_true),
        n_contrast_true=as_int(n_contrast_true),
        n_phot_true=as_int(n_phot_true),
    )


def target_from_jax(jax_target, device="cuda", dtype=torch.float32) -> PackedTarget:
    """This port's ``PackedTarget`` from a JAX-package ``PackedTarget``.

    Duck-typed: every data field goes through ``np.asarray`` (JAX arrays,
    numpy arrays and Python scalars all do), float fields are cast to
    ``dtype`` and the ``n_*_true`` counts to int32; the meta fields are
    copied unchanged.  A stacked JAX fleet (``inference.fleet.stack_targets``,
    a leading target axis on every field) comes across as a stacked fleet.
    """
    fields = {}
    for name in DATA_FIELDS:
        arr = np.asarray(getattr(jax_target, name))
        fields[name] = torch.tensor(  # copies: JAX exports read-only buffers
            arr, dtype=torch.int32 if name in INT_FIELDS else dtype, device=device)
    for name in META_FIELDS:
        fields[name] = getattr(jax_target, name)
    return PackedTarget(**fields)


def promoted(tgt: PackedTarget, dtype: torch.dtype) -> PackedTarget:
    """``tgt`` with every float field in ``dtype``, built once per dtype and cached."""
    if tgt.D.dtype == dtype:
        return tgt
    if dtype not in tgt._derived:
        tgt._derived[dtype] = dataclasses.replace(tgt, **{
            name: getattr(tgt, name).to(dtype) for name in DATA_FIELDS if name not in INT_FIELDS})
    return tgt._derived[dtype]


def common_dtype(p: torch.Tensor, tgt: PackedTarget):
    """(p, tgt) both in ``torch.promote_types(p.dtype, target dtype)``, as JAX promotes."""
    dtype = torch.promote_types(p.dtype, tgt.D.dtype)
    return p.to(dtype), promoted(tgt, dtype)


def _target_view(fleet: PackedTarget, i: int) -> PackedTarget:
    """Target ``i`` of a stacked fleet: every field sliced, nothing copied."""
    return dataclasses.replace(fleet, **{name: getattr(fleet, name)[i] for name in DATA_FIELDS})


def target_views(fleet: PackedTarget) -> list:
    """Every target of a stacked fleet as a ``PackedTarget`` view, cached on the fleet."""
    if "views" not in fleet._derived:
        fleet._derived["views"] = [_target_view(fleet, i) for i in range(fleet.D.shape[0])]
    return fleet._derived["views"]
