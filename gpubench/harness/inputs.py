"""The benchmark's inputs, made from the configuration, the cell and ``--seed``.

A frozen copy of the construction of ``mcmc_spec_tpu_torch.bench_target``: the
synthetic (Teff, logg) grid of Planck continua with seeded absorption lines (the
stand-in for BT-Settl), broadened to the data resolution inside the data window; an
observed composite at the configuration's truth on the data wavelengths with 1 %
Gaussian errors; Gaussian filter curves (the stand-in for the reference's ``bps/``
files); the builtin MIST 1-Gyr track as data; a constant Av prior; and a
truth-centred walker cloud.  The observed contrasts and photometry come from the
reference's own scalar forward model at truth plus noise.

The grid is computed on the card in float64 in a few large calls; the noise and the
walkers come from one ``torch.Generator`` on the card seeded with ``--seed``.  Both
the program and the reference receive these arrays and nothing else.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.reference.pack import ab_zero_flux, mist_nodes, pack, photon_weights
from gpubench.reference.posterior import forward_bands

_H, _C, _KB = 6.62607015e-27, 2.99792458e10, 1.380649e-16
FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))
LINE_SEED, N_LINES = 20241220, 160
RSUN_CM, PC_CM = 6.957e10, 3.086e18
GM_SUN_OVER_RSUN2 = 27420.0

# (Teff K, R/Rsun, M/Msun, M_H, M_Ks): the builtin ~1-Gyr main-sequence anchors
MIST_ANCHORS = np.array([
    [2560.0, 0.102, 0.075, 10.77, 10.30], [2710.0, 0.124, 0.090, 10.22, 9.78],
    [2850.0, 0.137, 0.102, 9.77, 9.33], [2960.0, 0.155, 0.123, 9.31, 8.90],
    [3060.0, 0.196, 0.162, 8.72, 8.44], [3190.0, 0.258, 0.231, 8.05, 7.83],
    [3340.0, 0.301, 0.290, 7.51, 7.28], [3410.0, 0.336, 0.360, 7.04, 6.82],
    [3550.0, 0.430, 0.440, 6.39, 6.19], [3660.0, 0.496, 0.490, 6.01, 5.84],
    [3770.0, 0.540, 0.530, 5.71, 5.55], [3850.0, 0.588, 0.570, 5.47, 5.31],
    [4015.0, 0.612, 0.590, 5.26, 5.10], [4140.0, 0.640, 0.630, 5.05, 4.91],
    [4410.0, 0.703, 0.680, 4.65, 4.53], [4600.0, 0.735, 0.720, 4.43, 4.32],
    [4830.0, 0.760, 0.750, 4.21, 4.11], [5040.0, 0.786, 0.780, 4.01, 3.93],
    [5280.0, 0.815, 0.830, 3.80, 3.73], [5490.0, 0.880, 0.930, 3.58, 3.52],
    [5660.0, 0.950, 0.970, 3.40, 3.35], [5770.0, 1.000, 1.000, 3.28, 3.24],
    [5930.0, 1.060, 1.060, 3.13, 3.09], [6120.0, 1.146, 1.180, 2.95, 2.92],
    [6340.0, 1.220, 1.250, 2.77, 2.74], [6510.0, 1.290, 1.330, 2.63, 2.60],
    [6720.0, 1.360, 1.440, 2.47, 2.45], [7030.0, 1.450, 1.540, 2.27, 2.25],
    [7220.0, 1.510, 1.610, 2.15, 2.13], [7500.0, 1.600, 1.700, 1.99, 1.97],
    [8000.0, 1.690, 1.850, 1.76, 1.74], [8750.0, 1.970, 2.000, 1.44, 1.42],
    [9700.0, 2.190, 2.180, 1.11, 1.08],
])


def mist_matrix(n_rows: int = 240) -> np.ndarray:
    """The builtin track in the isochrone file's column layout (1 log age, 3 mass,
    4 Teff, 5 logg, 6 L; Teff and L de-logged), monotone cubics in log Teff."""
    from scipy.interpolate import PchipInterpolator

    teff, rad, mass = MIST_ANCHORS[:, 0], MIST_ANCHORS[:, 1], MIST_ANCHORS[:, 2]
    lt = np.log10(teff)
    ltg = np.unique(np.concatenate([np.linspace(lt[0], lt[-1], n_rows), lt]))
    radg = 10.0 ** PchipInterpolator(lt, np.log10(rad))(ltg)
    massg = 10.0 ** PchipInterpolator(lt, np.log10(mass))(ltg)
    mat = np.zeros((len(ltg), 17))
    mat[:, 0] = np.arange(len(ltg))
    mat[:, 1] = 9.0
    mat[:, 3] = massg
    mat[:, 4] = 10.0**ltg
    mat[:, 5] = np.log10(GM_SUN_OVER_RSUN2 * massg / radg**2)
    mat[:, 6] = 10.0 ** (2.0 * np.log10(radg) + 4.0 * np.log10(10.0**ltg / 5772.0))
    return mat


def _lines(device):
    rng = np.random.RandomState(LINE_SEED)
    cols = [rng.uniform(3200.0, 29000.0, N_LINES), rng.uniform(1.5, 12.0, N_LINES),
            rng.uniform(0.05, 0.65, N_LINES), rng.uniform(-0.25, 0.4, N_LINES)]
    return [torch.as_tensor(c, dtype=torch.float64, device=device) for c in cols]


def synthetic_grid(grid: dict, step: float, device):
    """(temps, loggs, wl, flux [nT, nG, nwl]) on ``device`` in float64."""
    f64 = dict(dtype=torch.float64, device=device)
    temps = torch.arange(grid["temps"][0], grid["temps"][1] + 1.0, grid["temps"][2], **f64)
    loggs = torch.as_tensor(grid["loggs"], **f64)
    lo, hi = grid["specrange"]
    wl = torch.arange(lo, hi, step, **f64)
    T = temps.repeat_interleave(len(loggs))[:, None]
    g = loggs.repeat(len(temps))[:, None]
    lam = wl[None, :] * 1e-8
    x = torch.clamp(_H * _C / (lam * _KB * T), 1e-9, 500.0)
    flux = math.pi * (2.0 * _H * _C**2 / lam**5 / torch.expm1(x)) * 1e-8
    cool = torch.clamp((4800.0 - T) / 1800.0, 0.0, 1.2)
    flux = flux * (1.0 - 0.35 * cool * (0.5 + 0.5 * torch.sin(wl / 350.0))
                   * torch.exp(-0.5 * ((wl - 6500.0) / 2600.0) ** 2))
    tfac = torch.clamp((7000.0 - T) / 4000.0, 0.05, 1.2)
    log_depth = torch.zeros_like(flux)
    for c, w, s, gs in zip(*_lines(device)):
        strength = torch.clamp(s * tfac * (1.0 + gs * (g - 4.5)), 0.0, 0.92)
        log_depth += torch.log1p(-strength * torch.exp(-0.5 * ((wl - c) / w) ** 2))
    for c in (7665.0, 7699.0):
        s = torch.clamp(0.25 + 0.3 * (g - 4.0), 0.0, 0.9) * torch.clamp(tfac, 0.0, 1.0)
        log_depth += torch.log1p(-s * torch.exp(-0.5 * ((wl - c) / 6.0) ** 2))
    flux = flux * torch.exp(log_depth)
    flux = flux * (1.0 - 0.5 * cool * torch.exp(-0.5 * ((wl - 3600.0) / 900.0) ** 2))
    flux = _broaden_window(wl, flux, grid["data_window"], grid["resolution"])
    return temps, loggs, wl, flux.reshape(len(temps), len(loggs), -1)


def _broaden_window(wl, flux, window, resolution, maxsig=5.0):
    """Gaussian instrumental broadening (FWHM mean(wl)/R, unit-sum kernel out to
    ``maxsig`` sigma, 'same' convolution, the first 5 and last 10 points clamped) inside
    the data window only; the flanks keep the native spectrum."""
    inside = (wl >= min(window)) & (wl <= max(window))
    if int(inside.sum()) < 32:
        return flux
    seg_wl, seg = wl[inside], flux[:, inside]
    dx = float(seg_wl[1] - seg_wl[0])
    sigma = float(seg_wl.mean()) / resolution * FWHM_TO_SIGMA
    half = max(1, int(maxsig * sigma / dx))
    offs = torch.arange(-half, half + 1, dtype=torch.float64, device=wl.device) * dx
    kern = torch.exp(-0.5 * (offs / sigma) ** 2)
    kern = kern / kern.sum()
    n, k = seg.shape[1], kern.shape[0]
    nfft = 1 << (n + k).bit_length()
    full = torch.fft.irfft(torch.fft.rfft(seg, nfft) * torch.fft.rfft(kern, nfft), nfft)
    out = full[:, (k - 1) // 2:(k - 1) // 2 + n].clone()
    out[:, :5] = out[:, 5:6]
    out[:, n - 10:] = out[:, n - 11:n - 10]
    flux = flux.clone()
    flux[:, inside] = out
    return flux


def gaussian_filter(f: dict, n: int = 256) -> dict:
    wl = np.linspace(f["center"] - 4 * f["width"], f["center"] + 4 * f["width"], n)
    return {"name": f["name"], "wl": wl,
            "tr": np.exp(-0.5 * ((wl - f["center"]) / f["width"]) ** 2)}


def _composite(grid_np, mist, truth, nspec):
    """The composite flux at truth on the grid's wavelengths (host float64)."""
    temps, loggs, wl, flux = grid_np
    teff_n, logg_n, _ = mist_nodes(mist)
    plx, r1 = truth[-1], truth[nspec + 1]
    ratios = np.concatenate([[1.0], truth[nspec + 2:2 * nspec + 1]])
    comp = np.zeros_like(wl)
    for k in range(nspec):
        logg = np.interp(truth[k], teff_n, logg_n)
        ti = int(np.clip(np.searchsorted(temps, truth[k], side="right") - 1, 0, len(temps) - 2))
        gi = int(np.clip(np.searchsorted(loggs, logg, side="right") - 1, 0, len(loggs) - 2))
        tw = (truth[k] - temps[ti]) / (temps[ti + 1] - temps[ti])
        gw = (logg - loggs[gi]) / (loggs[gi + 1] - loggs[gi])
        f0 = flux[ti, gi] * (1 - gw) + flux[ti, gi + 1] * gw
        f1 = flux[ti + 1, gi] * (1 - gw) + flux[ti + 1, gi + 1] * gw
        comp += (r1 * ratios[k] * RSUN_CM * plx / PC_CM) ** 2 * (f0 * (1 - tw) + f1 * tw)
    return comp


def make_target(cfg: dict, grid_np, mist, nd: int, n_contrast: int, gen) -> dict:
    """One target's inputs: its data, filters, observations and priors."""
    temps, loggs, wl, flux = grid_np
    truth = np.asarray(cfg["truth"], np.float64)
    nspec = cfg["nspec"]
    data_wl_um = np.linspace(cfg["data"]["wl_um"][0], cfg["data"]["wl_um"][1], nd)
    obs = np.interp(data_wl_um * 1e4, wl, _composite(grid_np, mist, truth, nspec))
    dev = gen.device
    noise = lambda k: torch.randn(k, generator=gen, dtype=torch.float64, device=dev).cpu().numpy()
    err = cfg["data"]["flux_err_frac"] * np.abs(obs)
    obs = obs + err * noise(nd)
    med = np.median(obs)
    phot = [gaussian_filter(f) for f in cfg["phot_filters"]]
    prior_mu, prior_sig = np.zeros(len(truth)), np.ones(len(truth))
    prior_mu[-1], prior_sig[-1] = truth[-1], cfg["plx_prior_sig"]
    inp = {
        "nspec": nspec, "grid_temps": temps, "grid_loggs": loggs, "grid_wl": wl,
        "grid_flux": flux, "data_wl_um": data_wl_um, "data_flux": obs / med,
        "data_err": err / med,
        "contrast_filters": [gaussian_filter(f) for f in cfg["contrast_filters"][:n_contrast]],
        "cerr": np.full(n_contrast, cfg["cerr"]),
        "phot_filters": phot,
        "phot_zp": np.array([ab_zero_flux(photon_weights(f["wl"], f["wl"], f["tr"])[1])
                             for f in phot]),
        "perr": np.full(len(cfg["phot_filters"]), cfg["perr"]),
        "mist_matrix": mist, "av_dist_pc": np.array([1.0, 30000.0]),
        "av_mu": np.full(2, cfg["av_prior"]["mu"]), "av_sig": np.full(2, cfg["av_prior"]["sig"]),
        "prior_mu": prior_mu, "prior_sig": prior_sig,
    }
    inp["cmag"], inp["pmag"] = np.zeros(n_contrast), np.zeros(len(cfg["phot_filters"]))
    ref = pack(inp)
    cmag, pmag = forward_bands(truth, ref)
    inp["cmag"] = cmag + cfg["contrast_noise"] * noise(n_contrast)
    inp["pmag"] = pmag + cfg["phot_noise"] * noise(len(pmag))
    ref["cmag"], ref["pmag"] = inp["cmag"], inp["pmag"]
    return inp, ref


def walker_cloud(cfg: dict, shape: tuple, gen) -> torch.Tensor:
    """Walkers [*shape, 6] around truth, float32 on the generator's device."""
    dev = gen.device
    truth = torch.as_tensor(cfg["truth"], dtype=torch.float32, device=dev)
    scale = torch.as_tensor(cfg["walker_cloud"], dtype=torch.float32, device=dev)
    return truth + torch.randn((*shape, len(cfg["truth"])), generator=gen, dtype=torch.float32,
                               device=dev) * scale


def make_inputs(cfg: dict, cell: dict, seed: int, device) -> dict:
    """Every target's inputs and references, the walkers and the sampler's seed.  A test
    on the CPU may give ``cell`` smaller sizes: ``nd`` (every target's) and ``grid_step``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    step = cell.get("grid_step", cfg["grid"]["step"])
    temps, loggs, wl, flux = synthetic_grid(cfg["grid"], step, device)
    grid_np = tuple(x.cpu().numpy() for x in (temps, loggs, wl, flux))
    del temps, loggs, wl, flux
    mist = mist_matrix()
    targets = []
    for t in cfg["targets"]:
        nd = cell.get("nd", t["nd"])
        targets.append(make_target(cfg, grid_np, mist, nd, t["n_contrast"], gen))
    walkers = walker_cloud(cfg, (len(targets), cell["walkers"]), gen)
    sampler_seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=device))
    return {"targets": targets, "walkers": walkers, "sampler_seed": sampler_seed}
