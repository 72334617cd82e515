"""Downstream population analysis: revised exoplanet properties for binary hosts.

Port of ``mcmc_spec_tpu.analysis.planets`` without pandas and sklearn, which
the card's machine does not have: the catalogs and the derived tables are
:class:`~mcmc_spec_tpu_torch.analysis.table.Table` s with the JAX module's
columns and row order, and the period-radius figures' Gaussian kernel density
(sklearn's ``KernelDensity(kernel="gaussian", bandwidth=0.2)`` in JAX) is
computed in numpy (``gaussian_kde_logpdf``).  matplotlib is imported only to
draw.

Re-implements ``planet_error_analysis.py`` (reference, 838 LoC): propagate the
per-system stellar posteriors produced by the fit pipeline into revised planet
radii, equilibrium temperatures, semi-major axes, and instellations, under
both the primary-host and secondary-host hypotheses; aggregate population
statistics; and render the comparison plots.

Inputs are the per-system artifact directories written by the pipeline
(``samples.txt``, ``pri_corr.txt``, ``sec_corr.txt``,
``{primary,secondary}_{mass,lum}_posterior.txt``) plus Kepler-catalog tables
supplied as tables (the reference hardcodes its catalog paths,
``planet_error_analysis.py:26-124``; here they are arguments so the analysis
runs on any archive snapshot).

Key formulas (reference line cites):

* revised planet radius: ``Rp_new = Rp_old * prcf * (Rstar_new/Rstar_old)``
  (``planet_error_analysis.py:183-184``)
* revised Teq: ``Teq_new = Teq_old * (Teff_new/Teff_old) *
  sqrt(Rstar_new/Rstar_old)`` (``:204-205``)
* revised SMA: ``a = (P_yr^2 * M_new)^(1/3)`` (``:216-219``)
* revised instellation: ``S = L_new / a^2`` (``:232``)
* habitable-zone limits: Kopparapu-style polynomials (``:12-22``)
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

import numpy as np

from mcmc_spec_tpu_torch.analysis.table import Table

KDE_BANDWIDTH = 0.2  # the JAX module's KernelDensity bandwidth

# ---------------------------------------------------------------- HZ limits
def max_greenhouse_limit(tstar):
    """Outer HZ edge in Earth-instellation units (planet_error_analysis.py:12-14)."""
    ts = np.asarray(tstar, dtype=np.float64) - 5780.0
    return 0.356 + 6.171e-5 * ts + 1.698e-9 * ts**2 - 3.198e-12 * ts**3 - 5.575e-16 * ts**4


def recent_venus(tstar):
    """Optimistic inner HZ edge (planet_error_analysis.py:16-18)."""
    ts = np.asarray(tstar, dtype=np.float64) - 5780.0
    return 1.776 + 2.136e-4 * ts + 2.533e-8 * ts**2 - 1.332e-11 * ts**3 - 3.097e-15 * ts**4


def runaway_greenhouse(tstar):
    """Conservative inner HZ edge (planet_error_analysis.py:20-22)."""
    ts = np.asarray(tstar, dtype=np.float64) - 5780.0
    return 1.107 + 1.332e-4 * ts + 1.58e-8 * ts**2 - 8.308e-12 * ts**3 - 1.931e-15 * ts**4


def gaussian_kde_logpdf(points, samples, bandwidth: float = KDE_BANDWIDTH,
                        block: int = 4096) -> np.ndarray:
    """Log density at ``points`` [m, d] of a Gaussian kernel density over ``samples``
    [n, d]: ``sklearn.neighbors.KernelDensity(kernel="gaussian", bandwidth=h)``'s
    ``score_samples``, ``logsumexp_i(-|y - x_i|^2 / 2h^2) - log n - d/2 log(2 pi h^2)``,
    in blocks of ``block`` points."""
    from scipy.special import logsumexp

    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    samples = np.atleast_2d(np.asarray(samples, dtype=np.float64))
    n, d = samples.shape
    norm = np.log(n) + 0.5 * d * np.log(2.0 * np.pi * bandwidth**2)
    out = np.empty(len(points))
    for lo in range(0, len(points), block):
        diff = points[lo:lo + block, None, :] - samples[None, :, :]
        out[lo:lo + block] = logsumexp(-0.5 * np.sum(diff**2, axis=-1) / bandwidth**2,
                                       axis=1) - norm
    return out


# ------------------------------------------------------------ posterior IO
@dataclasses.dataclass
class SystemPosteriors:
    """Per-system fit artifacts, loaded from a results directory."""

    name: str
    t1: np.ndarray
    t2: np.ndarray
    r1: np.ndarray
    ratio: np.ndarray
    pri_prcf: np.ndarray
    sec_prcf: np.ndarray
    pri_mass: np.ndarray
    sec_mass: np.ndarray
    pri_lum: np.ndarray
    sec_lum: np.ndarray

    @classmethod
    def from_dir(cls, dirname: str, name: Optional[str] = None) -> "SystemPosteriors":
        samples = np.genfromtxt(os.path.join(dirname, "samples.txt"))
        if samples.shape[1] == 6:
            t1, t2, av, r1, ratio, plx = samples.T
        elif samples.shape[1] == 8:
            # 8-column layout (reference also supports a logg-augmented one,
            # planet_error_analysis.py:129-131)
            t1, t2, _, av, r1, ratio, _, plx = samples.T
        else:
            raise ValueError(f"unexpected samples.txt width {samples.shape[1]}")

        def load(fname):
            return np.genfromtxt(os.path.join(dirname, fname))

        return cls(
            name=name or os.path.basename(dirname.rstrip("/")),
            t1=t1, t2=t2, r1=r1, ratio=ratio,
            pri_prcf=load("pri_corr.txt"),
            sec_prcf=load("sec_corr.txt"),
            pri_mass=load("primary_mass_posterior.txt"),
            sec_mass=load("secondary_mass_posterior.txt"),
            pri_lum=load("primary_lum_posterior.txt"),
            sec_lum=load("secondary_lum_posterior.txt"),
        )

    def subsample(self, n, rng):
        """Random draws matched in length to the prcf posteriors (ref :151-158)."""
        idx = rng.choice(len(self.t1), size=n, replace=len(self.t1) < n)
        return idx


def _pcts(x):
    q16, q50, q84 = np.nanpercentile(np.asarray(x, dtype=np.float64), [16, 50, 84])
    return q50, q84 - q50, q50 - q16


# --------------------------------------------------------- per-planet update
def revise_planet(
    sys_post: SystemPosteriors,
    kep_rstar: float,
    kep_rstar_err: float,
    kep_teff: float,
    kep_teff_err: float,
    planet_radius: float,
    planet_radius_err: float,
    planet_teq: float,
    period_yr: float,
    period_err_yr: float,
    rng=None,
) -> Dict[str, np.ndarray]:
    """Posterior distributions of revised planet properties for one planet.

    Implements planet_error_analysis.py:176-251 for both host hypotheses.
    """
    rng = rng or np.random.RandomState(0)
    n = len(sys_post.pri_prcf)
    idx = sys_post.subsample(n, rng)
    t1, t2 = sys_post.t1[idx], sys_post.t2[idx]
    r1, ratio = sys_post.r1[idx], sys_post.ratio[idx]

    old_rstar = rng.normal(kep_rstar, kep_rstar_err, n)
    # reject negative radius draws (reference redraw loop, :197-202)
    while np.any(old_rstar <= 0):
        bad = old_rstar <= 0
        old_rstar[bad] = rng.normal(kep_rstar, kep_rstar_err, bad.sum())
    old_teff = rng.normal(kep_teff, kep_teff_err, n)
    old_rp = rng.normal(planet_radius, planet_radius_err, n)

    rp_pri = old_rp * sys_post.pri_prcf * (r1 / old_rstar)
    rp_sec = old_rp * sys_post.sec_prcf * (r1 / old_rstar)

    teq_pri = planet_teq * (t1 / old_teff) * np.sqrt(r1 / old_rstar)
    teq_sec = planet_teq * (t2 / old_teff) * np.sqrt((r1 * ratio) / old_rstar)

    period = rng.normal(period_yr, period_err_yr, n)
    sma_pri = (period**2 * sys_post.pri_mass) ** (1.0 / 3.0)
    sma_sec = (period**2 * sys_post.sec_mass) ** (1.0 / 3.0)

    s_pri = sys_post.pri_lum / sma_pri**2
    s_sec = sys_post.sec_lum / sma_sec**2

    return dict(
        rp_pri=rp_pri, rp_sec=rp_sec, teq_pri=teq_pri, teq_sec=teq_sec,
        sma_pri=sma_pri, sma_sec=sma_sec, s_pri=s_pri, s_sec=s_sec,
        prcf_pri=sys_post.pri_prcf * (r1 / old_rstar),
        prcf_sec=sys_post.sec_prcf * (r1 / old_rstar),
    )


# ----------------------------------------------------------- population run
def population_analysis(
    systems: List[SystemPosteriors],
    star_catalog: Table,  # system, kep_teff, kep_teff_err, kep_rstar,
    #               kep_rstar_err, kep_mstar [, kep_pri_prcf, kep_sec_prcf, separation]
    planet_catalog: Table,  # system, pname, radius, radius_err, teq,
    #                 period (yr), period_err, s, s_err
    out_dir: str = ".",
    cks_radii: Optional[np.ndarray] = None,
    cks_periods: Optional[np.ndarray] = None,
    make_plots: bool = True,
    seed: int = 0,
):
    """Full population pass: tables, stats, plots.

    Returns (derived_star Table, derived_planet Table, stats dict).
    """
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    star_rows, planet_rows = [], []
    star_tex = open(os.path.join(out_dir, "star_params.txt"), "a")
    planet_tex = open(os.path.join(out_dir, "revised_radii_teq.txt"), "a")

    by_name = {str(s.name): s for s in systems}
    for srow in star_catalog.rows():
        name = str(srow["system"])
        if name not in by_name:
            continue
        sp = by_name[name]
        n = len(sp.pri_prcf)
        idx = sp.subsample(n, rng)
        t1, t2, r1, ratio = sp.t1[idx], sp.t2[idx], sp.r1[idx], sp.ratio[idx]
        old_rstar = rng.normal(srow["kep_rstar"], srow["kep_rstar_err"], n)
        q = sp.sec_mass / sp.pri_mass

        np_prcf = sp.pri_prcf * (r1 / old_rstar)
        ns_prcf = sp.sec_prcf * (r1 / old_rstar)

        pt = _pcts(t1); st = _pcts(t2); pr = _pcts(r1); sr = _pcts(ratio)
        npf = _pcts(np_prcf); nsf = _pcts(ns_prcf); qq = _pcts(q)
        star_rows.append(dict(
            sname=name, pteff=pt[0], pteff_plus=pt[1], pteff_minus=pt[2],
            steff=st[0], steff_plus=st[1], steff_minus=st[2],
            prad=pr[0], prad_plus=pr[1], prad_minus=pr[2],
            srad=sr[0], srad_plus=sr[1], srad_minus=sr[2],
            p_prcf=npf[0], p_prcf_plus=npf[1], p_prcf_minus=npf[2],
            s_prcf=nsf[0], s_prcf_plus=nsf[1], s_prcf_minus=nsf[2],
            mp=float(np.mean(sp.pri_mass)), ms=float(np.mean(sp.sec_mass)),
            q=qq[0], q_plus=qq[1], q_minus=qq[2],
            kep_teff=srow["kep_teff"], kep_teff_err=srow["kep_teff_err"],
            kep_rstar=srow["kep_rstar"], kep_rstar_err=srow["kep_rstar_err"],
            kep_mstar=srow.get("kep_mstar", np.nan),
            kep_pri_prcf=srow.get("kep_pri_prcf", np.nan),
            kep_sec_prcf=srow.get("kep_sec_prcf", np.nan),
        ))
        # LaTeX star table row (planet_error_analysis.py:170-173)
        star_tex.write(
            r"{} & {:.0f}$^{{+{:.0f}}}_{{-{:.0f}}}$ & {:.0f}$^{{+{:.0f}}}_{{-{:.0f}}}$ & "
            r"{:.0f}$\pm${:.0f} & {:.2f}$^{{+{:.2f}}}_{{-{:.2f}}}$ & "
            r"{:.2f}$^{{+{:.2f}}}_{{-{:.2f}}}$ & {:.2f} $\pm$ {:.2f} & "
            r"{:.2f}$^{{+{:.2f}}}_{{-{:.2f}}}$ & {:.2f}$^{{+{:.2f}}}_{{-{:.2f}}}$\\".format(
                name, *pt, *st, srow["kep_teff"], srow["kep_teff_err"], *pr, *sr,
                srow["kep_rstar"], srow["kep_rstar_err"], *npf, *nsf
            ) + "\n"
        )

        mine = np.array([str(s) == name for s in planet_catalog["system"]], dtype=bool)
        for prow in planet_catalog[mine].rows():
            rev = revise_planet(
                sp, srow["kep_rstar"], srow["kep_rstar_err"], srow["kep_teff"],
                srow["kep_teff_err"], prow["radius"], prow["radius_err"],
                prow["teq"], prow["period"], prow["period_err"], rng,
            )
            rp = (float(np.mean(rev["rp_pri"])),) + tuple(np.nanpercentile(rev["rp_pri"], [84, 16]))
            rs = (float(np.mean(rev["rp_sec"])),) + tuple(np.nanpercentile(rev["rp_sec"], [84, 16]))
            tp = (float(np.mean(rev["teq_pri"])),) + tuple(np.nanpercentile(rev["teq_pri"], [84, 16]))
            ts = (float(np.mean(rev["teq_sec"])),) + tuple(np.nanpercentile(rev["teq_sec"], [84, 16]))
            ssp = (float(np.mean(rev["s_pri"])),) + tuple(np.nanpercentile(rev["s_pri"], [84, 16]))
            sss = (float(np.mean(rev["s_sec"])),) + tuple(np.nanpercentile(rev["s_sec"], [84, 16]))
            planet_rows.append(dict(
                pname=prow["pname"], system=name,
                rp=rp[0], rp_plus=rp[1] - rp[0], rp_minus=rp[0] - rp[2],
                rs=rs[0], rs_plus=rs[1] - rs[0], rs_minus=rs[0] - rs[2],
                tp=tp[0], tp_plus=tp[1] - tp[0], tp_minus=tp[0] - tp[2],
                ts=ts[0], ts_plus=ts[1] - ts[0], ts_minus=ts[0] - ts[2],
                sp=ssp[0], sp_plus=ssp[1] - ssp[0], sp_minus=ssp[0] - ssp[2],
                ss=sss[0], ss_plus=sss[1] - sss[0], ss_minus=sss[0] - sss[2],
                kep_radius=prow["radius"], kep_radius_err=prow["radius_err"],
                kep_teq=prow["teq"], kep_s=prow.get("s", np.nan),
                kep_s_err=prow.get("s_err", np.nan),
                period=prow["period"], period_err=prow.get("period_err", np.nan),
                # host-star links for the s_vs_t / m1_vs_r figures
                host_pteff=pt[0], host_pteff_plus=pt[1], host_pteff_minus=pt[2],
                host_steff=st[0], host_steff_plus=st[1], host_steff_minus=st[2],
                host_kep_teff=srow["kep_teff"],
                host_kep_teff_err=srow["kep_teff_err"],
                host_mp=float(np.mean(sp.pri_mass)),
                host_q_plus=qq[1], host_q_minus=qq[2],
                # projected separation in AU (arcsec * pc), when cataloged
                sep_au=(float(srow["separation"]) * float(srow["distance"])
                        if np.isfinite(srow.get("separation", np.nan))
                        and np.isfinite(srow.get("distance", np.nan)) else np.nan),
            ))
            planet_tex.write(
                r"{} & {:.2f}$^{{+{:.2f}}}_{{-{:.2f}}}$ & {:.2f}$^{{+{:.2f}}}_{{-{:.2f}}}$ & "
                r"{:.2f}$\pm${:.2f}\\".format(
                    prow["pname"], rp[0], rp[1] - rp[0], rp[0] - rp[2],
                    rs[0], rs[1] - rs[0], rs[0] - rs[2],
                    prow["radius"], prow["radius_err"],
                ) + "\n"
            )
    star_tex.close()
    planet_tex.close()

    derived_star = Table.from_rows(star_rows)
    derived_planet = Table.from_rows(planet_rows)

    stats = {}
    if len(derived_star):
        stats["n_stars"] = len(derived_star)
        stats["n_planets"] = len(derived_planet)
        stats["p_prcf_median"] = float(np.nanmedian(derived_star["p_prcf"]))
        stats["s_prcf_median"] = float(np.nanmedian(derived_star["s_prcf"]))
        stats["pteff_shift"] = float(
            np.nanmedian(derived_star["pteff"] - derived_star["kep_teff"])
        )
        stats["steff_shift"] = float(
            np.nanmedian(derived_star["kep_teff"] - derived_star["steff"])
        )
    if len(derived_planet):
        stats["rp_change_frac"] = float(np.nanmedian(
            (derived_planet["rp"] - derived_planet["kep_radius"]) / derived_planet["kep_radius"]
        ))
    if cks_radii is not None and len(derived_planet):
        from scipy.stats import anderson_ksamp

        sel = derived_planet[(derived_planet["kep_radius"] <= 2)
                             & (derived_planet["kep_radius"] >= 0.1)]
        if len(sel) >= 2:
            ad = anderson_ksamp([np.asarray(cks_radii), np.asarray(sel["rp"])])
            stats["anderson_darling_stat"] = float(ad.statistic)
            stats["anderson_darling_pvalue"] = float(ad.pvalue)

    if make_plots and len(derived_planet):
        _population_plots(derived_star, derived_planet, out_dir, cks_radii, cks_periods)
    return derived_star, derived_planet, stats


CONTRAST_KEYS = ["sdss,i", "lp600", "gaia,g", "562", "692", "880", "j", "h", "kp"]


def scan_het_obs_dates(het_data_dir: str) -> dict:
    """Observation dates from an HET data tree (planet_error_analysis.py:800-802).

    The reference globs ``HET_data/UT*/KOI*`` where each spectrum file is named
    ``...KOI-{target}_{date}...``; here any ``UT*`` trimester directory under
    ``het_data_dir`` is scanned.  Returns ``{target: date}`` (first hit wins,
    matching the reference's ``np.where(...)[0]`` pick).
    """
    from glob import glob

    out = {}
    for f in sorted(glob(os.path.join(het_data_dir, "UT*", "KOI*"))):
        base = os.path.basename(f)
        tail = base.split("-")[-1]
        target = tail.split("_")[0]
        parts = tail.split("_")
        if len(parts) > 1 and target not in out:
            out[target] = parts[1].split(".")[0]
    return out


def observation_table(param_files, separations=None, obs_dates=None,
                      out_dir=".", data_dir=None):
    """Giant LaTeX observation table (planet_error_analysis.py:790-838).

    Reads each system's parameter file, computes the spectrum SNR
    (``median(flux)/std(err)``), and tabulates the contrast magnitudes per
    standard filter key; writes ``obs.txt`` (with errors) and
    ``obs_noerr.txt``.  Returns the table.
    """
    from mcmc_spec_tpu_torch.utils.config import FitConfig

    rows = []
    for p in param_files:
        cfg = FitConfig.from_file(p)
        # the reference derives this with p.split('i')[1] (ref :806), which
        # mis-parses any filename with an 'i' before/inside the target id
        # (e.g. 'intermediate_koi2298.txt' -> 'ntermed...'); anchor on the
        # 'koi<digits>' token instead, falling back to the stem
        base = os.path.basename(p)
        m = re.search(r"koi(\d+(?:\.\d+)?)", base, re.IGNORECASE)
        target = m.group(1).split(".")[0] if m else base.split("_")[0].split(".")[0]
        fname = cfg.filename if data_dir is None else os.path.join(data_dir, cfg.filename)
        wl, flux, err = np.genfromtxt(fname, unpack=True)
        snr = int(np.median(flux) / np.std(err)) if np.std(err) > 0 else -99
        row = {"KOI": target,
               "sep": (separations or {}).get(target, np.nan),
               "obsdate": (obs_dates or {}).get(target, ""),
               "snr": snr}
        for key in CONTRAST_KEYS:
            row[key] = np.nan
            row["e_" + key] = np.nan
        for f, m, e in zip(cfg.cfilt, cfg.cmag, cfg.cerr):
            key = f.lower().strip()
            if key in CONTRAST_KEYS:
                row[key] = m
                row["e_" + key] = e
        rows.append(row)
    df = Table.from_rows(rows)

    def _latex(frame, path):
        with open(path, "w") as fh:
            fh.write("\\begin{tabular}{" + "l" * len(frame.columns) + "}\n")
            fh.write(" & ".join(str(c) for c in frame.columns) + " \\\\\n")
            for r in frame.rows():
                cells = ["" if (isinstance(v, float) and np.isnan(v)) else
                         (f"{v:.2f}" if isinstance(v, float) else str(v))
                         for v in r.values()]
                fh.write(" & ".join(cells) + " \\\\\n")
            fh.write("\\end{tabular}\n")

    _latex(df, os.path.join(out_dir, "obs.txt"))
    _latex(df[["KOI", "sep", "obsdate", "snr", *CONTRAST_KEYS]],
           os.path.join(out_dir, "obs_noerr.txt"))
    return df


def _population_plots(derived_star, derived_planet, out_dir, cks_radii, cks_periods):
    """The reference's population figures (planet_error_analysis.py:315-786)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    j = lambda name: os.path.join(out_dir, name)

    # prcf comparison vs Furlan+2017 (when catalog values present)
    if "kep_pri_prcf" in derived_star and np.any(np.isfinite(derived_star["kep_pri_prcf"])):
        plt.figure()
        plt.scatter(derived_star["p_prcf"] / derived_star["kep_pri_prcf"],
                    derived_star["s_prcf"] / derived_star["kep_sec_prcf"],
                    marker=".", s=100, color="k")
        plt.axvline(1, ls="--", color="0.5", label="Agreement")
        plt.axhline(1, ls="--", color="0.5")
        plt.xlabel("Primary PRCF ratio (this work/Furlan+2017)", fontsize=13)
        plt.ylabel("Secondary PRCF ratio (this work/Furlan+2017)", fontsize=13)
        plt.legend(loc="best")
        plt.tight_layout()
        plt.savefig(j("prcf_compare.pdf"))
        plt.close()

    # teff comparison
    fig, ax = plt.subplots()
    ax.scatter(derived_star["kep_teff"], derived_star["pteff"], marker=".", s=100,
               color="darkblue", label="Primary")
    ax.scatter(derived_star["kep_teff"], derived_star["steff"], marker=".", s=100,
               color="darkorange", label="Secondary")
    lims = [derived_star["kep_teff"].min() - 800, derived_star["kep_teff"].max() + 800]
    ax.plot(lims, lims, ls=":", color="k", label="1:1")
    ax.set_xlabel(r"$T_{eff}$ (Kepler; K)", fontsize=14)
    ax.set_ylabel(r"Fitted $T_{eff}$ (this work; K)", fontsize=14)
    ax.legend(loc="best")
    plt.tight_layout()
    plt.savefig(j("teff_diff.pdf"))
    plt.close(fig)

    # teff + radius histograms
    for cols, fname, xlabel in [
        (("kep_teff", "pteff", "steff"), "teff_hist.pdf", "Temperature (K)"),
        (("kep_radius", "rp", "rs"), "radius_hist.pdf", r"$R_{P}$ ($R_\oplus$)"),
    ]:
        src = derived_star if cols[0] == "kep_teff" else derived_planet
        fig, axes = plt.subplots(nrows=3, sharex=True, figsize=(7, 6),
                                 gridspec_kw=dict(hspace=0))
        for ax, col, color in zip(axes, cols, ["k", "darkblue", "darkorange"]):
            ax.hist(src[col], histtype="step", lw=2, color=color, label=col)
            ax.legend(loc="best", fontsize=10)
        axes[-1].set_xlabel(xlabel, fontsize=14)
        plt.tight_layout()
        plt.savefig(j(fname))
        plt.close(fig)

    # revised vs catalog planet radii
    for host, col, err_cols in [("primary", "rp", ("rp_minus", "rp_plus")),
                                ("secondary", "rs", ("rs_minus", "rs_plus"))]:
        fig, ax = plt.subplots()
        ax.scatter(derived_planet["kep_radius"], derived_planet[col], marker=".", s=100,
                   color="darkblue", label=f"{host} host")
        ax.errorbar(derived_planet["kep_radius"], derived_planet[col],
                    xerr=derived_planet["kep_radius_err"],
                    yerr=[derived_planet[err_cols[0]], derived_planet[err_cols[1]]],
                    ls="None", color="darkblue", alpha=0.5, elinewidth=1)
        ax.axhline(1.8, ls="-.", color="0.5", label=r"1.8 R$_\oplus$")
        ax.plot([0.3, 3], [0.3, 3], ls=":", color="0.3", label="1:1")
        ax.set_xlabel(r"R$_p$ (Kepler; R$_\oplus$)", fontsize=14)
        ax.set_ylabel(r"R$_p$ (this work; R$_\oplus$)", fontsize=14)
        ax.legend(loc="best")
        plt.tight_layout()
        plt.savefig(j(f"rp_diff_{host}.pdf"))
        plt.close(fig)

    # instellation vs radius with HZ bands
    for host, rcol, scol in [("primary", "rp", "sp"), ("secondary", "rs", "ss")]:
        fig, ax = plt.subplots()
        ax.scatter(derived_planet[scol], derived_planet[rcol], marker=".", s=100,
                   color="darkblue", label=f"{host} host")
        ax.axvspan(3e2, float(runaway_greenhouse(5870)), alpha=0.1, color="xkcd:bright red")
        ax.axvspan(0, float(max_greenhouse_limit(5870)), alpha=0.1, color="xkcd:azure")
        ax.axhline(1.8, ls="-.", color="0.5", lw=2)
        ax.set_xscale("log")
        ax.invert_xaxis()
        ax.set_xlabel(r"Instellation (S$_\oplus$)", fontsize=14)
        ax.set_ylabel(r"R$_P$ ($R_\oplus$)", fontsize=14)
        ax.legend(loc="best")
        plt.tight_layout()
        plt.savefig(j(f"s_vs_r_{host}.pdf"))
        plt.close(fig)

    # period-radius KDE diagrams (planet_error_analysis.py:495-623): the revised
    # sample against (a) its own KDE, (b) the CKS single-star sample, (c) the
    # pre-revision Kepler sample
    logp = np.log10(np.asarray(derived_planet["period"], float) * 365.25)
    rp = np.asarray(derived_planet["rp"], float)
    rp_err = [np.asarray(derived_planet["rp_minus"], float),
              np.asarray(derived_planet["rp_plus"], float)]

    def _kde_figure(kde_logp, kde_rp, out_name, cmap):
        """Scatter of the revised primary-host sample over a KDE contour of
        the given comparison sample + the Petigura+2022 single-star line."""
        X, Y = np.meshgrid(
            np.arange(-2, max(kde_logp.max(), logp.max()) + 1.5, 0.05),
            np.arange(min(kde_rp.min(), rp.min()) - 0.5,
                      max(kde_rp.max(), rp.max()) + 1.5, 0.05),
        )
        Z = np.exp(gaussian_kde_logpdf(np.vstack([X.ravel(), Y.ravel()]).T,
                                       np.stack([kde_logp, kde_rp], axis=1))).reshape(X.shape)
        fig, ax = plt.subplots()
        cf = ax.contourf(X, Y, Z, cmap=cmap, levels=np.linspace(0, Z.max(), 40),
                         zorder=-99)
        fig.colorbar(cf)
        ax.scatter(logp, rp, marker=".", s=100, color="darkblue", edgecolor="k",
                   label="Primary host", zorder=1)
        ax.errorbar(logp, rp, yerr=rp_err, ls="None", color="darkblue", alpha=0.3,
                    elinewidth=1, zorder=1)
        periods = np.linspace(-2, 4, 100)
        ax.plot(periods, 1.74 * ((10**periods) / 10) ** -0.13, color="k", lw=2,
                ls="--", label="Petigura+2022 (single stars)")
        ax.set_xlabel(r"log$_{10}$(Period) (days)", fontsize=14)
        ax.set_ylabel(r"R$_P$ ($R_\oplus$)", fontsize=14)
        ax.set_xlim(logp.min() - 1, logp.max() + 1)
        ax.set_ylim(max(rp.min() - 0.5, 0.1), rp.max() + 1.5)
        ax.legend(loc="best")
        plt.tight_layout()
        plt.savefig(j(out_name))
        plt.close(fig)

    if len(rp) >= 3:
        _kde_figure(logp, rp, "p_vs_r_primary.pdf", plt.cm.Blues)
        # pre-revision Kepler sample (p_vs_r_primary_before_after, ref :583-623)
        _kde_figure(logp, np.asarray(derived_planet["kep_radius"], float),
                    "p_vs_r_primary_before_after.pdf", plt.cm.Oranges)
        # CKS single-star comparison (p_vs_r_primary_CKS, ref :540-580)
        if cks_radii is not None and cks_periods is not None and len(cks_radii) >= 3:
            _kde_figure(np.log10(np.asarray(cks_periods, float)),
                        np.asarray(cks_radii, float),
                        "p_vs_r_primary_CKS.pdf", plt.cm.Oranges)
        else:
            print("[analysis] no CKS period/radius catalog; "
                  "skipping p_vs_r_primary_CKS.pdf")

    # separation vs revised radius (a_vs_r_primary, ref :626-652)
    if "sep_au" in derived_planet and np.any(np.isfinite(derived_planet["sep_au"])):
        fig, ax = plt.subplots()
        ax.scatter(derived_planet["sep_au"], rp, marker=".", s=100,
                   color="darkblue", label="Primary host")
        ax.errorbar(derived_planet["sep_au"], rp, yerr=rp_err, ls="None",
                    color="darkblue", alpha=0.3, elinewidth=1)
        ax.set_xscale("log")
        ax.set_xlabel("Approx. separation (AU)", fontsize=14)
        ax.set_ylabel(r"R$_P$ ($R_\oplus$)", fontsize=14)
        ax.legend(loc="upper left")
        plt.tight_layout()
        plt.savefig(j("a_vs_r_primary.pdf"))
        plt.close(fig)

    # instellation vs host Teff, revised filled + Kepler hollow
    # (s_vs_t_primary / s_vs_t_secondary, ref :655-677 and :763-786)
    for host, scol, tcol in [("primary", "sp", "host_pteff"),
                             ("secondary", "ss", "host_steff")]:
        fig, ax = plt.subplots()
        ax.scatter(derived_planet[scol], derived_planet[tcol], marker=".", s=100,
                   color="darkblue", label=f"{host.capitalize()} host")
        ax.scatter(derived_planet["kep_s"], derived_planet["host_kep_teff"],
                   marker=".", s=100, edgecolor="darkblue", facecolors="None",
                   label="Kepler")
        ax.errorbar(derived_planet[scol], derived_planet[tcol],
                    xerr=[derived_planet[scol + "_minus"],
                          derived_planet[scol + "_plus"]],
                    yerr=[derived_planet[tcol + "_minus"],
                          derived_planet[tcol + "_plus"]],
                    ls="None", color="darkblue", alpha=0.5, elinewidth=1)
        ax.set_xscale("log")
        ax.invert_xaxis()
        ax.set_xlabel(r"Instellation (S$_\oplus$)", fontsize=14)
        ax.set_ylabel(r"Host $T_{eff}$ (K)", fontsize=14)
        ax.legend(loc="best")
        plt.tight_layout()
        plt.savefig(j(f"s_vs_t_{host}.pdf"))
        plt.close(fig)

    # primary mass vs revised radius (m1_vs_r_primary, ref :680-703)
    fig, ax = plt.subplots()
    ax.scatter(derived_planet["host_mp"], rp, marker=".", s=100, color="darkblue",
               label="Primary host")
    ax.errorbar(derived_planet["host_mp"], rp,
                xerr=[derived_planet["host_q_minus"], derived_planet["host_q_plus"]],
                yerr=rp_err, ls="None", color="darkblue", alpha=0.5, elinewidth=1)
    ax.set_yscale("log")
    ax.set_xlabel(r"Primary star mass ($M_\odot$)", fontsize=14)
    ax.set_ylabel(r"$R_p$ ($R_\oplus$)", fontsize=14)
    ax.legend(loc="best", ncol=2)
    plt.tight_layout()
    plt.savefig(j("m1_vs_r_primary.pdf"))
    plt.close(fig)
