"""Loaders for the reference's population-analysis catalog files (port of ``mcmc_spec_tpu.analysis.catalogs``).

``planet_error_analysis.py`` reads five hardcoded catalogs (ref :26-124):

* ``targets/targets_kep/all_kois.csv``     — cumulative KOI table (NEA export)
* ``Rgap/exoarchive_kepler_stellar_params.tsv`` — Kepler stellar parameters
* ``Rgap/furlan2017_prcf.tsv``             — Furlan+2017 radius-correction factors
* ``targets/targets_kep/furlan_sample.tsv``— Furlan sample separations
* ``cks_rgap.tsv``                         — CKS radius-gap comparison sample

This module parses those exact formats and reproduces the reference's join
logic into the two tables ``analysis.planets.population_analysis`` consumes,
as the JAX module does, with :class:`~mcmc_spec_tpu_torch.analysis.table.Table`
in place of pandas (the card's machine has none): the same columns, values
and row order.
"""
from __future__ import annotations

import numpy as np

from mcmc_spec_tpu_torch.analysis.table import Table, as_str, to_numeric

__all__ = [
    "load_all_kois",
    "load_kepler_stellar_params",
    "load_furlan_prcf",
    "load_furlan_sample",
    "load_cks_rgap",
    "build_catalogs",
]

# the reference hand-patches four separations after the Furlan join
# (planet_error_analysis.py:119-122)
_SEPARATION_FIXES = {"5971": 0.043, "7099": 0.084, "7716": 0.086, "8077": 0.070}


def _strip(col) -> np.ndarray:
    return np.array([s.strip() for s in as_str(col)], dtype=object)


def load_all_kois(path) -> Table:
    """The cumulative KOI planet table (``all_kois.csv``, ref :26).

    Expected columns (NEA cumulative export): ``KIC ID``, ``KOI``,
    ``Radius (R_Earth)``, ``Radius error``, ``Eq Temp (K)``, ``Period (days)``,
    ``Period error``, ``Insolation (Earth flux)``, ``Insolation error``,
    ``Planet Radius/Stellar Radius``, ``Planet Rad/Stellar Rad error``.
    """
    t = Table.read_table(path)
    # period + error converted days -> years up front (ref :46-47)
    return Table({
        "kic": as_str(t["KIC ID"]),
        "pname": as_str(t["KOI"]),
        "radius": to_numeric(t["Radius (R_Earth)"]),
        "radius_err": to_numeric(t["Radius error"]),
        "teq": to_numeric(t["Eq Temp (K)"]),
        "period": to_numeric(t["Period (days)"]) / 365.25,
        "period_err": to_numeric(t["Period error"]) / 365.25,
        "s": to_numeric(t["Insolation (Earth flux)"]),
        "s_err": to_numeric(t["Insolation error"]),
        "rp_rstar": to_numeric(t["Planet Radius/Stellar Radius"]),
        "rp_rstar_err": to_numeric(t["Planet Rad/Stellar Rad error"]),
    })


def load_kepler_stellar_params(path) -> Table:
    """Exoplanet-archive Kepler stellar table (ref :58-76).

    Expected columns: ``kepid``, ``teff``, ``teff_err1``, ``teff_err2``,
    ``radius``, ``radius_err1``, ``radius_err2``, ``mass``, ``dist``.
    """
    t = Table.read_table(path)
    # symmetric error = np.max([err2, err1]) on the SIGNED values
    # (planet_error_analysis.py:105-106): archive exports carry err2 <= 0,
    # so this always selects err1 (the upper error) — matched exactly, NOT
    # max(|err1|, |err2|)
    return Table({
        "kepid": np.asarray(t["kepid"]).astype(np.int64),
        "kep_teff": to_numeric(t["teff"]),
        "kep_teff_err": np.maximum(to_numeric(t["teff_err1"]), to_numeric(t["teff_err2"])),
        "kep_rstar": to_numeric(t["radius"]),
        "kep_rstar_err": np.maximum(to_numeric(t["radius_err1"]),
                                    to_numeric(t["radius_err2"])),
        "kep_mstar": to_numeric(t["mass"]),
        "distance": to_numeric(t["dist"]),
    })


def load_furlan_prcf(path) -> Table:
    """Furlan+2017 planet-radius correction factors (ref :68-88).

    Expected columns: ``KOI``, ``Orbit`` (``primary``/``companion``, possibly
    space-padded as in the machine-readable table), ``Avg``.
    """
    t = Table.read_table(path)
    return Table({"koi": _strip(t["KOI"]), "orbit": _strip(t["Orbit"]),
                  "avg": to_numeric(t["Avg"])})


def load_furlan_sample(path) -> Table:
    """Furlan sample with companion separations (``KOI``, ``Sep``; ref :90-99)."""
    t = Table.read_table(path)
    return Table({"koi": _strip(t["KOI"]), "sep": to_numeric(t["Sep"])})


def load_cks_rgap(path, skip_dtype_rows: int = 3) -> Table:
    """CKS radius-gap sample (ref :124-125): drop the 3 header/dtype rows the
    machine-readable table carries, keep ``Samp == 1`` rows; needs ``Rp`` and
    (for the KDE diagrams) ``Per`` columns."""
    t = Table.read_table(path)
    if skip_dtype_rows:
        t = t[np.arange(skip_dtype_rows, len(t))]
    t = t[_strip(t["Samp"]) == "1"]
    out = Table({"Rp": to_numeric(t["Rp"])})
    if "Per" in t:
        out["Per"] = to_numeric(t["Per"])
    return out[~np.isnan(out["Rp"])]


def _short(koi: str) -> str:
    """'0268' -> '268': strip exactly ONE leading zero, as the reference's
    ``targets_short`` loop does (planet_error_analysis.py:70-74
    ``t[1:] if t[0] == '0' else t``).  For ids with two or more leading
    zeros ('0042' -> '042') the reference therefore misses Furlan rows keyed
    without padding — matched verbatim so joins hit/miss the same rows."""
    return koi[1:] if koi[:1] == "0" else koi


def _lookup(table: Table, key_col: str, val_col: str, key: str) -> float:
    """The first ``val_col`` of the rows whose ``key_col`` is ``key``, else NaN."""
    hit = np.flatnonzero(table[key_col] == key)
    return float(table[val_col][hit[0]]) if len(hit) else np.nan


def build_catalogs(targets, all_kois: Table, stellar_params: Table, furlan_prcf=None,
                   furlan_sample=None):
    """Reproduce the reference's join logic (ref :28-122).

    ``targets``: zero-padded KOI system numbers (e.g. ``["2298", "0268"]``)
    — the reference derives them from ``koi*`` result directory names.
    Returns ``(star_catalog, planet_catalog)`` tables for
    :func:`mcmc_spec_tpu_torch.analysis.planets.population_analysis`.
    """
    targets = [str(t) for t in targets]
    t_ints = {int(float(t)) for t in targets}

    # planets belonging to the targets: KOI 'nnnn.pp' matches system int
    sys_of = np.array([int(float(p)) for p in all_kois["pname"]], dtype=np.int64)
    planet = all_kois[np.isin(sys_of, list(t_ints))]
    planet["system"] = np.array([str(s).zfill(4) for s in sys_of[np.isin(sys_of, list(t_ints))]],
                                dtype=object)

    # one stellar row per distinct KIC, in target order (ref :54-66)
    rows = []
    for t in targets:
        sys_planets = planet[planet["system"] == t.zfill(4)]
        if len(sys_planets) == 0:
            continue
        kic = int(float(sys_planets["kic"][0]))
        match = np.flatnonzero(stellar_params["kepid"] == kic)
        row = {"system": t.split(".")[0]}
        if len(match):
            # a DataFrame row of numeric columns is float64 throughout
            row.update({k: float(v) for k, v in stellar_params.row(match[0]).items()
                        if k != "kepid"})
        rows.append(row)
    star = Table.from_rows(rows)

    if furlan_prcf is not None and len(star):
        pri = furlan_prcf[furlan_prcf["orbit"] == "primary"]
        sec = furlan_prcf[furlan_prcf["orbit"] == "companion"]
        star["kep_pri_prcf"] = np.array([_lookup(pri, "koi", "avg", _short(s))
                                         for s in star["system"]])
        star["kep_sec_prcf"] = np.array([_lookup(sec, "koi", "avg", _short(s))
                                         for s in star["system"]])
    if furlan_sample is not None and len(star):
        sep = np.array([_lookup(furlan_sample, "koi", "sep", _short(s))
                        for s in star["system"]])
        for sysno, fix in _SEPARATION_FIXES.items():
            sep[np.array([s.lstrip("0") == sysno for s in star["system"]], dtype=bool)] = fix
        star["separation"] = sep

    return star, planet
