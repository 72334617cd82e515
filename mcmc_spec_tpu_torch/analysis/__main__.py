"""Population-analysis CLI: ``python -m mcmc_spec_tpu_torch.analysis``.

Port of ``python -m mcmc_spec_tpu.analysis`` with the same options and
outputs, without pandas (the card's machine has none): the catalogs are read
and ``derived_star.csv`` / ``derived_planet.csv`` written through
``analysis.table.Table``, with the JAX CLI's header and columns.

The reference's second entry point (``planet_error_analysis.py``) is a script
with hardcoded catalog paths; here the catalogs are arguments:

    python -m mcmc_spec_tpu_torch.analysis \
        --results 'koi*' \
        --star-catalog stars.csv --planet-catalog planets.csv \
        [--cks cks.csv] [--out pop_out]

``stars.csv`` columns: system, kep_teff, kep_teff_err, kep_rstar,
kep_rstar_err [, kep_mstar, kep_pri_prcf, kep_sec_prcf, separation].
``planets.csv`` columns: system, pname, radius, radius_err, teq, period (yr),
period_err [, s, s_err].
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob

import numpy as np

from mcmc_spec_tpu_torch.analysis.table import Table, as_str


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results", required=True,
                    help="glob of per-system result dirs (each with samples.txt etc.)")
    ap.add_argument("--star-catalog", default=None)
    ap.add_argument("--planet-catalog", default=None)
    ap.add_argument("--cks", default=None,
                    help="CSV with Rp [, Per] columns (radius-gap test + CKS KDE)")
    # reference-format catalogs (planet_error_analysis.py:26-124): pass these
    # instead of --star-catalog/--planet-catalog to consume the original files
    ap.add_argument("--all-kois", default=None,
                    help="reference all_kois.csv (NEA cumulative KOI export)")
    ap.add_argument("--stellar-params", default=None,
                    help="reference exoarchive_kepler_stellar_params.tsv")
    ap.add_argument("--furlan-prcf", default=None,
                    help="reference furlan2017_prcf.tsv")
    ap.add_argument("--furlan-sample", default=None,
                    help="reference furlan_sample.tsv (separations)")
    ap.add_argument("--cks-rgap", default=None,
                    help="reference cks_rgap.tsv (3 dtype rows, Samp flag)")
    ap.add_argument("--het-data", default=None,
                    help="HET_data tree (UT*/KOI-{target}_{date}) for obs.txt dates")
    ap.add_argument("--param-files", default=None,
                    help="glob of per-system param files for the obs.txt table")
    ap.add_argument("--out", default="population_out")
    ap.add_argument("--no-plots", action="store_true")
    args = ap.parse_args(argv)

    from mcmc_spec_tpu_torch.analysis.planets import (
        SystemPosteriors,
        observation_table,
        population_analysis,
        scan_het_obs_dates,
    )

    dirs = sorted(d for d in glob(args.results) if os.path.isdir(d))
    if not dirs:
        raise SystemExit(f"no result directories match {args.results!r}")
    systems = []
    for d in dirs:
        name = os.path.basename(d.rstrip("/"))
        if name.startswith("koi"):
            name = name[3:]  # koi0042 -> 0042 (catalog 'system' uses this form)
        try:
            systems.append(SystemPosteriors.from_dir(d, name))
        except Exception as e:
            print(f"[skip] {d}: {e}")
    print(f"loaded {len(systems)} systems")

    if args.all_kois and args.stellar_params:
        from mcmc_spec_tpu_torch.analysis import catalogs as cat

        star_catalog, planet_catalog = cat.build_catalogs(
            [s.name for s in systems],
            cat.load_all_kois(args.all_kois),
            cat.load_kepler_stellar_params(args.stellar_params),
            cat.load_furlan_prcf(args.furlan_prcf) if args.furlan_prcf else None,
            cat.load_furlan_sample(args.furlan_sample) if args.furlan_sample else None,
        )
    elif args.star_catalog and args.planet_catalog:
        # 'system' must stay a string: KOI ids like "0042" would otherwise
        # parse as integers and silently fail to join with result-dir names
        star_catalog = Table.read_csv(args.star_catalog, str_cols=("system",))
        planet_catalog = Table.read_csv(args.planet_catalog, str_cols=("system",))
    else:
        raise SystemExit("pass --star-catalog/--planet-catalog, or the "
                         "reference files via --all-kois/--stellar-params")
    cks_radii, cks_periods = None, None
    if args.cks_rgap:
        from mcmc_spec_tpu_torch.analysis import catalogs as cat

        cks = cat.load_cks_rgap(args.cks_rgap)
    elif args.cks:
        cks = Table.read_csv(args.cks)
    if args.cks_rgap or args.cks:
        cks_radii = np.asarray(cks["Rp"], dtype=np.float64)
        if "Per" in cks:
            cks_periods = np.asarray(cks["Per"], dtype=np.float64)

    ds, dp, stats = population_analysis(
        systems, star_catalog, planet_catalog, out_dir=args.out,
        cks_radii=cks_radii, cks_periods=cks_periods,
        make_plots=not args.no_plots,
    )
    ds.to_csv(os.path.join(args.out, "derived_star.csv"))
    dp.to_csv(os.path.join(args.out, "derived_planet.csv"))

    if args.param_files:
        obs_dates = scan_het_obs_dates(args.het_data) if args.het_data else None
        seps = None
        if "separation" in star_catalog:
            seps = dict(zip(as_str(star_catalog["system"]), star_catalog["separation"]))
        observation_table(sorted(glob(args.param_files)), separations=seps,
                          obs_dates=obs_dates, out_dir=args.out)
        print(f"wrote {os.path.join(args.out, 'obs.txt')}")

    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
