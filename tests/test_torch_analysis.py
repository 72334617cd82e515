"""PyTorch port: the population analysis without pandas and sklearn, against the JAX package (CPU).

Three synthetic systems' result directories (``testing.write_result_dir``, the
JAX analysis test's fixture) and the reference's catalog files
(written here in the formats ``analysis/catalogs.py`` parses) go through both
packages:

* the catalog loaders and ``build_catalogs``: every column equal (strings) or
  within rtol 1e-12 (numbers), rows in the same order;
* ``population_analysis`` from the same catalogs and seed: every column of
  ``derived_star`` and ``derived_planet`` and every statistic within rtol
  1e-12, the LaTeX tables byte for byte, and the port's figure set;
* ``observation_table`` and ``scan_het_obs_dates``: the same table and files;
* the KDE of the period-radius figures against ``sklearn``'s
  ``KernelDensity(kernel="gaussian", bandwidth=0.2).score_samples`` within
  1e-10 (the log density against one leaf, the density against the default
  tree: ``test_kde_is_sklearn`` says why);
* the CLI with plain catalogs and with the reference's: ``derived_star.csv``
  and ``derived_planet.csv`` with JAX's header and columns;
* and the whole run again with ``sys.modules["pandas"]`` and
  ``sys.modules["sklearn"]`` set to None: the port imports neither.
"""
import os
import sys

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from mcmc_spec_tpu.analysis import catalogs as jcat  # noqa: E402
from mcmc_spec_tpu.analysis import planets as jpl  # noqa: E402
from mcmc_spec_tpu.analysis.__main__ import main as jmain  # noqa: E402
from mcmc_spec_tpu_torch.analysis import catalogs as tcat  # noqa: E402
from mcmc_spec_tpu_torch.analysis import planets as tpl  # noqa: E402
from mcmc_spec_tpu_torch.analysis.__main__ import main as tmain  # noqa: E402
from mcmc_spec_tpu_torch.analysis.table import Table  # noqa: E402
from mcmc_spec_tpu_torch.testing import write_result_dir  # noqa: E402

RTOL = 1e-12
SYSTEMS = ("2298", "0268", "0042")
FIGURES = ["prcf_compare.pdf", "teff_diff.pdf", "teff_hist.pdf", "radius_hist.pdf",
           "rp_diff_primary.pdf", "rp_diff_secondary.pdf", "s_vs_r_primary.pdf",
           "s_vs_r_secondary.pdf", "p_vs_r_primary.pdf", "p_vs_r_primary_CKS.pdf",
           "p_vs_r_primary_before_after.pdf", "a_vs_r_primary.pdf", "s_vs_t_primary.pdf",
           "s_vs_t_secondary.pdf", "m1_vs_r_primary.pdf"]


def _write_catalogs(root):
    """The reference's five catalogs, and plain star/planet/CKS CSVs."""
    j = lambda name: os.path.join(root, name)
    with open(j("all_kois.csv"), "w") as f:
        f.write("# NEA cumulative export\n"
                "KIC ID,KOI,Radius (R_Earth),Radius error,Eq Temp (K),Period (days),"
                "Period error,Insolation (Earth flux),Insolation error,"
                "Planet Radius/Stellar Radius,Planet Rad/Stellar Rad error\n"
                "10000001,2298.01,2.1,0.2,700,10.0,0.01,50,5,0.02,0.002\n"
                "10000001,2298.02,1.1,0.1,500,36.525,0.02,12,2,0.011,0.001\n"
                "10000002,268.01,3.0,0.4,900,3.65,0.01,150,20,0.03,0.004\n"
                "10000003,42.01,1.6,0.15,650,22.1,0.03,30,4,0.015,0.0015\n"
                "10000003,42.02,0.9,0.08,480,61.7,0.05,9,1,0.009,0.001\n"
                "10000099,9999.01,9.0,0.9,100,365.25,0.1,1,0.1,0.09,0.009\n")
    with open(j("stellar.tsv"), "w") as f:
        f.write("kepid\tteff\tteff_err1\tteff_err2\tradius\tradius_err1\tradius_err2\tmass\tdist\n"
                "10000001\t5100\t80\t-120\t0.9\t0.05\t-0.03\t0.85\t350\n"
                "10000002\t6000\t100\t-90\t1.2\t0.08\t-0.1\t1.1\t500\n"
                "10000003\t4700\t90\t-70\t0.72\t0.04\t-0.05\t0.76\t410\n")
    with open(j("furlan_prcf.tsv"), "w") as f:
        f.write("KOI\tOrbit\tAvg\n2298\tprimary  \t1.12\n2298\tcompanion\t2.30\n"
                "268\tprimary  \t1.05\n268\tcompanion\t1.80\n042\tprimary  \t1.07\n")
    with open(j("furlan_sample.tsv"), "w") as f:
        f.write("KOI\tSep\n2298 \t0.53\n268 \t1.20\n042\t0.8\n")
    with open(j("cks_rgap.tsv"), "w") as f:
        rng = np.random.RandomState(7)
        f.write("name\tRp\tPer\tSamp\n---\t---\t---\t---\nstr\tfloat\tfloat\tstr\n"
                "x\ty\tw\tz\n")
        for i in range(60):
            f.write(f"K{i}\t{rng.uniform(0.8, 3.0):.4f}\t{rng.uniform(1.0, 100.0):.3f}\t"
                    f"{1 if i % 5 else 0}\n")
    pd.DataFrame(dict(
        system=list(SYSTEMS), kep_teff=[5100.0, 6000.0, 4700.0], kep_teff_err=[80.0, 100.0, 90.0],
        kep_rstar=[0.9, 1.2, 0.72], kep_rstar_err=[0.05, 0.08, 0.04], kep_mstar=[0.85, 1.1, 0.76],
        kep_pri_prcf=[1.12, 1.05, np.nan], kep_sec_prcf=[2.3, 1.8, np.nan],
        separation=[0.53, 1.2, 0.8], distance=[350.0, 500.0, 410.0],
    )).to_csv(j("stars.csv"), index=False)
    pd.DataFrame(dict(
        system=["2298", "2298", "0268", "0042"], pname=["2298.01", "2298.02", "268.01", "42.01"],
        radius=[2.1, 1.1, 3.0, 1.6], radius_err=[0.2, 0.1, 0.4, 0.15],
        teq=[700.0, 500.0, 900.0, 650.0], period=[0.0274, 0.1, 0.01, 0.0605],
        period_err=[3e-5, 5e-5, 3e-5, 8e-5], s=[50.0, 12.0, 150.0, 30.0],
        s_err=[5.0, 2.0, 20.0, 4.0],
    )).to_csv(j("planets.csv"), index=False)
    rng = np.random.RandomState(1)
    pd.DataFrame(dict(Rp=rng.uniform(0.8, 3.0, 80), Per=rng.uniform(1.0, 100.0, 80))).to_csv(
        j("cks.csv"), index=False)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("analysis"))
    for i, name in enumerate(SYSTEMS):
        write_result_dir(r, name, seed=i)
    _write_catalogs(r)
    return r


def _assert_columns(got: Table, want, rtol=RTOL):
    """Every column of the port's table against the JAX DataFrame's, in order."""
    assert got.columns == list(want.columns)
    assert len(got) == len(want)
    for name in want.columns:
        w, g = want[name].to_numpy(), got[name]
        if w.dtype == object:
            assert [str(v) for v in g] == [str(v) for v in w], name
        else:
            np.testing.assert_allclose(np.asarray(g, dtype=np.float64), w.astype(np.float64),
                                       rtol=rtol, atol=0, err_msg=name)


def _ref_catalogs(mod, root):
    j = lambda name: os.path.join(root, name)
    return mod.build_catalogs(list(SYSTEMS), mod.load_all_kois(j("all_kois.csv")),
                              mod.load_kepler_stellar_params(j("stellar.tsv")),
                              mod.load_furlan_prcf(j("furlan_prcf.tsv")),
                              mod.load_furlan_sample(j("furlan_sample.tsv")))


@pytest.mark.parametrize("loader,fname", [
    ("load_all_kois", "all_kois.csv"), ("load_kepler_stellar_params", "stellar.tsv"),
    ("load_furlan_prcf", "furlan_prcf.tsv"), ("load_furlan_sample", "furlan_sample.tsv"),
    ("load_cks_rgap", "cks_rgap.tsv"),
])
def test_catalog_loaders_are_jax(root, loader, fname):
    path = os.path.join(root, fname)
    _assert_columns(getattr(tcat, loader)(path), getattr(jcat, loader)(path))


def test_build_catalogs_is_jax(root):
    for got, want in zip(_ref_catalogs(tcat, root), _ref_catalogs(jcat, root), strict=True):
        _assert_columns(got, want)
    assert tcat._short("0042") == "042" and tcat._SEPARATION_FIXES == jcat._SEPARATION_FIXES


def _systems(mod, root):
    return [mod.SystemPosteriors.from_dir(os.path.join(root, f"koi{s}"), s) for s in SYSTEMS]


@pytest.fixture(scope="module")
def populations(root, tmp_path_factory):
    """Both packages' population_analysis on the reference catalogs, plots off in JAX
    (its figures need sklearn) and on in the port."""
    star_j, planet_j = _ref_catalogs(jcat, root)
    star_t, planet_t = _ref_catalogs(tcat, root)
    cks = jcat.load_cks_rgap(os.path.join(root, "cks_rgap.tsv"))
    outs = {k: str(tmp_path_factory.mktemp(f"pop_{k}")) for k in ("jax", "port")}
    j = jpl.population_analysis(_systems(jpl, root), star_j, planet_j, out_dir=outs["jax"],
                                cks_radii=cks["Rp"].to_numpy(), cks_periods=cks["Per"].to_numpy(),
                                make_plots=False, seed=3)
    t = tpl.population_analysis(_systems(tpl, root), star_t, planet_t, out_dir=outs["port"],
                                cks_radii=cks["Rp"].to_numpy(), cks_periods=cks["Per"].to_numpy(),
                                make_plots=True, seed=3)
    return j, t, outs


@pytest.mark.parametrize("which", [0, 1], ids=["derived_star", "derived_planet"])
def test_population_tables_are_jax(populations, which):
    j, t, _ = populations
    _assert_columns(t[which], j[which])


def test_population_stats_and_latex_are_jax(populations):
    (_, _, js), (_, _, ts), outs = populations
    assert sorted(ts) == sorted(js) and "anderson_darling_stat" in ts
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=RTOL, err_msg=k)
    for name in ("star_params.txt", "revised_radii_teq.txt"):
        with open(os.path.join(outs["jax"], name)) as a, open(os.path.join(outs["port"], name)) as b:
            assert a.read() == b.read(), name
    got = sorted(f for f in os.listdir(outs["port"]) if f.endswith(".pdf"))
    assert got == sorted(FIGURES)


def test_kde_is_sklearn():
    """sklearn's default tree (leaf_size 40) bounds its nodes' sums and drifts by up to
    7e-8 in the log density far in the tails (log density below -18 here); with one leaf
    it sums every kernel as the port does.  So: the log density against one leaf within
    1e-10 and against the sum in long double within 1e-13; the density, which the figures
    draw, against the default tree within 1e-10."""
    from sklearn.neighbors import KernelDensity

    rng = np.random.RandomState(0)
    samples = np.column_stack([rng.normal(1.0, 0.5, 300), rng.normal(2.0, 0.7, 300)])
    points = np.column_stack([rng.uniform(-1, 3, 2000), rng.uniform(0, 4, 2000)])
    got = tpl.gaussian_kde_logpdf(points, samples, block=512)
    kde = lambda **kw: KernelDensity(kernel="gaussian", bandwidth=0.2, **kw).fit(
        samples).score_samples(points)
    np.testing.assert_allclose(got, kde(leaf_size=len(samples)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.exp(got), np.exp(kde()), rtol=0, atol=1e-10)
    P, S, h = (np.asarray(x, dtype=np.longdouble) for x in (points, samples, 0.2))
    exact = np.log(np.exp(-0.5 * ((P[:, None, :] - S[None]) ** 2).sum(-1) / h**2).sum(1)) \
        - np.log(np.longdouble(len(samples))) - np.log(2 * np.pi * h**2)
    np.testing.assert_allclose(got, exact.astype(np.float64), rtol=0, atol=1e-13)


def _param_file(root, name, koi):
    datafile = os.path.join(root, "spec.txt")
    rng = np.random.RandomState(0)
    np.savetxt(datafile, np.column_stack([np.linspace(0.65, 0.84, 100), 1 + 0.01 * rng.randn(100),
                                          0.01 * np.abs(rng.randn(100)) + 0.005]))
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(f"models synthetic\ndirname koi{koi}\nfname t\nfilename {datafile}\n"
                "cmag [2.08,1.3]\ncerr [0.14,0.02]\ncfilt ['lp600','Kp']\n"
                "pmag [13.0,12.0,11.0]\nperr [0.1,0.1,0.1]\npfilt ['j','h','k']\n")
    return path


def test_observation_table_is_jax(tmp_path):
    for ut, names in (("UT21-2-011", ["KOI-0042_20210403.txt"]),
                      ("UT22-3-016", ["KOI-2298_20220811.txt", "KOI-0042_20221201.txt"])):
        os.makedirs(tmp_path / ut)
        for n in names:
            (tmp_path / ut / n).write_text("")
    dates = tpl.scan_het_obs_dates(str(tmp_path))
    assert dates == jpl.scan_het_obs_dates(str(tmp_path))
    params = [_param_file(str(tmp_path), "param_koi0042.txt", "0042"),
              _param_file(str(tmp_path), "initial_param_koi2298.txt", "2298")]
    outs = {}
    for tag, mod in (("jax", jpl), ("port", tpl)):
        outs[tag] = tmp_path / tag
        os.makedirs(outs[tag])
        df = mod.observation_table(params, separations={"0042": 0.5}, obs_dates=dates,
                                   out_dir=str(outs[tag]))
        outs[tag + "_table"] = df
    _assert_columns(outs["port_table"], outs["jax_table"])
    for name in ("obs.txt", "obs_noerr.txt"):
        assert (outs["port"] / name).read_text() == (outs["jax"] / name).read_text(), name


def _cli_runs(root, out, main, reference):
    argv = ["--results", os.path.join(root, "koi*"), "--out", out, "--no-plots"]
    if reference:
        argv += ["--all-kois", os.path.join(root, "all_kois.csv"),
                 "--stellar-params", os.path.join(root, "stellar.tsv"),
                 "--furlan-prcf", os.path.join(root, "furlan_prcf.tsv"),
                 "--furlan-sample", os.path.join(root, "furlan_sample.tsv"),
                 "--cks-rgap", os.path.join(root, "cks_rgap.tsv")]
    else:
        argv += ["--star-catalog", os.path.join(root, "stars.csv"),
                 "--planet-catalog", os.path.join(root, "planets.csv"),
                 "--cks", os.path.join(root, "cks.csv")]
    main(argv)


@pytest.mark.parametrize("reference", [False, True], ids=["plain_catalogs", "reference_catalogs"])
def test_cli_writes_the_jax_tables(root, tmp_path, reference):
    for tag, main in (("jax", jmain), ("port", tmain)):
        _cli_runs(root, str(tmp_path / tag), main, reference)
    for name in ("derived_star.csv", "derived_planet.csv"):
        want = pd.read_csv(tmp_path / "jax" / name)
        got = Table.read_csv(tmp_path / "port" / name)
        _assert_columns(got, want)
        with open(tmp_path / "jax" / name) as a, open(tmp_path / "port" / name) as b:
            assert a.readline() == b.readline()  # the header


def test_the_analysis_runs_without_pandas_and_sklearn(root, tmp_path, monkeypatch):
    """Everything above that the port runs, in a process where pandas and sklearn cannot be
    imported: the catalogs, the population pass with its figures, the CLI."""
    for name in ("pandas", "sklearn", "sklearn.neighbors"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    star, planet = _ref_catalogs(tcat, root)
    cks = tcat.load_cks_rgap(os.path.join(root, "cks_rgap.tsv"))
    out = str(tmp_path / "pop")
    ds, dp, stats = tpl.population_analysis(_systems(tpl, root), star, planet, out_dir=out,
                                            cks_radii=cks["Rp"], cks_periods=cks["Per"], seed=3)
    assert len(ds) == 3 and len(dp) == 5 and stats["n_planets"] == 5
    assert sorted(f for f in os.listdir(out) if f.endswith(".pdf")) == sorted(FIGURES)
    for reference in (False, True):
        cli_out = str(tmp_path / f"cli_{reference}")
        _cli_runs(root, cli_out, tmain, reference)
        n_planets = 5 if reference else 4  # the reference catalogs hold KOI 42.02 too
        assert len(Table.read_csv(os.path.join(cli_out, "derived_planet.csv"))) == n_planets
    tpl.observation_table([_param_file(str(tmp_path), "param_koi0042.txt", "0042")],
                          out_dir=str(tmp_path))
    assert (tmp_path / "obs.txt").exists()
