"""PyTorch port: ``compat``, ``ops.misc``, the rest of ``ops.broaden``, ``utils.profiling``
and the package's public names, against the JAX package (CPU).

The host functions take the same numpy inputs on both sides and agree within
rtol 1e-12; ``instrumental_broaden_fft`` (``torch.fft`` against ``jnp.fft``)
in float64 within 1e-12 of the flux scale.  The port's ``__init__`` files
export every public name of the JAX package's that the port has.
"""
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu import compat as jc  # noqa: E402
from mcmc_spec_tpu.models.grid import SpectralGrid as JGrid  # noqa: E402
from mcmc_spec_tpu.models.mist import MistTable as JMist  # noqa: E402
from mcmc_spec_tpu.ops import broaden as jb  # noqa: E402
from mcmc_spec_tpu.ops import misc as jm  # noqa: E402
from mcmc_spec_tpu_torch import compat as tc  # noqa: E402
from mcmc_spec_tpu_torch.models.grid import SpectralGrid as TGrid  # noqa: E402
from mcmc_spec_tpu_torch.ops import broaden as tb  # noqa: E402
from mcmc_spec_tpu_torch.ops import misc as tm  # noqa: E402

RTOL = 1e-12
WL = np.linspace(6000.0, 8000.0, 2001)
FLUX = 1.0 + 0.3 * np.sin(WL / 17.0) + 0.1 * np.cos(WL / 3.1)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=RTOL, atol=0)


def _grid(cls):
    temps, loggs = np.array([3000.0, 3200.0, 3400.0]), np.array([4.0, 4.5, 5.0])
    wl = np.linspace(5000.0, 9000.0, 400)
    flux = (temps[:, None, None] / 3000.0) * (1 + 0.1 * loggs[None, :, None]) \
        * (1 + 0.2 * np.sin(wl / 50.0))[None, None, :]
    return cls(temps=temps, loggs=loggs, wl=wl, flux=flux)


@pytest.mark.parametrize("name,args", [
    ("bccorr", (WL, 12.5, -3.0)),
    ("extinct", (WL, FLUX, 0.7)),
    ("extinct", (1e4 / WL, FLUX, 0.4, 3.3, "invum")),
    ("find_nearest", (WL, 7123.4)),
    ("chisq", (FLUX, FLUX * 1.01, 0.02 * FLUX)),
    ("norm_spec", (WL, FLUX, FLUX * (1 + 1e-5 * (WL - 7000.0)))),
    ("interp_2_spec", (FLUX, 2 * FLUX, 3000.0, 3200.0, 3050.0)),
    ("interp_2_spec", (FLUX, FLUX[:-1], 3000.0, 3200.0, 3050.0)),
    ("gauss", (WL, 7000.0, 30.0, 2.0)),
    ("bimodal", (WL, 6800.0, 30.0, 2.0, 7300.0, 50.0, 1.0)),
    ("make_reg", (WL, FLUX, (6500.0, 7000.0))),
    ("redres", (WL, FLUX, 3)),
    ("broaden", (WL, FLUX, 3000.0)),
    ("broaden", (WL, FLUX, 3000.0, 30.0, 0.6)),
])
def test_host_function_is_jax(name, args):
    got, want = getattr(tc, name)(*args), getattr(jc, name)(*args)
    if isinstance(want, str):
        assert got == want
    elif isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            _close(g, w)
    else:
        _close(got, want)


@pytest.mark.parametrize("name", ["get_radius", "get_logg"])
def test_mist_functions_are_jax(name):
    matrix = JMist.builtin().matrix
    teff = np.array([3100.0, 3650.0, 4480.0, 5210.0])
    _close(getattr(tc, name)(teff, matrix), getattr(jc, name)(teff, matrix))


def test_make_varied_param_is_jax():
    init, sig = [4600.0, [0.5, 0.2], 3.0], [50.0, [0.01, 0.02], 0.1]
    np.random.seed(3)
    want = jc.make_varied_param(init, sig)
    np.random.seed(3)
    got = tc.make_varied_param(init, sig)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


@pytest.mark.parametrize("models,metal", [("btsettl", 0), ("hires", 0), ("hires", -0.5)])
def test_find_model_is_jax(models, metal):
    for t, g in ((3400, 4.5), (5200.0, 5.0)):
        assert tc.find_model(t, g, metal, models) == jc.find_model(t, g, metal, models)
        assert tc.find_model(t, g, metal, models, grid_dir="d") == \
            jc.find_model(t, g, metal, models, grid_dir="d")


@pytest.mark.parametrize("band", ["lp600", "Kp", "sdss,r", "j", "k"])
def test_get_transmission_is_jax(band, tmp_path):
    from mcmc_spec_tpu_torch.testing import write_filter_curves

    write_filter_curves(str(tmp_path))
    got, want = tc.get_transmission(band, 1700, str(tmp_path)), \
        jc.get_transmission(band, 1700, str(tmp_path))
    for g, w in zip(got, want, strict=True):
        _close(g, w)


@pytest.mark.parametrize("source", ["grid", "dict"])
@pytest.mark.parametrize("kw", [{}, {"normalize": True, "wlunit": "um"}])
def test_get_spec_is_jax(source, kw):
    jg, tg = _grid(JGrid), _grid(TGrid)
    if source == "dict":
        d = {"wl": jg.wl}
        for i, t in enumerate(jg.temps):
            for k, g in enumerate(jg.loggs):
                d[f"{int(t)}, {g}"] = jg.flux[i, k]
        jg = tg = d
    reg = (0.6, 0.75)
    for got, want in zip(tc.get_spec(3110.0, 4.7, reg, tg, **kw),
                         jc.get_spec(3110.0, 4.7, reg, jg, **kw), strict=True):
        _close(got, want)


# ---------------------------------------------------------------- ops
def test_misc_ops_are_jax():
    for wl in (WL, list(WL[:5]), torch.as_tensor(WL)):
        got = tm.bccorr(wl, 8.0, 1.5)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
        _close(got.numpy(), jm.bccorr(np.asarray(wl), 8.0, 1.5))
    for v in (6000.0, 7000.49, 7000.51, 9999.0):
        assert int(tm.find_nearest(WL, v)) == int(jm.find_nearest(WL, v))


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("res", [1700.0, 5000.0])
def test_instrumental_broaden_fft_is_jax(res, clamp):
    got = tb.instrumental_broaden_fft(WL, torch.as_tensor(FLUX), res, clamp_edges=clamp)
    want = np.asarray(jb.instrumental_broaden_fft(WL, jnp.asarray(FLUX), res, clamp_edges=clamp))
    assert got.dtype == torch.float64 and got.shape == (len(WL),)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(FLUX).max())
    # and the host convolution, away from the edges where both are the same sum
    host = tb.instrumental_broaden(WL, FLUX, res, clamp_edges=clamp)[1]
    np.testing.assert_allclose(got.numpy()[20:-20], host[20:-20], rtol=1e-10)


@pytest.mark.parametrize("vsini,eps", [(20.0, 0.6), (80.0, 0.3), (1e-3, 0.6)])
def test_rotational_broaden_is_jax(vsini, eps):
    _close(tb.rotational_broaden(WL, FLUX, vsini, eps), jb.rotational_broaden(WL, FLUX, vsini, eps))


def test_make_reg_is_jax():
    for rng in ((6200.0, 6900.0), (7900.0, 6100.0)):
        for g, w in zip(tb.make_reg(WL, FLUX, rng), jb.make_reg(WL, FLUX, rng), strict=True):
            _close(g, w)


# ---------------------------------------------------------------- profiling
def test_stage_timer_counts_the_first_call_apart():
    from mcmc_spec_tpu.utils.profiling import StageTimer as JTimer
    from mcmc_spec_tpu_torch.utils.profiling import StageTimer

    timers = (StageTimer(), JTimer())
    for t in timers:
        for _ in range(3):
            with t.stage("eval"):
                pass
        with t.stage("once"):
            pass
    got, want = (t.report().splitlines() for t in timers)
    assert got[0] == want[0] and len(got) == len(want) == 3
    assert [line.split()[0] for line in got[1:]] == ["eval", "once"]
    assert got[1].split()[-1] == "2" and got[2].split()[-1] == "0"
    assert timers[0].counts["eval"] == 2 and list(timers[0].first) == ["eval", "once"]


def test_trace_writes_a_chrome_trace(tmp_path):
    from mcmc_spec_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert any("cumsum" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


# ---------------------------------------------------------------- public names
@pytest.mark.parametrize("pkg", ["", ".inference", ".ops", ".models", ".io", ".report",
                                 ".parallel", ".analysis"])
def test_public_names_are_the_jax_packages_the_port_has(pkg):
    """Every name a JAX ``__init__`` exports is exported by the port's ``__init__`` where
    the port has it, from the port's module of the same name."""
    jax_pkg = importlib.import_module("mcmc_spec_tpu" + pkg)
    port_pkg = importlib.import_module("mcmc_spec_tpu_torch" + pkg)
    jax_dir = os.path.dirname(jax_pkg.__file__)
    for name in [n for n in vars(jax_pkg) if not n.startswith("_")]:
        obj = getattr(jax_pkg, name)
        mod = getattr(obj, "__module__", None)
        if not (mod and mod.startswith("mcmc_spec_tpu.")) or name == "annotations":
            continue
        port_mod = importlib.import_module(mod.replace("mcmc_spec_tpu.", "mcmc_spec_tpu_torch.",
                                                       1))
        if not hasattr(port_mod, name):
            continue  # not in the port (e.g. walker_sharding: a placement of JAX arrays)
        if (pkg, name) == (".report", "corner_plot"):
            continue  # the function would hide its module there (report/__init__.py)
        assert getattr(port_pkg, name) is getattr(port_mod, name), (pkg, name)
    assert os.path.isdir(jax_dir)
