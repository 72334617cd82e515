"""PyTorch port: target packing and the JAX bridge against the JAX package (CPU, f64)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.bench_target import build_bench_target as jax_build_bench_target  # noqa: E402
from mcmc_spec_tpu.inference.target import pack_target as jax_pack_target  # noqa: E402
from mcmc_spec_tpu_torch.bench_target import build_bench_target  # noqa: E402
from mcmc_spec_tpu_torch.inference.target import (  # noqa: E402
    DATA_FIELDS,
    META_FIELDS,
    pack_target,
    target_from_jax,
)
from mcmc_spec_tpu_torch.models.dust import AvProfile  # noqa: E402
from mcmc_spec_tpu_torch.models.grid import SpectralGrid  # noqa: E402
from mcmc_spec_tpu_torch.models.mist import MistTable  # noqa: E402
from mcmc_spec_tpu_torch.ops.photometry import FilterCurve  # noqa: E402
from tests.helpers import make_setup  # noqa: E402

PACK_DIALS = ("median_iters", "matmul_passes", "recip_newton")


def _port_inputs(st):
    """The port's host objects holding the same data as a make_setup() dict."""
    g = st["grid"]
    filt = lambda fs: [FilterCurve(name=f.name, wl=f.wl, tr=f.tr) for f in fs]
    prof = st["av_profile"]
    return dict(
        grid=SpectralGrid(temps=g.temps, loggs=g.loggs, wl=g.wl, flux=g.flux),
        contrast_filters=filt(st["cfilts"]), phot_filters=filt(st["pfilts"]),
        mist=MistTable.builtin(), av_profile=AvProfile(prof.dist_pc, prof.av_mu, prof.av_sig),
    )


def _assert_fields_equal(got, want, rtol, skip=()):
    for name in DATA_FIELDS:
        if name in skip:
            continue
        a = getattr(got, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=name)


PACK_CASES = {
    "binary": dict(nspec=2),
    "single": dict(nspec=1),
    "triple": dict(nspec=3),
    "no_plx": dict(nspec=2, fit_plx=False, dist_fit=False),
    "rad_nospec": dict(nspec=2, rad_prior=True, spectrum_weight=0.0, rad_sigma_frac=0.082),
    "padded": dict(nspec=2, pad_nd=960, pad_nc=3),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_target_matches_jax(case):
    st, _ = make_setup(dtype=jnp.float64)
    kw = PACK_CASES[case]
    args = (st["data_wl_um"], st["data_flux"], st["data_err"])
    obs = dict(cmag=st["cmag"], cerr=st["cerr"], phot_zero_flux=st["zps"], pmag=st["pmag"],
               perr=st["perr"])
    want = jax_pack_target(st["grid"], *args, contrast_filters=st["cfilts"],
                           phot_filters=st["pfilts"], mist=st["mist"],
                           av_profile=st["av_profile"], dtype=jnp.float64, **obs, **kw)
    got = pack_target(*(), **_port_inputs(st), data_wl_um=args[0], data_flux=args[1],
                      data_err=args[2], dtype=torch.float64, device="cpu", **obs, **kw)
    _assert_fields_equal(got, want, rtol=1e-12)
    for name in META_FIELDS:
        if name != "eval_block":  # the port has no walker blocks
            assert getattr(got, name) == getattr(want, name), name
    assert got.ndim == want.ndim and got.n_data == want.n_data


@pytest.mark.parametrize("nspec", [2, 3])
def test_build_bench_target_matches_jax(nspec):
    want, truth_j = jax_build_bench_target(jnp.float64, nd=256, grid_step=8.0, nspec=nspec)
    got, truth = build_bench_target(torch.float64, device="cpu", nd=256, grid_step=8.0,
                                    nspec=nspec)
    np.testing.assert_array_equal(truth, truth_j)
    # the observed contrasts/photometry come from the scalar forward model in both
    _assert_fields_equal(got, want, rtol=1e-12)
    for name in PACK_DIALS:
        assert getattr(got, name) == getattr(want, name)


@pytest.mark.parametrize("nspec,pad_nd,pad_nc", [(2, 300, 3), (3, 256, 4)])
def test_padded_build_bench_target_matches_jax(nspec, pad_nd, pad_nc):
    """A padded build equals JAX's, and consumes the RNG stream of its unpadded twin."""
    want, _ = jax_build_bench_target(jnp.float64, nd=256, grid_step=8.0, nspec=nspec,
                                     pad_nd=pad_nd, pad_nc=pad_nc)
    got, _ = build_bench_target(torch.float64, device="cpu", nd=256, grid_step=8.0, nspec=nspec,
                                pad_nd=pad_nd, pad_nc=pad_nc)
    _assert_fields_equal(got, want, rtol=1e-12)
    assert got.spectrum_backend == want.spectrum_backend == "xla"
    plain, _ = build_bench_target(torch.float64, device="cpu", nd=256, grid_step=8.0, nspec=nspec)
    assert torch.equal(got.pmag, plain.pmag)
    if nspec == 2:  # a triple splits its contrasts on the padded count, as JAX does
        assert torch.equal(got.cmag[: plain.n_contrast], plain.cmag)
    assert got.n_data == pad_nd and got.n_contrast == pad_nc


def test_entry_points_default_to_the_card():
    """Targets live on the card unless the caller asks for the CPU."""
    import inspect

    for fn in (pack_target, target_from_jax, build_bench_target, MistTable.device_nodes,
               AvProfile.device_nodes):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_target_from_jax_identical(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    st, _ = make_setup(dtype=jnp.float64)
    jt = jax_pack_target(st["grid"], st["data_wl_um"], st["data_flux"], st["data_err"],
                         st["cfilts"], st["cmag"], st["cerr"], st["pfilts"], st["zps"],
                         st["pmag"], st["perr"], st["mist"], st["av_profile"], dtype=jdt)
    tt = target_from_jax(jt, device="cpu", dtype=tdt)
    _assert_fields_equal(tt, jt, rtol=0)
    for name in DATA_FIELDS:
        want_dt = torch.int32 if name.startswith("n_") else tdt
        assert getattr(tt, name).dtype == want_dt, name
    for name in META_FIELDS:
        assert getattr(tt, name) == getattr(jt, name), name


def test_target_from_jax_accepts_host_numpy_fields():
    """A host-numpy JAX target (stage_on_device=False) bridges too: the bridge
    only needs np.asarray on each field."""
    want, _ = jax_build_bench_target(jnp.float64, nd=256, grid_step=8.0,
                                     stage_on_device=False)
    assert isinstance(want.D, np.ndarray)
    tt = target_from_jax(want, device="cpu", dtype=torch.float64)
    _assert_fields_equal(tt, want, rtol=0)


def test_replace_drops_kernel_tables():
    from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

    tgt, _ = build_bench_target(torch.float32, device="cpu", nd=128, grid_step=16.0)
    tabs = ck.kernel_tables(tgt)
    assert ck.kernel_tables(tgt) is tabs
    other = dataclasses.replace(tgt, cmag=tgt.cmag + 1.0)
    assert other._kernel_tables is None
    np.testing.assert_allclose(ck.kernel_tables(other)["cobs"][0].numpy(),
                               tabs["cobs"][0].numpy() + 1.0, rtol=1e-6)
