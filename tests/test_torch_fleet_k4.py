"""PyTorch port: the launch of the fleet spectrum chi^2 K4 v2 (CPU).

K4 v2 (``csrc/spectrum_chi2_fleet.cu``) runs K3's one-warp-per-walker body on K5
v2's map: the fleet's walkers are flattened to ``[ntgt * nw]``, a block holds
``walkers_per_block(nd, NO, 0)`` of them, and warp ``w`` of block ``b`` scores
walker ``g = b * wpb + w``, which is walker ``g % nw`` of target ``g // nw``, with
that target's median ranks and ``chi^2 = sum * 1/n_true``.  There is no card
here, so the tests hold:

* the launch arguments that the wrapper builds, the walkers per block last, in
  the order and types of the launch function's signature, and that signature
  against the C source;
* a Python rendering of the walker-to-target map on a ragged, padded fleet
  built from numpy seeds: each block's walkers, scored one by one by the plain
  spectrum block with their own target's ``fleet_stat``, give the plain fleet
  version within the JAX kernel gate (identical finiteness, rtol 5e-5, atol
  1e-4 * max|ref|), and the same walkers on each unpadded target, with its
  whole-row median and mean chi^2, give it too: the padded points are inert;
* the plain fleet version against the JAX ``spectrum_chi2_fleet`` in interpret
  mode at both dial sets, within the same gate.

The gate and not the bits: one walker's ``Wcomb @ D`` is a BLAS product whose
summation order may differ from a batch's.
"""
import ctypes
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.inference import batched as jb  # noqa: E402
from mcmc_spec_tpu.ops import pallas_kernels as pk  # noqa: E402
from mcmc_spec_tpu_torch.inference.batched import _forward_small  # noqa: E402
from mcmc_spec_tpu_torch.inference.fleet import target_views  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.runtime import cuda_build  # noqa: E402
from tests.test_torch_fleet import (  # noqa: E402
    EXACT,
    FAST,
    ND_MAX,
    SPECS,
    _assert_kernel_gate,
    _fleet_walkers,
    _jax_fleet,
    _to_port,
)
from tests.test_torch_fleet_warp import warp_walkers  # noqa: E402

DIALS = {"exact": EXACT, "fast": FAST}


@pytest.fixture(scope="module")
def fleets():
    """(JAX singles, JAX stacked fleet, port singles, port fleet), float32."""
    singles, jfl = _jax_fleet(jnp.float32)
    return (singles, jfl, [_to_port(s, torch.float32) for s in singles],
            _to_port(jfl, torch.float32))


def _wcomb(P, fleet):
    """[ntgt, nw, NO] blend weights and [ntgt, nw] av of walkers ``P``, as the fleet's
    composed route forms them for K4."""
    P = torch.from_numpy(np.asarray(P, np.float32))
    W = torch.stack([_forward_small(p, t)[4] for p, t in zip(P, target_views(fleet))])
    return W.contiguous(), P[..., fleet.nspec].contiguous()


def _c_signature(name):
    """The ctypes argument types of the C launch function ``name`` in ``csrc/``."""
    for src in cuda_build.SOURCES:
        text = (cuda_build.CSRC / src).read_text()
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        if m:
            kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
                     "int": ctypes.c_int, "float": ctypes.c_float}
            return [kinds[" ".join(a.split()[:-1])] for a in m.group(1).split(",")]
    raise AssertionError(f"{name} not found in csrc/")


def test_k4_launch_signature_matches_the_source():
    assert ck._SIGNATURES["spectrum_chi2_fleet_launch"] == _c_signature(
        "spectrum_chi2_fleet_launch")
    # 11 pointers, 7 ints (ntgt, nw, NO, nd, iters, recip, wpb), the stream
    assert ck._SIGNATURES["spectrum_chi2_fleet_launch"] == [ck._P] * 11 + [ck._I] * 7 + [ck._P]


@pytest.mark.parametrize("dials", ["exact", "fast"])
@pytest.mark.parametrize("nw", [13, 8])
def test_k4_launch_args_end_with_walkers_per_block(fleets, nw, dials):
    fl = dataclasses.replace(fleets[3], **DIALS[dials])
    W, av = _wcomb(_fleet_walkers(nw), fl)
    out, args = ck.fleet_spectrum_launch_args(W, av, fl)
    sig = ck._SIGNATURES["spectrum_chi2_fleet_launch"]
    assert len(args) == len(sig) - 1  # the stream follows
    for a, t in zip(args, sig):
        assert isinstance(a, int), t
    NO = fl.D.shape[1] * fl.D.shape[2]
    wpb = ck.walkers_per_block(ND_MAX, NO, 0)
    assert wpb == 8 and args[-1] == wpb
    assert args[:2] == (W.data_ptr(), av.data_ptr())
    assert args[10] == out.data_ptr() and tuple(out.shape) == (len(SPECS), nw)
    iters, _, recip = ck.resolve_dials(fl)
    assert args[11:17] == (len(SPECS), nw, NO, ND_MAX, iters, recip)
    out0, args0 = ck.fleet_spectrum_launch_args(W[:, :0].contiguous(), av[:, :0].contiguous(), fl)
    assert args0 is None and tuple(out0.shape) == (len(SPECS), 0)


def test_k4_launch_args_check_their_tables(fleets):
    fl = fleets[3]
    W, av = _wcomb(_fleet_walkers(6), fl)
    with pytest.raises(ValueError, match="av: expected"):
        ck.fleet_spectrum_launch_args(W, av[:, :5].contiguous(), fl)
    with pytest.raises(ValueError, match="Wcomb: expected"):
        ck.fleet_spectrum_launch_args(W.double(), av, fl)


def _score_by_blocks(W, av, fleet, wpb):
    """The kernel's map in Python: each block's warps, walker by walker, through the
    plain spectrum block on their own target's tables and fleet statistics."""
    iters, _, recip = ck.resolve_dials(fleet)
    t = ck.fleet_kernel_tables(fleet)
    ntgt, nw, _ = W.shape
    got = torch.full((ntgt, nw), float("nan"))
    for blk in warp_walkers(ntgt, nw, wpb):
        for tgt, i in blk:
            got[tgt, i] = ck._spectrum_block(
                W[tgt, i:i + 1], av[tgt, i:i + 1, None], t["D"][tgt], t["kd"][tgt],
                t["data"][tgt], t["inv_err"][tgt], t["VpinvT"][tgt], t["VT"][tgt],
                t["scal"][tgt, 2], iters, recip=recip, fleet_stat=ck._fleet_stat(t, tgt))[0, 0]
    return got


@pytest.mark.parametrize("dials", ["exact", "fast"])
@pytest.mark.parametrize("nw", [13, 5])
def test_k4_blocks_span_targets(fleets, nw, dials):
    """nw not a multiple of the 8 walkers a block: blocks straddle targets and the last
    block is ragged; every walker is scored once, on its own target's tables."""
    fl = dataclasses.replace(fleets[3], **DIALS[dials])
    P = _fleet_walkers(nw, seed=4)
    P = np.concatenate([P[:, :-3], P[:, -3:-2]], axis=1)  # in-grid walkers, one at Av = 0
    W, av = _wcomb(P, fl)
    ntgt, nw = av.shape
    blocks = warp_walkers(ntgt, nw, 8)
    assert any(len({tgt for tgt, _ in blk}) >= 2 for blk in blocks)
    assert sorted(w for blk in blocks for w in blk) == [(i, j) for i in range(ntgt)
                                                          for j in range(nw)]
    got = _score_by_blocks(W, av, fl, 8)
    _assert_kernel_gate(got.numpy(), ck.spectrum_chi2_fleet_reference(W, av, fl).numpy())


@pytest.mark.parametrize("dials", ["exact", "fast"])
def test_k4_padded_points_are_inert(fleets, dials):
    """Each target's walkers scored on the padded fleet (per-target ranks, sum / n_true)
    and on the unpadded target (whole-row median, mean): the same chi^2 in the gate."""
    fl = dataclasses.replace(fleets[3], **DIALS[dials])
    P = _fleet_walkers(9, seed=6)
    P = np.concatenate([P[:, :-3], P[:, -3:-2]], axis=1)
    W, av = _wcomb(P, fl)
    padded = _score_by_blocks(W, av, fl, 8)
    iters, _, recip = ck.resolve_dials(fl)
    for i, single in enumerate(fleets[2]):
        s = dataclasses.replace(single, **DIALS[dials])
        nT, nG, nd = s.D.shape
        Ws = _forward_small(torch.from_numpy(P[i].astype(np.float32)), s)[4]
        plain = ck.spectrum_chi2_reference(
            Ws, av[i], s.D.reshape(nT * nG, nd), s.ext_k_data, s.data_flux, s.data_err, s.V,
            s.Vpinv, s.med_data, iters, s.matmul_passes, True, recip)
        assert nd == SPECS[i][0] and nd <= ND_MAX
        _assert_kernel_gate(padded[i].numpy(), plain.numpy())


@pytest.mark.parametrize("dials", ["exact", "fast"])
def test_k4_reference_matches_pallas_interpret(fleets, dials):
    """The plain fleet version against the JAX kernel in interpret mode, on walkers
    whose blocks span targets at 8 a block (nw = 7)."""
    d = DIALS[dials]
    jfl = dataclasses.replace(fleets[1], **d)
    P = _fleet_walkers(9, seed=8).astype(np.float32)
    P = np.concatenate([P[:, :-3], P[:, -3:-2]], axis=1)
    Wcomb = jax.vmap(jb._forward_small)(jnp.asarray(P), jfl)[4]
    av = jnp.asarray(P[..., jfl.nspec])
    ntgt, nT, nG, nd = jfl.D.shape
    ref = np.asarray(pk.spectrum_chi2_fleet(
        Wcomb, av, jfl.D.reshape(ntgt, nT * nG, nd), jfl.ext_k_data, jfl.data_flux,
        jfl.data_err, jfl.V, jfl.Vpinv, jfl.med_data, jfl.n_data_true, interpret=True,
        iters=d["median_iters"], mm_passes=d["matmul_passes"], recip=d["recip_newton"]))
    tf = dataclasses.replace(fleets[3], **d)
    Wt, avt = torch.from_numpy(np.array(Wcomb)), torch.from_numpy(np.array(av))
    got = ck.spectrum_chi2_fleet_reference(Wt, avt, tf).numpy()
    assert got.shape == (ntgt, 7)
    _assert_kernel_gate(got, ref)
    before = dict(ck.LAUNCHES)
    np.testing.assert_array_equal(ck.spectrum_chi2_fleet(Wt, avt, tf).numpy(), got)
    assert ck.LAUNCHES == before  # a CPU tensor takes the plain version, no launch


def test_k4_source_runs_the_warp_body():
    src = (cuda_build.CSRC / "spectrum_chi2_fleet.cu").read_text()
    assert '#include "spectrum_warp.cuh"' in src and "spectrum_block(" not in src
    assert "__syncthreads" not in src and "spectrum_warp(" in src
    # S6 keeps K4 v1's block body
    s6 = (cuda_build.CSRC / "fleet_grid_order.cu").read_text()
    assert '#include "spectrum_block.cuh"' in s6 and "spectrum_block(" in s6
