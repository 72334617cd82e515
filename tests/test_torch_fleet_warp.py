"""PyTorch port: the launch of the fused fleet posterior K5 v3 (CPU).

K5 v3 (``csrc/log_posterior_fleet_fused.cu``) runs one warp per walker, each
target on its own row of blocks of ``staged_block`` walkers, so no block spans
two targets (v2 flattened the fleet and let blocks straddle them): warp ``w`` of
block ``(x, t)`` evaluates walker ``x * wpb + w`` of target ``t``, and a warp past
the target's ``nw`` walkers repeats the target's last walker and writes nothing.
There is no card here, so the tests hold the launch arguments that the wrapper
builds (the staging counter, the tile size and the walkers per block last, in the
order and types of the launch function's signature) and a Python rendering of
that walker-to-target map: each block's walkers, evaluated one
by one by the plain posterior on their own target's tables, must give the
plain fleet version within the JAX kernel gate (identical finiteness, rtol
5e-5, atol 1e-4 * max|ref|).  The gate and not the bits: the band fluxes are
BLAS products, whose order may differ between a batch of one and of nw.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tests.test_torch_fleet import (  # noqa: E402
    ND_MAX,
    SPECS,
    _assert_kernel_gate,
    _fleet_walkers,
    _jax_fleet,
    _to_port,
)


@pytest.fixture(scope="module")
def port_fleet():
    return _to_port(_jax_fleet(jnp.float32)[1], torch.float32)


def warp_walkers(ntgt, nw, wpb):
    """K4's map (K5 v2's): the fleet flattened, for each block the (target, walker) of
    each of its warps."""
    B = ntgt * nw
    return [[(g // nw, g % nw) for g in range(b * wpb, min(b * wpb + wpb, B))]
            for b in range((B + wpb - 1) // wpb)]


def target_walkers(ntgt, nw, wpb):
    """K5 v3's map: for each block, the (target, walker) of each of its warps that
    writes (a warp past its target's walkers repeats the last and writes nothing)."""
    return [[(t, i) for i in range(x * wpb, min(x * wpb + wpb, nw))]
            for t in range(ntgt) for x in range((nw + wpb - 1) // wpb)]


@pytest.mark.parametrize("nw", [13, 8])
def test_k5_launch_args_end_with_walkers_per_block(port_fleet, nw):
    P = torch.from_numpy(_fleet_walkers(nw).astype(np.float32))
    out, args = ck.fleet_posterior_launch_args(P, port_fleet)
    sig = ck._SIGNATURES["log_posterior_fleet_fused_launch"]
    assert len(args) == len(sig) - 1  # the stream follows
    kinds = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_float: float}
    for a, t in zip(args, sig):
        assert isinstance(a, kinds[t])
    NO = port_fleet.D.shape[1] * port_fleet.D.shape[2]
    wpb, stage = ck.staged_block(ND_MAX, NO, 1 + port_fleet.nspec)
    assert wpb == ck.WALKERS_MAX_STAGED and args[-3:] == (0, stage, wpb)
    assert args[21:23] == (len(SPECS), nw)  # ntgt, nw after the 21 pointers
    assert args[20] == out.data_ptr() and tuple(out.shape) == (len(SPECS), nw)
    out0, args0 = ck.fleet_posterior_launch_args(P[:, :0].contiguous(), port_fleet)
    assert args0 is None and tuple(out0.shape) == (len(SPECS), 0)


@pytest.mark.parametrize("nw", [13, 5])
def test_k5_blocks_span_targets(port_fleet, nw):
    """nw not a multiple of the 8 walkers a block, where v2's blocks straddled targets:
    v3's blocks hold one target's walkers each and each target's last block is ragged;
    every walker is evaluated once, on its own target's tables."""
    P = torch.from_numpy(_fleet_walkers(nw, seed=4).astype(np.float32))
    ntgt = P.shape[0]
    iters, _, recip = ck.resolve_dials(port_fleet)
    t = ck.fleet_kernel_tables(port_fleet)
    blocks = target_walkers(ntgt, nw, 8)
    assert all(len({tgt for tgt, _ in blk}) == 1 for blk in blocks)
    assert len(blocks) == ntgt * -(-nw // 8)
    assert all(len(blocks[k]) == nw % 8 for k in range(len(blocks) // ntgt - 1,
                                                         len(blocks), len(blocks) // ntgt))
    seen = [w for blk in blocks for w in blk]
    assert sorted(seen) == [(i, j) for i in range(ntgt) for j in range(nw)]
    got = torch.empty((ntgt, nw))
    for blk in blocks:
        for tgt, i in blk:
            ti = {k: v[tgt] for k, v in t.items()}
            got[tgt, i] = ck._posterior_plain(
                P[tgt, i:i + 1], port_fleet, ti, ti["scal"][0], ti["scal"][1], ti["scal"][2],
                ti["scal"][4], iters, recip, fleet_stat=ck._fleet_stat(t, tgt))[0]
    ref = ck.log_posterior_fleet_fused_reference(P, port_fleet)
    _assert_kernel_gate(got.numpy(), ref.numpy())
