"""PyTorch port: K1 and K5 v3 on the card, the staged spectrum body
(``csrc/spectrum_stage.cuh``).

K1 v3 is held bit for bit against S15 (``posterior_pair``, which runs K1 v2's warp body,
``csrc/spectrum_warp.cuh``, on the same walkers: v3 reads the same operands in the same
order, from shared-memory tiles instead of L2) and within the kernel gate of the plain
version, at both dial sets, on the cases the staging could get wrong: a ragged last
block, walkers spread over the whole grid (a block stages ~30 of the 56 rows), NaN
blend weights (a walker's list of all NO rows, longer than a build chunk), no spectrum
(nothing staged), nd = 1,791 (no multiple of 4 or of a tile: 4-byte copies and a short
last tile), nd = 4,096 (12 walkers a block) and a triple (nspec 3).  K5 v3 is held within
the gate of its plain version on a fleet whose targets' walkers are no multiple of a
block, and bit for bit against the same walkers in a larger launch.  The staging counter
of K1 (a binary and a triple) and of K5 (the ragged fleet) is held against its offline
count from the walkers' blend weights, its blocks against the launch's, and the kernels'
values with the counter on against those with it off, bit for bit.

The tests need the card and import no JAX: ``python -m pytest --noconftest
tests/test_torch_staged.py -m card`` on the H100.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch  # noqa: E402
from mcmc_spec_tpu_torch.inference.batched import _forward_small  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.utils import profiling  # noqa: E402

DIALS = {"exact": dict(median_iters=31, matmul_passes=6, recip_newton=0),
         "prod": dict(median_iters=14, matmul_passes=3, recip_newton=2)}
PROD_OUTSIDE = 1e-3  # the 14-pass midpoint median: 99.9 % of walkers in the gate
RTOL = 5e-5  # the JAX kernel gate, with atol 1e-4 max|ref|
NW = 16 * 64 + 5  # a ragged last block at 16 walkers a block (and at 12)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 "
                    "(python -m pytest --noconftest tests/test_torch_staged.py -m card)")
    return torch.device("cuda", 0)


def _outside(got, ref):
    """Walkers outside the kernel gate of ``ref`` (finiteness differs, or |got - ref| >
    1e-4 max|ref| + RTOL |ref| over the finite values)."""
    got, ref = got.double().flatten(), ref.double().flatten().to(got.device)
    fin = torch.isfinite(got) & torch.isfinite(ref)
    mag = torch.where(fin, ref.abs(), torch.zeros_like(ref))
    diff = torch.where(fin, (got - ref).abs(), torch.zeros_like(got))
    bad = (torch.isfinite(got) != torch.isfinite(ref)) | (diff > 1e-4 * mag.max() + RTOL * mag)
    return int(bad.sum())


def _same_bits(a, b):
    return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def _spread(tgt, truth, n, seed=3):
    """Walkers whose temperatures are uniform over the grid: a block's 16 walkers touch
    ~30 of its 56 rows (each component's log g follows its temperature on MIST's track,
    so its four rows lie along the track)."""
    gen = torch.Generator(device=tgt.device).manual_seed(seed)
    P = torch.as_tensor(truth, dtype=torch.float32, device=tgt.device).repeat(n, 1)
    lo, hi = float(tgt.temps[0]), float(tgt.temps[-1])
    P[:, :tgt.nspec] = lo + (hi - lo) * torch.rand((n, tgt.nspec), generator=gen,
                                                   device=tgt.device)
    return P


def _case(name, dev):
    """(target, walkers) of a K1 case."""
    if name == "triple":
        tgt, truth = build_bench_target(torch.float32, device=dev, nd=401, grid_step=8.0, nspec=3)
        return tgt, init_walker_batch(tgt, truth, NW, seed=2)
    nd = {"nd1791": 1791, "nd4096": 4096}.get(name, 1792)
    tgt, truth = build_bench_target(torch.float32, device=dev, nd=nd)
    if name == "spread":
        return tgt, _spread(tgt, truth, NW)
    P = init_walker_batch(tgt, truth, NW, seed=2)
    if name == "nan":  # NaN temperatures: every blend weight NaN, a list of all NO rows
        P[::7, 0] = float("nan")
    if name == "nospec":
        tgt = dataclasses.replace(tgt, spectrum_weight=0.0)
    return tgt, P


def _rows_offline(nz, wpb):
    """(rows staged, rows read) that the counter should read for one target's walkers
    whose non-zero blend weights are ``nz`` [B, NO]: the sum over blocks of the union of
    their walkers' rows, the last block's missing warps repeating the last walker, and
    the sum of the walkers' counts."""
    B, NO = nz.shape
    pad = torch.cat([nz, nz[-1:].expand(-B % wpb, NO)]).view(-1, wpb, NO)
    return int(pad.any(dim=1).sum()), int(nz.sum())


@pytest.mark.card
@pytest.mark.parametrize("dials", sorted(DIALS))
@pytest.mark.parametrize("name", ["cloud", "spread", "nan", "nospec", "nd1791", "nd4096",
                                  "triple"])
def test_k1_v3_is_v2_bit_for_bit(card, name, dials):
    tgt, P = _case(name, card)
    tgt = dataclasses.replace(tgt, **DIALS[dials])
    got = ck.log_posterior_fused(P, tgt)
    v2 = ck.posterior_pair(P, tgt)  # K1 v2's body
    ref = ck.log_posterior_fused_reference(P, tgt)
    torch.cuda.synchronize()
    assert _same_bits(got, v2)
    allowed = 0 if dials == "exact" else int(PROD_OUTSIDE * P.shape[0])
    assert _outside(got, ref) <= allowed
    if name == "nan":
        assert not torch.isfinite(got[::7]).any() and torch.isfinite(got[1::7]).all()
    for w in (1, 5, 8):  # other block sizes: the same bits
        assert _same_bits(ck.log_posterior_fused(P, tgt, walkers_per_block=w), got)


@pytest.mark.card
@pytest.mark.parametrize("name", ["cloud", "spread", "triple"])
def test_k1_counter_is_the_offline_count(card, name):
    """While spans record, K1 adds each block's union U, its walkers' list lengths and 1
    to the session's counter: the offline count from the same walkers' blend weights, and
    the launch's blocks.  A truth-centred cloud shares its rows (12 a block at koi2298's
    truth, a tenth of the reads); walkers spread over the grid stage more than 20 a
    block.  The values are the same bits with the counter on and off."""
    tgt, P = _case(name, card)
    tgt = dataclasses.replace(tgt, **DIALS["prod"])
    nT, nG, nd = tgt.D.shape
    wpb = ck.staged_block(nd, nT * nG, 1 + tgt.nspec)[0]
    with profiling.recording() as s:
        on = ck.log_posterior_fused(P, tgt)
    cols = s.columns()
    staged, read = _rows_offline(_forward_small(P, tgt)[4] != 0, wpb)
    blocks = -(-P.shape[0] // wpb)
    assert (cols["rows_staged"], cols["rows_read"]) == (staged, read)
    assert cols["blocks_staged"] == blocks
    if name == "cloud":
        assert staged / read <= 0.3
    elif name == "spread":
        assert staged / blocks > 20
    off = ck.log_posterior_fused(P, tgt)  # outside a session: no counter
    assert [sum(r.tolist()[k] for r in s.rows.values()) for k in (0, 2)] == [staged, blocks]
    assert _same_bits(on, off)


def _fleet(dev):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke.build_fleet(dev)


@pytest.mark.card
@pytest.mark.parametrize("dials", sorted(DIALS))
def test_k5_v3_ragged_targets(card, dials):
    """13 and 1,029 walkers a target (no multiple of 16): every target's last block is
    ragged; the walkers' values are those of the same walkers in a launch of 2,048 a
    target, bit for bit, and within the gate of the plain version."""
    fleet, singles, truth = _fleet(card)
    fleet = dataclasses.replace(fleet, **DIALS[dials])
    coords = torch.stack([init_walker_batch(t, truth, 2048, seed=1 + i)
                          for i, t in enumerate(singles)])
    full = ck.log_posterior_fleet_fused(coords, fleet)
    for nw in (13, 1029):
        got = ck.log_posterior_fleet_fused(coords[:, :nw].contiguous(), fleet)
        assert _same_bits(got, full[:, :nw])
    ref = ck.log_posterior_fleet_fused_reference(coords[:, :13].contiguous(), fleet)
    allowed = 0 if dials == "exact" else int(PROD_OUTSIDE * ref.numel())
    assert _outside(full[:, :13], ref) <= allowed


@pytest.mark.card
@pytest.mark.parametrize("nw", [13, 1029])
def test_k5_counter_is_the_offline_count(card, nw):
    """K5's counter on the ragged fleet: each target's row of blocks adds its unions, its
    walkers' list lengths and its blocks, the sum over targets of the offline count and
    of ceil(nw / wpb); the values are the same bits with the counter on and off."""
    import chip_smoke

    fleet, singles, truth = _fleet(card)
    fleet = dataclasses.replace(fleet, **DIALS["prod"])
    P = torch.stack([init_walker_batch(t, truth, nw, seed=1 + i)
                     for i, t in enumerate(singles)])
    ntgt, nT, nG, nd = fleet.D.shape
    wpb = ck.staged_block(nd, nT * nG, 1 + fleet.nspec)[0]
    with profiling.recording() as s:
        on = ck.log_posterior_fleet_fused(P, fleet)
    cols = s.columns()
    counts = [_rows_offline(nz, wpb) for nz in chip_smoke.fleet_wcomb(P, fleet) != 0]
    assert cols["rows_staged"] == sum(c[0] for c in counts)
    assert cols["rows_read"] == sum(c[1] for c in counts)
    assert cols["blocks_staged"] == ntgt * -(-nw // wpb)
    assert _same_bits(on, ck.log_posterior_fleet_fused(P, fleet))
