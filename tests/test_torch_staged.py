"""PyTorch port: K1 and K5 v3/v4, the staged spectrum body (``csrc/spectrum_stage.cuh``).

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

Since v4 (nd <= 1,792) each walker's row lives in its lanes' registers: the same
cases hold it bit for bit against S15, and the cells' shapes (the binary and the triple
at nd = 1,792, 32,768 walkers and a ragged block; the fleet at 9 x 1,029) with NaN and
out-of-bound walkers against the plain versions at both dial sets, the counter and the
launches that took the register row, and the reciprocal dials of 1 and 3 Newton steps,
which v4's tail serves rolled, within the gate.  On the CPU: the path choice, the shared-memory
layout of both paths and a numpy model of v4's point-to-lane and tile schedule against
the header, and the wrappers' launch counts with ``_launch`` monkeypatched.

The card tests import no JAX: ``python -m pytest --noconftest
tests/test_torch_staged.py -m card`` on the H100.
"""
import dataclasses
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch  # noqa: E402
from mcmc_spec_tpu_torch.inference.batched import _forward_small  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.runtime import cuda_build  # noqa: E402
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


# ---------------------------------------------------------------------------
# v4: the walker's row in registers (nd <= 32 kRegPoints)

NO = 14 * 4  # the bench grid


def _header():
    return (cuda_build.CSRC / "spectrum_stage.cuh").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = ([^;]+);", _header()).group(1).split("*")[-1])


@pytest.mark.parametrize("nd,reg", [(1791, True), (1792, True), (1793, False), (4096, False)])
def test_path_choice_mirrors_the_header(nd, reg):
    """nd 1,791 and 1,792 take the register row, 1,793 and 4,096 keep v3: the header's
    ``stage_reg_row``, nd <= 32 kRegPoints, and its Python twin."""
    src = _header()
    assert _const("kRegPoints") == ck.REG_POINTS == 56
    body = re.search(r"stage_reg_row\(int nd\) \{ return ([^;]+);", src)
    assert body and body.group(1) == "nd <= 32 * kRegPoints"
    assert ck.staged_reg_row(nd) is reg is (nd <= 32 * _const("kRegPoints"))
    assert "if (stage_reg_row(nd))" in src


@pytest.mark.parametrize("nd,rows", [(401, 4), (1791, 3), (1792, 3), (1792, 4), (1793, 3),
                                     (4096, 3)])
def test_smem_mirror_of_both_paths(nd, rows):
    """``staged_smem_bytes`` is the header's ``staged_smem_floats`` times 4 on both paths:
    a warp's slice holds its row (v3) or not (v4); ``stage_floats`` keeps v4's tail tile
    (kRegTailRows rows of 32 kRegPoints) and caps a buffer at a build tile of every grid
    row and kd ((NO + 1) kRegTilePoints), v3's as before."""
    src = _header()
    row = re.search(r"stage_row_floats\(int nd\) \{\s*return ([^;]+);", src).group(1)
    assert row == "stage_reg_row(nd) ? 0 : round4(nd)"
    warp = re.search(r"stage_warp_floats\(int nd, int NO, int weight_rows\) \{\s*return ([^;]+);",
                     src).group(1)
    assert warp == "stage_row_floats(nd) + round4((weight_rows + 2) * NO)"
    assert ck.REG_TILE_POINTS == 32 * _const("kRegTileSlots") == 448
    assert ck.REG_TAIL_ROWS == _const("kRegTailRows") == 8
    r4 = lambda n: (n + 3) // 4 * 4
    union = r4((NO + 31) // 32) + r4(NO) + 4
    reg = ck.staged_reg_row(nd)
    per = (0 if reg else r4(nd)) + r4((rows + 2) * NO)
    wpb, stage = ck.staged_block(nd, NO, rows)
    assert ck.staged_warp_bytes(nd, NO, rows) == 4 * per
    assert ck.staged_smem_bytes(nd, NO, rows, wpb, stage) == 4 * (wpb * per + union + 2 * stage)
    assert ck.staged_smem_bytes(nd, NO, rows, wpb, stage) <= ck.ROW_SMEM_BYTES
    if reg:  # stage_fits: the tail tile; one row group a build tile at NO = 56
        assert stage % 32 == 0 and stage >= ck.REG_TAIL_ROWS * 32 * ck.REG_POINTS
        assert stage == (NO + 1) * ck.REG_TILE_POINTS and wpb == ck.WALKERS_MAX_STAGED
    else:
        assert stage % 32 == 0 and stage >= 32 * (NO + 1)
    fits = re.search(r"stage_fits\(int nd, int NO, int stage\) \{(.*?)\n\}", src, re.S).group(1)
    assert "stage >= kRegTailRows * kRegRowPoints" in fits
    assert "stage >= 32 * (NO + 1) && stage >= 160" in fits
    for kernel in ("log_posterior_fused.cu", "log_posterior_fleet_fused.cu", "posterior_ablate.cu"):
        text = (cuda_build.CSRC / kernel).read_text()
        assert "stage_warp_floats(a.nd, a.NO, 1 + a.nspec)" in text
        assert "!stage_fits(nd, NO, stage)" in text


def _v4_schedule(nd):
    """A numpy model of v4's schedule: for each lane, the points its register slots hold in
    slot order (slot i: point lane + 32 i, for i below the lane's nv), and where the build
    tile and the tail tile hold each one, as the kernel indexes them."""
    P, S, W = ck.REG_POINTS, ck.REG_TILE_POINTS // 32, ck.REG_TILE_POINTS
    lanes = []
    for lane in range(32):
        nv = (nd - lane + 31) >> 5
        i = np.arange(P)
        j = lane + 32 * i
        t, q = i // S, i % S
        lanes.append({"nv": nv, "points": j[:nv], "tile": t[:nv], "build_off": (32 * q + lane)[:nv],
                      "tail_off": (32 * i + lane)[:nv], "tile_n": np.minimum(W, nd - W * t)[:nv]})
    return lanes


@pytest.mark.parametrize("nd", [1791, 1792, 1744])
def test_v4_schedule_covers_every_point_once_in_v3_order(nd):
    """Every point of the row lies in one lane's registers once; each lane's points ascend
    in slot order, v3's order (lane l sums the points j = l mod 32 ascending), which the
    renorm sums and the chi^2 take; a build tile t holds slot i's point at offset 32 q +
    lane of its kRegTilePoints-wide rows, inside the points the tile copies; the tail
    tile at offset 32 i + lane of rows of 32 kRegPoints."""
    lanes = _v4_schedule(nd)
    every = np.concatenate([ln["points"] for ln in lanes])
    assert np.array_equal(np.sort(every), np.arange(nd))
    for lane, ln in enumerate(lanes):
        v3_order = np.arange(lane, nd, 32)  # v3: x = lane, lane + 32, ... over ascending tiles
        assert np.array_equal(ln["points"], v3_order)
        assert ln["nv"] == len(v3_order) <= ck.REG_POINTS
        W = ck.REG_TILE_POINTS
        assert np.array_equal(W * ln["tile"] + ln["build_off"], ln["points"])
        assert (ln["build_off"] < ln["tile_n"]).all() and (ln["build_off"] < W).all()
        assert np.array_equal(ln["tail_off"], ln["points"])
        assert (ln["tail_off"] < 32 * ck.REG_POINTS).all()
    assert {t for ln in lanes for t in ln["tile"]} == set(range(-(-nd // ck.REG_TILE_POINTS)))


@pytest.mark.parametrize("nd", [1791, 1744])
def test_v4_padding_never_counts_in_the_median(nd):
    """A lane's slots past nd hold the bit pattern 0x7fffffff, above every bracket bound
    (at most +inf's 0x7f800000): the counts of every pass over the padded registers are
    the counts over the row, NaN, infinite and negative values included."""
    src = _header()
    assert "r[i] = __int_as_float(0x7fffffff)" in src
    rng = np.random.default_rng(5)
    row = rng.normal(1.0, 0.5, nd).astype(np.float32)
    row[::97] = np.nan
    row[5], row[6], row[7] = np.inf, -np.inf, -0.0
    bits = row.view(np.int32)
    regs = np.full((32, ck.REG_POINTS), 0x7FFFFFFF, dtype=np.int32)
    for lane, ln in enumerate(_v4_schedule(nd)):
        regs[lane, :ln["nv"]] = bits[ln["points"]]
    for v in [0, 1, 0x3F800000, 0x3F800001, 0x7F7FFFFF, 0x7F800000] + list(
            rng.integers(0, 0x7F800001, 64)):
        assert int((regs <= v).sum()) == int((bits <= v).sum())


def _meta_launches(monkeypatch):
    """The wrappers reach their launch with ``_launch`` and the argument builders
    replaced: each call is recorded and counted as ``_launch`` counts it."""
    calls = []

    def fake_launch(fn_name, counter, *args):
        calls.append((fn_name, counter))
        ck.LAUNCHES[counter] += 1

    monkeypatch.setattr(ck, "_launch", fake_launch)
    monkeypatch.setattr(ck, "_require_cuda", lambda t, name: None)
    monkeypatch.setattr(ck, "_stream", lambda dev: 0)
    monkeypatch.setattr(ck, "_rows_ptr", lambda dev: 0)
    monkeypatch.setattr(ck, "posterior_launch_args", lambda p, tgt, kernel: (None, (0,) * 4))
    monkeypatch.setattr(ck, "fleet_posterior_launch_args",
                        lambda params, fleet: (None, (0,) * 4))
    return calls


@pytest.mark.parametrize("nd", [1792, 1793])
def test_wrappers_count_the_register_row(monkeypatch, nd):
    """K1's and K5's wrappers add one to ``*_reg_row`` beside their own count where the
    row fits the registers (nd <= 1,792; K5 at its padded nd) and nothing past it; the
    span and the count of ``_launch`` stay the kernels' own."""
    calls = _meta_launches(monkeypatch)
    tgt, _ = build_bench_target(torch.float32, device="cpu", nd=nd, grid_step=8.0)
    fleet = types.SimpleNamespace(D=torch.empty((2, 14, 4, nd), device="meta"), nspec=2,
                                  median_iters=14, matmul_passes=3, recip_newton=2)
    before = dict(ck.LAUNCHES)
    ck.log_posterior_fused(torch.empty((5, tgt.ndim), device="meta"), tgt)
    ck.log_posterior_fused(torch.empty((5, tgt.ndim), device="meta"), tgt)
    ck.log_posterior_fleet_fused(torch.empty((2, 5, tgt.ndim), device="meta"), fleet)
    grown = {k: v - before[k] for k, v in ck.LAUNCHES.items() if v != before[k]}
    want = {"log_posterior_fused": 2, "log_posterior_fleet_fused": 1}
    if nd <= 32 * ck.REG_POINTS:
        want.update({"log_posterior_fused_reg_row": 2, "log_posterior_fleet_fused_reg_row": 1})
    assert grown == want
    assert calls == [("log_posterior_fused_launch", "log_posterior_fused")] * 2 + [
        ("log_posterior_fleet_fused_launch", "log_posterior_fleet_fused")]


def _cell_case(name, dev, nw):
    """(target, walkers) at a stage-2 cell's shape: the bench binary or triple at nd =
    1,792, a truth-centred cloud with NaN walkers (every seventh) and the out-of-bound
    edge walkers, a ragged last block."""
    import chip_smoke

    tgt, truth = build_bench_target(torch.float32, device=dev, nd=1792,
                                    nspec=3 if name == "triple" else 2)
    P = torch.cat([init_walker_batch(tgt, truth, nw, seed=11), chip_smoke.edge_walkers(truth, tgt)])
    P[3::7, 0] = float("nan")
    return tgt, P


@pytest.mark.card
@pytest.mark.parametrize("dials", sorted(DIALS))
@pytest.mark.parametrize("name", ["binary", "triple"])
def test_k1_v4_at_the_cells_shapes(card, name, dials):
    """K1 on 32,768 + 5 walkers at nd = 1,792 (the stage-2 cells' shape, a ragged last
    block): bit for bit S15 (v2's body), within the gate of the plain version, NaN walkers
    -inf, one ``log_posterior_fused_reg_row`` a launch; the counter's three slots the
    offline count, the values the same bits with the counter on and off."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    tgt, P = _cell_case(name, card, 32768)
    tgt = dataclasses.replace(tgt, **DIALS[dials])
    before = dict(ck.LAUNCHES)
    got = ck.log_posterior_fused(P, tgt)
    assert ck.LAUNCHES["log_posterior_fused_reg_row"] - before["log_posterior_fused_reg_row"] == 1
    v2 = ck.posterior_pair(P, tgt)
    ref = ck.log_posterior_fused_reference(P, tgt)
    torch.cuda.synchronize()
    assert _same_bits(got, v2)
    allowed = 0 if dials == "exact" else int(PROD_OUTSIDE * P.shape[0])
    assert _outside(got, ref) <= allowed
    assert not torch.isfinite(got[3::7]).any()
    nT, nG, nd = tgt.D.shape
    wpb = ck.staged_block(nd, nT * nG, 1 + tgt.nspec)[0]
    with profiling.recording() as s:
        on = ck.log_posterior_fused(P, tgt)
    cols = s.columns()
    assert (cols["rows_staged"], cols["rows_read"]) == _rows_offline(
        _forward_small(P, tgt)[4] != 0, wpb)
    assert cols["blocks_staged"] == -(-P.shape[0] // wpb)
    assert _same_bits(on, got)


@pytest.mark.card
@pytest.mark.parametrize("recip", [1, 3])
def test_v4_rolled_tail_at_the_other_dials(card, recip):
    """K1 on 1,029 walkers at nd = 1,792 and K5 on the fleet at 1,029 a target, with the
    reciprocal dial at 1 and 3 Newton steps, which v4's tail serves rolled
    (``reg_tail_rolled``): within the gate of their plain versions."""
    tgt, truth = build_bench_target(torch.float32, device=card, nd=1792)
    dials = dict(median_iters=14, matmul_passes=3, recip_newton=recip)
    tgt = dataclasses.replace(tgt, **dials)
    P = init_walker_batch(tgt, truth, NW, seed=2)
    got = ck.log_posterior_fused(P, tgt)
    assert _outside(got, ck.log_posterior_fused_reference(P, tgt)) <= int(PROD_OUTSIDE * NW)
    fleet, singles, truth = _fleet(card)
    fleet = dataclasses.replace(fleet, **dials)
    P = torch.stack([init_walker_batch(t, truth, NW, seed=1 + i) for i, t in enumerate(singles)])
    got = ck.log_posterior_fleet_fused(P, fleet)
    ref = ck.log_posterior_fleet_fused_reference(P, fleet)
    assert _outside(got, ref) <= int(PROD_OUTSIDE * ref.numel())


@pytest.mark.card
@pytest.mark.parametrize("dials", sorted(DIALS))
def test_k5_v4_at_the_fleet_shape(card, dials):
    """K5 on the fleet (9 ragged targets padded to nd = 1,792) at 1,029 walkers a target,
    with NaN walkers and out-of-bound temperatures: within the gate of the plain version,
    one ``log_posterior_fleet_fused_reg_row`` a launch, the counter's slots the offline
    count and the same bits with the counter on and off."""
    fleet, singles, truth = _fleet(card)
    import chip_smoke

    fleet = dataclasses.replace(fleet, **DIALS[dials])
    P = torch.stack([init_walker_batch(t, truth, 1029, seed=1 + i)
                     for i, t in enumerate(singles)])
    P[:, 3::7, 0] = float("nan")
    P[:, 5::11, 1] = float(singles[0].tmax) + 1.0
    before = dict(ck.LAUNCHES)
    got = ck.log_posterior_fleet_fused(P, fleet)
    grown = ck.LAUNCHES["log_posterior_fleet_fused_reg_row"] - before[
        "log_posterior_fleet_fused_reg_row"]
    assert grown == 1
    ref = ck.log_posterior_fleet_fused_reference(P, fleet)
    allowed = 0 if dials == "exact" else int(PROD_OUTSIDE * ref.numel())
    assert _outside(got, ref) <= allowed
    assert not torch.isfinite(got[:, 3::7]).any() and not torch.isfinite(got[:, 5::11]).any()
    ntgt, nT, nG, nd = fleet.D.shape
    wpb = ck.staged_block(nd, nT * nG, 1 + fleet.nspec)[0]
    with profiling.recording() as s:
        on = ck.log_posterior_fleet_fused(P, fleet)
    cols = s.columns()
    counts = [_rows_offline(nz, wpb) for nz in chip_smoke.fleet_wcomb(P, fleet) != 0]
    assert cols["rows_staged"] == sum(c[0] for c in counts)
    assert cols["rows_read"] == sum(c[1] for c in counts)
    assert cols["blocks_staged"] == ntgt * -(-1029 // wpb)
    assert _same_bits(on, got)
