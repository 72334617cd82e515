"""PyTorch port: the layout and summation order of K8 and K9 v2 (CPU).

K8 (``renorm_partials``) and K9 (``resid_chi2``) in ``csrc/segmented_stats.cu``
run a block per chunk of ``LANE_W`` walkers and segment of the points
(``spec_segmented.lane_stats_layout``), then sum the segments in a second
kernel.  There is no card here, so:

* the layout's Python twin (``lane_stats_block``) is held to cover every
  (walker, point) exactly once, with every chunk's rows aligned over its body,
  at the lane's real shapes, and to fill the card at 171 and 1,024 walkers;
* a numpy rendering of the kernels' summation order (float32 partials per
  thread over its steps, a butterfly in each warp, the warps in order, the
  segments in order; ``fmaf`` as a float64 product and sum rounded to float32)
  is held within the kernel gate (rtol 5e-5, atol 1e-4 * max|ref|) of the plain
  versions and of the JAX Pallas kernels in interpret mode, both renorm modes,
  recip 0, 1 and 2, on one segment and on many, at a tileable and an odd nd;
* the constants, the C signatures and what K9's wrapper hands its kernel
  (``data_err`` and ``V`` as they are) are checked against the source;
* the checkout comparison (``scripts/lane_against_checkout``) runs on the CPU.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmc_spec_tpu.ops import spec_segmented as jseg  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.ops import spec_segmented as seg  # noqa: E402
from mcmc_spec_tpu_torch.runtime import cuda_build  # noqa: E402
from tests.test_torch_fleet_k4 import _c_signature  # noqa: E402
from tests.test_torch_segmented import _jax_median, _segmented_args  # noqa: E402

H100_SMS = 132
SOURCE = cuda_build.CSRC / "segmented_stats.cu"


def _t(x):
    return torch.from_numpy(np.array(x))


def _gate(got, ref, rtol=5e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=1e-4 * np.abs(ref[fin]).max())


# ---------------------------------------------------------------------------
# the layout


@pytest.mark.parametrize("nd", [1, 4097, 65535, 65536, 131072])
@pytest.mark.parametrize("NW", [1, 5, 170, 171, 1024, 2048])
def test_layout_covers_every_walker_and_point_once(NW, nd):
    """Chunks partition the walkers and segments the points, so each (walker, point)
    lies in exactly one block; each block's head, body and tail partition its segment,
    the head and tail under 4 points, and every walker's row is 16-byte aligned over
    the body, whatever the model's own offset.  The layout also passes the launch's
    checks (``lane_chunks`` in the source)."""
    lay = seg.lane_stats_layout(NW, nd)
    assert lay.groups == 4 // math.gcd(nd, 4)
    assert lay.seg_len % seg.LANE_STEP == 0
    assert (lay.n_seg - 1) * lay.seg_len < nd <= lay.n_seg * lay.seg_len
    G, W = lay.groups, seg.LANE_W
    assert lay.chunks == G * math.ceil(math.ceil(NW / G) / W)
    seen = np.zeros(NW, np.int64)
    for k in range(lay.chunks):
        walkers = seg.lane_stats_block(lay, NW, nd, k * lay.n_seg)[0]
        assert len(walkers) <= W and len({w % G for w in walkers}) <= 1
        seen[walkers] += 1
        pieces = [seg.lane_stats_block(lay, NW, nd, k * lay.n_seg + s, offset)
                  for s in range(lay.n_seg) for offset in (0, 3)]
        for ws, lo, hi, a, nq in pieces:
            assert ws == walkers and lo <= a <= hi and a - lo < 4 and 0 <= hi - a - 4 * nq < 4
        segs = sorted({(lo, hi) for _, lo, hi, _, _ in pieces})
        assert segs[0][0] == 0 and segs[-1][1] == nd
        assert all(lo < hi for lo, hi in segs)
        assert all(s[1] == t[0] for s, t in zip(segs, segs[1:]))
    assert (seen == 1).all()
    for b in range(0, lay.blocks, max(1, lay.blocks // 64)):
        for offset in range(4):
            ws, lo, hi, a, nq = seg.lane_stats_block(lay, NW, nd, b, offset)
            if nq:
                assert all((offset + w * nd + a) % 4 == 0 for w in ws)


@pytest.mark.parametrize("NW", [171, 1024])
def test_layout_fills_the_card(NW):
    """The fit's stage-2 half-step and the throughput half-step at nd = 65,536 both give
    at least two blocks for each of an H100's SMs, in segments of whole steps."""
    lay = seg.lane_stats_layout(NW, 65536)
    assert lay.blocks >= 2 * H100_SMS
    assert lay.seg_len >= seg.LANE_MIN_STEPS * seg.LANE_STEP


def test_layout_constants_match_the_source():
    text = SOURCE.read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    assert int(const("kLaneThreads")) == seg.LANE_THREADS
    assert seg.LANE_STEP == 4 * seg.LANE_THREADS  # a float4 a thread
    assert int(const("kLaneW")) == seg.LANE_W
    for nd in range(1, 17):
        assert seg.lane_groups(nd) == 4 // math.gcd(nd, 4)


# ---------------------------------------------------------------------------
# the launches


@pytest.mark.parametrize("name,pointers,ints", [("renorm_partials_launch", 6, 5),
                                                ("resid_chi2_launch", 8, 6)])
def test_launch_signatures_match_the_source(name, pointers, ints):
    """K8: model, scale, data, Vpinv, scratch, out; NW, nd, recip, seg_len, n_seg.
    K9: model, scale, coeffs, data, err, V, scratch, out; NW, nd, recip, renorm,
    seg_len, n_seg.  Then the stream."""
    assert ck._SIGNATURES[name] == _c_signature(name)
    assert ck._SIGNATURES[name] == [ck._P] * pointers + [ck._I] * ints + [ck._P]


def _record_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(seg, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(seg, "_stream", lambda dev: 0)
    return calls


def _stats_inputs(NW, nd, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32))
    return f(NW, nd), f(NW), f(NW, 3), f(nd), f(nd), f(nd, 3), f(3, nd)


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("NW,nd", [(171, 65536), (5, 300)])
def test_k9_hands_data_err_and_v_to_the_kernel_untouched(monkeypatch, NW, nd, renorm):
    """K9's CUDA path passes ``data_err`` and the [nd, 3] ``V`` themselves (no
    ``1 / data_err``, no ``V.T`` copy), coeffs and V only under renorm, the scratch
    of the layout's segments (none for one segment) and the layout."""
    calls = _record_launch(monkeypatch)
    model, scale, coeffs, data, err, V, _ = _stats_inputs(NW, nd)
    out = seg._resid_chi2_launch(model, scale, coeffs, data, err, V, 2, renorm)
    assert out.shape == (NW,)
    (fn, counter, m, s, c, d, e, v, part, o, *ints), = calls
    lay = seg.lane_stats_layout(NW, nd)
    assert (fn, counter) == ("resid_chi2_launch", "resid_chi2")
    assert (m, s, d, o) == (model.data_ptr(), scale.data_ptr(), data.data_ptr(), out.data_ptr())
    assert e == err.data_ptr()
    assert (c, v) == ((coeffs.data_ptr(), V.data_ptr()) if renorm else (None, None))
    assert (part is None) == (lay.n_seg == 1)
    assert ints == [NW, nd, 2, int(renorm), lay.seg_len, lay.n_seg, 0]


@pytest.mark.parametrize("NW,nd", [(171, 65536), (5, 300)])
def test_k8_launch_takes_the_layout(monkeypatch, NW, nd):
    calls = _record_launch(monkeypatch)
    model, scale, _, data, _, _, Vpinv = _stats_inputs(NW, nd)
    out = seg._renorm_partials_launch(model, scale, data, Vpinv, 0)
    assert out.shape == (NW, 3)
    (fn, counter, m, s, d, p, part, o, *ints), = calls
    lay = seg.lane_stats_layout(NW, nd)
    assert (fn, counter) == ("renorm_partials_launch", "renorm_partials")
    assert (m, s, d, p, o) == tuple(t.data_ptr() for t in (model, scale, data, Vpinv, out))
    assert (part is None) == (lay.n_seg == 1)
    assert ints == [NW, nd, 0, lay.seg_len, lay.n_seg, 0]


def test_wrappers_check_shapes_before_launch(monkeypatch):
    calls = _record_launch(monkeypatch)
    model, scale, coeffs, data, err, V, Vpinv = _stats_inputs(4, 64)
    with pytest.raises(ValueError, match="V: expected"):
        seg._resid_chi2_launch(model, scale, coeffs, data, err, V.T, 0, True)
    with pytest.raises(ValueError, match="data_err: expected"):
        seg._resid_chi2_launch(model, scale, coeffs, data, err[:-1], V, 0, False)
    with pytest.raises(ValueError, match="Vpinv: expected"):
        seg._renorm_partials_launch(model, scale, data, Vpinv.T, 0)
    assert not calls
    # V.T of a [3, nd] table is a non-contiguous [nd, 3]: made contiguous, then launched
    seg._resid_chi2_launch(model, scale, coeffs, data, err, Vpinv.T, 0, True)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# a numpy rendering of the kernels' summation order


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _div(num, den, recip):
    if recip == 0:
        return (num / den).astype(np.float32)
    r = (np.uint32(ck._RECIP_MAGIC) - den.view(np.uint32)).view(np.float32)
    for _ in range(recip):
        r = r * (np.float32(2.0) - den * r)
    return num * r


def kernel_order_sums(terms, NW, nd, K):
    """The sums of K8 or K9 in the kernels' order: ``terms(w, lo, hi)`` gives walker w's
    fmaf operands (a, b), each [K, hi - lo] float32, over points [lo, hi).  Returns
    [NW, K] float32."""
    lay = seg.lane_stats_layout(NW, nd)
    T, nwarp = seg.LANE_THREADS, seg.LANE_THREADS // 32
    part = np.zeros((lay.n_seg, NW, K), np.float32)
    for b in range(lay.blocks):
        ws, lo, hi, a, nq = seg.lane_stats_block(lay, NW, nd, b)
        if not ws:
            continue
        s = b % lay.n_seg
        steps = -(-nq // T)
        for w in ws:
            x, y = terms(w, lo, hi)
            # thread t's body points a + 4 (t + T i) + c, step i, component c
            bx, by = (np.zeros((K, steps * T * 4), np.float32) for _ in range(2))
            body = slice(a - lo, a - lo + 4 * nq)
            bx[:, :4 * nq], by[:, :4 * nq] = x[:, body], y[:, body]
            bx, by = bx.reshape(K, steps, T, 4), by.reshape(K, steps, T, 4)
            acc = np.zeros((K, T), np.float32)
            for i in range(steps):
                for c in range(4):
                    acc = _fma(bx[:, i, :, c], by[:, i, :, c], acc)
            # the scalar points, head then tail, to threads 0, 1, ...
            scalar = [j - lo for j in range(lo, a)] + [j - lo for j in range(a + 4 * nq, hi)]
            for t, j in enumerate(scalar):
                acc[:, t] = _fma(x[:, j], y[:, j], acc[:, t])
            v = acc.reshape(K, nwarp, 32)
            lanes = np.arange(32)
            for o in (16, 8, 4, 2, 1):
                v = v + v[:, :, lanes ^ o]
            tot = v[:, 0, 0]
            for wp in range(1, nwarp):
                tot = tot + v[:, wp, 0]
            part[s, w] = tot
    out = part[0]
    for s in range(1, lay.n_seg):
        out = out + part[s]
    return out


def k8_order(model, scale, data, Vpinv, recip):
    def terms(w, lo, hi):
        f = _div(data[lo:hi], scale[w] * model[w, lo:hi], recip)
        return np.broadcast_to(f, (3, hi - lo)), Vpinv[:, lo:hi]
    return kernel_order_sums(terms, *model.shape, 3)


def k9_order(model, scale, coeffs, data, err, V, recip, renorm):
    ie = (np.float32(1.0) / err).astype(np.float32)

    def terms(w, lo, hi):
        t = data[lo:hi]
        if renorm:
            c, v = coeffs[w], V[lo:hi]
            t = _div(t, (c[0] * v[:, 0] + c[1] * v[:, 1]) + c[2] * v[:, 2], recip)
        r = ((scale[w] * model[w, lo:hi] - t) * ie[lo:hi])[None, :]
        return r, r
    return kernel_order_sums(terms, *model.shape, 1)[:, 0]


@pytest.fixture(scope="module")
def lane4096():
    """The JAX model of 13 walkers at nd = 4,096 (tileable) and its median-match scale,
    the lane's rows, and the same at nd = 4,097 (odd: every class of row offsets)."""
    out = {}
    for nd in (4096, 4097):
        _, Wcomb, av, (D, kd, data, err, V, Vpinv, med_data, n_true), _ = _segmented_args(nd, 13)
        model = np.asarray(jseg.model_extinct(Wcomb, av, D, kd, 6, interpret=True))
        scale = (med_data / _jax_median(model, n_true, None)).astype(np.float32)
        err = err.copy()
        err[-3:] = np.inf  # padded points: 1/err = 0
        out[nd] = (model, scale, data, err, V, Vpinv)
    return out


@pytest.mark.parametrize("min_steps", [16, seg.LANE_MIN_STEPS, 1])
@pytest.mark.parametrize("recip", [0, 1, 2])
@pytest.mark.parametrize("nd", [4096, 4097])
def test_summation_order_within_the_gate(lane4096, monkeypatch, nd, recip, min_steps):
    """The kernels' order against the plain versions and, at the tileable nd, the JAX
    Pallas kernels in interpret mode: K8, then K9 with and without renorm on the same
    coefficients.  ``min_steps`` (``LANE_MIN_STEPS``) cuts the points into one segment
    (16), two (the default) or one a step (1)."""
    monkeypatch.setattr(seg, "LANE_MIN_STEPS", min_steps)
    model, scale, data, err, V, Vpinv = lane4096[nd]
    lay = seg.lane_stats_layout(*model.shape)
    assert lay.n_seg == {16: 1, 1: -(-nd // seg.LANE_STEP)}.get(min_steps, 2)
    assert lay.groups == (1 if nd == 4096 else 4)
    got_c = k8_order(model, scale, data, Vpinv, recip)
    ref_c = seg.renorm_partials_reference(_t(model), _t(scale), _t(data), _t(Vpinv), recip)
    _gate(got_c, ref_c.numpy())
    if nd == 4096:
        _gate(got_c, jseg.renorm_partials(model, scale, data, Vpinv, recip, interpret=True))
    for renorm in (True, False):
        got = k9_order(model, scale, got_c, data, err, V, recip, renorm)
        ref = seg.resid_chi2_reference(_t(model), _t(scale), _t(got_c), _t(data), _t(err), _t(V),
                                       recip, renorm)
        _gate(got, ref.numpy())
        if nd == 4096:
            _gate(got, jseg.resid_chi2(model, scale, got_c if renorm else None, data, err, V,
                                       recip, renorm=renorm, interpret=True))


def test_summation_order_keeps_non_finite_values():
    """A NaN model value makes its walker's K8 and K9 sums NaN and no other's, as in the
    plain versions; an infinite err (padding) adds nothing."""
    model, scale, coeffs, data, err, V, Vpinv = (t.numpy() for t in _stats_inputs(6, 1030))
    model = model.copy()
    model[4, 517] = np.nan
    err = err.copy()
    err[-2:] = np.inf
    c = k8_order(model, scale, data, Vpinv, 0)
    assert np.isnan(c[4]).all() and np.isfinite(np.delete(c, 4, 0)).all()
    for renorm in (True, False):
        got = k9_order(model, scale, coeffs, data, err, V, 0, renorm)
        ref = seg.resid_chi2_reference(*map(_t, (model, scale, coeffs, data, err, V)), 0, renorm)
        _gate(got, ref.numpy())
        assert np.isnan(got[4]) and np.isfinite(np.delete(got, 4)).all()


# ---------------------------------------------------------------------------
# the checkout comparison on the CPU


@pytest.mark.parametrize("kernel", ["model_extinct", "renorm_partials", "resid_chi2",
                                    "resid_chi2_raw"])
def test_lane_against_checkout_runs_on_cpu(kernel):
    """This checkout against itself, one kernel: the child processes run the plain
    versions on the same saved inputs at both walker counts, so K6's rows match bit
    for bit and K8's and K9's walkers all lie in the gate; the four runs alternate
    other, this, this, other, and off the card none is timed alone."""
    from mcmc_spec_tpu_torch.scripts import lane_against_checkout as lac

    res = lac.main(lac.HERE, kernel, device="cpu", nw=5, nd=300, nw_stage2=3)
    assert sorted(res) == sorted(f"{kernel} {n}" for n in (5, 3))
    for key, r in res.items():
        assert len(r["this_ms"]) == len(r["other_ms"]) == 2
        assert r["this_alone_ms"] == r["other_alone_ms"] == [None, None]
        assert "speedup_alone" not in r
        if kernel == "model_extinct":
            assert r["rows"] == r["rows_same"] == int(key.split()[-1])
        else:
            assert r["outside"] == 0 and r["max_rel_diff"] == 0.0
    with pytest.raises(ValueError, match="not one of"):
        lac.main(lac.HERE, "median_nonneg", device="cpu")
