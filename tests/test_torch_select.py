"""PyTorch port: K7 v2's histogram select against the k-ary median (CPU).

The large-nd median kernel K7 (``csrc/median_kary.cu``) computes the k-ary
median of ``spec_segmented.median_nonneg_reference`` by a histogram select
over the int32 bit pattern: levels of bins over ``max(v, 0)``, each taking the
first bin whose running count reaches the rank (the last bin where none
does), the fast midpoint after the k-ary rounds' 2 ceil(iters / 2) bits, and
for an exact even count the upper middle from the last level's counts and
the tracked min of the elements above.  There is no card here, so
``histogram_select`` below is a numpy model of that kernel, level for level
and bin for bin; it must give the plain version's bits and JAX's
``median_nonneg_xla``'s (float32) on the edge rows the kernel must place
where the k-ary search puts them: negative patterns, positive NaN and +inf,
the 1e30 sentinel above odd and even counts, rows held by one bin, zeros,
constant and tied rows, the whole bit range, and odd row lengths.  An even
count's upper middle is a float mean, so two NaN results count as equal
whatever their payload; every other result must have the same bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.ops import spec_segmented as jseg  # noqa: E402
from mcmc_spec_tpu_torch.ops import spec_segmented as seg  # noqa: E402

ITERS = [0, 8, 13, 14, 15, 29, 30, 31]
NAN, NEG_NAN, MAX_PATTERN = 0x7FC00000, -0x00400000, 0x7FFFFFFF  # NEG_NAN: 0xFFC00000


def select_plan(iters):
    """(bit widths of the levels, exact): ``select_plan`` of ``csrc/median_kary.cu``."""
    if iters <= 0 or iters >= 31:
        return (11, 10, 10), True
    b = 2 * ((iters + 1) // 2)
    return ((b,) if b <= 14 else (b // 2, b // 2)), False


def histogram_select(model, n_true, iters):
    """The numpy model of K7 v2: [rows] float32 medians of the float32 ``model``
    [rows, nd] over ``n_true`` [rows] true points."""
    bits_of, exact = select_plan(iters)
    out = np.empty(model.shape[0], dtype=np.float32)
    for i, v in enumerate(model.view(np.int32).astype(np.int64)):
        n = int(n_true[i])
        r1 = (n + 1) // 2
        u = np.maximum(v, 0)
        prefix = consumed = below = 0
        upper_out = np.float32(np.inf)
        for lev, w in enumerate(bits_of):
            shift = 31 - consumed - w
            hi = u >> (31 - consumed)
            hist = np.bincount((u[hi == prefix] >> shift) & ((1 << w) - 1), minlength=1 << w)
            if exact and lev == len(bits_of) - 1:  # tracked during the last pass
                above = v[hi > prefix].astype(np.int32).view(np.float32)
                upper_out = above.min() if above.size else np.float32(np.inf)
            cum = below + np.cumsum(hist)
            hit = np.flatnonzero(cum >= r1)
            b = int(hit[0]) if hit.size else (1 << w) - 1
            below = int(cum[b] - hist[b])
            prefix = (prefix << w) | b
            consumed += w
        if not exact:
            shift = 31 - consumed
            out[i] = np.int32((prefix << shift) + (1 << (shift - 1))).view(np.float32)
            continue
        x1 = np.int32(prefix).view(np.float32)
        if n % 2:
            out[i] = x1
            continue
        nxt = np.flatnonzero(hist[b + 1:])
        upper = upper_out
        if nxt.size:  # the next non-empty bin of the last level comes first
            inside = np.int32((prefix & ~((1 << w) - 1)) | (b + 1 + int(nxt[0]))).view(np.float32)
            upper = np.float32(np.nan) if np.isnan(upper_out) else inside
        x2 = x1 if below + hist[b] >= r1 + 1 else upper
        out[i] = np.float32(0.5) * (x1 + x2)
    return out


def _pattern(bits):
    return np.asarray(bits, dtype=np.int64).astype(np.int32).view(np.float32)


def edge_rows(nd, seed=0):
    """([rows, nd] float32, [rows] true counts): each edge row with an even and an odd
    count, beside ordinary rows."""
    rng = np.random.RandomState(seed)
    real = rng.uniform(0.05, 8.0, nd).astype(np.float32)
    j = np.arange(nd)
    rows = [rng.uniform(0.05, 8.0, nd).astype(np.float32) for _ in range(3)]
    rows += [np.zeros(nd, np.float32), np.full(nd, 1.2345, np.float32)]
    one_bin = real.copy()
    one_bin[j % 10 != 0] = real[0]
    neg = real.copy()
    neg[j % 3 == 0] = -0.0
    neg[j % 5 == 0] = -1.0
    neg[j % 7 == 0] = _pattern(NEG_NAN)
    nan = real.copy()
    nan[j % 10 == 0] = _pattern(NAN)
    nan[j % 11 == 0] = np.inf
    rows += [one_bin, neg, nan, _pattern(np.full(nd, NAN)), _pattern(np.full(nd, MAX_PATTERN)),
             _pattern(rng.permutation(nd) + 1), _pattern(rng.randint(0, 2**31 - 1, nd)),
             _pattern(0x3F800000 + rng.randint(0, 5, nd)),
             rng.choice([0.0, 0.25, 1.0, 1.0, 3.5], nd).astype(np.float32)]
    counts = [nd & ~1, (nd - 1) | 1]
    pad = real.copy()
    n_pad = nd - nd // 3
    pad[n_pad:] = 1e30
    model = np.stack([r for r in rows for _ in counts] + [pad, pad])
    n_true = np.array(counts * len(rows) + [n_pad & ~1, (n_pad - 1) | 1])
    return model, n_true


def _same(got, want):
    """Bit-identical, or NaN on both sides (an upper-middle mean's payload)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("nd", [256, 255, 97])
def test_select_model_matches_the_plain_kary_median(nd, iters):
    """Per-row counts, odd and even, on every edge row."""
    model, n_true = edge_rows(nd)
    got = histogram_select(model, n_true, iters)
    want = seg.median_nonneg_reference(torch.from_numpy(model), torch.from_numpy(n_true),
                                       iters).numpy()
    bad = np.flatnonzero(~_same(got, want))
    assert bad.size == 0, f"rows {bad}: model {got[bad]} vs plain {want[bad]}"


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("n_true", [256, 255, 171, 170])
def test_select_model_matches_jax(n_true, iters):
    """One count for all rows (JAX's ``median_nonneg_xla`` takes one), the 1e30
    sentinel above it; float32.  Without the subnormal row: XLA on the CPU flushes
    subnormals to zero in the upper-middle mean (0.5 * (x1 + x2) of two subnormals
    is 0 there), where torch and the card keep them; the plain-version test above
    holds that row."""
    model, _ = edge_rows(256, seed=1)
    subnormal = (model.view(np.int32) > 0) & (model.view(np.int32) < 0x00800000)
    model = model[~subnormal.all(axis=1)]
    model[:, n_true:] = np.float32(1e30)
    n = np.full(model.shape[0], n_true)
    got = histogram_select(model, n, iters)
    fn = jax.jit(lambda m, k: jseg.median_nonneg_xla(m, k, iters=iters))
    want = np.asarray(fn(jnp.asarray(model), jnp.asarray(n_true, jnp.int32)))
    bad = np.flatnonzero(~_same(got, want))
    assert bad.size == 0, f"rows {bad}: model {got[bad]} vs JAX {want[bad]}"


@pytest.mark.parametrize("iters,levels", [(0, 3), (31, 3), (1, 1), (13, 1), (14, 1), (15, 2),
                                          (16, 2), (29, 2), (30, 2)])
def test_select_passes_per_dial(iters, levels):
    """The passes over the row: one up to the production dial 14 (2^14 bins, the
    64 KB histogram), two at 15-30, three exact; at most 15 bits (128 KB) a level."""
    bits_of, exact = select_plan(iters)
    assert len(bits_of) == levels
    assert exact == (levels == 3)
    assert sum(bits_of) == (31 if exact else 2 * ((iters + 1) // 2))
    assert max(bits_of) <= (14 if levels == 1 else 15)


def test_select_plan_mirrors_the_kernel():
    """``select_plan`` above is the kernel's: its three cases in ``csrc/median_kary.cu``."""
    from mcmc_spec_tpu_torch.runtime import cuda_build

    src = (cuda_build.CSRC / "median_kary.cu").read_text()
    for line in ("if (iters <= 0 || iters >= 31) return SelectPlan{3, {11, 10, 10}, true};",
                 "const int b = 2 * ((iters + 1) / 2);",
                 "if (b <= 14) return SelectPlan{1, {b, 0, 0}, false};",
                 "return SelectPlan{2, {b / 2, b / 2, 0}, false};"):
        assert line in src, line
