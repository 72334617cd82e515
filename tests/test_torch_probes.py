"""PyTorch port: the fleet grid-order experiment and the launch-cost probes vs the
JAX package's scripts (CPU).

The JAX scripts (``scripts/try_fleet_grid_order.py``, ``scripts/dma_probe.py``,
``scripts/dma_probe_bisect.py``, ``scripts/dma_probe_bisect2.py``) are loaded
from their files as ``tests/test_torch_scripts.py`` loads them (shrunken
shapes, interpret-mode Pallas, the timers replaced by one call whose outputs
are kept).  Their ``jnp`` is wrapped so that every array they make from numpy
is recorded: the port's inputs must be those arrays, bit for bit.  On them the
plain versions of the port's kernels must give

* S6 ``spectrum_chi2_fleet_2d``, both orders, on a padded three-target fleet
  at the exact dials (31, 6, 0) and (14, 6, 2): the JAX 2-D-grid kernel
  within the JAX kernel gate (S6's plain version is K4's: the order changes
  no arithmetic);
* S1 ``trivial_probe``, S2 ``bisect_probe`` (every variant: the interpreter
  takes the SMEM operand and the scalar-prefetch grid spec) and S3
  ``bisect2_probe`` (every variant): the JAX kernels within the gate (rtol
  5e-5, atol 1e-4 * max|ref|), since the two sides sum in other orders.
"""
import dataclasses
import importlib.util
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu.bench_target import build_bench_target as jax_build_bench_target  # noqa: E402
from mcmc_spec_tpu.bench_target import init_walker_batch as jax_init_walker_batch  # noqa: E402
from mcmc_spec_tpu.inference import batched as jb  # noqa: E402
from mcmc_spec_tpu.inference import fleet as jf  # noqa: E402
from mcmc_spec_tpu_torch.inference.target import target_from_jax  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.scripts import dma_probe as s1  # noqa: E402
from mcmc_spec_tpu_torch.scripts import dma_probe_bisect as s2  # noqa: E402
from mcmc_spec_tpu_torch.scripts import dma_probe_bisect2 as s3  # noqa: E402
from mcmc_spec_tpu_torch.scripts import try_fleet_grid_order as s6  # noqa: E402
from tests.test_torch_scripts import (EXACT, FAST, ND, NW, _gate, _InterpretPallas,  # noqa: E402,F401
                                      _load, jax_script)

ND_FLEET = (256, 240, 224)  # three ragged targets, padded to 256
NW_FLEET, BLOCK_FLEET = 16, 8


class _RecordingJnp:
    """``jax.numpy`` whose ``asarray`` keeps a numpy copy of every array it makes."""

    def __init__(self):
        self.made = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def asarray(self, *args, **kwargs):
        out = jnp.asarray(*args, **kwargs)
        self.made.append(np.asarray(out))
        return out


class _RecordingPallas(_InterpretPallas):
    """Interpret-mode ``pallas`` that keeps every ``pallas_call`` it builds."""

    def __init__(self):
        self.calls = []

    def pallas_call(self, *args, **kwargs):
        call = _InterpretPallas.pallas_call(*args, **kwargs)
        self.calls.append(call)
        return call


@pytest.fixture
def probe_script(jax_script, monkeypatch):
    """A JAX probe script at the test shapes (``jax_script``) with recording ``jnp`` and
    ``pl``, and its ``timed`` replaced by one call whose output and operands are kept in
    ``mod.captured`` and ``mod.operands``."""

    def load(name):
        mod = jax_script(name)
        monkeypatch.setattr(mod, "jnp", _RecordingJnp())
        monkeypatch.setattr(mod, "pl", _RecordingPallas())
        operands = []

        def once(fn, args, n_iter=20):
            operands.append([np.asarray(a) for a in args])
            mod.captured.append(np.asarray(fn(*args)))
            return 1.0

        if hasattr(mod, "timed"):
            monkeypatch.setattr(mod, "timed", once)
        monkeypatch.setattr(mod, "operands", operands, raising=False)
        return mod

    return load


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _no_launch(fn, ref, *args, **kwargs):
    """The wrapper on CPU tensors: its plain version's bits, no kernel launch."""
    before = dict(ck.LAUNCHES)
    np.testing.assert_array_equal(fn(*args, **kwargs).numpy(), ref)
    assert ck.LAUNCHES == before


# ---------------------------------------------------------------------------
# S6 (try_fleet_grid_order)


@pytest.fixture(scope="module")
def jax_fleet():
    """(padded stacked JAX fleet, walkers [3, 16, 6] f32): three bench targets of seeds
    0-2 at nd 256, 240, 224 padded to 256, a truth-centred cloud per target with one
    walker at Av = 0."""
    members, P = [], []
    for i, nd in enumerate(ND_FLEET):
        t, truth = jax_build_bench_target(jnp.float32, nd=nd, grid_step=8.0, seed=i,
                                          pad_nd=ND_FLEET[0])
        members.append(t)
        P.append(np.array(jax_init_walker_batch(t, truth, NW_FLEET, jnp.float32, seed=i)))
    P = np.stack(P).astype(np.float32)
    P[:, 0, members[0].nspec] = 0.0
    return jf.stack_targets(members), P


@pytest.mark.parametrize("dials", [EXACT, FAST], ids=["exact", "fast"])
def test_fleet_grid_order_reference_matches_jax(jax_script, jax_fleet, dials):
    jmod = jax_script("try_fleet_grid_order")
    jfl = dataclasses.replace(jax_fleet[0], **dials)
    P = jax_fleet[1]
    Wcomb = jax.vmap(jb._forward_small)(jnp.asarray(P), jfl)[4]
    av = jnp.asarray(P[..., jfl.nspec])
    ntgt, nT, nG, nd = jfl.D.shape
    want = np.asarray(jmod.spectrum_chi2_fleet_2d(
        Wcomb, av, jfl.D.reshape(ntgt, nT * nG, nd), jfl.ext_k_data, jfl.data_flux,
        jfl.data_err, jfl.V, jfl.Vpinv, jfl.med_data, jfl.n_data_true, block=BLOCK_FLEET,
        iters=dials["median_iters"], mm_passes=dials["matmul_passes"],
        recip=dials["recip_newton"]))
    assert want.shape == (3, NW_FLEET)
    tf = target_from_jax(jfl, device="cpu", dtype=torch.float32)
    Wt, avt = torch.from_numpy(np.array(Wcomb)), torch.from_numpy(np.array(av))
    # the order is a schedule: S6's plain version is K4's, and the wrapper's CPU path
    # gives its bits in either order
    assert s6.spectrum_chi2_fleet_2d_reference is ck.spectrum_chi2_fleet_reference
    got = s6.spectrum_chi2_fleet_2d_reference(Wt, avt, tf).numpy()
    _gate(got.reshape(-1), want.reshape(-1))
    for order in s6.ORDERS:
        _no_launch(s6.spectrum_chi2_fleet_2d, got, Wt, avt, tf, order)


def test_fleet_grid_order_rejects_bad_arguments(jax_fleet):
    tf = target_from_jax(dataclasses.replace(jax_fleet[0], **EXACT), device="cpu",
                         dtype=torch.float32)
    W, av = torch.zeros((3, 4, 32)), torch.zeros((3, 4))
    with pytest.raises(ValueError, match="unknown order"):
        s6.spectrum_chi2_fleet_2d(W, av, tf, "diagonal")
    with pytest.raises(ValueError, match="not supported"):
        s6.spectrum_chi2_fleet_2d(W.to("meta"), av.to("meta"), tf)
    with pytest.raises(ValueError, match="dials unset"):
        s6.spectrum_chi2_fleet_2d(W, av, dataclasses.replace(tf, median_iters=0))


# ---------------------------------------------------------------------------
# S1 (dma_probe)


@pytest.mark.parametrize("ntab", [0, 1, 3])
def test_trivial_probe_reference_matches_jax(probe_script, ntab):
    jmod = probe_script("dma_probe")
    nd, block = 128, 32
    jmod.trivial_call(nd, block, ntab, nw=NW)
    p, tables = s1.trivial_arrays(nd, ntab, nw=NW)
    _same_arrays(jmod.jnp.made[: 1 + ntab], [p] + tables)
    want = np.asarray(jmod.pl.calls[0](jnp.asarray(p), *map(jnp.asarray, tables)))
    got = s1.trivial_probe_reference(*_t([p]), _t(tables)).numpy()
    assert got.shape == (NW,) and np.isfinite(got).all()
    _gate(got, want[:, 0])
    _no_launch(s1.trivial_probe, got, torch.from_numpy(p), _t(tables), block)


def test_trivial_probe_sweeps_are_the_jax_scripts(jax_script, monkeypatch):
    jmod = jax_script("dma_probe")
    calls = []
    monkeypatch.setattr(jmod, "trivial_call",
                        lambda nd, block, n_tables, nw=None: calls.append((nd, block, n_tables))
                        or 1.0)
    jmod.main()
    sweep_a = [(nd, s1.BLOCK, ntab) for nd in s1.ND_SWEEP for ntab in s1.NTAB_SWEEP]
    assert calls[: len(sweep_a)] == sweep_a
    blocks = [block for _, block, _ in calls[len(sweep_a):]]
    assert all((nd, ntab) == (1792, 6) for nd, _, ntab in calls[len(sweep_a):])
    # the port adds one walker a block (K1's shape) and 32 (S8's tile)
    assert [b for b in s1.BLOCK_SWEEP if b not in blocks] == [1, 32]
    assert [b for b in s1.BLOCK_SWEEP if b in blocks] == blocks
    j0 = _load("dma_probe")  # the script's own constants
    assert (s1.NW, s1.NO) == (j0.NW, j0.NO)


# ---------------------------------------------------------------------------
# S2 (dma_probe_bisect)


@pytest.mark.parametrize("variant", list(s2.VARIANTS))
def test_bisect_probe_reference_matches_jax(probe_script, variant):
    jmod = probe_script("dma_probe_bisect")
    fn, args = jmod.build(**s2.VARIANTS[variant])
    want = np.asarray(fn(*args))[:, 0]
    p, tables, scal = s2.bisect_arrays(variant, nw=NW, nd=ND)
    _same_arrays([np.asarray(a) for a in args],
                 [p] + ([scal] if scal is not None else []) + tables)
    tp, tt, tscal, body = s2.bisect_inputs("cpu", variant, nw=NW, nd=ND)
    assert body == bool(s2.VARIANTS[variant].get("body_ops"))
    got = s2.bisect_probe_reference(tp, tt, tscal, body).numpy()
    assert got.shape == (NW,) and np.isfinite(got).all()
    _gate(got, want)
    _no_launch(s2.bisect_probe, got, tp, tt, tscal, body)


def test_bisect_probe_variants_are_the_jax_scripts(jax_script, monkeypatch):
    jmod = jax_script("dma_probe_bisect")
    calls = []
    monkeypatch.setattr(jmod, "run", lambda name, **kw: calls.append((name, kw)) or 1.0)
    jmod.main()
    assert calls == list(s2.VARIANTS.items())
    j0 = _load("dma_probe_bisect")  # the script's own constants
    assert (s2.NW, s2.NO, s2.ND, s2.BLOCK) == (j0.NW, j0.NO, j0.ND, j0.BLOCK)


# ---------------------------------------------------------------------------
# S3 (dma_probe_bisect2)


@pytest.mark.parametrize("variant", list(s3.variants()))
def test_bisect2_probe_reference_matches_jax(probe_script, variant):
    jmod = probe_script("dma_probe_bisect2")
    shapes, read = s3.variants(ND)[variant]
    jmod.run(variant, shapes, read=read)
    p, tables = s3.bisect2_arrays(shapes, nw=NW)
    _same_arrays(jmod.operands[0], [p] + tables)
    got = s3.bisect2_probe_reference(*_t([p]), _t(tables), read).numpy()
    assert got.shape == (NW,) and np.isfinite(got).all()
    _gate(got, jmod.captured[0][:, 0])
    _no_launch(s3.bisect2_probe, got, torch.from_numpy(p), _t(tables), read)


def test_bisect2_probe_variants_are_the_jax_scripts(monkeypatch):
    jmod = _load("dma_probe_bisect2")  # at the script's own ND
    calls = []
    monkeypatch.setattr(jmod, "run", lambda name, shapes, read="full": calls.append(
        (name, (list(shapes), read))) or 1.0)
    jmod.main()
    assert calls == list(s3.variants().items())
    assert s3.REALMIX == jmod.REALMIX and s3.table_floats(s3.REALMIX) == 118748
    assert (s3.NW, s3.ND, s3.BLOCK) == (jmod.NW, jmod.ND, jmod.BLOCK)


# ---------------------------------------------------------------------------
# wrappers and entry points


def test_probe_wrappers_reject_bad_arguments():
    p, tables = _t([np.zeros((4, 8), np.float32)])[0], [torch.zeros((2, 3))]
    bad = [
        lambda: s1.trivial_probe(p[:, :7].contiguous(), tables),  # 7 columns
        lambda: s1.trivial_probe(p.double(), tables),
        lambda: s1.trivial_probe(p, [tables[0].double()]),
        lambda: s1.trivial_probe(p, tables * 21),
        lambda: s1.trivial_probe(p, [torch.zeros(0)]),
        lambda: s1.trivial_probe(p, tables, walkers_per_cta=0),
        lambda: s2.bisect_probe(p, []),  # the first table is read
        lambda: s2.bisect_probe(p[:, :1].contiguous(), tables),
        lambda: s2.bisect_probe(p, tables, scal=(1.0, 2.0)),
        lambda: s3.bisect2_probe(p, tables, read="sum"),
        lambda: s3.bisect2_probe(p[0], tables),
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()


def test_probe_wrappers_refuse_other_devices():
    """No plain version for tensors that are not on the CPU, nor for a CPU tensor
    mixed with tensors on another device."""
    p, tables = torch.zeros((4, 8)), [torch.zeros((2, 3))]
    meta = lambda t: t.to("meta")
    for fn in (s1.trivial_probe, s2.bisect_probe, s3.bisect2_probe):
        with pytest.raises(ValueError, match="not supported"):
            fn(meta(p), [meta(tables[0])])
        with pytest.raises(ValueError, match="on meta"):
            fn(meta(p), tables)
        with pytest.raises(ValueError, match="on cpu"):
            fn(p, [meta(tables[0])])


def test_probe_bytes_count_what_is_read():
    """The probes' bounds count the bytes each function needs: p and the output once,
    one float of the tables for S1 and S2, and for S3 one float of each table (peek) or
    every table (full)."""
    nw = s1.NW
    assert s1.trivial_bytes(nw, 0) == 4 * (nw * s1.PW + nw)
    assert s1.trivial_bytes(nw, 6) == s1.trivial_bytes(nw, 1) == s1.trivial_bytes(nw, 0) + 4
    assert s2.bisect_bytes(nw, 6) == 4 * (nw * 6 + 1 + nw)
    shapes = s3.realmix()
    assert s3.bisect2_bytes(nw, shapes, "peek") == 4 * (nw * s1.PW + len(shapes) + nw)
    assert s3.bisect2_bytes(nw, shapes, "full") == 4 * (nw * s1.PW + 118748 + nw)


def test_probe_mains_run_on_cpu(capsys):
    r1 = s1.main(device="cpu", nw=64, nd_sweep=(32, 64), block_sweep=(1, 32, 64))
    assert set(r1) == ({("A", nd, n) for nd in (32, 64) for n in s1.NTAB_SWEEP}
                       | {("B", b) for b in (1, 32, 64)} | {"library", "replayed"})
    assert r1["replayed"] == 0
    r2 = s2.main(device="cpu", nw=64, nd=64)
    assert set(r2) == set(s2.VARIANTS) | {"replayed"}
    r3 = s3.main(device="cpu", nw=64, nd=64)
    assert set(r3) == {(v, s3.BLOCK) for v in s3.variants()} | {("realmix", 1), "replayed"}
    r6 = s6.main(device="cpu", ntgt=2, nw=8, nd=96, grid_step=16.0)
    assert set(r6) == {"A", "target_major", "walker_major", "C", "D"}
    out = capsys.readouterr().out
    assert "host-clock times of the plain versions, not device times" in out
    assert "bit-identical to target_major: True" in out and "[D] single-target fused (K1)" in out
    assert out.count("K4 within the kernel gate of it: True (0 walkers outside") == 2
    assert "(no CUDA counterpart of a zero-scalar prefetch grid spec" in out
    assert "realmix @   1 walkers a block (64 blocks)" in out and "[library] torch.sum" in out


def test_probe_mains_need_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (s1.main, s2.main, s3.main, s6.main):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main()


def test_new_modules_are_walked_without_jax():
    """``test_port_runs_without_jax`` imports every module ``walk_packages`` finds,
    with JAX unimportable; the four entry points are among them."""
    import mcmc_spec_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(mcmc_spec_tpu_torch.__path__,
                                                   "mcmc_spec_tpu_torch.")}
    new = {f"mcmc_spec_tpu_torch.scripts.{n}" for n in
           ("try_fleet_grid_order", "dma_probe", "dma_probe_bisect", "dma_probe_bisect2")}
    assert new <= names
    for name in new:
        source = importlib.util.find_spec(name).origin
        text = open(source).read()
        assert "import jax" not in text and "mcmc_spec_tpu." not in text


def test_probe_kernels_are_built_and_counted():
    from mcmc_spec_tpu_torch.runtime import cuda_build

    for src in ("fleet_grid_order.cu", "launch_probe.cu"):
        assert src in cuda_build.SOURCES and (cuda_build.CSRC / src).is_file()
    for name in ("spectrum_chi2_fleet_2d", "trivial_probe", "bisect_probe", "bisect2_probe"):
        assert name in ck.LAUNCHES
    for fn in ("fleet_grid_order_launch", "trivial_probe_launch", "bisect_probe_launch",
               "bisect2_probe_launch"):
        assert fn in ck._SIGNATURES
