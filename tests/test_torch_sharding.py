"""PyTorch port: walker sharding (``parallel.sharding``), the mesh (``parallel.mesh``), the
sharded pipeline and CLI (CPU).

The sharded chains run in gloo worlds of 2 and 4 spawned ranks
(``testing.run_world``), one world a size for the whole module, in float64 on
one CPU thread a rank:

* the walker-sharded chain (2 and 4 ranks) is ``run_ensemble``'s from the same
  generator bit for bit: every rank draws the whole ensemble's numbers and
  takes its share, and each walker's log-posterior does not depend on the
  batch it is evaluated in;
* the 2x2 spec-sharded chain is the 4-rank walker chain (JAX's
  ``tests/test_spec_shard.py`` holds its 2-D chain against its walker chain to
  rtol 1e-5; here it agrees to 1e-12 relative: the sharded sums round
  differently, and at these scales no accept decision flips);
* ``parse_wxs``, ``resolve_mesh`` and ``check_wxs_stage_counts`` raise JAX's errors.

The pipeline: a stage-2 checkpoint written on one device resumes on a 2-rank
walker mesh to the uninterrupted run's ``samples.txt`` byte for byte; the CLI
under ``python -m torch.distributed.run`` with ``--mesh auto`` (2 ranks)
writes the single-device CLI's ``samples.txt`` byte for byte, and with
``--mesh 1x2`` writes the same artifact set, from rank 0 only.  The CLI's
refusals come before any compute.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmc_spec_tpu_torch import cli, testing  # noqa: E402
from mcmc_spec_tpu_torch.testing import run_world  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NW, STEPS, THIN = 32, 6, 2
NTHIN = 20  # the resume test's chunk length


def _bench():
    from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch

    tgt, truth = build_bench_target(torch.float64, device="cpu", nd=256, grid_step=8.0)
    return tgt, init_walker_batch(tgt, truth, NW, torch.float64)


def _single_device():
    """run_ensemble's chain, log-probs, final state and accept count, on one thread."""
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.inference.stretch import init_ensemble, run_ensemble, stretch_step

    tgt, coords = _bench()
    logp = lambda b: log_posterior_batch(b, tgt)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = init_ensemble(coords, logp, torch.Generator().manual_seed(4))
        state, chain, logps = run_ensemble(state, logp, STEPS, thin=THIN)
        one = stretch_step(init_ensemble(coords, logp, torch.Generator().manual_seed(5)), logp)
        return {"chain": chain.numpy(), "logps": logps.numpy(), "coords": state.coords.numpy(),
                "n_accept": int(state.n_accept), "logp0": logp(coords).numpy(),
                "step": one.coords.numpy()}
    finally:
        torch.set_num_threads(n)


# --------------------------------------------------------------- the ranks
def _walker_chain(mesh):
    from mcmc_spec_tpu_torch.inference.batched import log_posterior_batch
    from mcmc_spec_tpu_torch.parallel import sharding

    tgt, coords = _bench()
    logp = lambda b: log_posterior_batch(b, tgt)
    state = sharding.shard_ensemble_state(coords, logp, torch.Generator().manual_seed(4), mesh)
    state, chain, logps = sharding.run_ensemble_sharded(state, logp, mesh, STEPS, thin=THIN)
    one = sharding.sharded_stretch_step(
        sharding.shard_ensemble_state(coords, logp, torch.Generator().manual_seed(5), mesh),
        logp, mesh)
    g = lambda x, dim: sharding.gather_walkers(x, mesh, dim).numpy()
    return {"chain": g(chain, 2).reshape(-1, NW, coords.shape[1]),
            "logps": g(logps, 2).reshape(-1, NW),
            "coords": g(state.coords, 1).reshape(NW, -1), "n_accept": int(state.n_accept),
            "logp0": sharding.sharded_log_prob(logp, mesh)(coords).numpy(),
            "step": g(one.coords, 1).reshape(NW, -1)}


def _spec_chain(mesh):
    from mcmc_spec_tpu_torch.parallel import sharding, spec_shard

    tgt, coords = _bench()
    t = spec_shard.shard_target_over_spec(tgt, mesh)
    state = spec_shard.shard_spec_ensemble_state(coords, t, torch.Generator().manual_seed(4),
                                                 mesh)
    state, chain, logps = spec_shard.run_ensemble_spec_sharded(state, t, mesh, STEPS,
                                                               thin=THIN)
    g = lambda x, dim: sharding.gather_walkers(x, mesh, dim).numpy()
    return {"chain": g(chain, 2).reshape(-1, NW, coords.shape[1]),
            "logps": g(logps, 2).reshape(-1, NW), "n_accept": int(state.n_accept)}


def _errors(fn, *cases):
    out = []
    for args in cases:
        try:
            got = fn(*args)
            out.append(None if got is None else
                       (getattr(got, "axis_names", None), getattr(got, "shape", None)))
        except ValueError as e:
            out.append(str(e))
    return out


def _ranks_2(rank):
    from mcmc_spec_tpu_torch.parallel.mesh import make_mesh

    return {"walkers": _walker_chain(make_mesh(2, 1, device="cpu",
                                                axis_names=("walkers",)))}


def _ranks_4(rank):
    from mcmc_spec_tpu_torch.parallel.mesh import make_mesh
    from mcmc_spec_tpu_torch.pipeline import resolve_mesh

    out = {"walkers": _walker_chain(make_mesh(4, 1, device="cpu", axis_names=("walkers",))),
           "spec": _spec_chain(make_mesh(2, 2, device="cpu"))}
    mesh = resolve_mesh("2x2", 64, device="cpu")
    out["mesh"] = (mesh.axis_names, mesh.shape, mesh.w_index, mesh.s_index)
    out["resolve"] = _errors(lambda *a: resolve_mesh(*a, device="cpu"),
                             ("4x2", 64), ("2x2", 62), ("banana", 64), ("0x2", 64),
                             ("2x2", 150, False), ("2x2", 150), ("auto", 64), ("auto", 60),
                             (None, 64), ("2x1", 64))
    return out


@pytest.fixture(scope="module")
def worlds():
    return {2: run_world(_ranks_2, 2), 4: run_world(_ranks_4, 4)}


@pytest.fixture(scope="module")
def single():
    return _single_device()


@pytest.mark.parametrize("ranks", [2, 4])
def test_walker_sharded_chain_is_run_ensemble_bit_for_bit(worlds, single, ranks):
    for out in worlds[ranks]:
        got = out["walkers"]
        for key in ("chain", "logps", "coords", "logp0", "step"):
            assert np.array_equal(got[key], single[key]), key
        assert got["n_accept"] == single["n_accept"] > 0


def test_spec_chain_matches_the_walker_chain(worlds):
    for out in worlds[4]:
        spec, walkers = out["spec"], out["walkers"]
        assert spec["chain"].shape == (STEPS // THIN, NW, 6)
        np.testing.assert_allclose(spec["chain"], walkers["chain"], rtol=1e-12, atol=0)
        np.testing.assert_allclose(spec["logps"], walkers["logps"], rtol=1e-12, atol=0)
        assert spec["n_accept"] == walkers["n_accept"]


def test_resolve_mesh_gives_jax_errors(worlds):
    import jax
    from jax.sharding import Mesh

    from mcmc_spec_tpu import pipeline as jpipe

    for rank, out in enumerate(worlds[4]):
        assert out["mesh"] == (("walkers", "spec"), {"walkers": 2, "spec": 2}, rank // 2,
                               rank % 2)
        (too_many, odd_nw, banana, zero, anneal_ok, halves, auto, auto_odd, off,
         too_few) = out["resolve"]
        assert too_many.startswith("mesh '4x2' needs 8 devices, have 4")
        assert anneal_ok == (("walkers", "spec"), {"walkers": 2, "spec": 2})
        assert auto == (("walkers",), {"walkers": 4, "spec": 1})
        assert "nw=60" in auto_odd and "2*4" in auto_odd
        assert off is None
        assert too_few == "a 2x1 mesh needs 2 ranks, the process group has 4"
        # the same inputs give JAX's own messages (JAX has 8 devices here)
        for got, args in ((odd_nw, ("2x2", 62)), (banana, ("banana", 64)),
                          (zero, ("0x2", 64)), (halves, ("2x2", 150))):
            with pytest.raises(ValueError) as exc:
                jpipe.resolve_mesh(*args)
            assert got == str(exc.value)
    with pytest.raises(ValueError, match="devices"):
        jpipe.resolve_mesh("8x2", 64)
    assert isinstance(jpipe.resolve_mesh("2x2", 64), Mesh) and jax.device_count() == 8


def test_resolve_mesh_without_a_process_group():
    from mcmc_spec_tpu_torch.pipeline import resolve_mesh

    assert resolve_mesh("auto", 64) is None and resolve_mesh(None, 64) is None
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        resolve_mesh("2x2", 64)


@pytest.mark.parametrize("nw,halves,ok", [(8, True, True), (6, True, False), (6, False, True),
                                          (5, False, False), (None, True, True)])
def test_resolve_mesh_checks_a_mesh_against_the_walkers(nw, halves, ok):
    """A mesh made once (the CLI's) is checked by each stage against its own walker count:
    2W for the sampler's halves, W for the annealer, nothing for nw None."""
    from mcmc_spec_tpu_torch.parallel.mesh import Mesh
    from mcmc_spec_tpu_torch.pipeline import resolve_mesh

    mesh = Mesh(2, 2, 0, torch.device("cpu"), ("walkers", "spec"), None, None)
    if ok:
        assert resolve_mesh(mesh, nw, halves=halves) is mesh
    else:
        with pytest.raises(ValueError, match=f"nw={nw} walkers must divide by "
                           + re.escape(f"{'2*' if halves else ''}2 (the mesh's")):
            resolve_mesh(mesh, nw, halves=halves)


@pytest.mark.parametrize("mesh", ["0x2", "4x", "2x2x2", "2x0", "4x2", "1x1", "banana", "auto",
                                  None, 7])
def test_parse_wxs_is_jax(mesh):
    from mcmc_spec_tpu.parallel.mesh import parse_wxs as jparse
    from mcmc_spec_tpu_torch.parallel.mesh import parse_wxs

    def outcome(fn):
        try:
            return fn(mesh)
        except ValueError as e:
            return str(e)

    assert outcome(parse_wxs) == outcome(jparse)


@pytest.mark.parametrize("args", [
    (24, "2x4", True, True), (150, "2x4", True, True), (150, "2x4", True, False),
    (151, "2x4", True, False), (150, "auto", True, True), (150, None, True, True),
    (150, "2x4", False, True), (8, "1x2", True, True), (90, "3x1", True, True),
])
def test_check_wxs_stage_counts_is_jax(args):
    from mcmc_spec_tpu import pipeline as jpipe
    from mcmc_spec_tpu_torch.pipeline import check_wxs_stage_counts

    def outcome(fn):
        try:
            return fn(*args)
        except ValueError as e:
            return str(e)

    assert outcome(check_wxs_stage_counts) == outcome(jpipe.check_wxs_stage_counts)


# --------------------------------------------------------------- pipeline and CLI
@pytest.fixture(scope="module")
def fitdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("shardfit")
    return testing.write_fit_dir(str(root), nd=300, tmax=5000, nwalk=24, nstep=2, nburn=100,
                                 nsteps=100)


def _cfg(fitdir, dirname, **kw):
    from mcmc_spec_tpu_torch.utils.config import FitConfig

    cfg = FitConfig.from_file(fitdir["paramfile"])
    cfg.dirname = dirname
    cfg.nsteps = 4 * NTHIN
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _p0(seed=1, n=8):
    t = np.array(testing.TRUTH)
    scale = np.array([40.0, 40.0, 0.01, 0.01, 0.01, 0.02e-3])
    return t + scale * np.random.RandomState(seed).randn(n, 6)


def _resume_rank(rank, fitdir, dirname):
    from mcmc_spec_tpu_torch import pipeline

    os.chdir(fitdir["root"])
    ctx = pipeline.setup_context(_cfg(fitdir, dirname), dtype=torch.float64, device="cpu")
    out = pipeline.run_mcmc_stage(ctx, p0=_p0(), nthin=NTHIN, check_convergence=False)
    return None if out is None else out.shape


def test_checkpoint_of_one_device_resumes_on_a_walker_mesh(fitdir, monkeypatch):
    """Interrupt a one-device run in its 3rd of 4 sampling chunks, resume it on 2 ranks
    (``mesh="auto"``): ``samples.txt`` is the uninterrupted run's, byte for byte."""
    from mcmc_spec_tpu_torch import pipeline
    from mcmc_spec_tpu_torch.io import results as results_io

    monkeypatch.chdir(fitdir["root"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        def run(dirname):
            ctx = pipeline.setup_context(_cfg(fitdir, dirname), dtype=torch.float64,
                                         device="cpu")
            return pipeline.run_mcmc_stage(ctx, p0=_p0(), nthin=NTHIN, check_convergence=False)

        full = run("uninterrupted")
        real_dump = results_io.dump_coords
        calls = {"n": 0}

        def exploding_dump(dirname, fname, step, coords, stage="results"):
            if stage == "results":
                calls["n"] += 1
                if calls["n"] == 3:
                    raise RuntimeError("simulated crash")
            return real_dump(dirname, fname, step, coords, stage=stage)

        monkeypatch.setattr(pipeline.results_io, "dump_coords", exploding_dump)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run("interrupted")
        monkeypatch.setattr(pipeline.results_io, "dump_coords", real_dump)
    finally:
        torch.set_num_threads(n)
    assert results_io.ChainStore("interrupted").chunk_ids() == [0, 1]
    shapes = run_world(_resume_rank, 2, fitdir, "interrupted")
    assert shapes == [full.shape, None]  # rank 0 returns the samples, rank 1 nothing
    with open("uninterrupted/samples.txt", "rb") as a, open("interrupted/samples.txt", "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists("interrupted/chain_checkpoint.npz")
    assert not os.path.isdir("interrupted/chain_chunks")


def _cli(fitdir, dirname, ranks=None, *extra):
    text = open(fitdir["paramfile"]).read().replace("dirname run", f"dirname {dirname}")
    param = os.path.join(fitdir["root"], f"param_{dirname}.txt")
    with open(param, "w") as f:
        f.write(text)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)] if ranks else [sys.executable])
    return subprocess.Popen(
        [*launch, "-m", "mcmc_spec_tpu_torch.cli", "-f", param, "-o", "True", "-e", "True",
         "--noplots", "--device", "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=fitdir["root"])


@pytest.fixture(scope="module")
def cli_runs(fitdir):
    """The single-device CLI, the 2-rank walker mesh and the 1x2 spec mesh, at once."""
    procs = {"single": _cli(fitdir, "single"), "auto": _cli(fitdir, "auto", 2, "--mesh", "auto"),
             "spec": _cli(fitdir, "spec", 2, "--mesh", "1x2")}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])
        out[name] = (os.path.join(fitdir["root"], name), stdout)
    return out


def test_cli_walker_mesh_writes_the_single_device_samples(cli_runs):
    (single, _), (auto, stdout) = cli_runs["single"], cli_runs["auto"]
    assert "[mcmc] sharding 8 walkers over mesh {'walkers': 2, 'spec': 1}" in stdout
    with open(os.path.join(single, "samples.txt"), "rb") as a, \
            open(os.path.join(auto, "samples.txt"), "rb") as b:
        assert a.read() == b.read()
    assert sorted(os.listdir(auto)) == sorted(os.listdir(single))


@pytest.mark.parametrize("name", ["auto", "spec"])
def test_cli_mesh_writes_the_artifact_set_from_rank_zero(cli_runs, name):
    single, _ = cli_runs["single"]
    d, stdout = cli_runs[name]
    assert sorted(os.listdir(d)) == sorted(os.listdir(single))
    events = [json.loads(line)["event"] for line in open(os.path.join(d, "run_log.jsonl"))]
    assert events == ["optimize.start", "optimize.end", "mcmc.end"]
    assert stdout.count("optimization complete") == 1
    assert stdout.count("Mean acceptance fraction") == 1
    samples = np.genfromtxt(os.path.join(d, "samples.txt"))
    assert samples.shape == (8 * 100, 6) and np.isfinite(samples).all()
    if name == "spec":
        assert "[optimize] spectral-sharded annealer over mesh {'walkers': 1, 'spec': 2}" in stdout


@pytest.mark.parametrize("argv,env,message", [
    (["--mesh", "2x2"], {}, "torchrun --nproc-per-node 4 -m mcmc_spec_tpu_torch.cli -f p.txt"),
    (["--mesh", "off"], {"WORLD_SIZE": "2"}, "--mesh off run on one device"),
    (["-f", "q.txt", "--mesh", "off"], {"WORLD_SIZE": "2"}, "--mesh off run on one device"),
    (["--device", "cuda"], {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"},
     "2 ranks on this host, 1 CUDA devices"),
], ids=["wxs_outside_torchrun", "off_on_ranks", "fleet_on_ranks", "more_ranks_than_cards"])
def test_cli_mesh_refusals_before_any_compute(argv, env, message, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for key in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        cli.main(["prog", "-f", "p.txt", "-o", "True", "--noplots", *argv])
    assert message in str(exc.value)
    assert os.listdir(tmp_path) == []


def test_cli_wxs_stage_counts_fail_before_any_compute(fitdir, monkeypatch):
    """nwalk 23 seeds 7 stage-2 walkers, which 2 W = 2 does not divide: the CLI exits
    before it packs the target or initialises a process group."""
    monkeypatch.chdir(fitdir["root"])
    text = open(fitdir["paramfile"]).read().replace("dirname run", "dirname counts")
    param = os.path.join(fitdir["root"], "param_counts.txt")
    with open(param, "w") as f:
        f.write(re.sub(r"^nwalk .*$", "nwalk 23", text, flags=re.M))
    with pytest.raises(SystemExit, match=re.escape("--mesh: mesh '1x1': the MCMC stage")):
        cli.main(["prog", "-f", param, "-o", "True", "-e", "True", "--noplots", "--device",
                  "cpu", "--mesh", "1x1"])
    assert not os.path.exists(os.path.join(fitdir["root"], "counts"))
    assert not torch.distributed.is_initialized()
