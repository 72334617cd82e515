"""PyTorch port: the fleet over a ``targets x walkers`` mesh of ranks (CPU).

The sharded fleet chains run in gloo worlds of 2, 3 and 4 spawned ranks
(``testing.run_world``), one world a size for the whole module, one CPU thread
a rank, on a ragged fleet of nine targets (nd = 120 - 4 i, 2 contrasts for
even i and 1 for odd i, padded to 120 and 2), 16 walkers a target:

* on every mesh (2x1 and 2x2 on the first six targets; 1x2, 3x1 and 1x4 on
  all nine), in float64 and float32, on the composition and on K5's plain
  version (``MCMC_SPEC_FUSED_EVAL=1``), the chain and the accept count are
  ``np.array_equal`` to the one-device ``run_fleet_ensemble`` from the same
  generator.  The log-probabilities agree to rtol 1e-12 (float64) and 5e-5
  (float32, the kernel gate): on the CPU the continuum renorm's ``frac @
  Vpinv.T`` ([m, nd] @ [nd, 3]) rounds differently at another walker count m
  (BLAS picks its kernel by the shape), which moves a log-probability by an
  ulp or two and, at these sizes, flips no acceptance;
* the census: one all_gather a half-step, one all_reduce_sum a call, two
  all_gathers to bring a chain to every rank, on every mesh;
* ``resolve_fleet_mesh`` picks JAX's layout: against JAX's own on the test
  test run's virtual devices for 1-8 devices, and on a world of 4.

The pipeline: ``run_fleet_mcmc`` on a 2x2 mesh writes each target's
``samples.txt`` byte for byte as one device does; a checkpoint written on one
device resumes on the 2x2 mesh to the uninterrupted run's bytes; the fleet CLI
under ``python -m torch.distributed.run`` with 2 ranks writes the one-device
CLI's artifact set and ``samples.txt`` bytes.  The refusals use JAX's words.
"""
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmc_spec_tpu_torch import cli, fleet_pipeline, testing  # noqa: E402
from mcmc_spec_tpu_torch.testing import run_world  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NTGT, NW, STEPS, THIN = 9, 16, 4, 2
DTYPES = {"f64": torch.float64, "f32": torch.float32}
ROUTES = ("composed", "fused")
# world size -> the meshes it runs: (targets, walkers, fleet targets)
MESHES = {2: ((2, 1, 6), (1, 2, 9)), 3: ((3, 1, 9),), 4: ((2, 2, 6), (1, 4, 9))}
LOGP_RTOL = {"f64": 1e-12, "f32": 5e-5}
# resolve_fleet_mesh cases on the world of 4: (mesh, ntgt, nw)
RESOLVE = (("auto", 6, 16), ("auto", 9, 16), ("auto", 8, 6), ("auto", 3, 6), ("2x2", 6, 16),
           ("0x2", 6, 16), (None, 6, 16), ("banana", 6, 16))
# the pipeline's fleet: stage 2 seeds 8 walkers a target
NDS, NCS = (300, 276), (2, 1)
NTHIN = 20


def _build(dtype):
    """(stacked padded fleet fields as host numpy, walkers [NTGT, NW, 6])."""
    from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch
    from mcmc_spec_tpu_torch.inference.fleet import stack_targets
    from mcmc_spec_tpu_torch.inference.target import DATA_FIELDS, META_FIELDS

    members, P = [], []
    for i in range(NTGT):
        t, truth = build_bench_target(dtype, device="cpu", nd=120 - 4 * i, grid_step=8.0,
                                      seed=i, pad_nd=120, pad_nc=2,
                                      n_contrast=2 if i % 2 == 0 else 1)
        members.append(t)
        P.append(init_walker_batch(t, truth, NW, dtype, seed=1 + i))
    fleet = stack_targets(members)
    fields = {k: getattr(fleet, k).numpy() for k in DATA_FIELDS}
    fields.update({k: getattr(fleet, k) for k in META_FIELDS})
    return fields, torch.stack(P).numpy()


def _fleet(fields, ntgt, dtype):
    from mcmc_spec_tpu_torch.inference.target import DATA_FIELDS, target_from_jax

    cut = {k: (v[:ntgt] if k in DATA_FIELDS else v) for k, v in fields.items()}
    return target_from_jax(types.SimpleNamespace(**cut), device="cpu", dtype=dtype)


def _route(route):
    if route == "fused":
        os.environ["MCMC_SPEC_FUSED_EVAL"] = "1"
    else:
        os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)


def _one_device(inputs):
    """run_fleet_ensemble's chain, log-probs and accept count for every fleet size,
    dtype and route, on one thread."""
    from mcmc_spec_tpu_torch.inference.fleet import init_fleet_ensemble, run_fleet_ensemble

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for ntgt in sorted({m[2] for ms in MESHES.values() for m in ms}):
            for dt, dtype in DTYPES.items():
                fields, P = inputs[dt]
                fleet = _fleet(fields, ntgt, dtype)
                for route in ROUTES:
                    _route(route)
                    st = init_fleet_ensemble(torch.as_tensor(P[:ntgt]), fleet,
                                             torch.Generator().manual_seed(3))
                    st, chain, logps = run_fleet_ensemble(st, fleet, STEPS, thin=THIN)
                    out[(ntgt, dt, route)] = (chain.numpy(), logps.numpy(), int(st.n_accept))
    finally:
        os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
        torch.set_num_threads(n)
    return out


# --------------------------------------------------------------- the ranks
def _chain_rank(rank, meshes, inputs):
    from mcmc_spec_tpu_torch.parallel import mesh as pm
    from mcmc_spec_tpu_torch.parallel import sharding

    out = {}
    for T, W, ntgt in meshes:
        mesh = pm.make_fleet_mesh(T, W, device="cpu")
        out[(T, W, "place")] = (mesh.axis_names, mesh.shape, mesh.t_index, mesh.w_index)
        for dt, dtype in DTYPES.items():
            fields, P = inputs[dt]
            block = sharding.fleet_block(_fleet(fields, ntgt, dtype), mesh)
            for route in ROUTES:
                _route(route)
                pm.reset_collectives()
                st = sharding.shard_fleet_state(torch.as_tensor(P[:ntgt]), block,
                                                torch.Generator().manual_seed(3), mesh)
                init = pm.collective_counts()
                pm.reset_collectives()
                st, chain, logps = sharding.run_fleet_ensemble_sharded(st, block, mesh, STEPS,
                                                                       thin=THIN)
                run = pm.collective_counts()
                pm.reset_collectives()
                chain = sharding.gather_fleet(chain, mesh, dim=2).numpy()
                out[(T, W, dt, route)] = {
                    "chain": chain, "logps": sharding.gather_fleet(logps, mesh, dim=2).numpy(),
                    "n_accept": int(st.n_accept), "census": (init, run),
                    "gather": pm.collective_counts()["all_gather"] / 2,  # a gather_fleet
                    "block": tuple(block.D.shape)}
    os.environ.pop("MCMC_SPEC_FUSED_EVAL", None)
    if tuple(meshes) == MESHES[4]:  # the world of 4
        out["resolve"] = _resolve_cases()
    return out


def _resolve_cases():
    out = []
    for mesh, ntgt, nw in RESOLVE:
        try:
            got = fleet_pipeline.resolve_fleet_mesh(mesh, ntgt, nw, device="cpu")
            out.append(None if got is None else
                       (got.axis_names, got.shape, got.t_index, got.w_index,
                        fleet_pipeline.resolve_fleet_mesh(got, ntgt, nw) is got))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.fixture(scope="module")
def inputs():
    return {dt: _build(dtype) for dt, dtype in DTYPES.items()}


@pytest.fixture(scope="module")
def worlds(inputs):
    return {n: run_world(_chain_rank, n, meshes, inputs) for n, meshes in MESHES.items()}


@pytest.fixture(scope="module")
def one_device(inputs):
    return _one_device(inputs)


CHAIN_CASES = [(n, m) for n, ms in MESHES.items() for m in ms]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("world,mesh", CHAIN_CASES,
                         ids=[f"{T}x{W}_on_{ntgt}" for _, (T, W, ntgt) in CHAIN_CASES])
def test_fleet_mesh_chain_is_one_device_bit_for_bit(worlds, one_device, world, mesh, dt,
                                                    route):
    T, W, ntgt = mesh
    chain, logps, n_accept = one_device[(ntgt, dt, route)]
    assert chain.shape == (STEPS // THIN, ntgt, NW, 6)
    for rank, out in enumerate(worlds[world]):
        got = out[(T, W, dt, route)]
        assert got["block"][0] == ntgt // T
        assert np.array_equal(got["chain"], chain), (rank, "chain")
        assert got["n_accept"] == n_accept > 0, rank
        np.testing.assert_allclose(got["logps"], logps, rtol=LOGP_RTOL[dt], atol=0)


@pytest.mark.parametrize("world,mesh", CHAIN_CASES,
                         ids=[f"{T}x{W}_on_{ntgt}" for _, (T, W, ntgt) in CHAIN_CASES])
def test_fleet_mesh_census_and_place(worlds, world, mesh):
    """Whatever the mesh: no collective to initialise, one all_gather a half-step and one
    all_reduce_sum a call, two all_gathers to bring an array to every rank; the ranks lie
    target-major."""
    T, W, _ = mesh
    none = {"all_reduce_sum": 0, "all_reduce_min": 0, "all_gather": 0, "barrier": 0}
    for rank, out in enumerate(worlds[world]):
        assert out[(T, W, "place")] == (("targets", "walkers"), {"targets": T, "walkers": W},
                                        rank // W, rank % W)
        for dt in DTYPES:
            for route in ROUTES:
                got = out[(T, W, dt, route)]
                init, run = got["census"]
                assert init == none
                assert run == dict(none, all_gather=2 * STEPS, all_reduce_sum=1)
                assert got["gather"] == 2


def test_resolve_fleet_mesh_on_a_world_of_four(worlds):
    from mcmc_spec_tpu import fleet_pipeline as jfp

    for rank, out in enumerate(worlds[4]):
        (six, nine, eight, three, wxs, zero, off, banana) = out["resolve"]
        names = ("targets", "walkers")
        assert six == (names, {"targets": 2, "walkers": 2}, rank // 2, rank % 2, True)
        assert nine == (names, {"targets": 1, "walkers": 4}, 0, rank, True)
        assert eight == (names, {"targets": 4, "walkers": 1}, rank, 0, True)
        assert banana == six  # any other truthy mesh is "auto", as in JAX
        assert three is None and off is None
        for got, mesh in ((wxs, "2x2"), (zero, "0x2")):
            with pytest.raises(ValueError) as exc:
                jfp.resolve_fleet_mesh(mesh, 6, 16)
            assert got == str(exc.value)


@pytest.mark.parametrize("ndev", range(1, 9))
def test_fleet_mesh_shape_is_jax_rule(ndev, monkeypatch):
    """JAX's ``resolve_fleet_mesh`` on the first ``ndev`` of the test run's virtual devices
    against ``fleet_mesh_shape`` over a world of ``ndev`` ranks."""
    import jax

    from mcmc_spec_tpu import fleet_pipeline as jfp

    devices = jax.devices()
    assert len(devices) >= 8
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:ndev])
    for ntgt in (1, 2, 3, 4, 6, 8, 9):
        for nw in (4, 6, 8, 12, 16, 18):
            jm = jfp.resolve_fleet_mesh("auto", ntgt, nw)
            want = None if jm is None else tuple(jm.devices.shape)
            if jm is not None:
                assert jm.axis_names == ("targets", "walkers")
            assert fleet_pipeline.fleet_mesh_shape(ndev, ntgt, nw) == want, (ntgt, nw)


def test_resolve_fleet_mesh_without_a_process_group():
    assert fleet_pipeline.resolve_fleet_mesh("auto", 6, 16) is None
    assert fleet_pipeline.resolve_fleet_mesh(None, 6, 16) is None
    with pytest.raises(ValueError, match="single-target only"):
        fleet_pipeline.resolve_fleet_mesh("1x1", 6, 16)


# --------------------------------------------------------------- pipeline and CLI
@pytest.fixture(scope="module")
def fleetdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_mesh")
    return testing.write_fleet_dirs(str(root), NDS, NCS, tmax=5000, nwalk=24, nstep=2,
                                    nburn=NTHIN, nsteps=4 * NTHIN)


def _p0s(fleetdir, n=8):
    scale = np.array([40.0, 40.0, 0.01, 0.01, 0.01, 0.02e-3])
    return [np.asarray(fd["truth"]) + scale * np.random.RandomState(i).randn(n, 6)
            for i, fd in enumerate(fleetdir)]


def _ctxs(fleetdir, tag):
    from mcmc_spec_tpu_torch.utils.config import FitConfig

    cfgs = []
    for i, fd in enumerate(fleetdir):
        cfg = FitConfig.from_file(fd["paramfile"])
        cfg.dirname = f"{tag}{i}"
        cfgs.append(cfg)
    return fleet_pipeline.setup_fleet(cfgs, dtype=torch.float64, device="cpu")


def _mcmc(fleetdir, tag, resume=False, ctxs=None):
    return fleet_pipeline.run_fleet_mcmc(ctxs or _ctxs(fleetdir, tag), p0s=_p0s(fleetdir),
                                         nthin=NTHIN, resume=resume)


def _pipeline_rank(rank, fleetdir):
    from mcmc_spec_tpu_torch.parallel import mesh as pm

    os.chdir(fleetdir[0]["root"])
    ctxs = _ctxs(fleetdir, "mesh")
    pm.reset_collectives()
    fresh = _mcmc(fleetdir, "mesh", ctxs=ctxs)
    census = pm.collective_counts()
    resumed = _mcmc(fleetdir, "cut", resume=True)
    return {"fresh": None if fresh is None else [s.shape for s in fresh], "census": census,
            "resumed": None if resumed is None else [s.shape for s in resumed]}


def _bytes(tag):
    return [open(f"{tag}{i}/samples.txt", "rb").read() for i in range(len(NDS))]


@pytest.fixture(scope="module")
def pipeline_runs(fleetdir):
    """One device: an uninterrupted run and one cut in its 3rd of 4 sampling chunks; then
    a world of 4 (a 2x2 fleet mesh): a fresh run and the cut run resumed."""
    from mcmc_spec_tpu_torch.io import results as results_io

    cwd = os.getcwd()
    os.chdir(fleetdir[0]["root"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    real_dump = results_io.dump_coords

    def exploding_dump(dirname, fname, step, coords, stage="results"):
        if stage == "results" and step == 2 * NTHIN:
            raise RuntimeError("simulated crash")
        return real_dump(dirname, fname, step, coords, stage=stage)

    try:
        full = _mcmc(fleetdir, "single")
        results_io.dump_coords = exploding_dump
        with pytest.raises(RuntimeError, match="simulated crash"):
            _mcmc(fleetdir, "cut")
        results_io.dump_coords = real_dump
        assert results_io.ChainStore("cut0", name="fleet_chain_chunks").chunk_ids() == [0, 1]
        ranks = run_world(_pipeline_rank, 4, fleetdir)
        return {"full": full, "ranks": ranks, "single": _bytes("single"),
                "mesh": _bytes("mesh"), "cut": _bytes("cut"),
                "leftovers": [os.path.exists(p) for p in ("cut0/fleet_chain_checkpoint.npz",
                                                          "cut0/fleet_chain_chunks",
                                                          "mesh0/fleet_chain_chunks")]}
    finally:
        results_io.dump_coords = real_dump
        torch.set_num_threads(n)
        os.chdir(cwd)


def test_run_fleet_mcmc_on_a_mesh_writes_the_one_device_samples(pipeline_runs):
    shapes = [s.shape for s in pipeline_runs["full"]]
    assert shapes == [(4 * NTHIN * 8, 6)] * len(NDS)
    assert [r["fresh"] for r in pipeline_runs["ranks"]] == [shapes, None, None, None]
    assert pipeline_runs["mesh"] == pipeline_runs["single"]
    # 1 burn-in and 4 sampling chunks, each (2 nthin + 2) gathers and one sum; 2 barriers
    chunks = 1 + 4
    for r in pipeline_runs["ranks"]:
        assert r["census"] == {"all_reduce_sum": chunks, "all_reduce_min": 0,
                               "all_gather": chunks * (2 * NTHIN + 2), "barrier": 2}


def test_one_device_checkpoint_resumes_on_a_fleet_mesh(pipeline_runs):
    assert [r["resumed"] for r in pipeline_runs["ranks"]][1:] == [None] * 3
    assert pipeline_runs["cut"] == pipeline_runs["single"]
    assert pipeline_runs["leftovers"] == [False, False, False]


def _cli(root, ranks, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)] if ranks else [sys.executable])
    argv = [*launch, "-m", "mcmc_spec_tpu_torch.cli"]
    for i in range(len(NDS)):
        argv += ["-f", f"param_synth_t{i}.txt"]
    return subprocess.Popen(argv + ["-o", "True", "-e", "True", "--noplots", "--device", "cpu",
                                    *extra],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=root)


@pytest.fixture(scope="module")
def cli_runs(fleetdir, tmp_path_factory):
    """The one-device fleet CLI and the fleet CLI under torchrun with 2 ranks, at once,
    each in a copy of the fleet directory."""
    roots = {}
    for tag in ("single", "ranks"):
        roots[tag] = str(tmp_path_factory.mktemp(f"fleet_cli_{tag}"))
        shutil.copytree(fleetdir[0]["root"], roots[tag], dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("single*", "mesh*", "cut*"))
    procs = {"single": _cli(roots["single"], None), "ranks": _cli(roots["ranks"], 2)}
    out = {}
    for tag, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (tag, stderr[-3000:])
        out[tag] = ([os.path.join(roots[tag], f"run{i}") for i in range(len(NDS))], stdout)
    return out


@pytest.mark.parametrize("t", range(len(NDS)))
def test_fleet_cli_on_ranks_writes_the_one_device_artifacts(cli_runs, t):
    (single, _), (ranks, stdout) = cli_runs["single"], cli_runs["ranks"]
    assert "[fleet] 2 targets x 8 walkers over mesh {'targets': 2, 'walkers': 1}" in stdout
    assert stdout.count("optimization complete") == len(NDS)  # rank 0's stage 1 only
    assert stdout.count("Mean acceptance fraction") == 1
    assert sorted(os.listdir(ranks[t])) == sorted(os.listdir(single[t]))
    for name in ("samples.txt", "optimize_res.txt", f"t{t}_autocorr.txt"):
        with open(os.path.join(single[t], name), "rb") as a, \
                open(os.path.join(ranks[t], name), "rb") as b:
            assert a.read() == b.read(), name


def test_cli_fleet_wxs_refusal_is_jax(fleetdir, monkeypatch):
    """The JAX CLI reads the param files before its refusal, so both run on real ones."""
    from mcmc_spec_tpu import cli as jcli

    monkeypatch.chdir(fleetdir[0]["root"])
    monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", "0")
    argv = ["prog", "-f", "param_synth_t0.txt", "-f", "param_synth_t1.txt", "-e", "True",
            "--noplots", "--mesh", "2x2"]
    messages = []
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    assert "single-target only; fleet mode shards (targets, walkers)" in messages[1]


@pytest.mark.parametrize("argv,message", [
    (["--mesh", "1x2"], "single-target only"),
    (["--mesh", "off"], "--mesh off run on one device"),
], ids=["wxs", "off"])
def test_cli_fleet_refusals_on_ranks_before_any_compute(argv, message, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as exc:
        cli.main(["prog", "-f", "p.txt", "-f", "q.txt", "-e", "True", "--noplots", "--device",
                  "cpu", *argv])
    assert message in str(exc.value)
    assert os.listdir(tmp_path) == []
    assert not torch.distributed.is_initialized()


def test_fleet_block_keeps_the_padded_widths(inputs):
    """A rank's block is its targets' slice of the padded fleet: the fleet's widths and
    each target's true lengths, not the block's own maxima."""
    from mcmc_spec_tpu_torch.parallel import sharding
    from mcmc_spec_tpu_torch.parallel.mesh import FleetMesh

    fleet = _fleet(inputs["f64"][0], NTGT, torch.float64)
    for t in range(3):
        mesh = FleetMesh(3, 1, t, torch.device("cpu"), None, None)
        block = sharding.fleet_block(fleet, mesh)
        assert block.D.shape == (3,) + tuple(fleet.D.shape[1:])
        assert block.n_data_true.tolist() == [120 - 4 * i for i in range(3 * t, 3 * t + 3)]
        assert torch.equal(block.Fc, fleet.Fc[3 * t:3 * t + 3])
    P = torch.as_tensor(inputs["f64"][1])
    mesh = FleetMesh(3, 2, 3, torch.device("cpu"), None, None)
    share = sharding.fleet_share(P, mesh)  # targets 3-5, walkers 4-7 and 12-15
    assert torch.equal(share, torch.stack([P[3:6, 4:8], P[3:6, 12:16]]))


def test_batch_rows_counts_each_op_on_cpu():
    """``scripts/batch_rows`` (which names the composed route's batch-dependent ops on the
    card) runs on the CPU: a count for each op, batch and share."""
    from mcmc_spec_tpu_torch.scripts import batch_rows

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = batch_rows.main("cpu", nw=64)
    finally:
        torch.set_num_threads(n)
    assert len(rows) == 8
    for counts in rows.values():
        assert sorted(counts) == [(32, 2), (32, 4), (64, 2), (64, 4)]
        assert all(0 <= r <= b for (b, _), r in counts.items())
