"""The plain reference against the program's own plain versions on the CPU, at small
sizes.  The test imports both; the reference itself imports nothing of the program."""
import json

import numpy as np
import pytest
import torch

from gpubench.drivers.packing import pack
from gpubench.harness import bench, inputs
from gpubench.reference import posterior, sampler
from mcmc_spec_tpu_torch.inference.fleet import (
    log_posterior_fleet,
    run_fleet_ensemble,
    stack_targets,
)
from mcmc_spec_tpu_torch.inference.posterior import forward
from mcmc_spec_tpu_torch.inference.stretch import EnsembleState, run_ensemble
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

CPU = torch.device("cpu")


def made(config, seed=7, walkers=48, **cell):
    cfg = bench.load_json(bench.BENCH / "configs" / f"{config}.json")
    if config == "fleet9":
        cfg["targets"] = cfg["targets"][:3]
    return cfg, inputs.make_inputs(cfg, {"walkers": walkers, "grid_step": 8.0, **cell}, seed, CPU)


@pytest.fixture(scope="module")
def single():
    return made("koi2298", nd=400)


@pytest.mark.parametrize("field,key", [("D", "D"), ("Fc", "Fc"), ("Fp", "Fp"), ("ext_k_data", "kd"),
                                       ("V", "V"), ("Vpinv", "Vpinv"), ("phot_zp", "zp"),
                                       ("ext_k_cwl", "k_cwl"), ("mist_logg_nodes", "mist_logg"),
                                       ("mist_teff_nodes", "mist_teff")])
def test_the_reference_works_out_the_packed_tables_again(single, field, key):
    cfg, m = single
    (inp, ref), = m["targets"]
    tgt = pack(inp, CPU)
    got = getattr(tgt, field)
    got = got.reshape(-1, got.shape[-1]) if field in ("D", "Fc", "Fp") else got
    want = torch.as_tensor(ref[key], dtype=torch.float32)
    assert torch.equal(got, want)


def test_the_observations_are_the_forward_model_at_truth(single):
    cfg, m = single
    (inp, ref), = m["targets"]
    tgt = pack(inp, CPU)
    out = forward(torch.as_tensor(cfg["truth"], dtype=torch.float32), tgt)
    c, p = posterior.forward_bands(np.asarray(cfg["truth"]), ref)
    assert np.allclose(out.contrasts.numpy(), c, atol=2e-5)
    assert np.allclose(out.phot_mags.numpy(), p, atol=2e-5)


def _gaps(a, b):
    return (a.double() - b.double()).abs()


def test_k1_plain_version_agrees(single, clean_env):
    cfg, m = single
    bench.set_env(cfg, {})
    (inp, ref), = m["targets"]
    P = m["walkers"][0]
    lp_prog = ck.log_posterior_fused_reference(P, pack(inp, CPU))
    lp_ref = posterior.log_posterior(P, posterior.tables(ref, CPU), 14, 2)
    assert torch.isfinite(lp_ref).all()
    gap = _gaps(lp_prog, lp_ref)
    assert float(gap.median()) < 1e-4 and float(gap.max()) < 1e-3


def test_k5_plain_version_agrees(clean_env):
    cfg, m = made("fleet9", walkers=32)
    bench.set_env(cfg, {})
    fleet = stack_targets([pack(inp, CPU, 1792, 2) for inp, _ in m["targets"]])
    lp_prog = ck.log_posterior_fleet_fused_reference(m["walkers"], fleet)
    for i, (_, ref) in enumerate(m["targets"]):
        lp_ref = posterior.log_posterior(m["walkers"][i], posterior.tables(ref, CPU), 14, 2)
        gap = _gaps(lp_prog[i], lp_ref)
        assert float(gap.median()) < 1e-4 and float(gap.max()) < 1e-3


@pytest.mark.parametrize("nd,block", [(1792, 4096), (1408, 4096), (300, 16384),
                                      (65536, 128), (1 << 24, 1)])
def test_the_reference_blocks_follow_the_data_length(nd, block):
    assert posterior.block_rows(nd) == block


@pytest.mark.parametrize("iters", [14, 20, 24])
@pytest.mark.parametrize("nd", [1792, 1791, 4500])
def test_median_searches_bit_for_bit(iters, nd):
    rows = torch.rand((16, nd), generator=torch.Generator().manual_seed(nd), dtype=torch.float32)
    rows[3] = 1.25  # constant row
    rows[4, ::3] = 0.0
    r1 = (nd + 1) // 2
    want = ck._row_order_stat_bits(rows.view(torch.int32), r1, iters, midpoint=True)
    assert torch.equal(posterior.median_bits(rows, iters).view(torch.int32), want)


@pytest.mark.parametrize("newton", [0, 1, 2, 3])
def test_reciprocal_bit_for_bit(newton):
    x = torch.rand(1000, generator=torch.Generator().manual_seed(1)) * 10 + 1e-3
    x[:10] = -x[:10]
    assert torch.equal(posterior.divide(torch.ones_like(x), x, newton),
                       ck._div(torch.ones_like(x), x, newton))


def _quadratic(x):
    return -0.5 * (x**2).sum(dim=-1)


@pytest.mark.parametrize("thin", [1, 5])
def test_the_reference_sampler_is_the_programs(thin):
    """The same draws and updates: the program's chain bit for bit, single and fleet."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 40, 6), generator=g)
    gen_p, gen_r = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    state = EnsembleState(x[0], _quadratic(x[0]), gen_p, torch.zeros((), dtype=torch.int64))
    for _ in range(2):
        state, _, _ = run_ensemble(state, _quadratic, thin, thin=thin)
    c, lp = x, _quadratic(x)
    for _ in range(2):
        c, lp = sampler.run_chunk(c, lp, gen_r, thin, 2.0, _quadratic, "single")
    assert torch.equal(state.coords, c[0]) and torch.equal(state.log_prob, lp[0])

    xf = torch.randn((3, 41, 6), generator=g)
    fleet_lp = lambda p, fleet: _quadratic(p)
    import mcmc_spec_tpu_torch.inference.fleet as fl

    gen_p, gen_r = torch.Generator().manual_seed(12), torch.Generator().manual_seed(12)
    saved = fl.log_posterior_fleet
    fl.log_posterior_fleet = fleet_lp
    try:
        state = EnsembleState(xf, _quadratic(xf), gen_p, torch.zeros((), dtype=torch.int64))
        state, _, _ = run_fleet_ensemble(state, None, thin, thin=thin)
    finally:
        fl.log_posterior_fleet = saved
    c, lp = sampler.run_chunk(xf, _quadratic(xf), gen_r, thin, 2.0, _quadratic, "fleet")
    assert torch.equal(state.coords, c) and torch.equal(state.log_prob, lp)


def test_a_real_update_agrees_and_an_inverted_one_does_not():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((512, 6), generator=g)
    gen = torch.Generator().manual_seed(21)
    proposals = []
    lp = lambda p: proposals.append(p) or _quadratic(p)
    state = EnsembleState(x, _quadratic(x), gen, torch.zeros((), dtype=torch.int64))
    start = gen.get_state()
    after, _, _ = run_ensemble(state, lp, 1, thin=1)
    z, idx, log_u = bench.last_draws(start, CPU, "single", 1, 1, 512, 2.0)
    z, idx, log_u = z[0], idx[0], log_u[0]
    first, second, proposal = after.coords[:256], after.coords[256:], proposals[-1]
    wrong = sampler.update_mismatch(first, second, proposal, z, idx, log_u, _quadratic)
    assert not wrong.any()
    # each walker of the second half takes the other branch of its accept test
    accepted = (second == proposal).all(dim=1)
    inverted = torch.where(accepted[:, None], x[256:], proposal)
    wrong = sampler.update_mismatch(first, inverted, proposal, z, idx, log_u, _quadratic)
    assert wrong.all()
    # a walker moved elsewhere matches neither branch
    moved = second.clone()
    moved[0] += 0.5
    assert sampler.update_mismatch(first, moved, proposal, z, idx, log_u, _quadratic)[0]
