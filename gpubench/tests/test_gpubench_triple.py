"""The reference on a triple star (``nspec`` 3) against the program's own plain versions
on the CPU, at small sizes, and the binary's arithmetic held bit for bit.

The triple is built here from ``configs/koi2298.json``: a third component, its radius
ratio, and the two contrast filters listed once for each companion, so that the split
of the contrast list (the first half companion 1 against the primary, the second half
companion 2) is exercised.  No configuration file or cell of the benchmark holds it."""
import math

import numpy as np
import pytest
import torch

from gpubench.drivers.packing import pack
from gpubench.harness import bench, inputs
from gpubench.reference import posterior
from gpubench.tests.test_gpubench_faults import CPU_SIZES, FAULTS, run_resolved
from mcmc_spec_tpu_torch.inference.posterior import forward
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck

CPU = torch.device("cpu")


def triple_config():
    cfg = bench.load_json(bench.BENCH / "configs" / "koi2298.json")
    cfg.update(nspec=3, truth=[4600.0, 3400.0, 3100.0, 0.12, 0.72, 0.45, 0.30, 0.002],
               walker_cloud=[50.0, 50.0, 50.0, 0.02, 0.02, 0.02, 0.02, 2e-05],
               contrast_filters=cfg["contrast_filters"] * 2,
               targets=[{"nd": 1792, "n_contrast": 4}])
    return cfg


def made(cfg, seed=7, walkers=48, **cell):
    return inputs.make_inputs(cfg, {"walkers": walkers, "grid_step": 8.0, **cell}, seed, CPU)


@pytest.fixture(scope="module")
def triple():
    cfg = triple_config()
    return cfg, made(cfg, nd=400)


@pytest.fixture(scope="module")
def binary():
    cfg = bench.load_json(bench.BENCH / "configs" / "koi2298.json")
    return cfg, made(cfg, nd=400)


def test_the_triple_observations_are_the_programs_forward_model(triple):
    cfg, m = triple
    (inp, ref), = m["targets"]
    out = forward(torch.as_tensor(cfg["truth"], dtype=torch.float32), pack(inp, CPU))
    c, p = posterior.forward_bands(np.asarray(cfg["truth"]), ref)
    assert len(c) == 4 and not np.allclose(c[:2], c[2:], atol=0.1)
    assert np.allclose(out.contrasts.numpy(), c, atol=2e-5)
    assert np.allclose(out.phot_mags.numpy(), p, atol=2e-5)


def test_the_triple_agrees_with_k1s_plain_version(triple, clean_env):
    cfg, m = triple
    bench.set_env(cfg, {})
    (inp, ref), = m["targets"]
    P = m["walkers"][0]
    lp_prog = ck.log_posterior_fused_reference(P, pack(inp, CPU))
    lp_ref = posterior.log_posterior(P, posterior.tables(ref, CPU), 14, 2)
    # the cloud puts a few walkers' T3 below the grid's 3,000 K: out of bounds on both sides
    fin = torch.isfinite(lp_ref)
    assert torch.equal(fin, torch.isfinite(lp_prog)) and int(fin.sum()) >= 40
    gap = (lp_prog.double() - lp_ref.double())[fin].abs()
    assert float(gap.median()) < 1e-4 and float(gap.max()) < 1e-3


@pytest.mark.parametrize("stars,column,values,finite", [
    ("binary", "plx", (4e-4, 9e-4), True), ("binary", "r1", (1.55, 1.9), False),
    ("triple", "plx", (4e-4, 9e-4), False), ("triple", "r1", (1.55, 1.9), True)])
def test_the_bounds_follow_nspec(stars, column, values, finite, request, clean_env):
    """A parallax in (1/3000, 1/1000) is out of a triple's bounds and in a binary's; an
    R1 over 1.5 is out of a binary's and in a triple's: on both sides alike."""
    cfg, m = request.getfixturevalue(stars)
    bench.set_env(cfg, {})
    (inp, ref), = m["targets"]
    n = cfg["nspec"]
    P = m["walkers"][0][:16].clone()
    P[:, 2 * n + 1 if column == "plx" else n + 1] = torch.linspace(*values, 16)
    lp_prog = ck.log_posterior_fused_reference(P, pack(inp, CPU))
    lp_ref = posterior.log_posterior(P, posterior.tables(ref, CPU), 14, 2)
    assert torch.equal(torch.isfinite(lp_ref), torch.isfinite(lp_prog))
    assert bool(torch.isfinite(lp_ref).all()) if finite else bool(torch.isneginf(lp_ref).all())


@pytest.mark.parametrize("nspec", [1, 4])
def test_other_component_counts_raise(triple, nspec):
    cfg, m = triple
    (_, ref), = m["targets"]
    t = {**posterior.tables(ref, CPU), "nspec": nspec}
    with pytest.raises(ValueError, match="nspec 2 and 3"):
        posterior.log_posterior(torch.ones((4, 2 * nspec + 2)), t, 14, 2)
    with pytest.raises(ValueError, match="nspec 2 and 3"):
        posterior.forward_bands(np.ones(2 * nspec + 2), {**ref, "nspec": nspec})


@pytest.mark.parametrize("fault", FAULTS)
def test_a_triples_chain_is_judged(fault, monkeypatch, clean_env, plain_dials):
    """A short stage-2 chain of the triple through the harness: sound, correct; with each
    of the faults of ``test_gpubench_faults``, not correct."""
    cell = {**bench.load_json(bench.BENCH / "workloads" / "koi2298.stage2.json"),
            **CPU_SIZES["stage2"]}
    res = {"entry": {"name": "koi2298triple.stage2", "config": "koi2298triple",
                     "traffic": "stage2", "chips": 1},
           "cfg": triple_config(), "cell": cell}
    numbers, correct = run_resolved(res, fault, CPU, monkeypatch)
    assert correct == (fault == "sound"), numbers


# The binary's arithmetic as the reference computed it before it took a triple: a frozen
# copy, which the reference has to equal bit for bit.
def _binary_block(p, t, iters, recip):
    n = t["nspec"]
    nT, nG = t["temps"].shape[0], t["loggs"].shape[0]
    tiny = torch.finfo(p.dtype).tiny
    teffs, av = p[:, :n], p[:, n]
    r1, ratios, plx = p[:, n + 1], p[:, n + 2:2 * n + 1], p[:, 2 * n + 1]
    base = (r1 * posterior.RSUN_CM * plx / posterior.PC_CM) ** 2
    scales = torch.cat([base[:, None], base[:, None] * ratios**2], dim=1)

    Wcomb, cmags = 0.0, []
    for s in range(n):
        logg = posterior.interp_weights(t["mist_teff"], teffs[:, s]) @ t["mist_logg"]
        Wk = (posterior.interp_weights(t["temps"], teffs[:, s])[:, :, None]
              * posterior.interp_weights(t["loggs"], logg)[:, None, :]).reshape(-1, nT * nG)
        sWk = scales[:, s:s + 1] * Wk
        Wcomb = Wcomb + sWk
        cmags.append(-2.5 / posterior.LN10 * torch.log(torch.clamp(sWk @ t["Fc"], min=tiny)))
    contrasts = cmags[1] - cmags[0]
    phot = -2.5 / posterior.LN10 * torch.log(torch.clamp((Wcomb @ t["Fp"]) / t["zp"], min=tiny))
    reddened = (av > 0)[:, None]
    phot = torch.where(reddened, phot + av[:, None] * t["k_cwl"], phot)
    chi_c = (((contrasts - t["cmag"]) / t["cerr"]) ** 2).sum(dim=1)
    chi_p = (((phot - t["pmag"]) / t["perr"]) ** 2).sum(dim=1)

    model = Wcomb @ t["D"]
    model = model * torch.where(reddened, torch.exp(-0.4 * posterior.LN10 * av[:, None] * t["kd"]),
                                torch.ones((), dtype=p.dtype, device=p.device))
    model = model * (t["med_data"] / posterior.median_bits(model, iters))
    frac = posterior.divide(t["data"], model, recip)
    coeffs = torch.stack([(frac * t["Vpinv"][k]).sum(dim=1) for k in range(3)], dim=1)
    fitted = sum(coeffs[:, k:k + 1] * t["V"][:, k] for k in range(3))
    resid = (model - posterior.divide(t["data"], fitted, recip)) / t["err"]
    chi_spec = (resid * resid).mean(dim=1)

    cs = t["n_bands"] * chi_spec + chi_c + chi_p
    ll = torch.where(torch.isnan(cs), torch.full_like(cs, -math.inf), -0.5 * cs)

    logd = torch.log(torch.clamp(1.0 / torch.clamp(plx, min=1e-12), min=1e-3))
    wav = posterior.interp_weights(t["av_logd"], logd)
    mu, sig = wav @ t["av_mu"], wav @ t["av_sig"]
    lp = -0.5 * ((av - mu) / sig) ** 2
    active = t["prior_mu"] != 0
    gauss = -0.5 * ((p - t["prior_mu"]) / t["prior_sig"]) ** 2
    lp = lp + torch.where(active, gauss, torch.zeros_like(gauss)).sum(dim=1)
    ok = ((teffs >= t["tmin"]) & (teffs <= t["tmax"])).all(dim=1) & (av >= 0)
    ok &= (ratios >= 0.05).all(dim=1) & (r1 >= 0.05) & (r1 <= 1.5)
    ok &= (plx >= 1.0 / 3000.0) & (plx <= 0.25)
    lp = torch.where(ok, lp, torch.full_like(lp, -math.inf))
    return torch.where(torch.isfinite(lp), lp + ll, torch.full_like(lp, -math.inf))


def _binary_log_posterior(P, t, iters, recip):
    block = posterior.block_rows(t["D"].shape[1])
    with torch.no_grad(), posterior.matmul_precision(False):
        return torch.cat([_binary_block(P[i:i + block], t, iters, recip)
                          for i in range(0, P.shape[0], block)])


def _binary_forward_bands(p, ref):
    n = ref["nspec"]
    teffs, r1, ratios, plx = p[:n], p[n + 1], np.asarray(p[n + 2:2 * n + 1]), p[2 * n + 1]
    base = (r1 * posterior.RSUN_CM * plx / posterior.PC_CM) ** 2
    scales = np.concatenate([[base], base * ratios**2])
    cflux, pflux = [], 0.0
    for s in range(n):
        logg = np.interp(teffs[s], ref["mist_teff"], ref["mist_logg"])
        w = scales[s] * np.outer(posterior._host_weights(ref["temps"], teffs[s]),
                                 posterior._host_weights(ref["loggs"], logg)).ravel()
        cflux.append(w @ ref["Fc"])
        pflux = pflux + w @ ref["Fp"]
    mags = -2.5 * np.log10(np.stack(cflux))
    return mags[1] - mags[0], -2.5 * np.log10(pflux / ref["zp"])


def _edges(P):
    """The walkers, and copies of them moved across each binary bound and to a parallax
    inside the binary's bounds and outside a triple's."""
    out = [P]
    for col, value in ((0, 2000.0), (1, 6000.0), (2, -0.05), (3, 0.04), (3, 1.6), (4, 0.01),
                       (5, 2e-4), (5, 0.3), (5, 5e-4)):
        Q = P[:8].clone()
        Q[:, col] = value
        out.append(Q)
    return torch.cat(out)


@pytest.mark.parametrize("config", ["koi2298", "fleet9"])
def test_the_binary_is_bit_for_bit_as_before(config, binary):
    """The reference's binary arithmetic is unchanged by the triple's: the same bits as
    the frozen copy above, in the log-posteriors and the forward model."""
    if config == "koi2298":
        cfg, m = binary
    else:
        cfg = bench.load_json(bench.BENCH / "configs" / "fleet9.json")
        cfg["targets"] = cfg["targets"][:3]
        m = made(cfg, walkers=32)
    dials = cfg["dials"]
    for i, (_, ref) in enumerate(m["targets"]):
        t = posterior.tables(ref, CPU)
        P = _edges(m["walkers"][i])
        want = _binary_log_posterior(P, t, dials["median_iters"], dials["recip_newton"])
        got = posterior.log_posterior(P, t, dials["median_iters"], dials["recip_newton"])
        assert torch.isneginf(got).sum() >= 8 * 8 and torch.isfinite(got).any()
        assert torch.equal(got, want)
        for p in (np.asarray(cfg["truth"]), P[0].double().numpy()):
            for a, b in zip(posterior.forward_bands(p, ref), _binary_forward_bands(p, ref)):
                assert np.array_equal(a, b)
