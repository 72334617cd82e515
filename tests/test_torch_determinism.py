"""PyTorch port: the plain versions give the same bits for the same inputs (CPU).

Every kernel gate of the port, on the card and here, holds a kernel against
its plain PyTorch version, so a plain version that gave other bits on a second
call with the same tensors makes gates pass or fail by chance (a one-ulp
change in a model row can move the 14-pass median by a bracket).  On a loaded
machine, the chunk of ``torch.exp`` that an intra-op worker thread computed in
the plain spectrum block has come back wrong by up to 1.5e-4 relative on one
call and right on the next.  The plain spectrum block (K2, under K1, K3, K4,
K5 and S4, S5, S8), the plain posterior (K1, K5) and the plain model (K6)
therefore run on the calling thread alone on the CPU
(``cuda_kernels._one_cpu_thread``).  Here they run on one thread whatever the
thread count, restore the count, and give the bits of a one-thread call when
called repeatedly at 1, 2, 4 and 7 threads, at shapes whose ``torch.exp``
torch would otherwise split across threads.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmc_spec_tpu_torch.bench_target import build_bench_target, init_walker_batch  # noqa: E402
from mcmc_spec_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mcmc_spec_tpu_torch.ops import spec_segmented as seg  # noqa: E402
from mcmc_spec_tpu_torch.scripts import try_fast_recip as fr  # noqa: E402
from tests.test_torch_fleet import _fleet_walkers, _jax_fleet, _to_port  # noqa: E402

THREADS = [1, 2, 4, 7]
REPEATS = 2


@pytest.fixture(scope="module")
def cases():
    """{name: a call of a plain version on fixed tensors}."""
    arrays = [torch.from_numpy(a) for a in fr.synthetic_arrays(nw=64, nd=1024)]
    medd, Wc, av, D, kd, data, ie, Vp, VT = arrays
    tgt, truth = build_bench_target(torch.float32, device="cpu", nd=1792)
    P = init_walker_batch(tgt, truth, 32)
    fl = _to_port(_jax_fleet(jnp.float32)[1], torch.float32)
    Pf = torch.from_numpy(_fleet_walkers(32).astype(np.float32))
    Wf = torch.rand((Pf.shape[0], Pf.shape[1], fl.D.shape[1] * fl.D.shape[2]),
                    generator=torch.Generator().manual_seed(0))
    block = lambda iters, recip: lambda: ck._spectrum_block(
        Wc, av, D, kd[0], data[0], ie[0], Vp, VT, medd[0, 0], iters, recip=recip)
    return {
        "spectrum block (14, recip 2)": block(14, 2),
        "spectrum block (31, recip 0)": block(31, 0),
        "spectrum block (16, recip 0), S4's dial": block(fr.ITERS, 0),
        "K1 plain": lambda: ck.log_posterior_fused_reference(P, tgt),
        "K4 plain": lambda: ck.spectrum_chi2_fleet_reference(Wf, Pf[..., fl.nspec], fl),
        "K5 plain": lambda: ck.log_posterior_fleet_fused_reference(Pf, fl),
        "K6 plain": lambda: seg.model_extinct_reference(Wc, av[:, 0], D, kd[0]),
    }


@pytest.fixture(scope="module")
def one_thread(cases):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: fn().clone() for name, fn in cases.items()}
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("threads", THREADS)
def test_plain_versions_are_deterministic(cases, one_thread, threads):
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for name, fn in cases.items():
            for k in range(REPEATS):
                got = fn()
                assert torch.get_num_threads() == threads, name
                same = got.view(torch.int32) == one_thread[name].view(torch.int32)
                assert bool(same.all()), (
                    f"{name}, call {k + 1} at {threads} threads: {int((~same).sum())} of "
                    f"{same.numel()} values differ from the one-thread call")
    finally:
        torch.set_num_threads(before)


def test_plain_versions_run_on_the_calling_thread(cases, monkeypatch):
    """Each plain version's ``torch.exp`` runs with one intra-op thread, and the
    caller's thread count is back afterwards."""
    seen = []
    exp = torch.exp
    monkeypatch.setattr(torch, "exp", lambda x: seen.append(torch.get_num_threads()) or exp(x))
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        for name, fn in cases.items():
            seen.clear()
            fn()
            assert seen and set(seen) == {1}, (name, seen)
            assert torch.get_num_threads() == 4, name
    finally:
        torch.set_num_threads(before)
