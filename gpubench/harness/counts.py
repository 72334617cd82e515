"""Operations and bytes of the work a cell's evaluations need, fixed by the
configuration and its dials: the same count whichever kernel or route does the work.

Per walker and target of nd data points (nc contrasts, npf bands, nspec components):

* the spectrum block, per data point: the model row from the 4 grid rows of each
  component's bilinear blend (a multiply and an add each: 8 nspec), the extinction (a
  multiply, an exp and a multiply: 3), the dial's median (a compare and a count for
  each bit the search resolves: 2 iters), the median match, the continuum fit and the
  chi^2 (the division into the data, three projections, the fitted continuum, its
  division, the scaled residual and its square sum: 19);
* the scalar part: per component the MIST logg lookup and the bilinear weights (20)
  and the contrast and band fluxes from the 4 grid rows (8 per band), then the
  magnitudes and their chi^2 (10 per band), the priors and the bounds (40).

Bytes count each input read once and each output written once, per launch of an
evaluation over a batch: the walkers' parameters and their log-posteriors, the grid on
the data wavelengths [NO, nd], the per-point vectors (data, errors, extinction, the two
continuum matrices: 9 nd) and the small tables (band fluxes of the grid, MIST and Av
nodes), in float32.  No intermediate (a model row held in memory between kernels)
counts: a fused and a split implementation are read against the same work.
"""
from __future__ import annotations

PEAK_F32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32 = 4


def spectrum_ops(nd: int, nspec: int, iters: int) -> int:
    return nd * (8 * nspec + 3 + 2 * iters + 19)


def scalar_ops(nc: int, npf: int, nspec: int) -> int:
    return nspec * (20 + 8 * (nc + npf)) + 10 * (nc + npf) + 40


class Counts:
    """The counts of one cell: ``targets`` [(nd, nc, npf)], each with as many walkers
    (one evaluation launch takes half of each target's walkers)."""

    def __init__(self, targets, nspec: int, NO: int, n_mist: int, iters: int):
        self.targets, self.nspec = list(targets), nspec
        self.NO, self.n_mist, self.iters = NO, n_mist, iters

    def eval_ops(self) -> float:
        """Operations of one evaluation, averaged over the targets (equal walkers)."""
        return sum(spectrum_ops(nd, self.nspec, self.iters) + scalar_ops(nc, npf, self.nspec)
                   for nd, nc, npf in self.targets) / len(self.targets)

    def launch_bytes(self, batch: int, ndim: int) -> int:
        """Bytes of one evaluation launch over ``batch`` walkers (spread evenly over the
        targets): parameters in, log-posteriors out, each target's tables once."""
        tables = sum(self.NO * nd + 9 * nd + self.NO * (nc + npf) + 3 * self.n_mist + 6
                     + 4 * (nc + npf) for nd, nc, npf in self.targets)
        return F32 * (batch * (ndim + 1) + tables)

    def least_seconds(self, evals: int, launches: int, ndim: int):
        """(seconds, bound by) of ``evals`` evaluations in ``launches`` launches."""
        ops = evals * self.eval_ops()
        nbytes = launches * self.launch_bytes(evals // max(launches, 1), ndim)
        t_ops, t_bytes = ops / PEAK_F32_PER_S, nbytes / PEAK_BYTES_PER_S
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
