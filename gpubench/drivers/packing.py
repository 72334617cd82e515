"""The program's targets from the benchmark's inputs, through its public packer, and
the evaluation a driver hands its sampler."""
from __future__ import annotations

import numpy as np
import torch


def pack(inp: dict, device, pad_nd=None, pad_nc=None):
    """``mcmc_spec_tpu_torch.inference.target.pack_target`` on one target's inputs."""
    from mcmc_spec_tpu_torch.inference.target import pack_target
    from mcmc_spec_tpu_torch.models.dust import AvProfile
    from mcmc_spec_tpu_torch.models.grid import SpectralGrid
    from mcmc_spec_tpu_torch.models.mist import MistTable
    from mcmc_spec_tpu_torch.ops.photometry import FilterCurve

    grid = SpectralGrid(inp["grid_temps"], inp["grid_loggs"], inp["grid_wl"], inp["grid_flux"])
    curves = lambda fs: [FilterCurve(name=f["name"], wl=f["wl"], tr=f["tr"]) for f in fs]
    return pack_target(
        grid, inp["data_wl_um"], inp["data_flux"], inp["data_err"],
        curves(inp["contrast_filters"]), inp["cmag"], inp["cerr"],
        curves(inp["phot_filters"]), inp["phot_zp"], inp["pmag"], inp["perr"],
        mist=MistTable(matrix=np.array(inp["mist_matrix"]), source="builtin"),
        av_profile=AvProfile(inp["av_dist_pc"], inp["av_mu"], inp["av_sig"]),
        nspec=inp["nspec"], dist_fit=True, rad_prior=False,
        prior_mu=inp["prior_mu"], prior_sig=inp["prior_sig"], dtype=torch.float32,
        device=device, pad_nd=pad_nd, pad_nc=pad_nc)


class Evaluation:
    """``fn(x, *args)`` as the sampler calls it (with ``args`` bound where the sampler
    passes only the batch), keeping by reference, with no copy, the batch it was last
    given and what it returned: the check judges the window's last update by them."""

    def __init__(self, fn, *args):
        self.fn, self.args, self.last = fn, args, None

    def __call__(self, x, *args):
        out = self.fn(x, *(args or self.args))
        self.last = (x, out)
        return out
