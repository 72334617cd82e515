"""Small utility ops from the reference's toolbox (port of ``mcmc_spec_tpu.ops.misc``).

Torch in, torch out on the input's device; numpy arrays and lists become CPU
tensors of numpy's dtype (float64 for floats).
"""
from __future__ import annotations

import numpy as np
import torch

C_KMS = 3e5  # the reference uses 3e5 km/s (mft6.py:44)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def bccorr(wl, bcvel_kms, radvel_kms):
    """Barycentric/radial velocity wavelength correction (mft6.py:32-44).

    ``wl * (1 + (bcvel - radvel)/c)`` with c = 3e5 km/s as in the reference.
    """
    return _tensor(wl) * (1.0 + (bcvel_kms - radvel_kms) / C_KMS)


def find_nearest(array, value):
    """Index of the array element closest to ``value`` (mft6.py:100-113)."""
    array = _tensor(array)
    return torch.argmin(torch.abs(array - value))
