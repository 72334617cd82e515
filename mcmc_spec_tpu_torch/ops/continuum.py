"""Closed-form polynomial continuum renormalisation (port of ``mcmc_spec_tpu.ops.continuum``).

``numpy.polynomial.Polynomial.fit(wl, frac, deg)`` evaluated at the same
``wl`` equals ``V @ pinv(V) @ frac`` for the scaled-domain Vandermonde ``V``;
both factors depend only on the fixed data grid and are built once at pack
time.
"""
from __future__ import annotations

import numpy as np


def polyfit_renorm_matrix(wl, deg=2):
    """(V [n, deg+1], pinv(V) [deg+1, n]) as float64 numpy arrays."""
    wl = np.asarray(wl, dtype=np.float64)
    lo, hi = wl.min(), wl.max()
    x = 2.0 * (wl - lo) / (hi - lo) - 1.0  # affine map onto [-1, 1]
    V = np.vander(x, deg + 1, increasing=True)
    Vpinv = np.linalg.pinv(V)
    return V, Vpinv
