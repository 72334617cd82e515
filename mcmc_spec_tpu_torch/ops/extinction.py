"""CCM89 interstellar extinction, host numpy (port of ``mcmc_spec_tpu.ops.extinction``).

Cardelli, Clayton & Mathis (1989): ``A(lambda) = Av * (a(x) + b(x)/Rv)`` with
``x = 1e4/lambda(AA)``, branchwise over infrared, optical/NIR, UV and far-UV.
The port only evaluates it at pack time (``k(lambda) = ccm89(wl, 1)``), so
this is the numpy branch of the JAX module, operation for operation.
"""
from __future__ import annotations

import numpy as np

# Optical/NIR polynomial coefficients (CCM89 Table 3), ascending degree.
_OPT_A = np.array([1.0, 0.17699, -0.50447, -0.02427, 0.72085, 0.01979, -0.77530, 0.32999])
_OPT_B = np.array([0.0, 1.41338, 2.28305, 1.07233, -5.38434, -0.62251, 5.30260, -2.09002])


def _polyval_ascending(coeffs, y):
    """Evaluate sum_k coeffs[k] * y**k (coeffs in ascending order)."""
    out = np.zeros_like(y)
    for c in reversed(list(coeffs)):
        out = out * y + c
    return out


def ccm89(wl_aa, av, rv=3.1):
    """CCM89 extinction A(lambda) in magnitudes for wavelengths in Angstroms."""
    wl_aa = np.asarray(wl_aa)
    x = 1e4 / wl_aa  # inverse microns

    # infrared power law (also extrapolated below x = 0.3)
    xir = np.power(np.maximum(x, 1e-12), 1.61)
    a_ir = 0.574 * xir
    b_ir = -0.527 * xir

    y = x - 1.82
    a_opt = _polyval_ascending(_OPT_A, y)
    b_opt = _polyval_ascending(_OPT_B, y)

    fa = np.where(x >= 5.9, -0.04473 * (x - 5.9) ** 2 - 0.009779 * (x - 5.9) ** 3, 0.0)
    fb = np.where(x >= 5.9, 0.2130 * (x - 5.9) ** 2 + 0.1207 * (x - 5.9) ** 3, 0.0)
    a_uv = 1.752 - 0.316 * x - 0.104 / ((x - 4.67) ** 2 + 0.341) + fa
    b_uv = -3.090 + 1.825 * x + 1.206 / ((x - 4.62) ** 2 + 0.263) + fb

    z = x - 8.0
    a_fuv = -1.073 - 0.628 * z + 0.137 * z**2 - 0.070 * z**3
    b_fuv = 13.670 + 4.257 * z - 0.420 * z**2 + 0.374 * z**3

    a = np.where(x < 1.1, a_ir, np.where(x < 3.3, a_opt, np.where(x < 8.0, a_uv, a_fuv)))
    b = np.where(x < 1.1, b_ir, np.where(x < 3.3, b_opt, np.where(x < 8.0, b_uv, b_fuv)))
    return av * (a + b / rv)
