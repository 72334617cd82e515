"""Line-of-sight Av(distance) prior profile (port of part of ``mcmc_spec_tpu.models.dust``).

The profile is tabulated once per target on a log-distance grid and
interpolated with tent weights on the device.  Only the constant profile is
ported; the Bayestar, table and analytic sources wait for the pipeline port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SIGMA_FLOOR = 0.05  # mag


@dataclasses.dataclass
class AvProfile:
    """Gaussian Av prior vs distance, tabulated on a log-distance grid."""

    dist_pc: np.ndarray  # [n] sorted distances (pc)
    av_mu: np.ndarray  # [n]
    av_sig: np.ndarray  # [n] (floored)

    def __post_init__(self):
        self.dist_pc = np.asarray(self.dist_pc, dtype=np.float64)
        self.av_mu = np.asarray(self.av_mu, dtype=np.float64)
        sig = np.asarray(self.av_sig, dtype=np.float64)
        self.av_sig = np.where(sig == 0.0, SIGMA_FLOOR, sig)

    @classmethod
    def constant(cls, av_mu: float, av_sig: float = SIGMA_FLOOR) -> "AvProfile":
        """Distance-independent prior."""
        d = np.array([1.0, 30000.0])
        return cls(d, np.full(2, av_mu), np.full(2, max(av_sig, SIGMA_FLOOR)))

    def device_nodes(self, dtype=torch.float32, device="cuda"):
        """(log_d_nodes, mu_nodes, sig_nodes) tensors for tent interpolation."""
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return as_t(np.log(self.dist_pc)), as_t(self.av_mu), as_t(self.av_sig)
