"""Line-of-sight extinction prior profile Av(distance) (port of ``mcmc_spec_tpu.models.dust``).

The reference queries the Bayestar2019 3-D dust map on every posterior
evaluation.  Here, as in JAX, the profile is built ONCE per target on a
log-distance grid and the per-step prior is a tent-basis interpolation on
the device.

Fallback order of :meth:`AvProfile.for_target` (every step is logged):

1. a user-supplied LOS table (``av_profile`` config key / ``from_table``);
2. Bayestar2019 via ``dustmaps`` (behind a guarded import);
3. the bundled per-KOI fixture table (``assets/av_los/koi*.txt``);
4. the analytic exponential-disk model :meth:`analytic` calibrated so
   ``Av(d_target) == av`` from the config;
5. a constant profile only when no target distance is known.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SIGMA_FLOOR = 0.05  # mag, reference mft6.py:1237-1238
BAYESTAR_TO_AV = 3.1 * 0.884  # reference mft6.py:1234
DUST_SCALE_HEIGHT_PC = 125.0  # exponential dust-disk scale height (Drimmel & Spergel 2001)
# J2000 north galactic pole (equatorial), for the analytic LOS model
_NGP_RA = np.radians(192.85948)
_NGP_DEC = np.radians(27.12825)


def galactic_latitude(ra_deg: float, dec_deg: float) -> float:
    """Galactic latitude b (deg) from J2000 equatorial coordinates.

    Spherical law of cosines against the J2000 north galactic pole; matches
    published galactic latitudes (NGP, galactic centre, Vega) to <0.01 deg
    (tests/test_models.py) with no astropy dependency.
    """
    ra, dec = np.radians(ra_deg), np.radians(dec_deg)
    sinb = np.sin(dec) * np.sin(_NGP_DEC) + np.cos(dec) * np.cos(_NGP_DEC) * np.cos(
        ra - _NGP_RA
    )
    return float(np.degrees(np.arcsin(np.clip(sinb, -1.0, 1.0))))


def bundled_table(target_name: str):
    """Path of the shipped LOS fixture for a bundled KOI, else None.

    Matches the FIRST ``koi(\\d+)`` token in the target/param name against
    ``assets/av_los/koi{id}.txt`` (generated by
    ``scripts/make_av_los_tables.py`` — Bayestar when available, else a
    documented thin-disk approximation of the sight line).  Callers that
    compose several name fields must put the authoritative target id
    first (the pipeline passes ``koi{fname} {filename} {dirname}`` so a
    dirname mentioning another KOI cannot shadow the target).
    """
    import os
    import re

    m = re.search(r"koi[_-]?(\d+)", str(target_name), re.IGNORECASE)
    if not m:
        return None
    path = os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                        "av_los", f"koi{int(m.group(1))}.txt")
    return os.path.abspath(path) if os.path.exists(path) else None


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
        """Distance-independent prior (fallback when no dust map is available)."""
        d = np.array([1.0, 30000.0])
        return cls(d, np.full(2, av_mu), np.full(2, max(av_sig, SIGMA_FLOOR)))

    @classmethod
    def from_bayestar(cls, ra_deg: float, dec_deg: float, d_min=4.0, d_max=3000.0, n=256):
        """Query Bayestar2019 once over a log-distance grid (needs ``dustmaps``)."""
        from astropy import units as u  # pragma: no cover - optional deps
        from astropy.coordinates import SkyCoord  # pragma: no cover
        from dustmaps.bayestar import BayestarQuery  # pragma: no cover

        bayestar = BayestarQuery(version="bayestar2019")  # pragma: no cover
        dists = np.geomspace(d_min, d_max, n)  # pragma: no cover
        mus, sigs = [], []  # pragma: no cover
        for d in dists:  # pragma: no cover
            pos = SkyCoord(ra_deg * u.deg, dec_deg * u.deg, distance=d * u.pc)
            samples = bayestar(pos, mode="samples") * BAYESTAR_TO_AV
            mus.append(np.mean(samples))
            sigs.append(np.std(samples))
        return cls(dists, np.asarray(mus), np.asarray(sigs))  # pragma: no cover

    @classmethod
    def analytic(
        cls,
        ra_deg: float,
        dec_deg: float,
        av_at_dist: float,
        dist_pc: float,
        av_err: float = SIGMA_FLOOR,
        d_min: float = 4.0,
        d_max: float = 30000.0,
        n: int = 256,
    ) -> "AvProfile":
        """Exponential thin-disk LOS extinction, calibrated at the target.

        Integrating a dust density ``rho ~ exp(-|z|/h)`` along a sight line at
        galactic latitude b gives ``Av(d) = k*(1 - exp(-d*|sin b|/h))`` — the
        canonical saturating LOS form (h = 125 pc).  ``k`` is set so
        ``Av(d_target)`` equals the config's measured ``av``, i.e. the prior
        *rises toward the measured extinction and saturates beyond it*, the
        qualitative shape of every Bayestar sight line, instead of the round-1
        constant.  ``|sin b|`` is floored at 0.05 so in-plane sight lines grow
        ~linearly out to ~2.5 kpc rather than diverging.  The Gaussian width is
        distance-independent: ``max(av_err, 0.05)`` (the reference's sample
        std with its 0.05 floor, mft6.py:1237-1238).
        """
        b = galactic_latitude(ra_deg, dec_deg)
        sinb = max(abs(np.sin(np.radians(b))), 0.05)
        h = DUST_SCALE_HEIGHT_PC

        def shape(d):
            return 1.0 - np.exp(-np.asarray(d) * sinb / h)

        dist_pc = max(float(dist_pc), d_min)
        k = float(av_at_dist) / max(shape(dist_pc), 1e-12)
        dists = np.geomspace(d_min, d_max, n)
        mu = k * shape(dists)
        sig = np.full(n, max(float(av_err), SIGMA_FLOOR))
        return cls(dists, mu, sig)

    @classmethod
    def for_target(
        cls,
        ra_deg,
        dec_deg,
        av_fallback,
        av_err_fallback=SIGMA_FLOOR,
        dist_pc=None,
        table_path=None,
        target_name=None,
    ) -> "AvProfile":
        """Best available Av(d) profile for a target; logs which one was used.

        Order: user LOS table (``av_profile`` config key) -> Bayestar2019
        (exact) -> bundled per-KOI fixture table (``assets/av_los/koi*.txt``,
        matched on ``target_name``) -> analytic thin-disk model calibrated at
        ``dist_pc`` -> constant (only without a distance).
        """
        if table_path is not None:
            print(f"[dust] Av(d) prior from LOS table {table_path}")
            return cls.from_table(table_path)
        try:
            prof = cls.from_bayestar(ra_deg, dec_deg)
            print("[dust] Av(d) prior from Bayestar2019 (256-pt LOS profile)")
            return prof
        except ImportError as e:
            reason = f"dustmaps unavailable ({e})"
        except Exception as e:  # map data missing, network-off, bad coords
            reason = f"Bayestar query failed ({type(e).__name__}: {e})"
        bundled = bundled_table(target_name) if target_name else None
        if bundled is not None:
            print(f"[dust] {reason}; Av(d) prior from bundled LOS fixture "
                  f"{bundled}")
            return cls.from_table(bundled)
        if dist_pc is not None and np.isfinite(dist_pc) and dist_pc > 0:
            print(f"[dust] {reason}; using analytic thin-disk Av(d) model "
                  f"calibrated to Av={av_fallback} at {dist_pc:.0f} pc")
            return cls.analytic(ra_deg, dec_deg, av_fallback, dist_pc,
                                av_err_fallback)
        print(f"[dust] {reason} and no target distance; using a CONSTANT "
              f"Av prior {av_fallback} +- {max(av_err_fallback, SIGMA_FLOOR)}")
        return cls.constant(av_fallback, av_err_fallback)

    @classmethod
    def from_table(cls, path: str) -> "AvProfile":
        d, mu, sig = np.loadtxt(path, unpack=True)
        return cls(d, mu, sig)

    # ------------------------------------------------------------- device form
    def device_nodes(self, dtype=torch.float32, device="cuda"):
        """(log_d_nodes, mu_nodes, sig_nodes) tensors for tent interpolation."""
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return as_t(np.log(self.dist_pc)), as_t(self.av_mu), as_t(self.av_sig)

    def device_tables(self, n=256, dtype=torch.float32, device="cuda"):
        """(log_d_lo, log_d_step, mu_tab, sig_tab) tensors on a uniform log-distance grid."""
        log_d = np.log(self.dist_pc)
        lo, hi = float(log_d.min()), float(log_d.max())
        step = (hi - lo) / (n - 1) if hi > lo else 1.0
        grid = lo + step * np.arange(n)
        mu = np.interp(grid, log_d, self.av_mu)
        sig = np.interp(grid, log_d, self.av_sig)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return as_t(lo), as_t(step), as_t(mu), as_t(sig)
