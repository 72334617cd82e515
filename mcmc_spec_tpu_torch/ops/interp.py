"""Interpolation primitives (port of ``mcmc_spec_tpu.ops.interp``).

``interp1d_weights`` is the host-side (numpy) projection of the model
wavelength grid onto the data grid, used once at pack time.
``tent_weights`` is the gather-free piecewise-linear basis the batched
posterior interpolates with: ``tent_weights(nodes, q) @ ys == np.interp(q,
nodes, ys)``, edge clamping included.  ``bilinear_bracket`` and
``bilinear_gather_blend`` are the scalar forward model's (Teff, logg) blend:
a bracket search and a 4-row gather.
"""
from __future__ import annotations

import numpy as np
import torch


def interp1d_weights(src_wl, dst_wl):
    """(idx, w) such that ``f_dst = (1-w)*f_src[idx] + w*f_src[idx+1]``.

    Matches ``scipy.interpolate.interp1d(kind='linear')`` on in-range targets;
    returns numpy int32/float64.
    """
    src = np.asarray(src_wl, dtype=np.float64)
    dst = np.asarray(dst_wl, dtype=np.float64)
    idx = np.searchsorted(src, dst, side="right") - 1
    idx = np.clip(idx, 0, len(src) - 2)
    w = (dst - src[idx]) / (src[idx + 1] - src[idx])
    return idx.astype(np.int32), w


def tent_weights(nodes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Tent-basis weights ``[..., n_nodes]`` of queries ``q[...]`` on ``nodes``."""
    q = q[..., None]
    prev = torch.cat([nodes[:1] - 1.0, nodes[:-1]])
    nxt = torch.cat([nodes[1:], nodes[-1:] + 1.0])
    left = (q - prev) / (nodes - prev)
    right = (nxt - q) / (nxt - nodes)
    w = torch.clamp(torch.minimum(left, right), 0.0, 1.0)
    # edge clamping: the first/last node keeps full weight outside the range
    w0 = torch.clamp((nodes[1] - q[..., 0]) / (nodes[1] - nodes[0]), 0.0, 1.0)
    wn = torch.clamp((q[..., 0] - nodes[-2]) / (nodes[-1] - nodes[-2]), 0.0, 1.0)
    return torch.cat([w0[..., None], w[..., 1:-1], wn[..., None]], dim=-1)


def pwl_interp(xs, ys, q):
    """``np.interp(q, xs, ys)`` as a tent-basis matvec."""
    return tent_weights(xs, q) @ ys


def bilinear_bracket(axis_vals: torch.Tensor, q: torch.Tensor):
    """Bracketing index and fractional weight on a sorted 1-D axis.

    Returns ``(i, w)`` with ``axis_vals[i] <= q <= axis_vals[i+1]`` (clipped to
    the axis range) and ``w = (q - axis_vals[i]) / (axis_vals[i+1] - axis_vals[i])``.
    """
    q = torch.as_tensor(q, dtype=axis_vals.dtype, device=axis_vals.device)
    i = torch.searchsorted(axis_vals, q.reshape(-1), right=True).reshape(q.shape) - 1
    i = torch.clamp(i, 0, axis_vals.shape[0] - 2)
    lo, hi = axis_vals[i], axis_vals[i + 1]
    return i, (q - lo) / (hi - lo)


def bilinear_gather_blend(table, ti, tw, gi, gw):
    """Bilinearly blend ``table[nT, nG, ...]`` at fractional indices ``(ti, tw)``, ``(gi, gw)``."""
    f0 = table[ti, gi] * (1.0 - gw) + table[ti, gi + 1] * gw
    f1 = table[ti + 1, gi] * (1.0 - gw) + table[ti + 1, gi + 1] * gw
    return f0 * (1.0 - tw) + f1 * tw
