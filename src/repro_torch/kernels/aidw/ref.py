"""Dense oracles for the Stage-2 kernels (no blocking, no kernel)."""

from __future__ import annotations

import torch

from repro_torch.core import aidw as A


def interpolate_ref(queries_xy, points_xy, values, alpha):
    """Dense Eq. (1): the full (n, m) weight matrix in one shot, f32 sums."""
    n = queries_xy.shape[0]
    f32 = torch.float32
    alpha = torch.broadcast_to(
        torch.as_tensor(alpha, dtype=f32, device=queries_xy.device), (n,))
    q, p, z = queries_xy.to(f32), points_xy.to(f32), values.to(f32)
    d2 = (q[:, 0:1] - p[None, :, 0]) ** 2 + (q[:, 1:2] - p[None, :, 1]) ** 2
    w = torch.pow(torch.clamp_min(d2, A.EPS_D2), -0.5 * alpha[:, None])
    return ((w * z[None, :]).sum(-1) / w.sum(-1)).to(queries_xy.dtype)


def fused_stage2_ref(queries_xy, points_xy, values, r_obs, *, n_points, area,
                     alphas=A.DEFAULT_ALPHAS, r_min=A.DEFAULT_R_MIN,
                     r_max=A.DEFAULT_R_MAX):
    """Alpha determination + Eq. (1), unfused reference path."""
    alpha = A.adaptive_alpha(r_obs.to(torch.float32), float(n_points),
                             float(area), alphas=alphas, r_min=r_min,
                             r_max=r_max)
    return interpolate_ref(queries_xy, points_xy, values, alpha)
