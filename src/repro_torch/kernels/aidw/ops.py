"""Public Stage-2 wrappers around the CUDA kernels (plain twins on the CPU).

PyTorch counterpart of the JAX package's ``kernels/aidw/ops.py``.  Every
wrapper returns ``(values, zero_weight_mask)``: the mask is True where the
f32 weight sum underflowed to zero and the value is the 0.0 sentinel
instead of NaN.

Padding contract of the reference: the global kernel's queries pad to a
multiple of ``tile_q`` (coordinates 0.0, alpha 1.0) and its data to a
multiple of ``tile_d`` with ``PAD_COORD`` coordinates, whose squared
distance overflows f32 to inf and whose weight is exactly 0.  The local
kernel takes any n and k as they come: the reference's k padding to 128
lanes is a TPU layout artifact and has no counterpart here.

Inputs of another float dtype (bf16) are cast to f32 for the kernel, and
the values cast back, as the reference's kernel casts inside its body.
"""

from __future__ import annotations

import torch

from repro_torch.core import aidw as A

from .aidw_kernel import (DEFAULT_TILE_D, DEFAULT_TILE_Q,
                          local_interpolate_kernel, tiled_interpolate_kernel)

PAD_COORD = 1e30  # padded data points -> d2 = inf (f32) -> weight exactly 0


def _pad1(a: torch.Tensor, mult: int, value: float = 0.0) -> torch.Tensor:
    pad = (-a.shape[0]) % mult
    return torch.nn.functional.pad(a, (0, pad), value=value) if pad else a


def stats_tensor(n_points, area, device) -> torch.Tensor:
    """The (2,) f32 (n_points, area) pair the fused kernels read."""
    return torch.stack([A.on_device(v, torch.float32, device).reshape(())
                        for v in (n_points, area)])


def tiled_inputs(queries_xy, points_xy, values, aux, *, tile_q, tile_d):
    """The padded, contiguous f32 ``(qx, qy, aux, px, py, pz)`` the tiled
    kernel takes; ``aux`` (alpha or r_obs) is broadcast to (n,) in the
    queries' dtype first, as the reference does."""
    n, dtype = queries_xy.shape[0], queries_xy.dtype
    aux = torch.broadcast_to(A.on_device(aux, dtype, queries_xy.device), (n,))
    def f32(a):
        return a.to(torch.float32).contiguous()

    return (_pad1(f32(queries_xy[:, 0]), tile_q),
            _pad1(f32(queries_xy[:, 1]), tile_q),
            _pad1(f32(aux), tile_q, 1.0),
            _pad1(f32(points_xy[:, 0]), tile_d, PAD_COORD),
            _pad1(f32(points_xy[:, 1]), tile_d, PAD_COORD),
            _pad1(f32(values), tile_d))


def _tiled_call(queries_xy, points_xy, values, aux, stats, *, fused, tile_q,
                tile_d, alphas, r_min, r_max):
    n = queries_xy.shape[0]
    qx, qy, aux, px, py, pz = tiled_inputs(queries_xy, points_xy, values, aux,
                                           tile_q=tile_q, tile_d=tile_d)
    out, sumw = tiled_interpolate_kernel(
        qx, qy, aux, stats, px, py, pz, tile_q=tile_q, tile_d=tile_d,
        fused=fused, alphas=alphas, r_min=r_min, r_max=r_max)
    return out[:n].to(queries_xy.dtype), sumw[:n] <= 0.0


def tiled_interpolate(queries_xy, points_xy, values, alpha, *,
                      tile_q: int = DEFAULT_TILE_Q,
                      tile_d: int = DEFAULT_TILE_D):
    """Eq. (1) weighted average over all data points, per-query (or scalar)
    alpha: the paper's 'tiled version'.  Returns ``(values, mask)``."""
    return _tiled_call(queries_xy, points_xy, values, alpha,
                       stats_tensor(1.0, 1.0, queries_xy.device), fused=False,
                       tile_q=tile_q, tile_d=tile_d, alphas=A.DEFAULT_ALPHAS,
                       r_min=A.DEFAULT_R_MIN, r_max=A.DEFAULT_R_MAX)


def fused_stage2(queries_xy, points_xy, values, r_obs, *, n_points, area,
                 alphas=A.DEFAULT_ALPHAS, r_min: float = A.DEFAULT_R_MIN,
                 r_max: float = A.DEFAULT_R_MAX,
                 tile_q: int = DEFAULT_TILE_Q, tile_d: int = DEFAULT_TILE_D):
    """Alpha determination (Eqs. 2/4/5/6) + Eq. (1) weighting in ONE kernel
    launch.  Returns ``(values, mask)``."""
    return _tiled_call(queries_xy, points_xy, values, r_obs,
                       stats_tensor(n_points, area, queries_xy.device),
                       fused=True, tile_q=tile_q, tile_d=tile_d,
                       alphas=tuple(alphas), r_min=r_min, r_max=r_max)


def _local_call(d2, idx, values, aux, stats, *, fused, tile_q, alphas, r_min,
                r_max):
    f32 = torch.float32
    out, sumw = local_interpolate_kernel(
        d2.to(f32).contiguous(), idx.to(torch.int32).contiguous(),
        aux.to(f32).contiguous(), stats, values.to(f32).contiguous(),
        tile_q=tile_q, fused=fused, alphas=alphas, r_min=r_min, r_max=r_max)
    return out.to(values.dtype), sumw <= 0.0


def local_interpolate(d2, idx, values, alpha, *, tile_q: int = DEFAULT_TILE_Q):
    """Local (exact-k) Eq. (1): neighbour gather + weighting in one kernel,
    bitwise the plain top-k path (``topk_weighted_partial_sums`` +
    ``guarded_values``) on the same inputs.  Returns ``(values, mask)``."""
    alpha = torch.broadcast_to(A.on_device(alpha, values.dtype, values.device),
                               (d2.shape[0],))
    return _local_call(d2, idx, values, alpha,
                       stats_tensor(1.0, 1.0, d2.device), fused=False,
                       tile_q=tile_q, alphas=A.DEFAULT_ALPHAS,
                       r_min=A.DEFAULT_R_MIN, r_max=A.DEFAULT_R_MAX)


def fused_local_stage2(d2, idx, values, r_obs, *, n_points, area,
                       alphas=A.DEFAULT_ALPHAS,
                       r_min: float = A.DEFAULT_R_MIN,
                       r_max: float = A.DEFAULT_R_MAX,
                       tile_q: int = DEFAULT_TILE_Q):
    """Adaptive alpha (Eqs. 2/4/5/6) + neighbour gather + local Eq. (1), one
    launch, O(k) per query.  Returns ``(values, mask)``."""
    return _local_call(d2, idx, values, r_obs.to(values.dtype),
                       stats_tensor(n_points, area, d2.device), fused=True,
                       tile_q=tile_q, alphas=tuple(alphas), r_min=r_min,
                       r_max=r_max)
