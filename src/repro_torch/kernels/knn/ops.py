"""Public brute-force kNN wrappers around the CUDA kernel (plain twin on the
CPU).

PyTorch counterpart of the JAX package's ``kernels/knn/ops.py``: the same
names and keyword arguments, minus the TPU-only ``interpret``.  The kernel
masks ragged edges itself, so nothing is padded to tile multiples.  Inputs
of another float dtype (bf16) are computed in f32 and the distances
returned in the queries' dtype, as the reference's kernel does.
"""

from __future__ import annotations

import torch

from repro_torch.core.knn import sqrt_f32

from .knn_kernel import DEFAULT_TILE_D, DEFAULT_TILE_Q, knn_brute_kernel

PAD_COORD = 1e30  # dead points -> d2 = inf (f32) -> never selected


def knn_d2(points_xy, queries_xy, *, k: int = 15,
           tile_q: int = DEFAULT_TILE_Q, tile_d: int = DEFAULT_TILE_D):
    """Squared distances (n, k), ascending, of each query's k nearest
    points; +inf where k > m."""
    def f32(a):
        return a.to(torch.float32).contiguous()

    out = knn_brute_kernel(f32(queries_xy[:, 0]), f32(queries_xy[:, 1]),
                           f32(points_xy[:, 0]), f32(points_xy[:, 1]), k=k,
                           tile_q=tile_q, tile_d=tile_d)
    return out.to(queries_xy.dtype)


def knn_d2_with_ring(points_xy, ring_xy, queries_xy, *, k: int = 15,
                     tile_q: int = DEFAULT_TILE_Q,
                     tile_d: int = DEFAULT_TILE_D):
    """:func:`knn_d2` over the compacted table PLUS the hot append ring:
    ring points join the candidate set directly.  Dead ring slots must carry
    ``PAD_COORD``; their squared distance overflows f32 to inf and is never
    selected."""
    return knn_d2(torch.cat([points_xy, ring_xy.to(points_xy.dtype)]),
                  queries_xy, k=k, tile_q=tile_q, tile_d=tile_d)


def mean_nn_distance(d2):
    """Eq. (3) r_obs from the kernel's squared distances (sqrt deferred
    here; correctly rounded on every device)."""
    return sqrt_f32(torch.clamp_min(d2, 0.0)).mean(dim=-1)
