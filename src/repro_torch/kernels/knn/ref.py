"""Dense oracle for the brute-force kNN kernel (no blocking, no kernel)."""

from __future__ import annotations

import torch


def knn_d2_ref(points_xy, queries_xy, *, k: int = 15):
    """The full (n, m) distance matrix + ``torch.topk``; f32 arithmetic,
    +inf where k > m, returned in the queries' dtype."""
    q = queries_xy.to(torch.float32)
    p = points_xy.to(torch.float32)
    d2 = (q[:, 0:1] - p[None, :, 0]) ** 2 + (q[:, 1:2] - p[None, :, 1]) ** 2
    out = torch.topk(d2, min(k, p.shape[0]), dim=1, largest=False,
                     sorted=True).values
    if out.shape[1] < k:  # fewer points than k: pad with inf like the kernel
        out = torch.nn.functional.pad(out, (0, k - out.shape[1]),
                                      value=torch.inf)
    return out.to(queries_xy.dtype)
