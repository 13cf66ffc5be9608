"""Launch wrapper for the brute-force kNN CUDA kernel, and its plain twin.

``knn_brute_kernel`` replaces the Pallas TPU kernel ``knn_kernel`` of the
JAX package's ``kernels/knn/knn_kernel.py``; the CUDA source is
``csrc/knn_kernels.cu``.

* For a CUDA tensor the wrapper checks device, dtype, shape and contiguity,
  allocates its output with ``torch.empty``, launches the kernel on the
  current stream (no synchronisation), raises if the launch reports an
  error, and adds one to its ``launches`` count.
* For a CPU tensor it runs the plain twin :func:`knn_brute_plain`.  There is
  no fallback from the kernel to the twin: a CUDA tensor either reaches the
  kernel or raises.

Layouts are 1-D f32 vectors: queries ``qx/qy`` (n,), data ``px/py`` (m,).
The output is (n, k) f32, each row ascending; slots beyond m are +inf.
"""

from __future__ import annotations

import torch

from .. import build
from ..aidw.aidw_kernel import _check, _require_cuda

DEFAULT_TILE_Q = 256   # queries (threads) per CTA
DEFAULT_TILE_D = 512   # data points per shared-memory tile
MAX_TILE_D = 6144      # 6144 float2 = 48 KiB, the static shared-memory limit
MAX_K = 64             # the largest per-thread register buffer instantiated

# the plain twin's blocks hold at most this many (query, point) distances
_PLAIN_ELEMS = 1 << 26


def reset_launches() -> None:
    """Zero the wrapper's launch count."""
    knn_brute_kernel.launches = 0


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}: the kernel's "
                         f"per-thread buffer holds at most {MAX_K} distances")


def knn_brute_plain(qx, qy, px, py, *, k: int):
    """Twin of the kernel: ``(qx - px)**2 + (qy - py)**2`` over blocks of
    queries, ``torch.topk(largest=False, sorted=True)`` over ``min(k, m)``,
    then +inf up to k.  Returns (n, k)."""
    _check_k(k)
    n, m = qx.shape[0], px.shape[0]
    kk = min(k, m)
    out = torch.full((n, k), torch.inf, dtype=torch.float32, device=qx.device)
    if kk == 0:
        return out
    block = max(1, _PLAIN_ELEMS // m)
    for i in range(0, n, block):
        q = slice(i, i + block)
        d2 = (qx[q, None] - px[None, :]) ** 2 + (qy[q, None] - py[None, :]) ** 2
        out[q, :kk] = torch.topk(d2, kk, dim=1, largest=False,
                                 sorted=True).values
    return out


def knn_brute_kernel(qx, qy, px, py, *, k: int,
                     tile_q: int = DEFAULT_TILE_Q,
                     tile_d: int = DEFAULT_TILE_D):
    """The k smallest squared distances per query, ascending, through
    ``knn_brute_kernel<KMAX>`` (KMAX = 16, 32 or 64, the smallest >= k).

    Any n and m (the kernel masks the ragged edges); ``1 <= k <= 64``.
    Returns (n, k) f32."""
    if qx.device.type == "cpu":
        return knn_brute_plain(qx, qy, px, py, k=k)
    _require_cuda(qx)
    _check_k(k)
    dev, f32 = qx.device, torch.float32
    n, m = qx.shape[0], px.shape[0]
    for name, t in (("qx", qx), ("qy", qy)):
        _check(name, t, f32, (n,), dev)
    for name, t in (("px", px), ("py", py)):
        _check(name, t, f32, (m,), dev)
    if not 1 <= tile_q <= 1024 or not 1 <= tile_d <= MAX_TILE_D:
        raise ValueError(f"tile_q must be in [1, 1024] and tile_d in "
                         f"[1, {MAX_TILE_D}], got {tile_q}, {tile_d}")
    out = torch.empty((n, k), dtype=f32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = build.library("knn_kernels").knn_brute(
            qx.data_ptr(), qy.data_ptr(), px.data_ptr(), py.data_ptr(),
            out.data_ptr(), n, m, k, tile_q, tile_d,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"knn_brute launch failed: CUDA error {err}")
    knn_brute_kernel.launches += 1
    return out


reset_launches()
