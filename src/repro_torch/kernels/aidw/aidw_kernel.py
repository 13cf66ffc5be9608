"""Launch wrappers for the Stage-2 CUDA kernels, and their plain PyTorch twins.

``tiled_interpolate_kernel`` and ``local_interpolate_kernel`` replace the
Pallas TPU kernels of the same names in the JAX package's
``kernels/aidw/aidw_kernel.py``; the CUDA source is ``csrc/aidw_kernels.cu``.

* For a CUDA tensor a wrapper checks device, dtype, shape and contiguity,
  allocates its outputs with ``torch.empty``, launches the kernel on the
  current stream (no synchronisation), raises if the launch reports an
  error, and adds one to its ``launches`` count.
* For a CPU tensor it runs the plain twin (``*_plain``), which repeats the
  kernel's arithmetic with PyTorch ops.  There is no fallback from the
  kernel to the twin: a CUDA tensor either reaches the kernel or raises.

Layouts are 1-D f32 vectors: queries ``qx/qy/aux`` (n,), data ``px/py/pz``
(m,), ``stats`` (2,) = (n_points, area) on the same device (read by the
fused variants only, so dataset churn changes no launch argument).

The tiled kernel splits the data axis across CTAs when the batch alone
would leave the card idle: :func:`plan_splits` picks the number of chunks
from the shapes, the card's SM count and the kernel's resident CTAs per SM,
and the partial sums are added in chunk order by a second small kernel.
The twin takes the same ``splits`` and adds in the same order; on a CPU
tensor the wrapper plans for an H100 (:func:`reference_ctas_per_sm`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.core import aidw as A

from .. import build

DEFAULT_TILE_Q = 256   # queries per CTA (tile_q / q threads, q a thread)
DEFAULT_TILE_D = 512   # data points per shared-memory tile
MAX_TILE_D = 3072      # 3072 float4 = 48 KiB, the static shared-memory limit

# The split planner, in waves of resident CTAs (SMs x CTAs an SM holds): a
# split launch aims at two; a launch whose query CTAs fill half of one stays
# whole, as the 262,144-query batch does on an H100 (1,024 CTAs of 128
# threads, 0.65 of a wave; PERF.md §6).
SPLIT_WAVES = 2
WHOLE_WAVES = 0.5

# The card the CPU path plans for: an H100 SXM's 132 SMs, and the registers
# a thread of each aidw_tiled_kernel<q, fused> instance takes (ptxas -v,
# CUDA 12.9, sm_90a), from which :func:`reference_ctas_per_sm` repeats the
# occupancy API's answer.
REFERENCE_SMS = 132
TILED_REGISTERS = {(1, False): 48, (2, False): 40, (4, False): 48,
                   (1, True): 48, (2, True): 40, (4, True): 48}

# the plain twin's blocks: it never builds an (n, m) matrix
_PLAIN_Q_BLOCK = 1024
_PLAIN_D_BLOCK = 8192


def reset_launches() -> None:
    """Zero both wrappers' launch counts."""
    tiled_interpolate_kernel.launches = 0
    local_interpolate_kernel.launches = 0


def _alpha_args(alphas, r_min, r_max):
    """Eq. (5)/(6) constants as the C entry points take them; the host array
    must stay referenced until the call returns."""
    if len(alphas) != 5:
        raise ValueError(f"need 5 alpha levels, got {len(alphas)}")
    arr = (ctypes.c_float * 5)(*(float(a) for a in alphas))
    cos_scale = float(np.float32(math.pi / r_max))
    return arr, float(r_min), float(r_max), cos_scale


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"kernels run on cuda or cpu tensors, got {t.device}")


# -- global (tiled) Stage 2 ----------------------------------------------------


def queries_per_thread(tile_q: int) -> int:
    """Queries a thread of the tiled kernel holds in registers: 4 or 2 while
    the CTA keeps four warps (tile_q / q >= 128 threads, a warp for each
    scheduler of the SM), else 1."""
    for q in (4, 2):
        if tile_q % q == 0 and tile_q // q >= 128:
            return q
    return 1


def plan_splits(n: int, m: int, tile_q: int, tile_d: int, *, sms: int,
                ctas_per_sm: int) -> int:
    """Data-axis chunks of a tiled launch over ``n`` queries and ``m``
    points on a card of ``sms`` SMs that holds ``ctas_per_sm`` of its CTAs.

    1 when the ``n / tile_q`` query CTAs alone fill :data:`WHOLE_WAVES`
    of a wave (``sms * ctas_per_sm`` resident CTAs); otherwise enough chunks
    to fill :data:`SPLIT_WAVES` waves, and never more than the
    ``m / tile_d`` data tiles.  Non-increasing in ``n``."""
    q_ctas = -(-n // tile_q)
    tiles = m // tile_d
    wave = sms * ctas_per_sm
    if q_ctas == 0 or tiles <= 1 or q_ctas >= WHOLE_WAVES * wave:
        return 1
    return min(tiles, -(-SPLIT_WAVES * wave // q_ctas))


def reference_ctas_per_sm(q: int, threads: int, tile_d: int,
                          fused: bool) -> int:
    """Resident CTAs of the tiled kernel an H100 SM holds, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives it: the least of
    32 CTAs, 64 warps, the registers (65,536, in 256-register units a warp,
    a quarter on each scheduler) and 228 KiB of shared memory (1 KiB more a
    CTA)."""
    warps = -(-threads // 32)
    regs_warp = -(-TILED_REGISTERS[q, bool(fused)] * 32 // 256) * 256
    by_regs = 4 * (16_384 // regs_warp) // warps
    by_smem = 233_472 // (16 * tile_d + 1024)
    return max(1, min(32, 64 // warps, by_regs, by_smem))


@functools.cache
def card_ctas_per_sm(index: int, q: int, threads: int, tile_d: int,
                     fused: bool) -> tuple[int, int]:
    """``(SM count, resident CTAs per SM)`` of card ``index`` for the tiled
    kernel instance, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    ctas = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.library("aidw_kernels").aidw_tiled_ctas_per_sm(
            q, threads, tile_d, int(fused), ctypes.addressof(ctas))
    if err:
        raise RuntimeError(f"aidw_tiled_ctas_per_sm failed: CUDA error {err}")
    return (torch.cuda.get_device_properties(index).multi_processor_count,
            ctas.value)


def tiled_splits(n: int, m: int, *, tile_q: int = DEFAULT_TILE_Q,
                 tile_d: int = DEFAULT_TILE_D, fused: bool = False,
                 device=None) -> int:
    """The ``splits`` the tiled wrapper launches with on ``device``: the
    card's own SM count and occupancy on CUDA, an H100's on the CPU (so the
    twin adds in the order that card would)."""
    device = torch.device("cpu" if device is None else device)
    q = queries_per_thread(tile_q)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        sms, ctas = card_ctas_per_sm(index, q, tile_q // q, tile_d,
                                     bool(fused))
    else:
        sms = REFERENCE_SMS
        ctas = reference_ctas_per_sm(q, tile_q // q, tile_d, fused)
    return plan_splits(n, m, tile_q, tile_d, sms=sms, ctas_per_sm=ctas)


def tiled_interpolate_plain(qx, qy, aux, stats, px, py, pz, *, fused=False,
                            alphas=A.DEFAULT_ALPHAS, r_min=A.DEFAULT_R_MIN,
                            r_max=A.DEFAULT_R_MAX, splits: int = 1,
                            tile_d: int = DEFAULT_TILE_D):
    """Twin of the tiled kernel, exp/log weights, ``max(sum_w, 1e-30)``
    finish.  Returns ``(values (n,), sum_w (n,))``.

    The data axis is cut as the kernel cuts it into ``splits`` chunks of
    whole ``tile_d`` tiles; per query, each chunk's (sum_w, sum_wz) is a
    running sum over its data blocks, and the chunks' sums are added in
    chunk order.  ``splits=1`` is one running sum over all blocks."""
    alpha = A.adaptive_alpha(aux, stats[0], stats[1], alphas=alphas,
                             r_min=r_min, r_max=r_max) if fused else aux
    nha = -0.5 * alpha
    m = px.shape[0]
    tiles = -(-m // tile_d)
    cuts = [min(m, tile_d * (s * tiles // splits)) for s in range(splits + 1)]
    sw = torch.zeros_like(qx)
    swz = torch.zeros_like(qx)
    for i in range(0, qx.shape[0], _PLAIN_Q_BLOCK):
        q = slice(i, i + _PLAIN_Q_BLOCK)
        x, y, h = qx[q, None], qy[q, None], nha[q, None]
        for a, b in zip(cuts[:-1], cuts[1:]):
            cw = torch.zeros_like(x[:, 0])
            cwz = torch.zeros_like(x[:, 0])
            for j in range(a, b, _PLAIN_D_BLOCK):
                d = slice(j, min(j + _PLAIN_D_BLOCK, b))
                d2 = (x - px[None, d]) ** 2 + (y - py[None, d]) ** 2
                w = torch.exp(h * torch.log(torch.clamp_min(d2, A.EPS_D2)))
                cw += w.sum(1)
                cwz += (w * pz[None, d]).sum(1)
            sw[q] += cw
            swz[q] += cwz
    return swz / torch.clamp_min(sw, 1e-30), sw


def tiled_interpolate_kernel(qx, qy, aux, stats, px, py, pz, *,
                             tile_q: int = DEFAULT_TILE_Q,
                             tile_d: int = DEFAULT_TILE_D, fused: bool = False,
                             alphas=A.DEFAULT_ALPHAS,
                             r_min: float = A.DEFAULT_R_MIN,
                             r_max: float = A.DEFAULT_R_MAX):
    """Global Eq. (1) through ``aidw_tiled_kernel<q, fused>``, q =
    :func:`queries_per_thread` (tile_q), split along the data axis as
    :func:`tiled_splits` plans it (then a second small kernel adds the
    chunks' partial sums in order; one launch count either way).

    ``n % tile_q == 0`` and ``m % tile_d == 0`` (the ops layer pads).
    Returns ``(values (n,), sum_w (n,))``; ``aux`` is alpha, or r_obs when
    ``fused``."""
    n, m = qx.shape[0], px.shape[0]
    if qx.device.type == "cpu":
        return tiled_interpolate_plain(
            qx, qy, aux, stats, px, py, pz, fused=fused, alphas=alphas,
            r_min=r_min, r_max=r_max, tile_d=tile_d,
            splits=tiled_splits(n, m, tile_q=tile_q, tile_d=tile_d,
                                fused=fused))
    _require_cuda(qx)
    dev, f32 = qx.device, torch.float32
    for name, t in (("qx", qx), ("qy", qy), ("aux", aux)):
        _check(name, t, f32, (n,), dev)
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        _check(name, t, f32, (m,), dev)
    _check("stats", stats, f32, (2,), dev)
    if not 1 <= tile_q <= 1024 or not 1 <= tile_d <= MAX_TILE_D:
        raise ValueError(f"tile_q must be in [1, 1024] and tile_d in "
                         f"[1, {MAX_TILE_D}] (float4 points in 48 KiB of "
                         f"shared memory), got {tile_q}, {tile_d}")
    if n % tile_q or m % tile_d:
        raise ValueError(f"n={n} and m={m} must be multiples of tile_q="
                         f"{tile_q} and tile_d={tile_d}")
    out = torch.empty_like(qx)
    sumw = torch.empty_like(qx)
    if n == 0:
        return out, sumw
    q = queries_per_thread(tile_q)
    splits = tiled_splits(n, m, tile_q=tile_q, tile_d=tile_d, fused=fused,
                          device=dev)
    part = torch.empty((2, splits, n), dtype=f32, device=dev) \
        if splits > 1 else None
    arr, rmin, rmax, cos_scale = _alpha_args(alphas, r_min, r_max)
    with torch.cuda.device(dev):
        err = build.library("aidw_kernels").aidw_tiled(
            qx.data_ptr(), qy.data_ptr(), aux.data_ptr(), stats.data_ptr(),
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), out.data_ptr(),
            sumw.data_ptr(), 0 if part is None else part.data_ptr(), n, m,
            tile_q, tile_d, q, splits, int(fused), ctypes.addressof(arr),
            rmin, rmax, cos_scale,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"aidw_tiled launch failed: CUDA error {err}")
    tiled_interpolate_kernel.launches += 1
    return out, sumw


# -- local (exact-k) Stage 2 ---------------------------------------------------


def local_interpolate_plain(d2, idx, aux, stats, pz, *, fused=False,
                            alphas=A.DEFAULT_ALPHAS, r_min=A.DEFAULT_R_MIN,
                            r_max=A.DEFAULT_R_MAX):
    """Twin of the local kernel: gather ``pz[idx]``, power-form weights, a
    sequential left-to-right sum over k, the guarded division.  Returns
    ``(values (n,), sum_w (n,))``."""
    alpha = A.adaptive_alpha(aux, stats[0], stats[1], alphas=alphas,
                             r_min=r_min, r_max=r_max) if fused else aux
    swz, sw = A.topk_weighted_partial_sums(d2, pz[idx.long()], alpha)
    return A.guarded_values(swz, sw)[0], sw


def local_interpolate_kernel(d2, idx, aux, stats, pz, *,
                             tile_q: int = DEFAULT_TILE_Q, fused: bool = False,
                             alphas=A.DEFAULT_ALPHAS,
                             r_min: float = A.DEFAULT_R_MIN,
                             r_max: float = A.DEFAULT_R_MAX):
    """Local Eq. (1) through ``aidw_local_kernel<fused>``.

    ``d2`` (n, k) f32 and ``idx`` (n, k) int32 are the Stage-1 neighbours
    (``idx`` must index ``pz`` (m,)); any n (the kernel masks the ragged
    edge).  Returns ``(values (n,), sum_w (n,))``."""
    if d2.device.type == "cpu":
        return local_interpolate_plain(d2, idx, aux, stats, pz, fused=fused,
                                       alphas=alphas, r_min=r_min,
                                       r_max=r_max)
    _require_cuda(d2)
    dev = d2.device
    if d2.ndim != 2 or d2.shape[1] < 1:
        raise ValueError(f"d2 must be (n, k) with k >= 1, got {tuple(d2.shape)}")
    n, k = d2.shape
    _check("d2", d2, torch.float32, (n, k), dev)
    _check("idx", idx, torch.int32, (n, k), dev)
    _check("aux", aux, torch.float32, (n,), dev)
    _check("stats", stats, torch.float32, (2,), dev)
    _check("pz", pz, torch.float32, (pz.shape[0],), dev)
    if not 1 <= tile_q <= 1024:
        raise ValueError(f"tile_q must be in [1, 1024], got {tile_q}")
    out = torch.empty_like(aux)
    sumw = torch.empty_like(aux)
    if n == 0:
        return out, sumw
    arr, rmin, rmax, cos_scale = _alpha_args(alphas, r_min, r_max)
    with torch.cuda.device(dev):
        err = build.library("aidw_kernels").aidw_local(
            d2.data_ptr(), idx.data_ptr(), aux.data_ptr(), stats.data_ptr(),
            pz.data_ptr(), out.data_ptr(), sumw.data_ptr(), n, k, tile_q,
            int(fused), ctypes.addressof(arr), rmin, rmax, cos_scale,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"aidw_local launch failed: CUDA error {err}")
    local_interpolate_kernel.launches += 1
    return out, sumw


reset_launches()
