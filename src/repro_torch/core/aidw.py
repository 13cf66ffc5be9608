"""AIDW mathematics — Eqs. (1)-(6) of Mei, Xu & Xu (2016) / Lu & Wong (2008).

PyTorch counterpart of the JAX package's ``core/aidw.py``: the same
constants, the same op chains, the same zero-weight guard.  Every function
works on tensors of any device; scalars that enter an f32 division are made
f32 tensors first, so the CPU and the card divide the same way (a CUDA
division by a host scalar multiplies by its reciprocal instead).

Stage-2 modes: ``naive``/``tiled`` take Eq. (1) over ALL m data points;
``local`` truncates it to the k Stage-1 neighbours
(:func:`topk_weighted_partial_sums`), leaving ``r_obs``/``alpha`` unchanged.

Zero-weight contract: a query whose every f32 weight underflows to zero
yields the sentinel 0.0 and a raised ``zero_weight_mask`` bit, never NaN
(:func:`guarded_values`).
"""

from __future__ import annotations

import math
import numbers

import torch

DEFAULT_ALPHAS = (0.5, 1.0, 2.0, 3.0, 4.0)
DEFAULT_R_MIN = 0.0
DEFAULT_R_MAX = 2.0
EPS_D2 = 1e-12
PAD_SENTINEL = 1e30  # padded points -> d2 = inf (f32) -> weight exactly 0
ZERO_WEIGHT_SENTINEL = 0.0  # value reported where sum(w) underflowed to zero


def on_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device`` (no copy if it is one).

    A Python or numpy number is filled in on the device: ``torch.tensor``
    of a host value would copy it over and block the stream."""
    if isinstance(x, numbers.Number):
        return torch.full((), float(x), dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def expected_nn_distance(n_points, area):
    """Eq. (2): r_exp = 1 / (2 sqrt(n / A)) for a random point pattern."""
    return 1.0 / (2.0 * torch.sqrt(n_points / area))


def nn_statistic(r_obs, r_exp):
    """Eq. (4): R(S0) = r_obs / r_exp."""
    return r_obs / r_exp


def fuzzy_membership(r_stat, r_min: float = DEFAULT_R_MIN,
                     r_max: float = DEFAULT_R_MAX):
    """Eq. (5): normalize R(S0) to mu_R in [0, 1] by a cosine fuzzy membership."""
    mu = 0.5 - 0.5 * torch.cos(math.pi / r_max * (r_stat - r_min))
    one = torch.ones_like(mu)
    return torch.where(r_stat <= r_min, torch.zeros_like(mu),
                       torch.where(r_stat >= r_max, one, mu))


def alpha_from_membership(mu, alphas=DEFAULT_ALPHAS):
    """Eq. (6): piecewise-linear alpha through the five levels: constant a1
    on [0, .1], linear a1->a2 on [.1, .3], ..., a4->a5 on [.7, .9], constant
    a5 on [.9, 1]."""
    a1, a2, a3, a4, a5 = (float(a) for a in alphas)
    out = torch.where(mu <= 0.1, torch.full_like(mu, a1),
                      torch.zeros_like(mu))
    segs = ((0.1, a1, a2), (0.3, a2, a3), (0.5, a3, a4), (0.7, a4, a5))
    for lo, alo, ahi in segs:
        t = 5.0 * (mu - lo)
        out = torch.where((mu > lo) & (mu <= lo + 0.2),
                          alo * (1.0 - t) + ahi * t, out)
    return torch.where(mu > 0.9, torch.full_like(mu, a5), out)


def adaptive_alpha(r_obs, n_points, area, *, alphas=DEFAULT_ALPHAS,
                   r_min: float = DEFAULT_R_MIN, r_max: float = DEFAULT_R_MAX):
    """Full Stage-2 alpha determination: Eqs. (2) -> (4) -> (5) -> (6).

    ``n_points`` and ``area`` may be Python numbers or f32 tensors; both
    become f32 tensors on ``r_obs``'s device."""
    f32, dev = torch.float32, r_obs.device
    r_exp = expected_nn_distance(on_device(n_points, f32, dev),
                                 on_device(area, f32, dev))
    return alpha_from_membership(
        fuzzy_membership(nn_statistic(r_obs, r_exp), r_min, r_max), alphas)


def idw_weights_sq(d2, alpha):
    """w_i = 1/d^alpha from SQUARED distances: (d^2)^(-alpha/2), with a zero
    distance clamped to ``EPS_D2`` so the weight saturates."""
    return torch.pow(torch.clamp_min(d2, EPS_D2), -0.5 * alpha)


def weighted_partial_sums(queries_xy, points_xy, values, alpha,
                          block: int = 1024, data_block: int = 0):
    """Eq. (1) numerator/denominator: (sum_i w_i z_i, sum_i w_i) per query.

    Blocked over queries (``block``); ``data_block`` additionally chunks the
    data axis with running sums, so no (block x m) tile is built.  Padded
    data rows carry ``PAD_SENTINEL`` coordinates and weigh exactly 0.
    """
    n = queries_xy.shape[0]
    m = points_xy.shape[0]
    alpha = torch.broadcast_to(on_device(alpha, values.dtype, values.device),
                               (n,))
    px, py = points_xy[:, 0], points_xy[:, 1]
    chunks = [(px, py, values)]
    if data_block and data_block < m:
        chunks = [(px[j:j + data_block], py[j:j + data_block],
                   values[j:j + data_block]) for j in range(0, m, data_block)]
    swz = torch.zeros(n, dtype=torch.float32, device=values.device)
    sw = torch.zeros_like(swz)
    for i in range(0, n, block):
        qb, ab = queries_xy[i:i + block], alpha[i:i + block, None]
        for dx, dy, dz in chunks:
            d2 = (qb[:, 0:1] - dx[None, :]) ** 2 + (qb[:, 1:2] - dy[None, :]) ** 2
            w = idw_weights_sq(d2, ab)
            swz[i:i + block] += (w * dz[None, :]).sum(-1)
            sw[i:i + block] += w.sum(-1)
    return swz, sw


def guarded_values(swz, sw):
    """Eq. (1) final division with the zero-denominator guard.

    Returns ``(values, zero_weight_mask)``: where the f32 weight sum is 0 the
    value is ``ZERO_WEIGHT_SENTINEL`` and the mask bit is set; elsewhere the
    division is performed verbatim.
    """
    zero = sw <= 0.0
    vals = torch.where(zero, torch.full_like(swz, ZERO_WEIGHT_SENTINEL),
                       swz / torch.where(zero, torch.ones_like(sw), sw))
    return vals, zero


def topk_weighted_partial_sums(d2, z, alpha):
    """Local-mode Eq. (1) partials over the k merged Stage-1 neighbours.

    ``d2``/``z``: (n, k) squared distances and neighbour values; ``alpha``:
    (n,) or scalar.  Slots with ``d2 = inf`` weigh exactly 0.  The k axis is
    summed SEQUENTIALLY left to right, the order the local CUDA kernel
    follows, so kernel and this path agree bitwise.
    """
    alpha = on_device(alpha, z.dtype, z.device)
    if alpha.ndim == 1:
        alpha = alpha[:, None]
    w = idw_weights_sq(d2, alpha)
    wz = w * z
    swz, sw = wz[..., 0], w[..., 0]
    for i in range(1, d2.shape[-1]):
        swz = swz + wz[..., i]
        sw = sw + w[..., i]
    return swz, sw


def weighted_interpolate(queries_xy, points_xy, values, alpha,
                         block: int = 1024, data_block: int = 0):
    """Eq. (1) over ALL data points with the guarded division (zero-weight
    queries give 0.0, never NaN)."""
    swz, sw = weighted_partial_sums(queries_xy, points_xy, values, alpha,
                                    block, data_block)
    return guarded_values(swz, sw)[0]
