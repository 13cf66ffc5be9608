"""Fast kNN search over the even grid — Stage 1 of the improved algorithm.

PyTorch counterpart of the JAX package's ``core/knn.py`` (the replicated
search; the slab and ring variants are not ported yet).  Paper mapping
(§3.2.4 / Fig. 5), per query: locate its cell, choose the expansion level
from ring counts, gather the candidates of the level's block and keep the k
nearest, then average the k distances (Eq. 3).

The reference vmaps one query at a time; here a block of queries is one
batch dimension:

* ring counts for every level come from gathers of ``cell_start`` at
  (query, level, band row) — no loop over points;
* the level is the first with >= k candidates, plus the paper's safety ring;
* the candidates of a level's block, one contiguous CSR slice per band row,
  are packed into ``window`` slots (a batched ``searchsorted`` finds each
  slot's row) and the k nearest are selected with ``torch.topk``;
* with ``exact=True`` a second gather at ``ceil(d_k / cell_width)`` runs for
  EVERY query and is selected with ``torch.where`` (no per-query branch),
  certifying the result unless the window overflows or the level clamps.

Integer outputs (``n_candidates``, ``overflow``) equal the reference's
exactly: the f32 index arithmetic follows XLA's compiled form
(``repro_torch.core.grid.scaled``), and square roots are rounded correctly
on every device (:func:`sqrt_f32`).  ``idx`` may differ only among equal
distances, where ``torch.topk`` and ``jax.lax.top_k`` break ties apart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .grid import CellTable, GridSpec, cell_index, scaled, to_int32_saturating


class KnnResult(NamedTuple):
    d2: torch.Tensor            # (n, k) squared distances, ascending
    idx: torch.Tensor           # (n, k) int32 indices into the ORIGINAL points
    n_candidates: torch.Tensor  # (n,) int32 candidates examined per query
    overflow: torch.Tensor      # (n,) bool: window too small (result approximate)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on any device (through f64: the CPU
    build's vectorised f32 sqrt is not always correctly rounded)."""
    return torch.sqrt(x.double()).float()


def _gather_topk(k, max_level, window, cell_start, sx, sy, order, qx, qy,
                 col0, n_cols, dr, row_ok, row_base, lvl):
    """Gather each query's level-``lvl`` block and select its k nearest.

    Shapes: ``qx/qy/col0/lvl`` (B,); ``dr`` (n_band,); ``row_ok``/
    ``row_base`` (B, n_band).  Returns ``(d2, idx, total)``."""
    n_band = 2 * max_level + 1
    flo = (col0 - lvl).clamp(0, n_cols - 1)[:, None]
    fhi = (col0 + lvl).clamp(0, n_cols - 1)[:, None]
    active = (dr.abs()[None, :] <= lvl[:, None]) & row_ok
    r_start = cell_start[row_base + flo]
    r_len = torch.where(active, cell_start[row_base + fhi + 1] - r_start, 0)
    offsets = r_len.cumsum(1, dtype=torch.int32)                 # (B, n_band)
    total = offsets[:, -1]

    slots = torch.arange(window, dtype=torch.int32, device=qx.device)
    row_of = torch.searchsorted(
        offsets, slots.expand(qx.shape[0], window).contiguous(), right=True)
    row_of = row_of.clamp_max(n_band - 1)
    prev = torch.where(row_of > 0,
                       offsets.gather(1, (row_of - 1).clamp_min(0)), 0)
    src = r_start.gather(1, row_of) + (slots - prev)
    valid = slots[None, :] < total.clamp_max(window)[:, None]
    src = src.clamp(0, sx.shape[0] - 1).long()

    # exact kNN among candidates (squared distances; sqrt deferred)
    d2 = (sx[src] - qx[:, None]) ** 2 + (sy[src] - qy[:, None]) ** 2
    d2 = torch.where(valid, d2, torch.inf)
    neg_top, top_i = torch.topk(-d2, k, dim=1, sorted=True)
    return -neg_top, order[src.gather(1, top_i)], total


def _query_knn(spec, k, max_level, window, exact, cell_start, sx, sy, order,
               qx, qy) -> KnnResult:
    """kNN for a block of queries ``qx``/``qy`` (B,)."""
    n_cols, n_rows = spec.n_cols, spec.n_rows
    dev = qx.device
    col0 = cell_index(qx, spec.min_x, spec.cell_width, n_cols)
    row0 = cell_index(qy, spec.min_y, spec.cell_width, n_rows)

    dr = torch.arange(-max_level, max_level + 1, dtype=torch.int32, device=dev)
    rows = row0[:, None] + dr[None, :]                             # (B, n_band)
    row_ok = (rows >= 0) & (rows < n_rows)
    row_base = rows.clamp(0, n_rows - 1) * n_cols

    # ring counts for every level L: points of rows |dr| <= L in columns
    # [col0 - L, col0 + L], from two gathers of cell_start
    levels = torch.arange(max_level + 1, dtype=torch.int32, device=dev)
    clo = (col0[:, None] - levels[None, :]).clamp(0, n_cols - 1)   # (B, n_lvl)
    chi = (col0[:, None] + levels[None, :]).clamp(0, n_cols - 1)
    start_idx = row_base[:, None, :] + clo[:, :, None]          # (B, n_lvl, n_band)
    end_idx = row_base[:, None, :] + chi[:, :, None] + 1
    row_cnt = cell_start[end_idx] - cell_start[start_idx]
    in_band = dr.abs()[None, :] <= levels[:, None]                 # (n_lvl, n_band)
    row_cnt = torch.where(in_band[None] & row_ok[:, None, :], row_cnt, 0)
    counts = row_cnt.sum(2)                                        # (B, n_lvl)

    # first level with >= k candidates; paper's Remark: one extra ring.  The
    # true point count is cell_start[-1]: capacity-padded tables carry
    # sentinel tail slots outside every CSR range.
    need = torch.clamp(cell_start[-1], min=1).clamp_max(k)
    enough = counts >= need
    first = torch.where(enough.any(1), enough.to(torch.uint8).argmax(1),
                        max_level).to(torch.int32)
    lvl = (first + 1).clamp_max(max_level)

    args = (k, max_level, window, cell_start, sx, sy, order, qx, qy, col0,
            n_cols, dr, row_ok, row_base)
    d2, idx, total = _gather_topk(*args, lvl)
    not_exact = total > window

    if exact:
        # certified second pass: a level-L block covers radius L*cw and the
        # first pass's kth distance bounds the true one, so re-gathering at
        # ceil(d_k / cw) certifies the result
        d_k = sqrt_f32(torch.clamp_min(d2[:, -1], 0.0))
        lvl2 = to_int32_saturating(torch.ceil(scaled(d_k, 0.0, spec.cell_width)))
        clamped = lvl2 > max_level
        lvl2 = torch.maximum(lvl2, lvl).clamp_max(max_level)
        d2b, idxb, totalb = _gather_topk(*args, lvl2)
        redo = lvl2 > lvl
        d2 = torch.where(redo[:, None], d2b, d2)
        idx = torch.where(redo[:, None], idxb, idx)
        total = torch.where(redo, totalb, total)
        not_exact = (total > window) | clamped

    return KnnResult(d2=d2, idx=idx, n_candidates=total, overflow=not_exact)


def auto_max_level(spec: GridSpec, m: int, k: int) -> int:
    """Expansion-level bound from expected point density (points/cell):
    (2L+1)^2 * ppc >= k at the count level, plus the safety ring and the
    certified pass's headroom, clamped to the grid radius."""
    ppc = max(m / spec.n_cells, 1e-3)
    lvl = int(math.ceil(0.5 * (math.sqrt(4.0 * k / ppc) - 1.0))) + 3
    return max(2, min(lvl, max(spec.n_rows, spec.n_cols)))


def grid_knn(spec: GridSpec, table: CellTable, queries_xy: torch.Tensor,
             k: int = 15, max_level: int | None = None, window: int = 256,
             block: int = 4096, exact: bool = True) -> KnnResult:
    """kNN for every query via local grid search (paper Stage 1).

    ``exact=False`` is the paper's heuristic (count level + one safety
    ring); ``exact=True`` adds the certified second pass.  ``window`` bounds
    the candidates per query; ``overflow`` flags queries whose window
    overflowed or whose certified level exceeded ``max_level``.  ``block``
    queries are searched per batch to bound peak memory.
    """
    n = queries_xy.shape[0]
    if max_level is None:
        # the CAPACITY-padded length, as the reference sizes it
        max_level = auto_max_level(spec, table.sx.shape[0], k)
    parts = [
        _query_knn(spec, k, max_level, window, exact, table.cell_start,
                   table.sx, table.sy, table.order,
                   queries_xy[i:i + block, 0], queries_xy[i:i + block, 1])
        for i in range(0, n, max(block, 1))]
    if not parts:
        dev = queries_xy.device
        return KnnResult(torch.empty((0, k), device=dev),
                         torch.empty((0, k), dtype=torch.int32, device=dev),
                         torch.empty(0, dtype=torch.int32, device=dev),
                         torch.empty(0, dtype=torch.bool, device=dev))
    return KnnResult(*(torch.cat(t) for t in zip(*parts)))


def brute_knn(points_xy: torch.Tensor, queries_xy: torch.Tensor, k: int = 15,
              block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force kNN (the 'original' algorithm's global search, §3.1):
    ``(d2, idx)`` with d2 ascending, blocked over queries so the (n, m)
    distance matrix never exists in full."""
    px, py = points_xy[:, 0], points_xy[:, 1]
    k = min(k, points_xy.shape[0])
    d2s, idxs = [], []
    for i in range(0, queries_xy.shape[0], block):
        qb = queries_xy[i:i + block]
        d2 = (qb[:, 0:1] - px[None, :]) ** 2 + (qb[:, 1:2] - py[None, :]) ** 2
        neg_top, idx = torch.topk(-d2, k, dim=1, sorted=True)
        d2s.append(-neg_top)
        idxs.append(idx.to(torch.int32))
    return torch.cat(d2s), torch.cat(idxs)


def mean_nn_distance(d2: torch.Tensor) -> torch.Tensor:
    """Eq. (3): r_obs = mean of the k NN distances (sqrt deferred until here).

    The mean is taken as compiled XLA takes it: a left-to-right sum times
    the f32 reciprocal of k, so equal distances give a bitwise-equal r_obs."""
    d = sqrt_f32(torch.clamp_min(d2, 0.0))
    k = d.shape[-1]
    acc = d[..., 0]
    for i in range(1, k):
        acc = acc + d[..., i]
    return acc * float(np.float32(1.0) / np.float32(k))
