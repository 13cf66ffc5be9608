"""Even-grid construction — the Stage-1 substrate of the improved algorithm.

PyTorch counterpart of the JAX package's ``core/grid.py`` (planning and
binning; incremental rebinning is not ported yet).  Paper mapping (Mei, Xu &
Xu 2016, §3.2.1-§3.2.3): :func:`plan_grid` creates the even grid on the host
(it fixes array shapes), :func:`cell_ids` distributes points into cells, and
:func:`sort_core` replaces thrust's sort_by_key + reduce/unique_by_key with
one stable sort and a binary search that yields the CSR ``cell_start``.

Bitwise contract with the reference: the reference runs :func:`cell_ids`
under ``jax.jit``, where XLA rewrites ``(x - min_x) / cell_width`` into a
multiplication by the f32 reciprocal of ``cell_width``.  :func:`cell_index`
does that multiplication explicitly, then truncates toward zero with the
saturation of XLA's f32 -> int32 conversion, then clips, so the port's
``CellTable`` is element-identical to the reference's on any device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_INT32_MAX_F32 = 2147483520.0   # largest f32 below 2**31


class GridSpec(NamedTuple):
    """Static description of the even grid.  The flattened id of cell
    (row, col) is ``row * n_cols + col``."""

    min_x: float
    min_y: float
    cell_width: float
    n_rows: int
    n_cols: int

    @property
    def n_cells(self) -> int:
        return self.n_rows * self.n_cols


class CellTable(NamedTuple):
    """CSR layout over grid cells (the paper's Figure 3): ``sx/sy/sz`` are the
    points sorted by cell id; cell ``c`` holds
    ``sx[cell_start[c]:cell_start[c + 1]]``."""

    sx: torch.Tensor          # (m,) sorted x coordinates
    sy: torch.Tensor          # (m,) sorted y coordinates
    sz: torch.Tensor          # (m,) sorted values
    cell_start: torch.Tensor  # (n_cells + 1,) int32 CSR offsets
    order: torch.Tensor       # (m,) int32: original index of each sorted point


def expected_nn_distance(n_points: float, area: float) -> float:
    """Eq. (2): expected nearest-neighbour distance of a random pattern."""
    return 1.0 / (2.0 * math.sqrt(n_points / area))


def plan_grid(points_xy: np.ndarray, queries_xy: np.ndarray | None = None,
              *, cell_width: float | None = None, cell_factor: float = 1.0,
              pad: float = 1e-6) -> GridSpec:
    """Host-side grid planning: bounding box + static row/col counts, in f64
    exactly as the reference computes them.  ``cell_factor`` scales the
    Eq. (2) cell width (1.0 = paper)."""
    pts = np.asarray(points_xy, dtype=np.float64)
    if queries_xy is not None:
        pts = np.concatenate([pts, np.asarray(queries_xy, dtype=np.float64)],
                             axis=0)
    min_x = float(pts[:, 0].min()) - pad
    max_x = float(pts[:, 0].max()) + pad
    min_y = float(pts[:, 1].min()) - pad
    max_y = float(pts[:, 1].max()) + pad
    area = max(max_x - min_x, 1e-30) * max(max_y - min_y, 1e-30)
    m = points_xy.shape[0]
    if cell_width is None:
        cell_width = cell_factor * expected_nn_distance(m, area)
    # int nCol = (maxX - minX + cellWidth) / cellWidth;   (paper §4.1.1)
    n_cols = int((max_x - min_x + cell_width) / cell_width)
    n_rows = int((max_y - min_y + cell_width) / cell_width)
    return GridSpec(min_x, min_y, float(cell_width), max(n_rows, 1),
                    max(n_cols, 1))


def scaled(v: torch.Tensor, origin: float, cell_width: float) -> torch.Tensor:
    """``(v - origin) / cell_width`` in f32 as compiled XLA computes it: a
    multiplication by the f32 reciprocal of ``cell_width``.  Both scalars
    are f32 values passed as Python floats: f32 arithmetic on any device,
    and no launch or copy to the card."""
    inv = np.float32(1.0) / np.float32(cell_width)
    return (v - float(np.float32(origin))) * float(inv)


def to_int32_saturating(f: torch.Tensor) -> torch.Tensor:
    """f32 -> int32, truncating toward zero and saturating out-of-range
    values as XLA's conversion does (a far query or an infinite distance
    lands on the clipped border, never on an undefined integer)."""
    return f.clamp(-2.0 ** 31, _INT32_MAX_F32).to(torch.int32)


def cell_index(v: torch.Tensor, origin: float, cell_width: float,
               n: int) -> torch.Tensor:
    """Column (or row) index of each coordinate, clipped to ``[0, n)``."""
    return to_int32_saturating(scaled(v, origin, cell_width)).clamp(0, n - 1)


def cell_ids(spec: GridSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Flattened cell id per point (paper §4.1.2's col_idx/row_idx kernels)."""
    col = cell_index(x, spec.min_x, spec.cell_width, spec.n_cols)
    row = cell_index(y, spec.min_y, spec.cell_width, spec.n_rows)
    return row * spec.n_cols + col


def sort_core(n_cells: int, ids: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor, z: torch.Tensor) -> CellTable:
    """Stable sort by cell id + CSR offsets (points of one cell keep their
    original relative order, as with the reference's stable argsort)."""
    sorted_ids, order = torch.sort(ids, stable=True)
    cell_start = torch.searchsorted(
        sorted_ids,
        torch.arange(n_cells + 1, dtype=sorted_ids.dtype, device=ids.device),
        right=False, out_int32=True)
    return CellTable(x[order], y[order], z[order], cell_start,
                     order.to(torch.int32))


def bin_points(spec: GridSpec, x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor) -> CellTable:
    """Sort points by cell id and build the CSR cell table."""
    return sort_core(spec.n_cells, cell_ids(spec, x, y), x, y, z)
