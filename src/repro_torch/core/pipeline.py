"""End-to-end AIDW pipelines — the paper's Figure 1 in PyTorch.

Counterpart of the JAX package's ``core/pipeline.py`` for ONE device:

* :func:`aidw_improved` — grid kNN (Stage 1) + adaptive alpha + Eq. (1)
  (Stage 2).  ``stage2='naive'`` sums with blocked PyTorch ops,
  ``'tiled'`` through the tiled CUDA kernel (``fused=True`` computes alpha
  inside it), ``'local'`` truncates Eq. (1) to the k Stage-1 neighbours
  (``fused=True`` through the local CUDA kernel).
* :func:`aidw_original` — brute-force kNN through the kNN CUDA kernel +
  the same Stage 2 (the paper's baseline); :func:`idw_standard` —
  constant-alpha IDW.

Plan/execute: :func:`plan` does the host grid planning and the CSR binning
once per dataset and keeps the arrays on the device; :func:`execute` runs
the per-query stages over it.  Plan arrays are capacity-padded to
:data:`PLAN_PAD_MULTIPLE` rows with ``PAD_SENTINEL`` coordinates, which no
CSR range addresses and whose weight is exactly 0, so the padding changes
no result bit.  PyTorch runs eagerly, so there is nothing to trace: the
Stage-1/Stage-2 split of :func:`stage1`/:func:`stage2` is the same code the
session runs fused, and a profiled query gives bit-identical values.

Every entry point takes ``device=``; ``None`` means ``cuda`` and raises
without a card (:func:`repro_torch.device.resolve_device`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Literal

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..kernels.aidw import ops as aidw_ops
from ..kernels.knn import ops as knn_ops
from . import aidw as A
from . import grid as G
from . import knn as K


@dataclass(frozen=True)
class AidwConfig:
    k: int = 15
    alphas: tuple = A.DEFAULT_ALPHAS
    r_min: float = A.DEFAULT_R_MIN
    r_max: float = A.DEFAULT_R_MAX
    cell_factor: float = 1.0       # scales Eq.(2) cell width (1.0 = paper)
    max_level: int | None = None   # None = auto from density (knn.auto_max_level)
    window: int = 256
    exact: bool = True             # certified 2-pass kNN (False = paper heuristic)
    knn_block: int = 4096
    interp_block: int = 1024
    interp_data_block: int = 0     # chunk Stage-2 data axis (0 = whole dataset)
    stage2: Literal["naive", "tiled", "local", "global"] = "naive"
    fused: bool = False            # tiled/local: the fused kernel variant
    tile_q: int = 256              # queries per CTA
    tile_d: int = 512              # data points per shared-memory tile
    interpret: bool = True         # kept so configs round-trip; unused here

    def __post_init__(self):
        # 'global' is the documented alias for the all-points Eq. (1) path
        if self.stage2 == "global":
            object.__setattr__(self, "stage2", "naive")


@dataclass
class AidwResult:
    values: torch.Tensor           # (n,) predictions
    alpha: torch.Tensor            # (n,) adaptive power parameter
    r_obs: torch.Tensor            # (n,) observed mean NN distance
    overflow: int = 0              # queries whose candidate window overflowed
    timings: dict = field(default_factory=dict)   # stage -> seconds
    overflow_mask: torch.Tensor | None = None     # (n,) bool per-query flag
    zero_weight_mask: torch.Tensor | None = None  # (n,) bool: sum(w) underflow


@dataclass(frozen=True)
class AidwPlan:
    """Reusable Stage-1 build: everything that depends only on the dataset.

    ``table``/``points_xy``/``values`` live on the plan's device,
    capacity-padded by :func:`pad_plan`; ``n_points`` is the TRUE count."""

    spec: G.GridSpec
    table: G.CellTable
    points_xy: torch.Tensor        # (cap, 2); rows [n_points:] are sentinels
    values: torch.Tensor           # (cap,)
    n_points: int
    area: float
    cfg: AidwConfig

    @property
    def device(self) -> torch.device:
        return self.points_xy.device


# Plan arrays pad to this capacity multiple (the reference's value).
PLAN_PAD_MULTIPLE = 64


def pad_plan(pln: AidwPlan, multiple: int = PLAN_PAD_MULTIPLE) -> AidwPlan:
    """Capacity-pad a plan's point arrays to a ``multiple``-sized bucket with
    ``PAD_SENTINEL`` coordinates (weight exactly 0; CSR tail slots beyond
    ``cell_start[-1]`` are never addressed)."""
    m = pln.n_points
    cap = -(-max(m, 1) // multiple) * multiple
    pad = cap - pln.points_xy.shape[0]
    if pad == 0:
        return pln
    if pad < 0:
        raise ValueError(f"plan arrays ({pln.points_xy.shape[0]}) exceed "
                         f"capacity bucket {cap} for n_points={m}")
    big = A.PAD_SENTINEL
    fpad = torch.nn.functional.pad
    t = pln.table
    tpad = cap - t.sx.shape[0]
    table = G.CellTable(sx=fpad(t.sx, (0, tpad), value=big),
                        sy=fpad(t.sy, (0, tpad), value=big),
                        sz=fpad(t.sz, (0, tpad)),
                        cell_start=t.cell_start,
                        order=fpad(t.order, (0, tpad)))
    return AidwPlan(spec=pln.spec, table=table,
                    points_xy=fpad(pln.points_xy, (0, 0, 0, pad), value=big),
                    values=fpad(pln.values, (0, pad)), n_points=m,
                    area=pln.area, cfg=pln.cfg)


def plan_host_points(pln: AidwPlan) -> np.ndarray:
    """The TRUE (n_points, 3) dataset from a (possibly padded) plan."""
    m = pln.n_points
    return np.concatenate([pln.points_xy[:m].cpu().numpy(),
                           pln.values[:m, None].cpu().numpy()], axis=1)


def _study_area(spec: G.GridSpec) -> float:
    return (spec.n_cols * spec.cell_width) * (spec.n_rows * spec.cell_width)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _on(a, dev: torch.device) -> torch.Tensor:
    """``a`` (tensor or array-like) as an f32 tensor on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)


def plan(points_xyz, cfg: AidwConfig = AidwConfig(), *, query_domain=None,
         device=None, timings: dict | None = None) -> AidwPlan:
    """One-time Stage-1 build: grid planning (host, f64) + CSR binning (on
    the device).  ``query_domain`` extends the grid's bounding box to cover
    queries outside the data's hull.  ``timings`` (optional dict) receives
    ``bin_s``, the fenced wall of the CSR build."""
    dev = resolve_device(device)
    pts = _on(points_xyz, dev)
    qd = None if query_domain is None else _host(query_domain)
    spec = G.plan_grid(_host(pts[:, :2]), qd, cell_factor=cfg.cell_factor)
    tb = time.perf_counter()
    table = G.bin_points(spec, pts[:, 0], pts[:, 1], pts[:, 2])
    if timings is not None:
        synchronize(dev)
        timings["bin_s"] = time.perf_counter() - tb
    return pad_plan(AidwPlan(spec=spec, table=table,
                             points_xy=pts[:, :2].contiguous(),
                             values=pts[:, 2].contiguous(),
                             n_points=pts.shape[0], area=_study_area(spec),
                             cfg=cfg))


def plan_from_reference(spec_fields, table_arrays, points_xy, values,
                        n_points: int, area: float, cfg: AidwConfig,
                        device=None) -> AidwPlan:
    """Carry a plan across from the JAX package: its ``GridSpec`` fields,
    the five ``CellTable`` arrays (sx, sy, sz, cell_start, order), the
    (capacity-padded) point arrays and values, all as numpy."""
    dev = resolve_device(device)
    sx, sy, sz, cell_start, order = table_arrays
    table = G.CellTable(_on(sx, dev), _on(sy, dev), _on(sz, dev),
                        torch.tensor(np.asarray(cell_start, np.int32),
                                     device=dev),
                        torch.tensor(np.asarray(order, np.int32), device=dev))
    return AidwPlan(spec=G.GridSpec(*spec_fields), table=table,
                    points_xy=_on(points_xy, dev), values=_on(values, dev),
                    n_points=int(n_points), area=float(area), cfg=cfg)


def _stage1(spec: G.GridSpec, cfg: AidwConfig, table: G.CellTable,
            queries_xy):
    block = min(cfg.knn_block, max(queries_xy.shape[0], 1))
    res = K.grid_knn(spec, table, queries_xy, cfg.k, cfg.max_level,
                     cfg.window, block, cfg.exact)
    return res, K.mean_nn_distance(res.d2)


def _stage2(queries_xy, points_xy, values, alpha, cfg: AidwConfig):
    """Global Eq. (1): returns ``(values, zero_weight_mask)``."""
    if cfg.stage2 == "tiled":
        return aidw_ops.tiled_interpolate(queries_xy, points_xy, values, alpha,
                                          tile_q=cfg.tile_q, tile_d=cfg.tile_d)
    swz, sw = A.weighted_partial_sums(queries_xy, points_xy, values, alpha,
                                      cfg.interp_block, cfg.interp_data_block)
    return A.guarded_values(swz, sw)


def _stage2_fused(queries_xy, points_xy, values, r_obs, n_points, area,
                  cfg: AidwConfig):
    """Alpha-in-kernel Stage 2: Eqs. (2)/(4)/(5)/(6) + Eq. (1) in ONE launch."""
    return aidw_ops.fused_stage2(
        queries_xy, points_xy, values, r_obs, n_points=n_points, area=area,
        alphas=tuple(cfg.alphas), r_min=cfg.r_min, r_max=cfg.r_max,
        tile_q=cfg.tile_q, tile_d=cfg.tile_d)


def _stage2_local(knn_res: K.KnnResult, values, alpha, cfg: AidwConfig):
    """Local (exact-k) Eq. (1) over the Stage-1 neighbours at the session's
    alpha: through the local kernel when ``fused``, else the plain top-k
    path; the two agree bitwise.  (The alpha-in-kernel variant,
    ``ops.fused_local_stage2``, stays kernel-layer only, as in the
    reference.)"""
    if cfg.fused:
        return aidw_ops.local_interpolate(knn_res.d2, knn_res.idx, values,
                                          alpha, tile_q=cfg.tile_q)
    z = values[knn_res.idx.long()]
    swz, sw = A.topk_weighted_partial_sums(knn_res.d2, z, alpha)
    return A.guarded_values(swz, sw)


def stage1(pln: AidwPlan, queries_xy):
    """Stage 1 over a plan: ``(KnnResult, r_obs)``."""
    return _stage1(pln.spec, pln.cfg, pln.table, queries_xy)


def stage2(pln: AidwPlan, queries_xy, knn_res: K.KnnResult, r_obs):
    """Stage 2 over a plan: ``(values, alpha, zero_weight_mask)``."""
    cfg = pln.cfg
    n_points = A.on_device(pln.n_points, torch.float32, pln.device)
    alpha = A.adaptive_alpha(r_obs, n_points, pln.area, alphas=cfg.alphas,
                             r_min=cfg.r_min, r_max=cfg.r_max)
    if cfg.stage2 == "local":
        out, zero = _stage2_local(knn_res, pln.values, alpha, cfg)
    elif cfg.fused and cfg.stage2 == "tiled":
        out, zero = _stage2_fused(queries_xy, pln.points_xy, pln.values,
                                  r_obs, n_points, pln.area, cfg)
    else:
        out, zero = _stage2(queries_xy, pln.points_xy, pln.values, alpha, cfg)
    return out, alpha, zero


def _execute_core(pln: AidwPlan, queries_xy):
    """Stage 1 + Stage 2 over a prebuilt plan.  Returns ``(values, alpha,
    r_obs, overflow_mask, zero_weight_mask)``."""
    res, r_obs = stage1(pln, queries_xy)
    out, alpha, zero = stage2(pln, queries_xy, res, r_obs)
    return out, alpha, r_obs, res.overflow, zero


def execute(pln: AidwPlan, queries_xy, *, timings: bool = False) -> AidwResult:
    """Per-query pass over a prebuilt :class:`AidwPlan`.  ``timings=True``
    fences each stage and reports ``{"knn": s, "interp": s}``."""
    q = _on(queries_xy, pln.device)
    t0 = time.perf_counter()
    res, r_obs = stage1(pln, q)
    if timings:
        synchronize(pln.device)
    t1 = time.perf_counter()
    values, alpha, zero = stage2(pln, q, res, r_obs)
    if timings:
        synchronize(pln.device)
    t2 = time.perf_counter()
    return AidwResult(
        values=values, alpha=alpha, r_obs=r_obs,
        overflow=int(res.overflow.sum()),
        timings={"knn": t1 - t0, "interp": t2 - t1} if timings else {},
        overflow_mask=res.overflow, zero_weight_mask=zero)


def aidw_improved(points_xyz, queries_xy, cfg: AidwConfig = AidwConfig(), *,
                  device=None, timings: bool = False) -> AidwResult:
    """The paper's improved algorithm: grid kNN -> adaptive alpha -> Eq. (1).
    Plans on EVERY call; for repeated queries use a session."""
    t0 = time.perf_counter()
    pln = plan(points_xyz, cfg, query_domain=_host(queries_xy), device=device)
    res = execute(pln, queries_xy, timings=timings)
    if timings:
        # the reference's split: 'knn' covers plan+bin+Stage-1
        res.timings["plan"] = time.perf_counter() - t0 \
            - res.timings["knn"] - res.timings["interp"]
        res.timings["knn"] += res.timings["plan"]
    return res


def aidw_original(points_xyz, queries_xy, cfg: AidwConfig = AidwConfig(), *,
                  device=None, timings: bool = False) -> AidwResult:
    """The Mei et al. (2015) baseline: brute-force global kNN (the kNN
    kernel, :func:`repro_torch.kernels.knn.ops.knn_d2`) + the same Stage 2.
    ``timings["knn"]`` is the kNN stage's wall (the paper's Table 3)."""
    dev = resolve_device(device)
    pts, q = _on(points_xyz, dev), _on(queries_xy, dev)
    t0 = time.perf_counter()
    # k clamps to m as the reference's brute_knn does: knn_d2 pads with inf
    d2 = knn_ops.knn_d2(pts[:, :2], q, k=min(cfg.k, pts.shape[0]),
                        tile_q=cfg.tile_q, tile_d=cfg.tile_d)
    r_obs = K.mean_nn_distance(d2)
    if timings:
        synchronize(dev)
    t1 = time.perf_counter()
    spec = G.plan_grid(_host(pts[:, :2]), _host(q), cell_factor=cfg.cell_factor)
    alpha = A.adaptive_alpha(r_obs, pts.shape[0], _study_area(spec),
                             alphas=cfg.alphas, r_min=cfg.r_min,
                             r_max=cfg.r_max)
    values, zero = _stage2(q, pts[:, :2], pts[:, 2], alpha, cfg)
    if timings:
        synchronize(dev)
    t2 = time.perf_counter()
    return AidwResult(
        values=values, alpha=alpha, r_obs=r_obs,
        timings={"knn": t1 - t0, "interp": t2 - t1} if timings else {},
        zero_weight_mask=zero)


def idw_standard(points_xyz, queries_xy, alpha: float = 2.0,
                 cfg: AidwConfig = AidwConfig(), *, device=None):
    """Shepard (1968): constant user-specified power parameter."""
    dev = resolve_device(device)
    pts, q = _on(points_xyz, dev), _on(queries_xy, dev)
    return _stage2(q, pts[:, :2], pts[:, 2],
                   torch.full((q.shape[0],), float(alpha), device=dev),
                   cfg)[0]
