"""InterpolationSession — amortized AIDW queries over a static dataset, on one
device.

Counterpart of the JAX package's ``core/session.py``, single-device layout:

* ``plan once`` — grid planning + CSR binning run at construction and on a
  full :meth:`update`, never per query; the plan stays on the device.
* ``buckets`` — a batch is padded to a power-of-two bucket with its LAST
  query (edge mode).  Per-query results are independent, so the slice
  ``[:n]`` equals an unpadded call bitwise.  ``bucket_hits``/
  ``bucket_misses`` count the bucket sizes seen, the shape set a later
  CUDA-graph ladder will capture.
* ``profile=True`` fences Stage 1 and Stage 2 apart and records their walls
  as ``session/stage1_s``/``session/stage2_s`` in :attr:`registry`;
  ``timings=True`` records the fenced ``session/query_s``.  Without either
  nothing is fenced and nothing recorded.

Not ported yet, and raising ``NotImplementedError``: ``mesh=`` layouts
(ROADMAP A10), :meth:`precompile` (A6: a CUDA-graph bucket ladder) and
delta updates ``update(inserts=, deletes=)`` (A7).
"""

from __future__ import annotations

import time

import torch

from ..device import resolve_device, synchronize
from ..obs import Registry
from . import pipeline as P

__all__ = ["InterpolationSession", "bucket_size"]


def bucket_size(n: int, min_bucket: int = 64) -> int:
    """Smallest power of two >= n, floored at ``min_bucket`` (itself rounded
    up to a power of two first, so every bucket is a true power of two)."""
    if n <= 0:
        raise ValueError(f"query batch must be non-empty, got n={n}")
    b = 1
    while b < min_bucket:
        b *= 2
    while b < n:
        b *= 2
    return b


class InterpolationSession:
    """Reusable AIDW query session over one (mostly static) dataset.

    >>> sess = InterpolationSession(points_xyz, device="cuda")
    >>> out = sess.query(queries_xy)          # Stage 1 + Stage 2 on the card
    >>> sess.update(new_points_xyz)           # re-plan + re-bin once
    """

    def __init__(self, points_xyz, cfg: P.AidwConfig = P.AidwConfig(), *,
                 query_domain=None, min_bucket: int = 64, device=None,
                 mesh=None, registry: Registry | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= layouts (replicated, ring, grid_ring) are not ported "
                "yet: ROADMAP A10")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.registry = registry if registry is not None else Registry()
        self.min_bucket = int(min_bucket)
        self._query_domain = query_domain
        self.stats = {"stage1_builds": 0, "delta_updates": 0, "batches": 0,
                      "queries": 0, "bucket_hits": 0, "bucket_misses": 0,
                      "last_plan_s": 0.0, "devices": 1, "n_points": 0}
        self._seen_buckets: set[int] = set()
        self._plan: P.AidwPlan | None = None
        self.update(points_xyz)

    @property
    def plan(self) -> P.AidwPlan:
        return self._plan

    def update(self, points_xyz=None, *, inserts=None, deletes=None,
               deltas=None) -> None:
        """Full dataset refresh: re-plan + re-bin once."""
        if inserts is not None or deletes is not None or deltas is not None:
            raise NotImplementedError(
                "incremental update(inserts=, deletes=) is not ported yet: "
                "ROADMAP A7; pass the full dataset")
        if points_xyz is None:
            raise ValueError("update() needs the full dataset")
        t0 = time.perf_counter()
        bin_t: dict = {}
        self._plan = P.plan(points_xyz, self.cfg,
                            query_domain=self._query_domain,
                            device=self.device, timings=bin_t)
        dur = time.perf_counter() - t0
        self.stats["stage1_builds"] += 1
        self.stats["n_points"] = int(self._plan.n_points)
        self.stats["last_plan_s"] = dur
        self.registry.observe("session/plan_s", dur)
        self.registry.observe("session/bin_s", bin_t["bin_s"])

    def precompile(self, *args, **kwargs):
        raise NotImplementedError(
            "precompile (a CUDA-graph bucket ladder) is not ported yet: "
            "ROADMAP A6")

    def _bucket(self, n: int) -> int:
        b = bucket_size(n, self.min_bucket)
        if b in self._seen_buckets:
            self.stats["bucket_hits"] += 1
        else:
            self._seen_buckets.add(b)
            self.stats["bucket_misses"] += 1
        return b

    def query(self, queries_xy, *, timings: bool = False,
              profile: bool = False) -> P.AidwResult:
        """Interpolate one query batch; results are bit-identical to a cold
        :func:`repro_torch.core.pipeline.execute` on the same plan.

        ``timings=True`` fences the result and reports
        ``res.timings={"query": wall_s, "bucket": b}``; ``profile=True``
        additionally fences between the stages and adds ``stage1``/
        ``stage2`` walls (values unchanged: the stages are the same code)."""
        q = P._on(queries_xy, self.device)
        n = q.shape[0]
        b = self._bucket(n)
        t0 = time.perf_counter()
        qp = torch.cat([q, q[-1:].expand(b - n, 2)]) if b != n else q
        if profile:
            knn, r_obs = P.stage1(self._plan, qp)
            synchronize(self.device)
            t1 = time.perf_counter()
            values, alpha, zero = P.stage2(self._plan, qp, knn, r_obs)
            overflow = knn.overflow
        else:
            values, alpha, r_obs, overflow, zero = P._execute_core(
                self._plan, qp)
        out = P.AidwResult(
            values=values[:n], alpha=alpha[:n], r_obs=r_obs[:n],
            overflow=int(overflow[:n].sum()), overflow_mask=overflow[:n],
            zero_weight_mask=zero[:n])
        if timings or profile:
            synchronize(self.device)
            t2 = time.perf_counter()
            self.registry.observe("session/query_s", t2 - t0)
            out.timings = {"query": t2 - t0, "bucket": b}
            if profile:
                self.registry.observe("session/stage1_s", t1 - t0)
                self.registry.observe("session/stage2_s", t2 - t1)
                out.timings.update(stage1=t1 - t0, stage2=t2 - t1)
        self.stats["batches"] += 1
        self.stats["queries"] += n
        return out
