"""InterpolationSession — amortized AIDW queries over a static dataset, on one
device.

Counterpart of the JAX package's ``core/session.py``, single-device layout:

* ``plan once`` — grid planning + CSR binning run at construction and on a
  full :meth:`update`, never per query; the plan stays on the device.
* ``buckets`` — a batch is padded to a power-of-two bucket with its LAST
  query (edge mode).  Per-query results are independent, so the slice
  ``[:n]`` equals an unpadded call bitwise.  ``bucket_hits``/
  ``bucket_misses`` count the bucket sizes seen.
* ``CUDA-graph ladder`` — :meth:`precompile` captures one CUDA graph of
  Stage 1 + Stage 2 per bucket (the counterpart of the reference's AOT
  ladder).  A query of a captured bucket copies its padded batch into the
  graph's static input, replays the graph and returns cloned slices of its
  static outputs: one host call instead of the ~170 launches a 4,096-query
  Stage-1 block costs eagerly.  A full :meth:`update` drops every graph.
* ``profile=True`` fences Stage 1 and Stage 2 apart (always eagerly) and
  records their walls as ``session/stage1_s``/``session/stage2_s`` in
  :attr:`registry`; ``timings=True`` records the fenced
  ``session/query_s``.  Without either nothing is fenced and nothing
  recorded.

Not ported yet, and raising ``NotImplementedError``: ``mesh=`` layouts
(ROADMAP A10) and delta updates ``update(inserts=, deletes=)`` (A7).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .. import kernels
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


@dataclass
class _Graph:
    """One captured bucket: the graph, its static input and outputs, the
    kernel launches recorded during capture, and how often it replayed."""

    graph: torch.cuda.CUDAGraph
    static_q: torch.Tensor
    outs: tuple                # (values, alpha, r_obs, overflow, zero)
    launches: dict             # kernel name -> launches in one replay
    replays: int = 0


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
                      "last_plan_s": 0.0, "devices": 1, "n_points": 0,
                      "aot_buckets": 0}
        self._seen_buckets: set[int] = set()
        self._graphs: dict[int, _Graph] = {}
        self._pool = None
        self._plan: P.AidwPlan | None = None
        self.update(points_xyz)

    @property
    def plan(self) -> P.AidwPlan:
        return self._plan

    def update(self, points_xyz=None, *, inserts=None, deletes=None,
               deltas=None) -> None:
        """Full dataset refresh: re-plan + re-bin once.  Drops every
        captured graph: they hold the old plan's pointers."""
        if inserts is not None or deletes is not None or deltas is not None:
            raise NotImplementedError(
                "incremental update(inserts=, deletes=) is not ported yet: "
                "ROADMAP A7; pass the full dataset")
        if points_xyz is None:
            raise ValueError("update() needs the full dataset")
        self._drop_graphs()
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

    # -- CUDA-graph bucket ladder ------------------------------------------

    def bucket_ladder(self, max_queries: int) -> list[int]:
        """Every bucket the session can dispatch for batches up to
        ``max_queries``: doubling powers of two from the minimum bucket up
        to ``bucket_size(max_queries)``."""
        top = bucket_size(int(max_queries), self.min_bucket)
        b = bucket_size(1, self.min_bucket)
        out = [b]
        while b < top:
            b *= 2
            out.append(b)
        return out

    def _drop_graphs(self) -> None:
        self._graphs.clear()
        self._pool = None
        self.stats["aot_buckets"] = 0
        self.registry.set("compiled_buckets", 0, merge="max")

    def _capture(self, b: int) -> _Graph:
        """Capture Stage 1 + Stage 2 of one bucket: a static (b, 2) input,
        one warm-up run on a side stream, one graph into the session's
        shared memory pool.  A failed capture raises."""
        dev, pln = self.device, self._plan
        static_q = pln.points_xy[:1].expand(b, 2).clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            P._execute_core(pln, static_q)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            outs = P._execute_core(pln, static_q)
        launches = {name: c - before[name]
                    for name, c in kernels.launch_counts().items()
                    if c > before[name]}
        return _Graph(graph, static_q, outs, launches)

    def precompile(self, max_queries: int | None = None, buckets=None,
                   warm: bool = False,
                   compiler_options: dict | None = None) -> list[int]:
        """Capture the bucket ladder as CUDA graphs.

        Pass ``max_queries=`` to cover the doubling ladder up to that batch
        size (:meth:`bucket_ladder`) or an explicit ``buckets=`` iterable
        (each entry is rounded to its bucket).  On a CUDA session each
        bucket not yet captured gets one graph, the largest first, all in
        one shared memory pool; each capture's wall lands in the
        ``session/compile_s`` histogram.  Later non-profiled queries of
        those buckets replay their graph.  Precompiled buckets count as
        seen, not as misses; ``stats["aot_buckets"]`` and the
        ``compiled_buckets`` gauge count the live graphs.

        On a CPU session there is nothing to capture: the bookkeeping is
        done and ``aot_buckets`` stays 0.  ``warm=True`` runs each bucket
        once on the dataset's first point (eagerly on the CPU, a replay on
        the card).  ``compiler_options`` has no counterpart here and must be
        None.  Returns the sorted bucket list covered by this call."""
        if compiler_options is not None:
            raise ValueError("compiler_options has no counterpart for CUDA "
                             "graphs; pass None")
        if buckets is None:
            if max_queries is None:
                raise ValueError(
                    "precompile() needs max_queries= or buckets=")
            buckets = self.bucket_ladder(max_queries)
        buckets = sorted({bucket_size(int(b), self.min_bucket)
                          for b in buckets})
        if self.device.type == "cuda":
            for b in reversed(buckets):
                if b in self._graphs:
                    continue
                t0 = time.perf_counter()
                self._graphs[b] = self._capture(b)
                self.registry.observe("session/compile_s",
                                      time.perf_counter() - t0)
        # precompiled buckets are warm by construction, not misses
        self._seen_buckets.update(buckets)
        self.stats["aot_buckets"] = len(self._graphs)
        self.registry.set("compiled_buckets", len(self._graphs), merge="max")
        if warm:
            for b in buckets:
                self.query(self._plan.points_xy[:1].expand(b, 2))
        return buckets

    def graph_launches(self) -> dict[str, int]:
        """Kernel launches made by graph replays, by kernel name: the
        launches recorded during each capture times its replays.  (A replay
        moves no wrapper's ``launches`` count.)"""
        out: dict[str, int] = {}
        for g in self._graphs.values():
            for name, c in g.launches.items():
                out[name] = out.get(name, 0) + c * g.replays
        return out

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

        A bucket captured by :meth:`precompile` replays its graph (the same
        kernels on the same inputs, so the same bits).  ``timings=True``
        fences the result and reports ``res.timings={"query": wall_s,
        "bucket": b}``; ``profile=True`` runs eagerly, additionally fences
        between the stages and adds ``stage1``/``stage2`` walls (values
        unchanged: the stages are the same code)."""
        q = P._on(queries_xy, self.device)
        n = q.shape[0]
        b = self._bucket(n)
        t0 = time.perf_counter()
        graph = None if profile else self._graphs.get(b)
        if graph is not None:
            graph.static_q[:n].copy_(q)
            graph.static_q[n:].copy_(q[-1:].expand(b - n, 2))
            graph.graph.replay()
            graph.replays += 1
            # clones: the next replay overwrites the static outputs
            values, alpha, r_obs, overflow, zero = (
                t[:n].clone() for t in graph.outs)
        else:
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
