#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch twins.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with
``nvcc`` (``repro_torch.kernels.build``, one compiler per source, started
together), then runs seven phases at the paper's protocol (uniform points
in the unit square, n queries):

1. global  — ``InterpolationSession`` with ``stage2="tiled"``, fused and
   unfused, m = 262,144 points, batches of 262,144, 70,001 and 1,000
   queries; the tiled kernel against its twin at the largest batch and at
   1,024 queries, where the data axis is split (values within 2e-5
   abs/rel: another summation order; masks equal), and against an f64
   evaluation of Eq. (1) on a 2,048-query prefix; both shapes timed, with
   ``splits``, the occupancy the split planner read (and the CPU path's
   model of it) and ``tools/sass_loop.py``'s count of the hot loop;
2. local   — ``stage2="local", fused=True`` at m = n = 1,048,576; the local
   kernel against its twin on all queries (at most 1 ulp apart; the line
   says whether they are bitwise equal);
3. kernel layer — ``fused_local_stage2`` and ``fused_stage2`` called
   directly on phase 2's Stage-1 output;
4. sentinels — a far query [1e18, 1e18] through every kernel variant gives
   0.0 and a raised mask bit, never NaN; 1e30-padded data weigh nothing;
5. Stage 1 — ``grid_knn`` on the card equals the port's CPU ``grid_knn``
   on 4,096 queries (overflow and n_candidates exactly, d2 within 1e-6);
6. original — ``aidw_original`` (brute-force kNN kernel + tiled Stage 2)
   on phase 1's data; the kNN kernel bitwise against its twin, alone at
   262,144² and 1,048,576², with the append ring and at the edges (k > m,
   duplicates); r_obs within 1e-6 and values within 2e-5 of the improved
   session on its certified queries; the paper's Table 3 on this card
   (the original kNN stage beside the improved Stage 1);
7. precompile — the CUDA-graph bucket ladder of a tiled session (m =
   262,144) and of phase 2's local session (1 M): replays bitwise equal
   to eager queries, earlier results unchanged by a later replay, a full
   ``update()`` drops the graphs; replayed and eager walls in turns.

Each kernel wrapper counts its launches; the counts are zeroed just before
a phase drives the main path and read just after it, before any
comparison launch.  A graph replay moves no count: phase 7 prints the
launches recorded at capture times the replays.  Times come from CUDA
events after a warm-up.

Output: one JSON line per phase, one ``{"kernels": [...]}`` line, the
card's name and power limit as ``nvidia-smi`` prints them, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is not 0 and the last line is not printed.  Without CUDA the script
exits with 1 before printing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GLOBAL_M = 262_144
GLOBAL_BATCHES = (262_144, 70_001, 1_000)
LOCAL_N = 1_048_576
COMPARE_Q = 2_048          # the global twin and f64 are checked on this prefix
SMALL_Q = 1_024            # the split tiled launch (the smallest bucket)
F64_BLOCK = 256            # f64 evaluation, queries a block
STAGE1_Q = 4_096
FUSED_STAGE2_Q = 4_096     # phase 3's direct fused_stage2 call
VAL_TOL = 2e-5             # tiled kernel vs twin: another summation order
MAX_ULPS = 1               # local kernel vs twin (powf vs torch.pow)
KNN_K = 15                 # the paper's k
KNN_HEAD_1M = 1_024        # the 1 M-point kNN run is checked on this prefix
RING_SLOTS, RING_LIVE = 256, 64
R_TOL = 1e-6               # grid kNN vs brute force (tests/test_knn.py:28)
ORIG_REPS = 3              # aidw_original runs (kNN-stage walls)
TURNS = 5                  # replayed and eager queries, taken in turns
GRAPH_BUCKETS = (1_024, 131_072, 262_144)
FIELDS = ("values", "alpha", "r_obs", "overflow_mask", "zero_weight_mask")

# Peak rates of one H100 SXM (NVIDIA data sheet, at a 700 W limit): 3.35
# TB/s of HBM; at the 1.98 GHz boost clock, 132 SMs each issue 128 FP32
# instructions a clock (the 67 TFLOP/s of the data sheet counts an FMA as
# two operations) and 16 MUFU results (ex2, lg2) a clock.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
MUFU_PER_S = 132 * 16 * 1.98e9
# tiled kernel, per (query, point) pair, at the fewest instructions: FADD
# dx, FADD dy, FMUL + FFMA d2, FMNMX clamp, FMUL by -alpha/2, FADD sum_w,
# FFMA sum_wz; and one lg2, one ex2 (MUFU).  tools/sass_loop.py counts the
# built loop (its line in phase 1).
TILED_FP32_PER_PAIR = 8
TILED_MUFU_PER_PAIR = 2
TILED_SASS_ARGS = ("--library", "aidw_kernels",
                   "--kernel", "aidw_tiled_kernelILi2ELb1E",
                   "--unit", "MUFU", "--cold", "")
# kNN kernel, per (query, point) pair on the path without an insertion, at
# the fewest instructions: 2 FADD dx/dy, 2 FMUL, FADD d2, FSETP, BRA and half
# an LDS.128 (one load serves two points), each issued at the same 128 a
# clock on each SM (4 schedulers x 32 lanes) as the FP32 ones; insertions
# (~k ln(m/k) a query) add < 1%.  tools/sass_loop.py counts the built loop:
# 11.5 a pair, the 7.5 plus convergence barriers (BSSY/BSYNC) around the
# divergent insertion and loop overhead.
KNN_INSTR_PER_PAIR = 7.5
BATCH_REPS = 5             # timed session queries per batch
PROFILE_REPS = 3           # profiled session queries per batch

DEVICE = "cuda"
SOURCE = "src/repro_torch/kernels/aidw/csrc/aidw_kernels.cu"
KNN_SOURCE = "src/repro_torch/kernels/knn/csrc/knn_kernels.cu"


def kw_alpha(cfg) -> dict:
    return dict(alphas=cfg.alphas, r_min=cfg.r_min, r_max=cfg.r_max)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int = 3, warmup: int = 1):
    """``(last result, mean milliseconds per call)`` of ``fn`` from CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def max_ulps(torch, a, b) -> int:
    """Largest distance between two f32 tensors in units in the last place
    (0 where bitwise equal; -0.0 and +0.0 count as equal)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def rmse(values, queries: np.ndarray, surface) -> float:
    truth = surface(queries[:, 0].astype(np.float64),
                    queries[:, 1].astype(np.float64))
    v = values.double().cpu().numpy()
    return float(np.sqrt(np.mean((v - truth) ** 2)))


def rep_ms(torch, fn, reps: int) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``fn``, each timed alone by
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def turns_ms(torch, fns: dict, reps: int) -> dict:
    """Milliseconds of each of ``reps`` calls of every function in ``fns``,
    taken in turns (a, b, a, b, ...), each timed alone by CUDA events,
    after one warm-up call each.  Returns name -> median, min, max."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end))
    return {name: {"ms": statistics.median(v), "ms_min": min(v),
                   "ms_max": max(v), "reps": reps} for name, v in ms.items()}


def tiled_bound(n: int, m: int) -> tuple[float, dict]:
    """``(bound ms, its terms)`` of the tiled kernel over n x m pairs."""
    terms = {"bytes": 1e3 * 4 * (3 * n + 3 * m + 2 * n + 2) / HBM_BYTES_PER_S,
             "fp32_issue": 1e3 * TILED_FP32_PER_PAIR * n * m
             / FP32_INSTR_PER_S,
             "mufu": 1e3 * TILED_MUFU_PER_PAIR * n * m / MUFU_PER_S}
    return max(terms.values()), terms


def f64_err(torch, A, out, qx, qy, alpha, px, py, pz) -> float:
    """Largest distance of ``out`` from Eq. (1) in f64 (the exp/log weights
    of the reference kernel) on the queries given, in blocks."""
    err = 0.0
    x64, y64, z64 = px.double(), py.double(), pz.double()
    for i in range(0, qx.shape[0], F64_BLOCK):
        b = slice(i, i + F64_BLOCK)
        d2 = ((qx[b, None].double() - x64) ** 2
              + (qy[b, None].double() - y64) ** 2)
        w = torch.exp(-0.5 * alpha[b, None].double()
                      * torch.log(torch.clamp_min(d2, A.EPS_D2)))
        exact = (w * z64).sum(1) / w.sum(1)
        err = max(err, float((out[b].double() - exact).abs().max()))
    return err


def results_equal(torch, a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def run_batches(torch, sess, batches, surface) -> list[dict]:
    """Per batch: a warm-up, ``BATCH_REPS`` timed queries and
    ``PROFILE_REPS`` profiled ones; medians with the spread."""
    rows = []
    for q in batches:
        ms = rep_ms(torch, lambda: sess.query(q), BATCH_REPS)
        profs = [sess.query(q, profile=True) for _ in range(PROFILE_REPS)]
        res = profs[-1]
        v = res.values
        check(v.shape == (q.shape[0],), f"values shape {tuple(v.shape)}")
        check(bool(torch.isfinite(v).all()), "non-finite values")
        rows.append({"n": int(q.shape[0]), "ms": statistics.median(ms),
                     "ms_min": min(ms), "ms_max": max(ms),
                     "reps": BATCH_REPS,
                     "stage1_s": statistics.median(
                         p.timings["stage1"] for p in profs),
                     "stage2_s": statistics.median(
                         p.timings["stage2"] for p in profs),
                     "overflow": res.overflow,
                     "zero_weight": int(res.zero_weight_mask.sum()),
                     "rmse": rmse(v, q, surface)})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import aidw as A, knn as K, pipeline as P
    from repro_torch.core.grid import CellTable
    from repro_torch.core.session import InterpolationSession
    from repro_torch.data.pipeline import (spatial_points, spatial_queries,
                                           spatial_surface)
    from repro_torch import kernels
    from repro_torch.kernels import build
    from repro_torch.kernels.aidw import ops, ref
    from repro_torch.kernels.aidw import aidw_kernel as AK
    from repro_torch.kernels.aidw.aidw_kernel import (
        local_interpolate_kernel, local_interpolate_plain,
        tiled_interpolate_kernel, tiled_interpolate_plain)
    from repro_torch.kernels.knn import ops as knn_ops, ref as knn_ref
    from repro_torch.kernels.knn.knn_kernel import (knn_brute_kernel,
                                                    knn_brute_plain)

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    sos = build.build_all()
    for name in build.LIBRARIES:
        build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [so.name for so in sos],
          "ptxas": {so.name: [ln.strip() for ln in so.with_suffix(".log")
                              .read_text().splitlines()
                              if "registers" in ln or "spill" in ln]
                    for so in sos}})

    # -- phase 1: global (tiled) Stage 2 ----------------------------------
    pts1 = spatial_points(GLOBAL_M, seed=0)
    batches = [spatial_queries(n, seed=10 + i)
               for i, n in enumerate(GLOBAL_BATCHES)]
    tiled = {"launches": 0, "max_abs_err": 0.0}
    for fused in (True, False):
        cfg = P.AidwConfig(stage2="tiled", fused=fused)
        sess = InterpolationSession(pts1, cfg, device=dev)
        kernels.reset_launches()
        rows = run_batches(torch, sess, batches, spatial_surface)
        launches = tiled_interpolate_kernel.launches
        check(launches > 0, "tiled kernel not launched on the main path")
        check(local_interpolate_kernel.launches == 0,
              "local kernel launched on the global path")
        tiled["launches"] += launches

        pln = sess.plan
        qt = torch.as_tensor(batches[0], device=dev)
        knn, r_obs = P.stage1(pln, qt)
        _, alpha, _ = P.stage2(pln, qt, knn, r_obs)
        aux = r_obs if fused else alpha
        stats = ops.stats_tensor(pln.n_points, pln.area, dev) if fused \
            else ops.stats_tensor(1.0, 1.0, dev)
        args = ops.tiled_inputs(qt, pln.points_xy, pln.values, aux,
                                tile_q=cfg.tile_q, tile_d=cfg.tile_d)
        qx, qy, aux_p, px, py, pz = args
        n, m = qx.shape[0], px.shape[0]
        tiles = dict(tile_q=cfg.tile_q, tile_d=cfg.tile_d)
        kw = dict(fused=fused, **kw_alpha(cfg))
        kern = lambda: tiled_interpolate_kernel(  # noqa: E731
            qx, qy, aux_p, stats, px, py, pz, **tiles, **kw)
        out_k, sw_k = kern()
        splits = AK.tiled_splits(n, m, fused=fused, device=dev, **tiles)
        head = slice(0, COMPARE_Q)
        out_h, sw_h = tiled_interpolate_plain(
            qx[head], qy[head], aux_p[head], stats, px, py, pz, **kw)
        torch.testing.assert_close(out_k[head], out_h, rtol=VAL_TOL,
                                   atol=VAL_TOL)
        (out_p, sw_p), plain_ms = cuda_ms(
            torch, lambda: tiled_interpolate_plain(
                qx, qy, aux_p, stats, px, py, pz, splits=splits,
                tile_d=cfg.tile_d, **kw),
            reps=1, warmup=0)
        torch.testing.assert_close(out_k, out_p, rtol=VAL_TOL, atol=VAL_TOL)
        check(torch.equal(sw_k <= 0, sw_p <= 0), "tiled zero-weight masks")
        err = float((out_k - out_p).abs().max())
        # both f32 sums against an f64 evaluation of the same Eq. (1)
        a64 = (A.adaptive_alpha(aux_p[head], stats[0], stats[1],
                                **kw_alpha(cfg)) if fused else aux_p[head])
        f64 = {name: f64_err(torch, A, o[head], qx[head], qy[head], a64, px,
                             py, pz) for name, o in (("kernel", out_k),
                                                     ("plain", out_p))}
        _, ms = cuda_ms(torch, kern, reps=3, warmup=0)
        bound_ms, terms = tiled_bound(n, m)

        # the smallest bucket: the data axis split across CTAs
        small = slice(0, SMALL_Q)
        sq = (qx[small], qy[small], aux_p[small])
        s_splits = AK.tiled_splits(SMALL_Q, m, fused=fused, device=dev,
                                   **tiles)
        check(s_splits > 1, f"{SMALL_Q} queries not split")
        skern = lambda: tiled_interpolate_kernel(  # noqa: E731
            *sq, stats, px, py, pz, **tiles, **kw)
        out_s, sw_s = skern()
        want_s, wsw_s = tiled_interpolate_plain(
            *sq, stats, px, py, pz, splits=s_splits, tile_d=cfg.tile_d, **kw)
        torch.testing.assert_close(out_s, want_s, rtol=VAL_TOL, atol=VAL_TOL)
        check(torch.equal(sw_s <= 0, wsw_s <= 0), "split zero-weight masks")
        check(torch.equal(out_s, skern()[0]), "split launch not deterministic")
        _, small_ms = cuda_ms(torch, skern, reps=20, warmup=2)
        q_ = AK.queries_per_thread(cfg.tile_q)
        occupancy = {"card": AK.card_ctas_per_sm(
            torch.cuda.current_device(), q_, cfg.tile_q // q_, cfg.tile_d,
            fused)[1], "model": AK.reference_ctas_per_sm(
                q_, cfg.tile_q // q_, cfg.tile_d, fused)}
        check(occupancy["card"] == occupancy["model"],
              f"the CPU path's occupancy model is off the card's: {occupancy}")

        tiled["max_abs_err"] = max(tiled["max_abs_err"], err,
                                   float((out_s - want_s).abs().max()))
        if fused:
            tiled.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        emit({"phase": "global", "fused": fused, "m": GLOBAL_M,
              "batches": rows, "launches": launches,
              "kernel_n": n, "kernel_m": m, "kernel_ms": ms, "splits": splits,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_terms_ms": terms,
              "max_abs_err": err, f"f64_max_abs_err_{COMPARE_Q}q": f64,
              "small": {"n": SMALL_Q, "m": m, "splits": s_splits,
                        "kernel_ms": small_ms,
                        "bound_ms": tiled_bound(SMALL_Q, m)[0],
                        "max_abs_err": float((out_s - want_s).abs().max())},
              "queries_per_thread": q_, "ctas_per_sm": occupancy})
        del sess, knn, r_obs, alpha, args, out_p, sw_p

    tool = ROOT / "tools" / "sass_loop.py"
    sass = subprocess.run([sys.executable, str(tool), *TILED_SASS_ARGS],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    emit({"phase": "tiled_sass", **json.loads(sass.strip().splitlines()[-1])})

    # -- phase 2: local (exact-k) Stage 2 ----------------------------------
    pts2 = spatial_points(LOCAL_N, seed=0)
    q2 = spatial_queries(LOCAL_N, seed=1)
    cfg = P.AidwConfig(stage2="local", fused=True)
    sess = InterpolationSession(pts2, cfg, device=dev)
    kernels.reset_launches()
    rows = run_batches(torch, sess, [q2], spatial_surface)
    local_launches = local_interpolate_kernel.launches
    check(local_launches > 0, "local kernel not launched on the main path")
    check(tiled_interpolate_kernel.launches == 0,
          "tiled kernel launched on the local path")

    pln = sess.plan
    qt = torch.as_tensor(q2, device=dev)
    knn, r_obs = P.stage1(pln, qt)
    _, alpha, _ = P.stage2(pln, qt, knn, r_obs)
    one = ops.stats_tensor(1.0, 1.0, dev)
    kw = kw_alpha(cfg)
    kern = lambda: local_interpolate_kernel(  # noqa: E731
        knn.d2, knn.idx, alpha, one, pln.values, tile_q=cfg.tile_q, **kw)
    out_k, sw_k = kern()
    plain = lambda: local_interpolate_plain(  # noqa: E731
        knn.d2, knn.idx, alpha, one, pln.values, **kw)
    out_p, sw_p = plain()
    ulps = max(max_ulps(torch, out_k, out_p), max_ulps(torch, sw_k, sw_p))
    check(ulps <= MAX_ULPS, f"local kernel {ulps} ulps from its twin")
    check(torch.equal(sw_k <= 0, sw_p <= 0), "local zero-weight masks")
    local_err = float((out_k - out_p).abs().max())
    n, k = knn.d2.shape
    m = pln.values.shape[0]
    local = {"launches": local_launches, "max_abs_err": local_err,
             "ms": cuda_ms(torch, kern, reps=20, warmup=2)[1],
             "plain_ms": cuda_ms(torch, plain, reps=3, warmup=1)[1],
             "bound_ms": 1e3 * 4 * (2 * n * k + n + m + 2 * n)
             / HBM_BYTES_PER_S}
    emit({"phase": "local", "fused": True, "n": LOCAL_N, "m": LOCAL_N,
          "batches": rows, "launches": local_launches, "k": k,
          "kernel_ms": local["ms"], "plain_ms": local["plain_ms"],
          "bound_ms": local["bound_ms"], "max_abs_err": local_err,
          "max_ulps": ulps,
          "bitwise": bool(torch.equal(out_k, out_p)
                          and torch.equal(sw_k, sw_p))})

    # -- phase 3: the kernel layer on phase 2's Stage-1 output -------------
    stats = ops.stats_tensor(pln.n_points, pln.area, dev)
    fl, fl_zero = ops.fused_local_stage2(knn.d2, knn.idx, pln.values, r_obs,
                                         n_points=pln.n_points, area=pln.area)
    ul, ul_zero = ops.local_interpolate(knn.d2, knn.idx, pln.values, alpha)
    fl_p, _ = local_interpolate_plain(knn.d2, knn.idx, r_obs, stats,
                                      pln.values, fused=True, **kw)
    fu_ulps = max_ulps(torch, fl, ul)
    tw_ulps = max_ulps(torch, fl, fl_p)
    check(fu_ulps <= MAX_ULPS and tw_ulps <= MAX_ULPS,
          f"fused local: {fu_ulps} ulps from unfused, {tw_ulps} from twin")
    check(torch.equal(fl_zero, ul_zero), "fused/unfused local masks")
    sub = slice(0, FUSED_STAGE2_Q)
    fs, fs_zero = ops.fused_stage2(qt[sub], pln.points_xy, pln.values,
                                   r_obs[sub], n_points=pln.n_points,
                                   area=pln.area)
    fs_args = ops.tiled_inputs(qt[sub], pln.points_xy, pln.values, r_obs[sub],
                               tile_q=cfg.tile_q, tile_d=cfg.tile_d)
    fs_p, fs_sw = tiled_interpolate_plain(*fs_args[:3], stats, *fs_args[3:],
                                          fused=True, **kw)
    torch.testing.assert_close(fs, fs_p[:FUSED_STAGE2_Q], rtol=VAL_TOL,
                               atol=VAL_TOL)
    check(torch.equal(fs_zero, fs_sw[:FUSED_STAGE2_Q] <= 0),
          "fused_stage2 masks")
    emit({"phase": "kernel_layer", "n": LOCAL_N,
          "fused_local_vs_unfused_ulps": fu_ulps,
          "fused_local_vs_twin_ulps": tw_ulps,
          "fused_stage2_n": FUSED_STAGE2_Q,
          "fused_stage2_max_abs_err": float((fs - fs_p[:FUSED_STAGE2_Q])
                                            .abs().max())})

    # -- phase 4: zero-weight and padding sentinels -----------------------
    far = torch.tensor([[1e18, 1e18], [0.5, 0.5]], device=dev)
    fknn, fr = P.stage1(pln, far)
    outs = {
        "tiled": ops.tiled_interpolate(far, pln.points_xy, pln.values, 4.0),
        "fused_stage2": ops.fused_stage2(far, pln.points_xy, pln.values, fr,
                                         n_points=pln.n_points,
                                         area=pln.area),
        "local": ops.local_interpolate(fknn.d2, fknn.idx, pln.values, 4.0),
        "fused_local": ops.fused_local_stage2(fknn.d2, fknn.idx, pln.values,
                                              fr, n_points=pln.n_points,
                                              area=pln.area),
    }
    for name, (v, zero) in outs.items():
        check(not bool(torch.isnan(v).any()), f"{name}: NaN")
        check(float(v[0]) == 0.0 and bool(zero[0]), f"{name}: far query")
        check(not bool(zero[1]), f"{name}: near query flagged")
    # 1000 points pad to 1024 with 1e30 coordinates: those weigh exactly 0
    pq = torch.as_tensor(spatial_queries(256, seed=5), device=dev)
    pv, pzero = ops.tiled_interpolate(pq, pln.points_xy[:1000],
                                      pln.values[:1000], 2.0)
    want = ref.interpolate_ref(pq, pln.points_xy[:1000], pln.values[:1000],
                               2.0)
    torch.testing.assert_close(pv, want, rtol=VAL_TOL, atol=VAL_TOL)
    check(not bool(pzero.any()), "padded data raised a mask bit")
    emit({"phase": "sentinels", "far_query_values":
          {k: float(v[0]) for k, (v, _) in outs.items()},
          "pad_max_abs_err": float((pv - want).abs().max())})

    # -- phase 5: Stage 1 on the card against the CPU ----------------------
    q5 = qt[:STAGE1_Q]
    args = (cfg.k, cfg.max_level, cfg.window, cfg.knn_block, cfg.exact)
    g = K.grid_knn(pln.spec, pln.table, q5, *args)
    c = K.grid_knn(pln.spec, CellTable(*(t.cpu() for t in pln.table)),
                   q5.cpu(), *args)
    check(torch.equal(g.overflow.cpu(), c.overflow), "Stage-1 overflow")
    check(torch.equal(g.n_candidates.cpu(), c.n_candidates),
          "Stage-1 n_candidates")
    d2_err = float((g.d2.cpu() - c.d2).abs().max())
    check(d2_err <= 1e-6, f"Stage-1 d2 differs by {d2_err}")
    emit({"phase": "stage1", "n": STAGE1_Q, "m": LOCAL_N,
          "overflow": int(g.overflow.sum()), "d2_max_abs_err": d2_err,
          "idx_equal_share": float((g.idx.cpu() == c.idx).double().mean()),
          "r_obs_max_abs_err": float((K.mean_nn_distance(g.d2).cpu()
                                      - K.mean_nn_distance(c.d2))
                                     .abs().max())})

    # -- phase 6: the original algorithm through the kNN kernel -----------
    q1 = batches[0]
    cfg_o = P.AidwConfig(stage2="tiled")
    kernels.reset_launches()
    origs = [P.aidw_original(pts1, q1, cfg_o, device=dev, timings=True)
             for _ in range(ORIG_REPS)]
    o_launches = kernels.launch_counts()
    check(o_launches["knn_brute_kernel"] > 0,
          "kNN kernel not launched on the original path")
    check(o_launches["aidw_tiled_kernel"] > 0,
          "tiled kernel not launched on the original path")
    ores = origs[-1]
    # the improved session over the same grid (query_domain: same area)
    sess_t = InterpolationSession(pts1, P.AidwConfig(stage2="tiled",
                                                     fused=True),
                                  query_domain=q1, device=dev)
    profs = [sess_t.query(q1, profile=True) for _ in range(PROFILE_REPS + 1)]
    imp = profs[-1]
    cert = ~imp.overflow_mask
    r_err = float((ores.r_obs - imp.r_obs)[cert].abs().max())
    a_err = float((ores.alpha - imp.alpha)[cert].abs().max())
    v_err = float((ores.values - imp.values)[cert].abs().max())
    check(r_err <= R_TOL, f"original r_obs {r_err} from the improved one")
    check(a_err <= R_TOL, f"original alpha {a_err} from the improved one")
    check(v_err <= VAL_TOL, f"original values {v_err} from the improved ones")

    p1 = torch.as_tensor(pts1, device=dev)
    qt1 = torch.as_tensor(q1, device=dev)
    px, py = p1[:, 0].contiguous(), p1[:, 1].contiguous()
    qx, qy = qt1[:, 0].contiguous(), qt1[:, 1].contiguous()
    kkw = dict(k=KNN_K, tile_q=cfg_o.tile_q, tile_d=cfg_o.tile_d)
    head = slice(0, STAGE1_Q)
    head_ulps = max_ulps(torch, knn_brute_kernel(qx[head], qy[head], px, py,
                                                 **kkw),
                         knn_brute_plain(qx[head], qy[head], px, py, k=KNN_K))
    check(head_ulps == 0, f"kNN kernel {head_ulps} ulps from its twin")
    kern = lambda: knn_brute_kernel(qx, qy, px, py, **kkw)  # noqa: E731
    out_k, knn_ms = cuda_ms(torch, kern, reps=5, warmup=1)
    out_p, knn_plain_ms = cuda_ms(
        torch, lambda: knn_brute_plain(qx, qy, px, py, k=KNN_K), reps=1,
        warmup=0)
    check(torch.equal(out_k, out_p), "kNN kernel differs from its twin")
    knn_err = float((out_k - out_p).abs().max())
    n, m = qx.shape[0], px.shape[0]
    knn_terms = {"bytes": 1e3 * 4 * (2 * n + 2 * m + n * KNN_K)
                 / HBM_BYTES_PER_S,
                 "issue": 1e3 * KNN_INSTR_PER_PAIR * n * m
                 / FP32_INSTR_PER_S}
    knn_bound = max(knn_terms.values())
    del out_k, out_p

    p2 = torch.as_tensor(pts2, device=dev)
    q2t = torch.as_tensor(q2, device=dev)
    px2, py2 = p2[:, 0].contiguous(), p2[:, 1].contiguous()
    qx2, qy2 = q2t[:, 0].contiguous(), q2t[:, 1].contiguous()
    out_1m, ms_1m = cuda_ms(
        torch, lambda: knn_brute_kernel(qx2, qy2, px2, py2, **kkw), reps=2,
        warmup=1)
    h1 = slice(0, KNN_HEAD_1M)
    check(torch.equal(out_1m[h1], knn_brute_plain(qx2[h1], qy2[h1], px2, py2,
                                                  k=KNN_K)),
          "1 M-point kNN kernel differs from its twin")
    del out_1m

    ring = torch.full((RING_SLOTS, 2), knn_ops.PAD_COORD, device=dev)
    live = torch.as_tensor(spatial_points(RING_LIVE, seed=7)[:, :2],
                           device=dev)
    ring[:RING_LIVE] = live
    qh = qt1[head]
    check(torch.equal(knn_ops.knn_d2_with_ring(p1[:, :2], ring, qh, **kkw),
                      knn_ops.knn_d2(torch.cat([p1[:, :2], live]), qh,
                                     **kkw)),
          "knn_d2_with_ring differs from knn_d2 over the live points")
    few = knn_ops.knn_d2(p1[:10, :2], qh, k=KNN_K)
    check(bool(torch.isinf(few[:, 10:]).all())
          and bool(torch.isfinite(few[:, :10]).all()), "k > m tail")
    check(torch.equal(few, knn_ref.knn_d2_ref(p1[:10, :2], qh, k=KNN_K)),
          "k > m differs from knn_d2_ref")
    dup = torch.tensor([[0.5, 0.5]] * 20 + [[0.1, 0.1]] * 5, device=dev)
    dq = torch.tensor([[0.5, 0.5]], device=dev)
    check(torch.equal(knn_ops.knn_d2(dup, dq, k=21),
                      knn_ref.knn_d2_ref(dup, dq, k=21)), "duplicates")
    knn = {"launches": o_launches["knn_brute_kernel"], "max_abs_err": knn_err,
           "ms": knn_ms, "plain_ms": knn_plain_ms, "bound_ms": knn_bound}
    emit({"phase": "original", "n": n, "m": m, "k": KNN_K,
          "launches": o_launches, "reps": ORIG_REPS,
          "knn_stage_s": statistics.median(r.timings["knn"] for r in origs),
          "knn_stage_s_all": [r.timings["knn"] for r in origs],
          "interp_s": statistics.median(r.timings["interp"] for r in origs),
          "improved_stage1_s": statistics.median(
              p.timings["stage1"] for p in profs[1:]),
          "improved_stage1_s_all": [p.timings["stage1"] for p in profs[1:]],
          "certified": int(cert.sum()),
          "r_obs_max_abs_err": r_err,
          "r_obs_bitwise_share": float((ores.r_obs == imp.r_obs)[cert]
                                       .double().mean()),
          "alpha_max_abs_err": a_err, "values_max_abs_err": v_err,
          "kernel_head_ulps": head_ulps, "kernel_ms": knn_ms,
          "plain_ms": knn_plain_ms, "bound_ms": knn_bound,
          "bound_terms_ms": knn_terms, "max_abs_err": knn_err,
          "kernel_ms_1m": ms_1m, "kernel_1m_head": KNN_HEAD_1M,
          "ring": [RING_SLOTS, RING_LIVE]})
    del origs, ores, profs

    # -- phase 7: the CUDA-graph bucket ladder ---------------------------
    graph_rows = []
    for label, gs, gbuckets, qs_eq, qs_all, used in (
            ("tiled_fused_m262144", sess_t, GRAPH_BUCKETS, q1, batches,
             ("aidw_tiled_kernel",)),
            ("local_fused_m1048576", sess, (LOCAL_N,), q2, [q2],
             ("aidw_local_kernel",))):
        # capture empties the allocator's cache first: empty it on both
        # sides, so the growth is what the graphs' pool holds
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        got = gs.precompile(buckets=gbuckets)
        capture_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        mem1 = torch.cuda.memory_reserved(dev)
        check(got == sorted(gbuckets) and gs.stats["aot_buckets"]
              == len(gbuckets), f"{label}: precompile bookkeeping")
        for qb in qs_all:
            replay = gs.query(qb)
            eager = gs.query(qb, profile=True)
            check(results_equal(torch, replay, eager),
                  f"{label}: replay differs from eager at n={len(qb)}")
        small = qs_all[-1]
        first = gs.query(small)
        kept = first.values.clone()
        gs.query(small[::-1].copy())
        check(torch.equal(first.values, kept),
              f"{label}: a replay overwrote an earlier result")
        qeq = torch.as_tensor(qs_eq, device=dev)
        walls = turns_ms(torch, {"replayed": lambda: gs.query(qeq),
                                 "eager": lambda: P.execute(gs.plan, qeq)},
                         TURNS)
        check(all(gs.graph_launches().get(name, 0) > 0 for name in used),
              f"{label}: replays launched no {used}")
        hist = gs.registry.snapshot()["histograms"]["session/compile_s"]
        graph_rows.append({
            "session": label, "buckets": got, "capture_s": capture_s,
            "compile_s_count": hist["count"],
            "memory_reserved_growth_bytes": mem1 - mem0,
            "n": len(qs_eq), **{f"{k}_{f}": v for k, w in walls.items()
                                for f, v in w.items()},
            "launches": gs.graph_launches()})
    sess_t.update(pts1)
    check(sess_t.stats["aot_buckets"] == 0 and sess_t.graph_launches() == {}
          and sess_t.registry.snapshot()["gauges"]["compiled_buckets"] == 0,
          "update() kept its graphs")
    emit({"phase": "precompile", "sessions": graph_rows,
          "update_drops_graphs": True})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    common = {"route": "cuda", "source": SOURCE, "bound_by": None,
              "library_ms": None}
    emit({"kernels": [
        {**common, "name": "aidw_tiled_kernel",
         "replaces": "src/repro/kernels/aidw/aidw_kernel.py:98",
         "launches": tiled["launches"], "max_abs_err": tiled["max_abs_err"],
         "ms": tiled["ms"], "plain_ms": tiled["plain_ms"],
         "bound_ms": tiled["bound_ms"], "bound_by": "operations"},
        {**common, "name": "aidw_local_kernel",
         "replaces": "src/repro/kernels/aidw/aidw_kernel.py:178",
         "launches": local["launches"], "max_abs_err": local["max_abs_err"],
         "ms": local["ms"], "plain_ms": local["plain_ms"],
         "bound_ms": local["bound_ms"], "bound_by": "bytes"},
        {**common, "name": "knn_brute_kernel", "source": KNN_SOURCE,
         "replaces": "src/repro/kernels/knn/knn_kernel.py:75",
         "launches": knn["launches"], "max_abs_err": knn["max_abs_err"],
         "ms": knn["ms"], "plain_ms": knn["plain_ms"],
         "bound_ms": knn["bound_ms"], "bound_by": "operations"},
    ], "gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
