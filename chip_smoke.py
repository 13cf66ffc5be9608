#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch twins.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the Stage-2 CUDA kernels from ``src/repro_torch/kernels/aidw/csrc``
with ``nvcc`` (``repro_torch.kernels.aidw.build``), then runs five phases at
the paper's protocol (uniform points in the unit square, n queries):

1. global  — ``InterpolationSession`` with ``stage2="tiled"``, fused and
   unfused, m = 262,144 points, batches of 262,144, 70,001 and 1,000
   queries; the tiled kernel against its twin at the largest batch
   (values within 2e-5 abs/rel: another summation order; masks equal);
2. local   — ``stage2="local", fused=True`` at m = n = 1,048,576; the local
   kernel against its twin on all queries (at most 1 ulp apart; the line
   says whether they are bitwise equal);
3. kernel layer — ``fused_local_stage2`` and ``fused_stage2`` called
   directly on phase 2's Stage-1 output;
4. sentinels — a far query [1e18, 1e18] through every kernel variant gives
   0.0 and a raised mask bit, never NaN; 1e30-padded data weigh nothing;
5. Stage 1 — ``grid_knn`` on the card equals the port's CPU ``grid_knn``
   on 4,096 queries (overflow and n_candidates exactly, d2 within 1e-6).

Each kernel wrapper counts its launches; the counts are zeroed just before
a phase drives the main path and read just after it, before any
comparison launch.  Times come from CUDA events after a warm-up.

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

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

GLOBAL_M = 262_144
GLOBAL_BATCHES = (262_144, 70_001, 1_000)
LOCAL_N = 1_048_576
COMPARE_Q = 2_048          # the global twin is also checked on this prefix
STAGE1_Q = 4_096
FUSED_STAGE2_Q = 4_096     # phase 3's direct fused_stage2 call
VAL_TOL = 2e-5             # tiled kernel vs twin: another summation order
MAX_ULPS = 1               # local kernel vs twin (powf vs torch.pow)

# Peak rates of one H100 SXM (NVIDIA data sheet, at a 700 W limit): 3.35
# TB/s of HBM; at the 1.98 GHz boost clock, 132 SMs each issue 128 FP32
# instructions a clock (the 67 TFLOP/s of the data sheet counts an FMA as
# two operations) and 16 MUFU results (ex2, lg2) a clock.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
MUFU_PER_S = 132 * 16 * 1.98e9
# tiled kernel, per (query, point) pair, at the fewest instructions: FADD
# dx, FADD dy, FMUL + FFMA d2, FMNMX clamp, FMUL by -alpha/2 (the ln -> log2
# factors folded in), FADD sum_w, FFMA sum_wz; and one lg2, one ex2
TILED_FP32_PER_PAIR = 8
TILED_MUFU_PER_PAIR = 2
BATCH_REPS = 5             # timed session queries per batch
PROFILE_REPS = 3           # profiled session queries per batch

DEVICE = "cuda"
SOURCE = "src/repro_torch/kernels/aidw/csrc/aidw_kernels.cu"


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
    from repro_torch.kernels.aidw import build, ops, ref
    from repro_torch.kernels.aidw.aidw_kernel import (
        local_interpolate_kernel, local_interpolate_plain, reset_launches,
        tiled_interpolate_kernel, tiled_interpolate_plain)

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = build.library_path()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": so.name,
          "ptxas": [ln.strip() for ln in so.with_suffix(".log").read_text()
                    .splitlines() if "registers" in ln or "spill" in ln]})

    # -- phase 1: global (tiled) Stage 2 ----------------------------------
    pts1 = spatial_points(GLOBAL_M, seed=0)
    batches = [spatial_queries(n, seed=10 + i)
               for i, n in enumerate(GLOBAL_BATCHES)]
    tiled = {"launches": 0, "max_abs_err": 0.0}
    for fused in (True, False):
        cfg = P.AidwConfig(stage2="tiled", fused=fused)
        sess = InterpolationSession(pts1, cfg, device=dev)
        reset_launches()
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
        kw = dict(fused=fused, **kw_alpha(cfg))
        kern = lambda: tiled_interpolate_kernel(  # noqa: E731
            qx, qy, aux_p, stats, px, py, pz, tile_q=cfg.tile_q,
            tile_d=cfg.tile_d, **kw)
        out_k, sw_k = kern()
        head = slice(0, COMPARE_Q)
        out_h, sw_h = tiled_interpolate_plain(
            qx[head], qy[head], aux_p[head], stats, px, py, pz, **kw)
        torch.testing.assert_close(out_k[head], out_h, rtol=VAL_TOL,
                                   atol=VAL_TOL)
        (out_p, sw_p), plain_ms = cuda_ms(
            torch, lambda: tiled_interpolate_plain(qx, qy, aux_p, stats, px,
                                                   py, pz, **kw),
            reps=1, warmup=0)
        torch.testing.assert_close(out_k, out_p, rtol=VAL_TOL, atol=VAL_TOL)
        check(torch.equal(sw_k <= 0, sw_p <= 0), "tiled zero-weight masks")
        err = float((out_k - out_p).abs().max())
        # both f32 sums against an f64 evaluation of the same Eq. (1)
        f64 = slice(0, 64)
        a64 = (A.adaptive_alpha(aux_p[f64], stats[0], stats[1],
                                **kw_alpha(cfg))
               if fused else aux_p[f64]).double()
        d2 = (qx[f64, None].double() - px.double()) ** 2 \
            + (qy[f64, None].double() - py.double()) ** 2
        w = torch.exp(-0.5 * a64[:, None]
                      * torch.log(torch.clamp_min(d2, A.EPS_D2)))
        exact = (w * pz.double()).sum(1) / w.sum(1)
        f64_err = {"kernel": float((out_k[f64] - exact).abs().max()),
                   "plain": float((out_p[f64] - exact).abs().max())}
        _, ms = cuda_ms(torch, kern, reps=3, warmup=0)
        n, m = qx.shape[0], px.shape[0]
        nbytes = 4 * (3 * n + 3 * m + 2 * n + 2)
        terms = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
                 "fp32_issue": 1e3 * TILED_FP32_PER_PAIR * n * m
                 / FP32_INSTR_PER_S,
                 "mufu": 1e3 * TILED_MUFU_PER_PAIR * n * m / MUFU_PER_S}
        bound_ms = max(terms.values())
        tiled["max_abs_err"] = max(tiled["max_abs_err"], err)
        if fused:
            tiled.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        emit({"phase": "global", "fused": fused, "m": GLOBAL_M,
              "batches": rows, "launches": launches,
              "kernel_n": n, "kernel_m": m, "kernel_ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_terms_ms": terms,
              "max_abs_err": err, "f64_max_abs_err_64q": f64_err})
        del sess, knn, r_obs, alpha, args, out_p, sw_p

    # -- phase 2: local (exact-k) Stage 2 ----------------------------------
    pts2 = spatial_points(LOCAL_N, seed=0)
    q2 = spatial_queries(LOCAL_N, seed=1)
    cfg = P.AidwConfig(stage2="local", fused=True)
    sess = InterpolationSession(pts2, cfg, device=dev)
    reset_launches()
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
    ], "gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
