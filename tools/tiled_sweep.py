#!/usr/bin/env python3
"""Time the tiled Stage-2 kernel at chosen queries a thread and splits.

    python3 tools/tiled_sweep.py [--m M] [--n N,N,...] [--q Q,Q,...]
                                 [--splits plan|S,...] [--variant NAME,...]
                                 [--reps R] [--unfused] [--seed S]

The wrapper ``tiled_interpolate_kernel`` always takes its own q
(``queries_per_thread``) and the planned splits (``tiled_splits``); this
script calls the C entry point ``aidw_tiled`` directly so that the other
choices can be timed beside them.  For every n it makes uniform queries and
m uniform points in the unit square from ``--seed``, checks each
combination against the planned one (values within 2e-5, masks equal), and
times all of them in turns, each call alone between CUDA events after one
warm-up (median, min and max of ``--reps``).  ``plan`` in ``--splits`` is the
planner's choice.  ``--variant`` also builds edited copies of the source in
a temporary directory: ``lg2-ftz`` uses ``lg2.approx.ftz.f32`` (the same
result for every clamped d2 >= 1e-12) and ``ex2-ftz`` also flushes subnormal
weights; ``built`` is the source as it is.

Prints one JSON line per n, one with the occupancy API's resident CTAs per SM
for each kernel instance at the tiles the tests use (the table
``tests/test_torch_tiled_split.py`` holds), and the card's name and power
limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TILE_Q, TILE_D = 256, 512
# (tile_q, tile_d) of the occupancy table, for q = 1, 2 and 4
OCCUPANCY_TILES = ((256, 512), (8, 128), (128, 256), (256, 3072), (64, 128),
                   (1024, 512))
VARIANTS = {"built": (),
            "lg2-ftz": (("lg2.approx.f32", "lg2.approx.ftz.f32"),),
            "ex2-ftz": (("lg2.approx.f32", "lg2.approx.ftz.f32"),
                        ("ex2.approx.f32", "ex2.approx.ftz.f32"))}


def combos(qs, splits, tiles: int, planned: int) -> list[tuple[int, int]]:
    """The (q, splits) pairs to time: ``plan`` is ``planned``; a split count
    above the data tiles, or below 1, is left out; order kept, no repeats."""
    out = []
    for q, s in itertools.product(qs, splits):
        s = planned if s == "plan" else int(s)
        if 1 <= s <= max(tiles, 1) and (q, s) not in out:
            out.append((q, s))
    return out


def _libraries(names):
    from repro_torch.kernels import build

    build.build_all()
    source = build.LIBRARIES["aidw_kernels"][0].read_text()
    tmp = Path(tempfile.mkdtemp(prefix="tiled_sweep_"))
    procs = {}
    for name in names:
        if name == "built":
            continue
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(tmp / f"{name}.so"),
             str(tmp / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    libs = {"built": build.library("aidw_kernels")} if "built" in names else {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn, argtypes in build.LIBRARIES["aidw_kernels"][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=262_144)
    ap.add_argument("--n", default="262144,131072,1024")
    ap.add_argument("--q", default="2,4,1")
    ap.add_argument("--splits", default="plan,1,2,4")
    ap.add_argument("--variant", default="built")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--unfused", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.core import aidw as A
    from repro_torch.kernels.aidw import aidw_kernel as AK, ops

    if not torch.cuda.is_available():
        print("tiled_sweep: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fused = not args.unfused
    libs = _libraries(args.variant.split(","))
    alphas, r_min, r_max, cos_scale = AK._alpha_args(
        A.DEFAULT_ALPHAS, A.DEFAULT_R_MIN, A.DEFAULT_R_MAX)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, t, stats, q, splits):
        qx, qy, aux, px, py, pz = t
        n, m = qx.shape[0], px.shape[0]
        out, sumw = torch.empty_like(qx), torch.empty_like(qx)
        part = torch.empty((2, splits, n), device=dev) if splits > 1 else None
        err = lib.aidw_tiled(
            qx.data_ptr(), qy.data_ptr(), aux.data_ptr(), stats.data_ptr(),
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), out.data_ptr(),
            sumw.data_ptr(), 0 if part is None else part.data_ptr(), n, m,
            TILE_Q, TILE_D, q, splits, int(fused), ctypes.addressof(alphas),
            r_min, r_max, cos_scale, stream)
        if err:
            raise RuntimeError(f"aidw_tiled failed: CUDA error {err}")
        return out, sumw

    rng = np.random.default_rng(args.seed)
    pts = torch.tensor(rng.random((args.m, 2)), dtype=torch.float32,
                       device=dev)
    z = torch.sin(7 * torch.tensor(rng.random(args.m), dtype=torch.float32,
                                   device=dev))
    stats = ops.stats_tensor(args.m, 1.0, dev)
    for n in (int(v) for v in args.n.split(",")):
        qs = torch.tensor(rng.random((n, 2)), dtype=torch.float32, device=dev)
        # fused: r_obs near the mean NN distance of m uniform points
        aux = (0.5 / args.m ** 0.5) * (0.5 + torch.tensor(
            rng.random(n), dtype=torch.float32, device=dev)) if fused \
            else 0.5 + 3.5 * torch.tensor(rng.random(n), dtype=torch.float32,
                                          device=dev)
        t = ops.tiled_inputs(qs, pts, z, aux, tile_q=TILE_Q, tile_d=TILE_D)
        n_pad, m_pad = t[0].shape[0], t[3].shape[0]
        planned = AK.tiled_splits(n_pad, m_pad, tile_q=TILE_Q, tile_d=TILE_D,
                                  fused=fused, device=dev)
        plan_q = AK.queries_per_thread(TILE_Q)
        todo = combos([int(v) for v in args.q.split(",")],
                      args.splits.split(","), m_pad // TILE_D, planned)
        fns = {(v, q, s): (lambda lib=lib, q=q, s=s: launch(lib, t, stats,
                                                            q, s))
               for v, lib in libs.items() for q, s in todo}
        want, wsw = launch(libs.get("built", next(iter(libs.values()))), t,
                           stats, plan_q, planned)
        for key, fn in fns.items():
            out, sw = fn()
            torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
            if not torch.equal(sw <= 0, wsw <= 0):
                raise RuntimeError(f"{key}: zero-weight masks differ")
        torch.cuda.synchronize()
        ms = {key: [] for key in fns}
        for _ in range(args.reps):
            for key, fn in fns.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ms[key].append(start.elapsed_time(end))
        print(json.dumps({
            "n": n, "m": args.m, "fused": fused, "tile_q": TILE_Q,
            "tile_d": TILE_D, "planned": {"q": plan_q, "splits": planned},
            "reps": args.reps,
            "ms": [{"variant": v, "q": q, "splits": s,
                    "median": statistics.median(x), "min": min(x),
                    "max": max(x)} for (v, q, s), x in ms.items()]}),
            flush=True)

    table = []
    for q, (tq, td), f in itertools.product((1, 2, 4), OCCUPANCY_TILES,
                                            (False, True)):
        if tq % q or tq // q > 1024:
            continue
        table.append([q, tq // q, td, f, AK.card_ctas_per_sm(
            torch.cuda.current_device(), q, tq // q, td, f)[1]])
    print(json.dumps({"occupancy": table,
                      "sms": torch.cuda.get_device_properties(dev)
                      .multi_processor_count}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
