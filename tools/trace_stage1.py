#!/usr/bin/env python3
"""Time and trace Stage 1 (grid kNN) of the PyTorch port on one CUDA card.

    python3 tools/trace_stage1.py [--src DIR] [--label NAME]

Plans the local configuration of ``chip_smoke.py``'s phase 2 (m = n =
1,048,576 uniform points, ``stage2="local", fused=True``), then

1. times 5 warm Stage-1 calls and 5 warm session queries, each on
   the host clock around a call that ends in a synchronise (median, min,
   max);
2. traces one warm Stage-1 call with ``torch.profiler`` and reads from the
   trace: the kernels launched, the device-busy time (union of kernel
   intervals), the device's idle share of the traced wall and of the
   untraced median wall, the CUDA runtime calls that block the host
   (synchronisations and copies), and the kernels that take the most time.

Prints one JSON line.  ``--src`` imports the package from another checkout's
``src`` directory, so two versions can be held against each other in one
call (parent, change, change, parent).  The trace file goes to
``chiprun_out/`` and is deleted once read.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N = 1_048_576
REPS = 5
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def walls(torch, fn, reps: int) -> dict:
    """Median, min and max seconds of ``reps`` synchronised calls of ``fn``
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(out), "min_s": min(out),
            "max_s": max(out), "reps": reps}


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def read_trace(path: Path) -> dict:
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    cpu = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels + cpu + runtime
             if "dur" in e]
    wall = max(e for _, e in spans) - min(s for s, _ in spans) if spans else 0
    busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e["name"][:90], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    calls: dict[str, int] = {}
    for e in runtime:
        if e["name"] in BLOCKING or e["name"] == "cudaLaunchKernel":
            calls[e["name"]] = calls.get(e["name"], 0) + 1
    return {"kernels": len(kernels), "device_busy_ms": busy / 1e3,
            "traced_wall_ms": wall / 1e3,
            "traced_idle_share": 1.0 - busy / wall if wall else None,
            "runtime_calls": calls,
            "top_kernels": [{"name": k, "count": c, "ms": d / 1e3}
                            for k, (c, d) in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("trace_stage1: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import pipeline as P
    from repro_torch.core.session import InterpolationSession
    from repro_torch.data.pipeline import spatial_points, spatial_queries

    pts = spatial_points(N, seed=0)
    q = spatial_queries(N, seed=1)
    cfg = P.AidwConfig(stage2="local", fused=True)
    sess = InterpolationSession(pts, cfg, device="cuda")
    qt = torch.as_tensor(q, device="cuda")
    stage1 = walls(torch, lambda: P.stage1(sess.plan, qt), REPS)
    query = walls(torch, lambda: sess.query(q), REPS)

    from torch.profiler import ProfilerActivity, profile
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / f"trace_stage1_{args.label}_{os.getpid()}.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        P.stage1(sess.plan, qt)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    trace = read_trace(path)
    path.unlink()
    busy = trace["device_busy_ms"] / 1e3
    if not trace["kernels"]:  # the profiler saw no device activity
        trace.update(device_busy_ms=None, traced_idle_share=None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({
        "label": args.label, "n": N, "m": N,
        "blocks": -(-N // cfg.knn_block), "stage1": stage1,
        "session_query": query, "trace": trace,
        "untraced_idle_share": (1.0 - busy / stage1["median_s"]
                                if trace["kernels"] else None),
        "gpu": smi.splitlines()[0], "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
