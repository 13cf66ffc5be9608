"""The trace reader of tools/trace_stage1.py on a synthetic profiler trace."""

import importlib.util
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

TOOL = Path(__file__).resolve().parent.parent / "tools" / "trace_stage1.py"


def _tool():
    spec = importlib.util.spec_from_file_location("trace_stage1", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 2), (5, 6)], 3.0),
    ([(0, 2), (1, 3), (5, 6)], 4.0),        # overlap counted once
    ([(1, 3), (0, 10), (4, 5)], 10.0),      # nested spans
])
def test_busy_us_is_the_union_of_intervals(spans, want):
    assert _tool().busy_us(spans) == want


def test_read_trace_counts_kernels_idle_share_and_blocking_calls(tmp_path):
    events = [
        {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 100},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 5},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 30,
         "dur": 20},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 28, "dur": 2},
        {"cat": "kernel", "name": "gather", "ts": 20, "dur": 30},
        {"cat": "kernel", "name": "topk", "ts": 60, "dur": 10},
        {"cat": "kernel", "name": "gather", "ts": 180, "dur": 20},
        {"ph": "M", "name": "process_name"},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = _tool().read_trace(path)
    assert out["kernels"] == 3
    assert out["device_busy_ms"] == pytest.approx(0.060)
    assert out["traced_wall_ms"] == pytest.approx(0.200)
    assert out["traced_idle_share"] == pytest.approx(0.7)
    assert out["runtime_calls"] == {"cudaLaunchKernel": 2,
                                    "cudaStreamSynchronize": 1,
                                    "cudaMemcpyAsync": 1}
    assert out["top_kernels"][0] == {"name": "gather", "count": 2,
                                     "ms": pytest.approx(0.050)}


SASS = """
        Function : _Z7otherPf
        /*0000*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_116knn_brute_kernelILi16EEEvPKfS2_S2_S2_Pfiiii
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDS.64 R2, [R9] ;                 /* 0x0 */
        /*0020*/                   FADD R4, R0, -R2 ;
        /*0030*/                   FADD R5, R1, -R3 ;
        /*0040*/                   FMUL R4, R4, R4 ;
        /*0050*/                   FMUL R5, R5, R5 ;
        /*0060*/                   FADD R6, R4, R5 ;
        /*0070*/                   FSETP.GEU.AND P0, PT, R6, R7, PT ;
        /*0080*/              @!P0 BRA 0xc0 ;
        /*0090*/                   IADD3 R9, R9, 0x8, RZ ;
        /*00a0*/               @P1 BRA 0x10 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   FMNMX R8, R6, R10, PT ;
        /*00d0*/                   FMNMX R7, R6, R10, !PT ;
        /*00e0*/                   BRA 0x90 ;
        /*00f0*/               @P2 BRA 0x0 ;
"""


def test_sass_loop_counts_one_iteration_off_the_cold_path():
    """The innermost loop with FMULs, walked around its insertion block."""
    spec = importlib.util.spec_from_file_location(
        "sass_loop", TOOL.parent / "sass_loop.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.count(SASS, "knn_brute_kernelILi16", {"FMNMX"})
    assert out["loop"] == ["0x10", "0xa0"]
    assert out["iteration_instructions"] == 10
    assert out["pairs_per_iteration"] == 1
    assert out["instructions_per_pair"] == 10
    assert out["iteration_opcodes"]["FADD"] == 3
    assert "FMNMX" not in out["iteration_opcodes"]
    with pytest.raises(ValueError, match="no function"):
        mod.count(SASS, "missing", {"FMNMX"})


def test_tiled_sweep_combos_resolve_plan_and_drop_impossible_splits():
    spec = importlib.util.spec_from_file_location(
        "tiled_sweep", TOOL.parent / "tiled_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.combos([2, 4], ["plan", "1", "2", "600"], tiles=512, planned=1)
    assert got == [(2, 1), (2, 2), (4, 1), (4, 2)]
    assert mod.combos([2], ["plan", "8"], tiles=4, planned=4) == [(2, 4)]
    assert mod.combos([1], ["plan"], tiles=0, planned=1) == [(1, 1)]
