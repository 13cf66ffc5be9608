#!/usr/bin/env python3
"""Count the instructions one iteration of a kernel's hot loop issues.

    python3 tools/sass_loop.py [--lib LIB.so | --library NAME]
                               [--kernel NAME] [--cold OP] [--unit OP]
                               [--per-pair N]

Builds the port's CUDA libraries if needed (``repro_torch.kernels.build``),
runs ``cuobjdump -sass`` on ``--lib`` (default: the built library
``--library``, ``knn_kernels``) and takes the first function whose mangled
name contains ``--kernel`` (default ``knn_brute_kernelILi16``, the k <= 16
instance).  A branch back to an earlier address closes a loop; the hot loop
is the innermost one (it holds no other loop) with the most ``--unit``
instructions (default ``FMUL``).  The script walks one iteration from the
loop's head: at a conditional branch it avoids the side whose block holds a
``--cold`` opcode (default ``FMNMX``: the kNN kernel's insertion, taken
~k ln(m/k) times a query) and otherwise falls through.  Prints one JSON
line: the loop's span, the instructions of one iteration by opcode, the
pairs it covers (``--per-pair`` units a pair, default 2) and the
instructions a pair.  The kNN kernel's count is the number
``chip_smoke.py``'s kNN bound cites; the tiled kernel's hot loop is counted
with ``--library aidw_kernels --kernel aidw_tiled_kernelILi2ELb1E --unit
MUFU --cold ''`` (two MUFU ops, lg2 and ex2, a pair).  Needs ``cuobjdump``
(the CUDA toolkit's ``bin``), so it runs where the kernels build.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")
TARGET = re.compile(r"0x([0-9a-f]+)")


def functions(sass: str) -> dict[str, list[tuple]]:
    """Mangled function name -> ``[(addr, predicated, opcode, operands)]``."""
    out: dict[str, list[tuple]] = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        mt = LINE.search(line)
        if mt and cur is not None:
            cur.append((int(mt.group(1), 16), bool(mt.group(2)),
                        mt.group(3), mt.group(4).strip()))
    return out


def _base(op: str) -> str:
    return op.split(".", 1)[0]


def _target(ins) -> int | None:
    if _base(ins[2]) != "BRA":
        return None
    mt = TARGET.search(ins[3])
    return int(mt.group(1), 16) if mt else None


def hot_loop(code: list[tuple], unit: str = "FMUL") -> tuple[int, int]:
    """``(head index, back-edge index)`` of the innermost loop (one that
    holds no other loop) with the most ``unit`` instructions."""
    at = {ins[0]: i for i, ins in enumerate(code)}
    loops = [(at[t], j) for j, ins in enumerate(code)
             if (t := _target(ins)) is not None and t < ins[0] and t in at]
    inner = [(i, j) for i, j in loops
             if not any(i <= i2 and j2 <= j and (i2, j2) != (i, j)
                        for i2, j2 in loops)]
    best = max(inner, default=None, key=lambda ij: sum(
        _base(c[2]) == unit for c in code[ij[0]:ij[1] + 1]))
    if best is None or not any(_base(c[2]) == unit
                               for c in code[best[0]:best[1] + 1]):
        raise ValueError(f"no loop with {unit} instructions")
    return best


def _cold(code, i: int, cold: set) -> bool:
    """Whether the straight-line block starting at index ``i`` (up to its
    first branch or exit) holds a cold opcode."""
    for ins in code[i:]:
        if _base(ins[2]) in cold:
            return True
        if _base(ins[2]) in ("BRA", "EXIT", "RET"):
            return False
    return False


def walk(code: list[tuple], head: int, cold: set,
         max_steps: int = 100_000) -> list[tuple]:
    """The instructions of one iteration from ``head`` back to ``head``,
    avoiding blocks with a cold opcode."""
    at = {ins[0]: i for i, ins in enumerate(code)}
    path, i = [], head
    for _ in range(max_steps):
        ins = code[i]
        path.append(ins)
        t = _target(ins)
        if t is None:
            i += 1
            continue
        j = at[t]
        if j == head:                        # the loop's own back-edge
            return path
        if not ins[1]:                       # unconditional
            i = j
        elif _cold(code, j, cold) or not _cold(code, i + 1, cold):
            i += 1
        else:
            i = j
    raise RuntimeError("no way back to the loop head")


def count(sass: str, kernel: str, cold: set, unit: str = "FMUL",
          per_pair: int = 2) -> dict:
    """The hot loop of the first function matching ``kernel``, counted."""
    name = next((f for f in functions(sass) if kernel in f), None)
    if name is None:
        raise ValueError(f"no function matching {kernel!r}")
    code = functions(sass)[name]
    head, back = hot_loop(code, unit)
    path = walk(code, head, cold)
    ops = Counter(_base(ins[2]) for ins in path)
    pairs = ops[unit] / per_pair
    return {"function": name, "loop": [hex(code[head][0]),
                                       hex(code[back][0])],
            "loop_instructions": back - head + 1,
            "iteration_instructions": len(path),
            "iteration_opcodes": dict(ops.most_common()),
            "pairs_per_iteration": pairs,
            "instructions_per_pair": len(path) / pairs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", help="shared library (default: --library's)")
    ap.add_argument("--library", default="knn_kernels",
                    help="name of a built library of the port")
    ap.add_argument("--kernel", default="knn_brute_kernelILi16")
    ap.add_argument("--cold", default="FMNMX",
                    help="comma-separated opcodes of rarely taken blocks")
    ap.add_argument("--unit", default="FMUL",
                    help="opcode that marks the hot loop and counts pairs")
    ap.add_argument("--per-pair", type=int, default=2,
                    help="--unit instructions a (query, point) pair")
    args = ap.parse_args()
    if args.lib:
        lib = Path(args.lib)
    else:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import build

        build.build_all()
        lib = build.library_path(args.library)
    tool = shutil.which("cuobjdump")
    if tool is None:
        from torch.utils.cpp_extension import CUDA_HOME

        tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin",
                            "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    print(json.dumps({"library": lib.name,
                      **count(sass, args.kernel, set(args.cold.split(",")),
                              args.unit, args.per_pair)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
