"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each source under ``kernels/*/csrc/`` has a plain C interface, so it
compiles in seconds without PyTorch's headers.  Its shared library goes to
``src/repro_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags: an edited source builds anew, an unchanged one is
loaded as it is.  The compiler's report (``-Xptxas -v``: registers, shared
memory, spills) is written beside it as ``.log``.

Nothing here runs at import: :func:`library` builds on its first call, which
the kernel wrappers make only for CUDA tensors.  :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# library name -> (source, {C entry point: argtypes}); every entry point
# returns cudaGetLastError() as an int
LIBRARIES = {
    "aidw_kernels": (KERNELS_DIR / "aidw" / "csrc" / "aidw_kernels.cu", {
        # aidw_tiled(qx, qy, aux, stats, px, py, pz, out, sumw, part, n, m,
        #            tile_q, tile_d, q, splits, fused, alphas[5] (host),
        #            r_min, r_max, cos_scale, stream)
        "aidw_tiled": [_P] * 10 + [_I] * 7 + [_P, _F, _F, _F, _P],
        # aidw_tiled_ctas_per_sm(q, threads, tile_d, fused, ctas (host))
        "aidw_tiled_ctas_per_sm": [_I] * 4 + [_P],
        # aidw_local(d2, idx, aux, stats, pz, out, sumw, n, k, tile_q, fused,
        #            alphas[5] (host), r_min, r_max, cos_scale, stream)
        "aidw_local": [_P] * 7 + [_I] * 4 + [_P, _F, _F, _F, _P],
    }),
    "knn_kernels": (KERNELS_DIR / "knn" / "csrc" / "knn_kernels.cu", {
        # knn_brute(qx, qy, px, py, out, n, m, k, tile_q, tile_d, stream)
        "knn_brute": [_P] * 5 + [_I] * 5 + [_P],
    }),
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` as PyTorch finds it, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built."""
    source = LIBRARIES[name][0]
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start ``nvcc`` for library ``name`` unless it is built; returns
    ``(so, tmp, process)`` or None."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(LIBRARIES[name][0])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return so, tmp, proc


def _finish(started) -> None:
    if started is None:
        return
    so, tmp, proc = started
    out, err = proc.communicate()
    so.with_suffix(".log").write_text(out + err)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {so.name} ({proc.returncode}):"
                           f"\n{err}")
    os.replace(tmp, so)          # atomic: a concurrent loader sees all or none


def build_all() -> list[Path]:
    """Build every library not built yet, one ``nvcc`` per source, all
    started together; returns the libraries' paths."""
    started = [_start(name) for name in LIBRARIES]
    for s in started:
        _finish(s)
    return [library_path(name) for name in LIBRARIES]


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Library ``name``, built if needed and loaded, with every entry
    point's C signature."""
    _finish(_start(name))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in LIBRARIES[name][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    return lib
