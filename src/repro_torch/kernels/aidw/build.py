"""Build the Stage-2 CUDA kernels with ``nvcc`` at first use and load them.

The source ``csrc/aidw_kernels.cu`` has a plain C interface, so it compiles
in seconds without PyTorch's headers.  The shared library goes to
``src/repro_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags: an edited source builds anew, an unchanged one is
loaded as it is.  The compiler's report (``-Xptxas -v``: registers, shared
memory, spills) is written beside it as ``.log``.

Nothing here runs at import: :func:`library` builds on its first call, which
the kernel wrappers make only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "aidw_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# aidw_tiled(qx, qy, aux, stats, px, py, pz, out, sumw, n, m, tile_q, tile_d,
#            fused, alphas[5] (host), r_min, r_max, cos_scale, stream)
_TILED_ARGS = [_P] * 9 + [_I] * 5 + [_P, _F, _F, _F, _P]
# aidw_local(d2, idx, aux, stats, pz, out, sumw, n, k, tile_q, fused,
#            alphas[5] (host), r_min, r_max, cos_scale, stream)
_LOCAL_ARGS = [_P] * 7 + [_I] * 4 + [_P, _F, _F, _F, _P]


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


def library_path() -> Path:
    """Build the shared library if needed; return its path."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libaidw_kernels_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)          # atomic: a concurrent loader sees all or none
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's C signature."""
    lib = ctypes.CDLL(str(library_path()))
    lib.aidw_tiled.argtypes = _TILED_ARGS
    lib.aidw_tiled.restype = _I
    lib.aidw_local.argtypes = _LOCAL_ARGS
    lib.aidw_local.restype = _I
    return lib
