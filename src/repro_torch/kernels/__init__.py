"""Hand-written Hopper kernels for the compute hot spots the paper optimizes:

* ``aidw`` — Stage-2 weighted interpolation: the tiled global kernel (the
  paper's shared-memory tiling) and the exact-k local kernel.
* ``knn`` — brute-force kNN, the original algorithm's global search.

``build`` compiles every CUDA source with ``nvcc`` at first use.
"""


def _wrappers() -> dict:
    from .aidw.aidw_kernel import (local_interpolate_kernel,
                                   tiled_interpolate_kernel)
    from .knn.knn_kernel import knn_brute_kernel

    return {"aidw_tiled_kernel": tiled_interpolate_kernel,
            "aidw_local_kernel": local_interpolate_kernel,
            "knn_brute_kernel": knn_brute_kernel}


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launches() -> None:
    """Zero every kernel wrapper's launch count."""
    for fn in _wrappers().values():
        fn.launches = 0
