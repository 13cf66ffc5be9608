"""AIDW Stage-2 kernels: hand-written CUDA for Hopper, plain twins on the CPU."""

from . import ops, ref
from .aidw_kernel import (local_interpolate_kernel, reset_launches,
                          tiled_interpolate_kernel)
from .ops import (fused_local_stage2, fused_stage2, local_interpolate,
                  tiled_interpolate)

__all__ = ["ops", "ref", "local_interpolate_kernel", "reset_launches",
           "tiled_interpolate_kernel", "fused_local_stage2", "fused_stage2",
           "local_interpolate", "tiled_interpolate"]
