"""Hand-written Hopper kernels for the compute hot spots the paper optimizes:

* ``aidw`` — Stage-2 weighted interpolation: the tiled global kernel (the
  paper's shared-memory tiling) and the exact-k local kernel.
"""
