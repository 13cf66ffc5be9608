"""Brute-force kNN kernel: hand-written CUDA for Hopper, plain twin on the
CPU."""

from . import ops, ref
from .knn_kernel import knn_brute_kernel, knn_brute_plain, reset_launches
from .ops import knn_d2, knn_d2_with_ring, mean_nn_distance

__all__ = ["ops", "ref", "knn_brute_kernel", "knn_brute_plain",
           "reset_launches", "knn_d2", "knn_d2_with_ring", "mean_nn_distance"]
