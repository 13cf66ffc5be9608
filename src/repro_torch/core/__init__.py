"""Core library in PyTorch: grid kNN + AIDW, mirroring ``repro.core``."""

from .aidw import (
    DEFAULT_ALPHAS,
    adaptive_alpha,
    alpha_from_membership,
    expected_nn_distance,
    fuzzy_membership,
    idw_weights_sq,
    nn_statistic,
    weighted_interpolate,
    weighted_partial_sums,
)
from .grid import CellTable, GridSpec, bin_points, cell_ids, plan_grid
from .knn import KnnResult, brute_knn, grid_knn, mean_nn_distance
from .pipeline import (
    AidwConfig,
    AidwPlan,
    AidwResult,
    aidw_improved,
    aidw_original,
    execute,
    idw_standard,
    plan,
    plan_from_reference,
)
from .session import InterpolationSession, bucket_size

__all__ = [
    "DEFAULT_ALPHAS", "adaptive_alpha", "alpha_from_membership",
    "expected_nn_distance", "fuzzy_membership", "idw_weights_sq",
    "nn_statistic", "weighted_interpolate", "weighted_partial_sums",
    "CellTable", "GridSpec", "bin_points", "cell_ids", "plan_grid",
    "KnnResult", "brute_knn", "grid_knn", "mean_nn_distance",
    "AidwConfig", "AidwPlan", "AidwResult", "aidw_improved",
    "aidw_original", "execute", "idw_standard", "plan", "plan_from_reference",
    "InterpolationSession", "bucket_size",
]
