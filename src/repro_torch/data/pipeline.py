"""Spatial point streams of the paper's testing protocol (§5.1).

A copy of the spatial generators of the JAX package's data pipeline: the
same numpy RNG calls in the same order, so a seed gives the same points in
both packages.
"""

from __future__ import annotations

import numpy as np


def spatial_surface(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth analytic terrain used as ground truth for accuracy checks."""
    return (np.sin(3.1 * x) * np.cos(2.3 * y)
            + 0.5 * np.sin(7.9 * x * y) + 0.1 * x - 0.2 * y)


def spatial_points(n: int, *, seed: int = 0, clustered: bool = False,
                   noise: float = 0.0) -> np.ndarray:
    """(n, 3) data points: x, y in the unit square (paper: random in a square),
    z from the analytic surface (+ optional noise)."""
    rng = np.random.default_rng(seed)
    if clustered:
        k = max(1, n // 500)
        centers = rng.random((k, 2))
        xy = centers[rng.integers(0, k, n)] + rng.normal(0, 0.02, (n, 2))
        xy = np.clip(xy, 0.0, 1.0)
    else:
        xy = rng.random((n, 2))
    z = spatial_surface(xy[:, 0], xy[:, 1])
    if noise:
        z = z + rng.normal(0, noise, n)
    return np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)


def spatial_queries(n: int, *, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 2)).astype(np.float32)
