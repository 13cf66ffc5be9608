"""Port parity: grid planning and CSR binning of repro_torch against repro.

``plan_grid`` must give an identical ``GridSpec`` and ``bin_points`` a
``CellTable`` element-identical in all five arrays (stable sort, same f32
cell-id arithmetic as the reference's compiled form).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import grid as JG  # noqa: E402
from repro_torch.core import grid as TG  # noqa: E402


def _points(kind: str, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        xy = rng.random((m, 2))
    elif kind == "clustered":
        centers = rng.random((4, 2))
        xy = np.clip(centers[rng.integers(0, 4, m)]
                     + rng.normal(0, 0.02, (m, 2)), 0, 1)
    else:  # one cell: a 1e-4 box inside a unit-square query domain
        xy = 0.5 + 1e-4 * rng.random((m, 2))
    z = rng.random((m, 1))
    return np.concatenate([xy, z], 1).astype(np.float32)


def _queries(seed=7, n=300):
    return np.random.default_rng(seed).random((n, 2)).astype(np.float32)


KINDS = ["uniform", "clustered", "one_cell"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cell_factor", [1.0, 0.7])
def test_plan_grid_identical(kind, cell_factor):
    pts = _points(kind, 1500, seed=1)
    qs = _queries()
    for qd in (None, qs):
        want = JG.plan_grid(pts[:, :2], qd, cell_factor=cell_factor)
        got = TG.plan_grid(pts[:, :2], qd, cell_factor=cell_factor)
        assert tuple(got) == tuple(want)
        assert got.n_cells == want.n_cells


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [1, 777, 4096])
def test_bin_points_element_identical(kind, m):
    pts = _points(kind, m, seed=m)
    spec = JG.plan_grid(pts[:, :2], _queries())
    want = JG.bin_points(spec, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
                         jnp.asarray(pts[:, 2]))
    t = torch.from_numpy(pts)
    got = TG.bin_points(TG.GridSpec(*spec), t[:, 0], t[:, 1], t[:, 2])
    for name in ("sx", "sy", "sz", "cell_start", "order"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    if kind == "one_cell":
        assert np.count_nonzero(np.diff(got.cell_start.numpy())) == 1


def test_cell_ids_identical_on_boundaries():
    """Coordinates on and around cell boundaries, and far outside the grid,
    land in the same (clipped) cells as in the reference's binning, where
    ``cell_ids`` runs under ``jax.jit`` (XLA multiplies by the reciprocal of
    the cell width there)."""
    spec = JG.plan_grid(_points("uniform", 3000, seed=4)[:, :2])
    edges = spec.min_x + spec.cell_width * np.arange(spec.n_cols + 1)
    x = np.concatenate([edges, np.nextafter(edges, -np.inf),
                        np.nextafter(edges, np.inf),
                        [-5.0, 5.0, 1e18, -1e18]]).astype(np.float32)
    y = x[::-1].copy()
    want = np.asarray(jax.jit(JG.cell_ids, static_argnums=0)(
        spec, jnp.asarray(x), jnp.asarray(y)))
    got = TG.cell_ids(TG.GridSpec(*spec), torch.from_numpy(x),
                      torch.from_numpy(y)).numpy()
    assert np.array_equal(got, want)
