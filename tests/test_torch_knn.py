"""Port parity: Stage-1 grid kNN of repro_torch against repro, on the CPU.

``overflow`` and ``n_candidates`` must match exactly, ``d2`` within 1e-6,
``idx`` wherever the distance is not (nearly) tied with a neighbour in the
same row — ``torch.topk`` and ``jax.lax.top_k`` break ties apart, and the two
frameworks may round a squared distance one ulp apart.  A case where every
query overflows is allowed (see ROADMAP §C).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import grid as JG, knn as JK  # noqa: E402
from repro_torch.core import grid as TG, knn as TK  # noqa: E402

D2_TOL = 1e-6


def _data(kind: str, m: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        xy = rng.random((m, 2))
    elif kind == "clustered":
        centers = rng.random((3, 2))
        xy = np.clip(centers[rng.integers(0, 3, m)]
                     + rng.normal(0, 0.02, (m, 2)), 0, 1)
    else:  # one cell
        xy = 0.5 + 1e-4 * rng.random((m, 2))
    pts = np.concatenate([xy, rng.random((m, 1))], 1).astype(np.float32)
    return pts, rng.random((n, 2)).astype(np.float32)


def _tables(pts, qs):
    spec = JG.plan_grid(pts[:, :2], qs)
    jt = JG.bin_points(spec, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
                       jnp.asarray(pts[:, 2]))
    t = torch.from_numpy(pts)
    tt = TG.bin_points(TG.GridSpec(*spec), t[:, 0], t[:, 1], t[:, 2])
    return spec, jt, tt


def _assert_idx_equal_off_ties(d2, got_idx, want_idx):
    """idx must agree wherever d2 is finite and more than a few ulps from
    both row neighbours."""
    d2 = np.asarray(d2, np.float64)
    gap = 5e-7 * np.maximum(np.abs(d2), 1e-30)
    fin = np.isfinite(d2)
    left = np.ones_like(fin)
    right = np.ones_like(fin)
    with np.errstate(invalid="ignore"):
        left[:, 1:] = np.abs(d2[:, 1:] - d2[:, :-1]) > gap[:, 1:]
        right[:, :-1] = np.abs(d2[:, :-1] - d2[:, 1:]) > gap[:, :-1]
    clear = fin & left & right
    assert np.array_equal(got_idx[clear], want_idx[clear])


def _compare(jr, tr):
    assert np.array_equal(tr.overflow.numpy(), np.asarray(jr.overflow))
    assert np.array_equal(tr.n_candidates.numpy(),
                          np.asarray(jr.n_candidates))
    assert tr.n_candidates.dtype == torch.int32
    jd2, td2 = np.asarray(jr.d2), tr.d2.numpy()
    assert np.array_equal(np.isfinite(td2), np.isfinite(jd2))
    fin = np.isfinite(jd2)
    np.testing.assert_allclose(td2[fin], jd2[fin], rtol=0, atol=D2_TOL)
    _assert_idx_equal_off_ties(jd2, tr.idx.numpy(), np.asarray(jr.idx))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("kind,m,n,k,window,block", [
    ("uniform", 3000, 700, 15, 256, 512),
    ("uniform", 2000, 300, 1, 256, 4096),
    ("clustered", 2000, 400, 15, 64, 128),     # some queries overflow
    ("clustered", 500, 64, 25, 64, 4096),
    ("uniform", 10, 64, 15, 256, 32),          # k > m: inf slots
    ("one_cell", 235, 32, 1, 256, 4096),       # all-overflow is allowed
])
def test_grid_knn_matches_reference(kind, m, n, k, window, block, exact):
    pts, qs = _data(kind, m, n, seed=m + k)
    spec, jt, tt = _tables(pts, qs)
    jr = JK.grid_knn(spec, jt, jnp.asarray(qs), k, None, window, block, exact)
    tr = TK.grid_knn(TG.GridSpec(*spec), tt, torch.from_numpy(qs), k, None,
                     window, block, exact)
    _compare(jr, tr)
    if kind == "clustered" and window == 64 and k == 15:
        assert tr.overflow.any()
    np.testing.assert_allclose(TK.mean_nn_distance(tr.d2).numpy(),
                               np.asarray(JK.mean_nn_distance(jr.d2)),
                               rtol=0, atol=D2_TOL)


def test_grid_knn_explicit_max_level_and_padded_table():
    """A capacity-padded table (sentinel tail slots) and a fixed max_level
    give the reference's answer."""
    pts, qs = _data("uniform", 1000, 200, seed=5)
    spec, jt, tt = _tables(pts, qs)
    pad = 24
    jt = JG.CellTable(jnp.pad(jt.sx, (0, pad), constant_values=1e30),
                      jnp.pad(jt.sy, (0, pad), constant_values=1e30),
                      jnp.pad(jt.sz, (0, pad)), jt.cell_start,
                      jnp.pad(jt.order, (0, pad)))
    fpad = torch.nn.functional.pad
    tt = TG.CellTable(fpad(tt.sx, (0, pad), value=1e30),
                      fpad(tt.sy, (0, pad), value=1e30), fpad(tt.sz, (0, pad)),
                      tt.cell_start, fpad(tt.order, (0, pad)))
    for max_level in (None, 3):
        jr = JK.grid_knn(spec, jt, jnp.asarray(qs), 15, max_level, 256, 64,
                         True)
        tr = TK.grid_knn(TG.GridSpec(*spec), tt, torch.from_numpy(qs), 15,
                         max_level, 256, 64, True)
        _compare(jr, tr)


@pytest.mark.parametrize("m,n,k", [(500, 100, 15), (40, 30, 60)])
def test_brute_knn_matches_reference(m, n, k):
    pts, qs = _data("uniform", m, n, seed=m)
    jd2, jidx = JK.brute_knn(jnp.asarray(pts[:, :2]), jnp.asarray(qs), k, 64)
    td2, tidx = TK.brute_knn(torch.from_numpy(pts[:, :2]),
                             torch.from_numpy(qs), k, 64)
    assert td2.shape == jd2.shape and tidx.dtype == torch.int32
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=0,
                               atol=D2_TOL)
    _assert_idx_equal_off_ties(np.asarray(jd2), tidx.numpy(),
                               np.asarray(jidx))


@pytest.mark.parametrize("kind,m,k", [("uniform", 3000, 15),
                                      ("clustered", 500, 7),
                                      ("one_cell", 235, 1),
                                      ("uniform", 1, 15)])
def test_auto_max_level_identical(kind, m, k):
    pts, qs = _data(kind, m, 16, seed=1)
    spec = JG.plan_grid(pts[:, :2], qs)
    assert TK.auto_max_level(TG.GridSpec(*spec), m, k) == \
        JK.auto_max_level(spec, m, k)


def test_mean_nn_distance_bitwise():
    """Equal distances give a bitwise-equal r_obs (Eq. 3)."""
    d2 = (np.random.default_rng(2).random((300, 15)) ** 2 * 1e-3) \
        .astype(np.float32)
    want = np.asarray(JK.mean_nn_distance(jnp.asarray(d2)))
    got = TK.mean_nn_distance(torch.from_numpy(d2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=D2_TOL)
