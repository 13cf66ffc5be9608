"""Port parity: the brute-force kNN kernel layer of repro_torch against
repro's Pallas ``knn_d2`` (run in interpret mode), on the CPU, where the
wrapper takes its plain PyTorch twin.

Tolerances: rtol 1e-5 / atol 1e-7 with an identical finiteness pattern in
f32, 5e-2 in bf16 (the reference's own kernel tolerances,
``tests/test_kernels.py``); the port against its own dense oracle bitwise
(the same f32 operations, the same multiset of k smallest).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as JP  # noqa: E402
from repro.kernels.knn import ops as jops, ref as jref  # noqa: E402
from repro_torch.core import knn as TK, pipeline as TP  # noqa: E402
from repro_torch.kernels.knn import ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels.knn.knn_kernel import (  # noqa: E402
    knn_brute_kernel, knn_brute_plain, reset_launches)

SHAPES = [(256, 512, 15), (100, 300, 1), (70, 40, 8), (128, 128, 32),
          (33, 9, 15)]


def _data(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 2)).astype(np.float32),
            rng.random((m, 2)).astype(np.float32))


def _assert_ref_close(got, want, rtol=1e-5, atol=1e-7):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,m,k", SHAPES)
def test_knn_d2_matches_reference(n, m, k):
    q, p = _data(n, m, seed=k)
    want = jops.knn_d2(jnp.asarray(p), jnp.asarray(q), k=k, tile_q=64,
                       tile_d=128, interpret=True)
    got = tops.knn_d2(torch.from_numpy(p), torch.from_numpy(q), k=k,
                      tile_q=64, tile_d=128)
    assert got.shape == (n, k) and got.dtype == torch.float32
    _assert_ref_close(got.numpy(), want)
    assert torch.equal(got, tref.knn_d2_ref(torch.from_numpy(p),
                                            torch.from_numpy(q), k=k))
    if k > m:
        assert torch.isinf(got[:, m:]).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_knn_d2_dtypes(dtype, tol):
    q, p = _data(200, 400, seed=9)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.knn_d2(jnp.asarray(p, jd), jnp.asarray(q, jd), k=10,
                       tile_q=64, tile_d=128, interpret=True)
    got = tops.knn_d2(torch.from_numpy(p).to(td), torch.from_numpy(q).to(td),
                      k=10, tile_q=64, tile_d=128)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_knn_d2_duplicate_points():
    """Equal distances stay separate entries: the same multiset as the
    reference's first-occurrence masked-min."""
    p = np.array([[0.5, 0.5]] * 20 + [[0.1, 0.1]] * 5, np.float32)
    q = np.array([[0.5, 0.5]], np.float32)
    want = jref.knn_d2_ref(jnp.asarray(p), jnp.asarray(q), k=21)
    got = tops.knn_d2(torch.from_numpy(p), torch.from_numpy(q), k=21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    assert (got[0, :20] == 0).all() and got[0, 20] > 0
    assert torch.equal(got, tref.knn_d2_ref(torch.from_numpy(p),
                                            torch.from_numpy(q), k=21))


def test_mean_nn_distance_matches_core_brute_knn():
    """r_obs from the kernel's distances equals r_obs from the core
    ``brute_knn`` bitwise on the CPU, and the reference's within 1e-5."""
    q, p = _data(150, 350, seed=11)
    tq, tp = torch.from_numpy(q), torch.from_numpy(p)
    d2k = tops.knn_d2(tp, tq, k=15)
    d2c, _ = TK.brute_knn(tp, tq, 15)
    assert torch.equal(d2k, d2c)
    assert torch.equal(tops.mean_nn_distance(d2k), tops.mean_nn_distance(d2c))
    want = jops.mean_nn_distance(jops.knn_d2(jnp.asarray(p), jnp.asarray(q),
                                             k=15, interpret=True))
    np.testing.assert_allclose(tops.mean_nn_distance(d2k).numpy(),
                               np.asarray(want), rtol=1e-5)


def test_knn_d2_with_ring_matches_reference():
    """Dead ring slots at PAD_COORD are never selected: the ring result is
    the plain result over the points plus the live ring points."""
    q, p = _data(96, 300, seed=4)
    live = np.random.default_rng(5).random((6, 2)).astype(np.float32)
    ring = np.full((16, 2), tops.PAD_COORD, np.float32)
    ring[:6] = live
    want = jops.knn_d2_with_ring(jnp.asarray(p), jnp.asarray(ring),
                                 jnp.asarray(q), k=12, tile_q=32, tile_d=128,
                                 interpret=True)
    got = tops.knn_d2_with_ring(torch.from_numpy(p), torch.from_numpy(ring),
                                torch.from_numpy(q), k=12, tile_q=32,
                                tile_d=128)
    _assert_ref_close(got.numpy(), want)
    assert torch.equal(got, tops.knn_d2(
        torch.from_numpy(np.concatenate([p, live])), torch.from_numpy(q),
        k=12))


def test_plain_twin_on_cpu_counts_no_launch():
    """A CPU tensor takes the twin: no launch is counted, and k outside
    [1, 64] raises with the limit named."""
    q, p = _data(20, 50)
    tq, tp = torch.from_numpy(q), torch.from_numpy(p)
    reset_launches()
    out = knn_brute_kernel(tq[:, 0], tq[:, 1], tp[:, 0], tp[:, 1], k=5)
    assert knn_brute_kernel.launches == 0
    assert torch.equal(out, knn_brute_plain(tq[:, 0], tq[:, 1], tp[:, 0],
                                            tp[:, 1], k=5))
    for k in (0, 65):
        with pytest.raises(ValueError, match="64"):
            knn_brute_plain(tq[:, 0], tq[:, 1], tp[:, 0], tp[:, 1], k=k)


def test_aidw_original_calls_knn_d2_with_clamped_k(spatial_data, monkeypatch):
    pts, qs = spatial_data
    seen = []
    real = TP.knn_ops.knn_d2

    def spy(points_xy, queries_xy, *, k, tile_q, tile_d):
        seen.append((points_xy.shape[0], k, tile_q, tile_d))
        return real(points_xy, queries_xy, k=k, tile_q=tile_q, tile_d=tile_d)

    monkeypatch.setattr(TP.knn_ops, "knn_d2", spy)
    cfg = TP.AidwConfig(tile_q=128, tile_d=256)
    TP.aidw_original(pts, qs[:64], cfg, device="cpu")
    TP.aidw_original(pts[:10], qs[:64], cfg, device="cpu")
    assert seen == [(2048, 15, 128, 256), (10, 10, 128, 256)]


@pytest.mark.parametrize("stage2", ["naive", "tiled"])
def test_aidw_original_fewer_points_than_k(spatial_data, stage2):
    """m < k: k clamps to m, so r_obs stays finite and equals the
    reference's."""
    pts, qs = spatial_data
    pts, qs = pts[:10], qs[:64]
    jres = JP.aidw_original(pts, qs, JP.AidwConfig(stage2=stage2))
    tres = TP.aidw_original(pts, qs, TP.AidwConfig(stage2=stage2),
                            device="cpu")
    assert torch.isfinite(tres.r_obs).all()
    np.testing.assert_allclose(tres.r_obs.numpy(), np.asarray(jres.r_obs),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres.alpha.numpy(), np.asarray(jres.alpha),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres.values.numpy(), np.asarray(jres.values),
                               rtol=2e-5, atol=2e-5)
