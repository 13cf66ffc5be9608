"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Marked ``cuda``: each test skips with a reason where there is no card (the
decision is taken inside the fixture, never at import).  This file imports
neither jax nor repro, so it also runs on a machine with only PyTorch::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the tiled kernel within 2e-5 of its twin (another summation
order), the local and kNN kernels bitwise (the same f32 operations, no FMA
contraction), CUDA-graph replays bitwise against eager queries (the same
kernels on the same inputs).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import aidw as A, knn as K, pipeline as P  # noqa: E402
from repro_torch.core.session import InterpolationSession  # noqa: E402
from repro_torch.data.pipeline import spatial_points, spatial_queries  # noqa: E402
from repro_torch.kernels.aidw import aidw_kernel as AK, ops  # noqa: E402
from repro_torch.kernels.aidw.aidw_kernel import (  # noqa: E402
    local_interpolate_kernel, local_interpolate_plain, reset_launches,
    tiled_interpolate_kernel, tiled_interpolate_plain)
from repro_torch.kernels.knn import ops as knn_ops, ref as knn_ref  # noqa: E402
from repro_torch.kernels.knn.knn_kernel import (  # noqa: E402
    knn_brute_kernel, knn_brute_plain)

pytestmark = pytest.mark.cuda
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _data(n, m, dev, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.random(s), dtype=torch.float32,  # noqa: E731
                                device=dev)
    return f(n, 2), f(m, 2), torch.sin(f(m) * 7), 0.5 + 3.5 * f(n)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,m,tq,td", [(256, 512, 256, 512),
                                       (700, 1300, 256, 512),
                                       (64, 100, 8, 128), (1, 1, 8, 128),
                                       (4096, 65536, 256, 512)])
def test_tiled_kernel_matches_twin(cuda, n, m, tq, td, fused):
    q, p, z, a = _data(n, m, cuda)
    aux = a * 0.01 if fused else a
    stats = ops.stats_tensor(m, 1.0, cuda)
    args = ops.tiled_inputs(q, p, z, aux, tile_q=tq, tile_d=td)
    reset_launches()
    out, sw = tiled_interpolate_kernel(*args[:3], stats, *args[3:], tile_q=tq,
                                       tile_d=td, fused=fused)
    torch.cuda.synchronize()
    assert tiled_interpolate_kernel.launches == 1
    want, wsw = tiled_interpolate_plain(*args[:3], stats, *args[3:],
                                        fused=fused)
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
    assert torch.equal(sw <= 0, wsw <= 0)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("m", [65_536, 262_144])
@pytest.mark.parametrize("n", [1, 1_000, 1_024])
def test_tiled_kernel_split_matches_twin(cuda, n, m, fused):
    """Small batches split the data axis; the twin adds in the same order."""
    q, p, z, a = _data(n, m, cuda, seed=21)
    aux = a * 0.01 if fused else a
    stats = ops.stats_tensor(m, 1.0, cuda)
    args = ops.tiled_inputs(q, p, z, aux, tile_q=256, tile_d=512)
    splits = AK.tiled_splits(args[0].shape[0], args[3].shape[0], fused=fused,
                             device=cuda)
    assert splits > 1
    reset_launches()
    out, sw = tiled_interpolate_kernel(*args[:3], stats, *args[3:],
                                       fused=fused)
    again, _ = tiled_interpolate_kernel(*args[:3], stats, *args[3:],
                                        fused=fused)
    torch.cuda.synchronize()
    assert tiled_interpolate_kernel.launches == 2
    assert torch.equal(out, again)          # no atomics: the same bits
    want, wsw = tiled_interpolate_plain(*args[:3], stats, *args[3:],
                                        fused=fused, splits=splits)
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
    assert torch.equal(sw <= 0, wsw <= 0)


@pytest.mark.parametrize("n", [2, 1_024])
def test_tiled_kernel_keeps_subnormal_weights(cuda, n):
    """A query at (1e10, 0) weighs the unit-square points ~1e-40 at alpha 4:
    subnormal, but not flushed (ex2 without .ftz), so sum_w > 0 and the
    masks equal the twin's, split or not."""
    q = torch.rand(n, 2, device=cuda)
    q[0] = torch.tensor([1e10, 0.0])
    p = torch.rand(65_536, 2, device=cuda)
    z = torch.sin(torch.rand(65_536, device=cuda) * 7)
    args = ops.tiled_inputs(q, p, z, 4.0, tile_q=256, tile_d=512)
    stats = ops.stats_tensor(1.0, 1.0, cuda)
    out, sw = tiled_interpolate_kernel(*args[:3], stats, *args[3:])
    splits = AK.tiled_splits(args[0].shape[0], 65_536, device=cuda)
    want, wsw = tiled_interpolate_plain(*args[:3], stats, *args[3:],
                                        splits=splits)
    w_max = float(torch.exp(-2.0 * torch.log(
        ((q[0, 0] - p[:, 0]) ** 2 + p[:, 1] ** 2).min())))
    assert 0.0 < w_max < torch.finfo(torch.float32).tiny
    assert float(sw[0]) > 0.0 and float(wsw[0]) > 0.0
    assert torch.equal(sw <= 0, wsw <= 0)
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,tq,real_tiles", [(1_024, 256, 1),
                                             (16_896, 8, 8)])
def test_tiled_kernel_pad_tiles_weigh_nothing(cuda, n, tq, real_tiles):
    """Whole tiles of PAD_COORD points leave sum_w and the values bitwise as
    they are without them: one real tile under a split launch, eight under
    one that stays whole."""
    td = 512
    q, p, z, a = _data(n, real_tiles * td, cuda, seed=22)
    stats = ops.stats_tensor(1.0, 1.0, cuda)
    args = ops.tiled_inputs(q, p, z, a, tile_q=tq, tile_d=td)
    pad = list(args)
    for k, v in ((3, ops.PAD_COORD), (4, ops.PAD_COORD), (5, 0.0)):
        pad[k] = torch.cat([args[k], torch.full((4 * td,), v, device=cuda)])
    plans = [AK.tiled_splits(n, t[3].shape[0], tile_q=tq, tile_d=td,
                             device=cuda) for t in (args, pad)]
    assert plans[1] > 1 if real_tiles == 1 else plans == [1, 1]
    out, sw = tiled_interpolate_kernel(*args[:3], stats, *args[3:],
                                       tile_q=tq, tile_d=td)
    pout, psw = tiled_interpolate_kernel(*pad[:3], stats, *pad[3:],
                                         tile_q=tq, tile_d=td)
    assert torch.equal(sw, psw) and torch.equal(out, pout)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,m,k", [(256, 512, 15), (300, 600, 7),
                                   (33, 90, 15), (1, 64, 1)])
def test_local_kernel_bitwise_twin(cuda, n, m, k, fused):
    q, p, z, a = _data(n, m, cuda, seed=5)
    d2, idx = K.brute_knn(p, q, k)
    aux = K.mean_nn_distance(d2) if fused else a
    stats = ops.stats_tensor(m, 1.0, cuda)
    out, sw = local_interpolate_kernel(d2, idx, aux, stats, z, tile_q=64,
                                       fused=fused)
    want, wsw = local_interpolate_plain(d2, idx, aux, stats, z, fused=fused)
    assert torch.equal(out, want) and torch.equal(sw, wsw)


def test_sentinels_on_card(cuda):
    q = torch.tensor([[1e18, 1e18], [0.5, 0.5]], device=cuda)
    p = torch.rand(64, 2, device=cuda)
    z = torch.ones(64, device=cuda)
    out, zero = ops.tiled_interpolate(q, p, z, 4.0, tile_q=8, tile_d=128)
    assert zero.tolist() == [True, False] and float(out[0]) == 0.0
    d2 = torch.full((4, 8), float("inf"), device=cuda)
    idx = torch.zeros(4, 8, dtype=torch.int32, device=cuda)
    out, zero = ops.local_interpolate(d2, idx, z, 2.0)
    assert zero.all() and (out == 0).all()


def test_wrappers_validate_inputs(cuda):
    x = torch.rand(256, device=cuda)
    s = ops.stats_tensor(1.0, 1.0, cuda)
    with pytest.raises(TypeError):
        tiled_interpolate_kernel(x.double(), x, x, s, x, x, x)
    with pytest.raises(ValueError, match="multiples"):
        tiled_interpolate_kernel(x, x, x, s, x[:100], x[:100], x[:100])
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.rand(512, device=cuda)[::2]
        tiled_interpolate_kernel(t, t, t, s, x, x, x, tile_d=256)
    with pytest.raises(ValueError, match="on cpu"):
        tiled_interpolate_kernel(x, x.cpu(), x, s, x, x, x)
    d2 = torch.rand(8, 3, device=cuda)
    with pytest.raises(TypeError):
        local_interpolate_kernel(d2, torch.zeros(8, 3, dtype=torch.int64,
                                                 device=cuda), x[:8], s, x)


@pytest.mark.parametrize("stage2,fused", [("naive", False), ("tiled", False),
                                          ("tiled", True), ("local", False),
                                          ("local", True)])
def test_session_on_card_matches_cpu(cuda, stage2, fused):
    pts = spatial_points(8192, seed=0)
    qs = spatial_queries(3000, seed=1)
    cfg = P.AidwConfig(stage2=stage2, fused=fused)
    got = InterpolationSession(pts, cfg, device=cuda).query(qs)
    want = InterpolationSession(pts, cfg, device="cpu").query(qs)
    assert torch.equal(got.overflow_mask.cpu(), want.overflow_mask)
    torch.testing.assert_close(got.r_obs.cpu(), want.r_obs, rtol=0, atol=1e-6)
    torch.testing.assert_close(got.alpha.cpu(), want.alpha, rtol=0, atol=1e-6)
    torch.testing.assert_close(got.values.cpu(), want.values, rtol=TOL,
                               atol=TOL)
    assert A.DEFAULT_ALPHAS[0] <= float(got.alpha.min())


@pytest.mark.parametrize("k", [1, 15, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("n,m,tq,td", [(256, 512, 256, 512),
                                       (700, 1300, 256, 512),
                                       (33, 9, 64, 128), (1, 1, 8, 128),
                                       (3000, 70_001, 128, 1024)])
def test_knn_kernel_bitwise_twin(cuda, n, m, tq, td, k):
    q, p, _, _ = _data(n, m, cuda, seed=k)
    args = (q[:, 0].contiguous(), q[:, 1].contiguous(),
            p[:, 0].contiguous(), p[:, 1].contiguous())
    knn_brute_kernel.launches = 0
    out = knn_brute_kernel(*args, k=k, tile_q=tq, tile_d=td)
    torch.cuda.synchronize()
    assert knn_brute_kernel.launches == 1
    assert torch.equal(out, knn_brute_plain(*args, k=k))
    assert bool(torch.isinf(out[:, m:]).all())


def test_knn_kernel_edges(cuda):
    """Duplicates stay separate entries; PAD_COORD points are never
    selected; k above 64 raises with the limit named."""
    p = torch.tensor([[0.5, 0.5]] * 20 + [[0.1, 0.1]] * 5, device=cuda)
    q = torch.tensor([[0.5, 0.5]], device=cuda)
    assert torch.equal(knn_ops.knn_d2(p, q, k=21),
                       knn_ref.knn_d2_ref(p, q, k=21))
    ring = torch.full((8, 2), knn_ops.PAD_COORD, device=cuda)
    ring[:2] = p[:2]
    assert torch.equal(knn_ops.knn_d2_with_ring(p, ring, q, k=21),
                       knn_ops.knn_d2(torch.cat([p, p[:2]]), q, k=21))
    x = torch.rand(64, device=cuda)
    with pytest.raises(ValueError, match="64"):
        knn_brute_kernel(x, x, x, x, k=65)


def test_knn_wrapper_validates_inputs(cuda):
    x = torch.rand(256, device=cuda)
    with pytest.raises(TypeError):
        knn_brute_kernel(x.double(), x, x, x, k=4)
    with pytest.raises(ValueError, match="on cpu"):
        knn_brute_kernel(x, x, x.cpu(), x, k=4)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.rand(512, device=cuda)[::2]
        knn_brute_kernel(x, x, t, t, k=4)
    with pytest.raises(ValueError, match="shape"):
        knn_brute_kernel(x, x[:100], x, x, k=4)


def test_aidw_original_on_card(cuda):
    """The original algorithm reaches the kNN kernel and matches the CPU."""
    pts = spatial_points(8192, seed=0)
    qs = spatial_queries(3000, seed=1)
    cfg = P.AidwConfig(stage2="tiled")
    knn_brute_kernel.launches = 0
    got = P.aidw_original(pts, qs, cfg, device=cuda)
    assert knn_brute_kernel.launches == 1
    want = P.aidw_original(pts, qs, cfg, device="cpu")
    assert torch.equal(got.r_obs.cpu(), want.r_obs)
    torch.testing.assert_close(got.values.cpu(), want.values, rtol=TOL,
                               atol=TOL)


FIELDS = ("values", "alpha", "r_obs", "overflow_mask", "zero_weight_mask")


@pytest.mark.parametrize("stage2,fused", [("tiled", True), ("local", True),
                                          ("naive", False)])
def test_graph_replay_equals_eager(cuda, stage2, fused):
    pts = spatial_points(8192, seed=0)
    qs = spatial_queries(3000, seed=1)
    sess = InterpolationSession(pts, P.AidwConfig(stage2=stage2, fused=fused),
                                device=cuda)
    assert sess.precompile(max_queries=1024) == [64, 128, 256, 512, 1024]
    assert sess.stats["aot_buckets"] == 5
    hist = sess.registry.snapshot()["histograms"]["session/compile_s"]
    assert hist["count"] == 5
    for n in (1024, 777, 64, 1):     # exact and odd batches in captured buckets
        replay = sess.query(qs[:n])
        eager = sess.query(qs[:n], profile=True)
        for name in FIELDS:
            assert torch.equal(getattr(replay, name), getattr(eager, name)), \
                (n, name)
    # naive Stage 2 is plain torch ops: its graphs hold no hand-written kernel
    assert bool(sess.graph_launches()) == (stage2 != "naive")
    misses = sess.stats["bucket_misses"]
    sess.query(qs[:2000])            # an uncaptured bucket runs eagerly
    assert sess.stats["bucket_misses"] == misses + 1


@pytest.mark.parametrize("n_points", [8_192, 500])
def test_graph_replay_of_split_and_whole_buckets(cuda, n_points):
    """Bucket 1,024 over 8,192 points splits the data axis (16 tiles); over
    500 points (one tile) it stays whole.  Replays equal eager bitwise."""
    pts = spatial_points(n_points, seed=0)
    qs = spatial_queries(1_024, seed=1)
    sess = InterpolationSession(pts, P.AidwConfig(stage2="tiled", fused=True),
                                device=cuda)
    m = -(-sess.plan.points_xy.shape[0] // 512) * 512
    splits = AK.tiled_splits(1_024, m, fused=True, device=cuda)
    assert (splits > 1) == (n_points > 512)
    sess.precompile(buckets=[1_024])
    for n in (1_024, 999):
        replay = sess.query(qs[:n])
        eager = sess.query(qs[:n], profile=True)
        for name in FIELDS:
            assert torch.equal(getattr(replay, name), getattr(eager, name)), \
                (n, name)
    assert sess.graph_launches() == {"aidw_tiled_kernel": 2}


def test_graph_results_survive_replay_and_update_drops_graphs(cuda):
    pts = spatial_points(8192, seed=0)
    qs = spatial_queries(512, seed=1)
    sess = InterpolationSession(pts, P.AidwConfig(stage2="tiled", fused=True),
                                device=cuda)
    sess.precompile(buckets=[512])
    first = sess.query(qs)
    kept = first.values.clone()
    sess.query(qs.copy()[::-1].copy())      # replays into the same buffers
    assert torch.equal(first.values, kept)
    assert sess.graph_launches() == {"aidw_tiled_kernel": 2}
    sess.update(pts[:4000])
    assert sess.stats["aot_buckets"] == 0 and sess.graph_launches() == {}
    assert sess.registry.snapshot()["gauges"]["compiled_buckets"] == 0.0
    want = InterpolationSession(pts[:4000],
                                P.AidwConfig(stage2="tiled", fused=True),
                                device=cuda).query(qs)
    assert torch.equal(sess.query(qs).values, want.values)
