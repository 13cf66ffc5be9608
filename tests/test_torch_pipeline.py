"""Port parity: the end-to-end single-device pipeline and session of
repro_torch against repro, on the CPU.

Tolerances: r_obs and alpha within 1e-6, overflow masks exactly, values
within 2e-5 (another summation order in Stage 2; the local path differs only
by the ulp-level pow and d2 roundings).  The port's own contracts are
bitwise: a warm session query equals a cold ``aidw_improved``.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as JP, session as JS  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.obs import metrics as JM  # noqa: E402
from repro_torch.core import pipeline as TP, session as TS  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.obs import metrics as TM  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
R_TOL = 1e-6
VAL_TOL = 2e-5
CONFIGS = [(s, f) for s in ("naive", "tiled", "local") for f in (False, True)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _compare(tres, jres):
    _close(tres.r_obs, jres.r_obs, R_TOL)
    _close(tres.alpha, jres.alpha, R_TOL)
    np.testing.assert_allclose(tres.values.numpy(), np.asarray(jres.values),
                               rtol=VAL_TOL, atol=VAL_TOL)
    if jres.overflow_mask is not None:
        assert np.array_equal(tres.overflow_mask.numpy(),
                              np.asarray(jres.overflow_mask))
    assert np.array_equal(tres.zero_weight_mask.numpy(),
                          np.asarray(jres.zero_weight_mask))


@pytest.mark.parametrize("stage2,fused", CONFIGS)
def test_aidw_improved_matches_reference(spatial_data, stage2, fused):
    pts, qs = spatial_data
    jres = JP.aidw_improved(pts, qs, JP.AidwConfig(stage2=stage2, fused=fused))
    tres = TP.aidw_improved(pts, qs, TP.AidwConfig(stage2=stage2, fused=fused),
                            device="cpu")
    _compare(tres, jres)
    assert tres.overflow == jres.overflow


def test_clustered_overflow_mask_matches_reference():
    """Clustered data with a small window: overflowed queries are flagged
    identically (their values are approximate in both packages)."""
    pts = JD.spatial_points(2048, seed=3, clustered=True)
    qs = JD.spatial_queries(256, seed=4)
    cfg = dict(stage2="local", window=32)
    jres = JP.aidw_improved(pts, qs, JP.AidwConfig(**cfg))
    tres = TP.aidw_improved(pts, qs, TP.AidwConfig(**cfg), device="cpu")
    assert np.asarray(jres.overflow_mask).any()
    _compare(tres, jres)


@pytest.mark.parametrize("stage2,fused", [("naive", False), ("tiled", False),
                                          ("tiled", True), ("local", True)])
def test_stage2_on_reference_plan(spatial_data, stage2, fused):
    """A JAX plan, pulled to numpy and carried across with
    ``plan_from_reference``, gives the reference's results."""
    pts, qs = spatial_data
    jcfg = JP.AidwConfig(stage2=stage2, fused=fused)
    jpln = JP.plan(pts, jcfg, query_domain=qs)
    tpln = TP.plan_from_reference(
        tuple(jpln.spec), [np.asarray(a) for a in jpln.table],
        np.asarray(jpln.points_xy), np.asarray(jpln.values), jpln.n_points,
        jpln.area, TP.AidwConfig(stage2=stage2, fused=fused), device="cpu")
    assert tpln.points_xy.shape == tuple(jpln.points_xy.shape)
    _compare(TP.execute(tpln, qs), JP.execute(jpln, jnp.asarray(qs)))


def test_plan_matches_reference_plan(spatial_data):
    """The port's own plan equals the reference's, padding included."""
    pts, qs = spatial_data
    pts = pts[:2000]                    # pads to 2048 capacity rows
    jpln = JP.plan(pts, JP.AidwConfig(), query_domain=qs)
    tpln = TP.plan(pts, TP.AidwConfig(), query_domain=qs, device="cpu")
    assert tuple(tpln.spec) == tuple(jpln.spec)
    assert (tpln.n_points, tpln.area) == (jpln.n_points, jpln.area)
    for a, b in zip(tpln.table, jpln.table):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tpln.points_xy.numpy(), np.asarray(jpln.points_xy))
    assert np.array_equal(tpln.values.numpy(), np.asarray(jpln.values))
    assert np.array_equal(TP.plan_host_points(tpln),
                          JP.plan_host_points(jpln))


@pytest.mark.parametrize("stage2,fused", [("naive", False), ("tiled", True),
                                          ("local", True)])
def test_session_warm_query_equals_cold(spatial_data, stage2, fused):
    pts, qs = spatial_data
    cfg = TP.AidwConfig(stage2=stage2, fused=fused)
    sess = TS.InterpolationSession(pts, cfg, query_domain=qs, device="cpu")
    cold = TP.aidw_improved(pts, qs, cfg, device="cpu")
    for n in (300, 512, 300):           # padded bucket, exact bucket, hit
        warm = sess.query(qs[:n])
        for name in ("values", "alpha", "r_obs", "overflow_mask",
                     "zero_weight_mask"):
            assert torch.equal(getattr(warm, name), getattr(cold, name)[:n])
    assert sess.stats["bucket_misses"] == 1 and sess.stats["bucket_hits"] == 2
    assert sess.stats["stage1_builds"] == 1
    assert sess.stats["queries"] == 1112 and sess.stats["batches"] == 3
    jsess = JS.InterpolationSession(pts, JP.AidwConfig(stage2=stage2,
                                                       fused=fused),
                                    query_domain=qs)
    _compare(sess.query(qs[:300]), jsess.query(qs[:300]))


def test_session_profile_and_timings(spatial_data):
    pts, qs = spatial_data
    sess = TS.InterpolationSession(pts, TP.AidwConfig(stage2="tiled"),
                                   device="cpu")
    plain = sess.query(qs)
    assert plain.timings == {}
    prof = sess.query(qs, profile=True)
    assert torch.equal(prof.values, plain.values)
    assert set(prof.timings) == {"query", "stage1", "stage2", "bucket"}
    timed = sess.query(qs[:100], timings=True)
    assert timed.timings["bucket"] == 128
    hist = sess.registry.snapshot()["histograms"]
    assert hist["session/stage1_s"]["count"] == 1
    assert hist["session/query_s"]["count"] == 2
    assert hist["session/plan_s"]["count"] == 1
    sess.update(pts[:1000])
    assert sess.stats["stage1_builds"] == 2
    assert sess.stats["n_points"] == 1000
    assert sess.plan.points_xy.shape[0] == 1024


def test_bucket_size_matches_reference():
    for n in (1, 63, 64, 65, 1000, 70_001):
        for mb in (1, 48, 64):
            assert TS.bucket_size(n, mb) == JS.bucket_size(n, mb)
    with pytest.raises(ValueError):
        TS.bucket_size(0)


def test_unported_session_features_raise(spatial_data):
    """mesh= (A10) and delta updates (A7) still raise; precompile (A6) is
    ported: the reference's ladder, and a ValueError without a size."""
    pts, _ = spatial_data
    with pytest.raises(NotImplementedError, match="A10"):
        TS.InterpolationSession(pts, mesh=object(), device="cpu")
    sess = TS.InterpolationSession(pts[:256], device="cpu")
    assert sess.precompile(max_queries=256) == [64, 128, 256]
    with pytest.raises(ValueError, match="max_queries"):
        sess.precompile()
    with pytest.raises(NotImplementedError, match="A7"):
        sess.update(inserts=pts[:3])


@pytest.mark.parametrize("min_bucket,max_queries", [
    (64, 256), (64, 1), (64, 1000), (1, 70_001), (48, 300), (128, 100)])
def test_bucket_ladder_matches_reference(spatial_data, min_bucket,
                                         max_queries):
    pts, qs = spatial_data
    tsess = TS.InterpolationSession(pts, min_bucket=min_bucket, device="cpu")
    jsess = JS.InterpolationSession(pts, min_bucket=min_bucket)
    assert tsess.bucket_ladder(max_queries) == \
        jsess.bucket_ladder(max_queries)


def test_precompile_bookkeeping_on_cpu(spatial_data):
    """On the CPU nothing is captured (``aot_buckets`` stays 0, the gauge
    reads 0), precompiled buckets count as hits, ``buckets=`` entries round
    to their bucket, ``warm=True`` runs each bucket once, and
    ``compiler_options`` has no counterpart."""
    pts, qs = spatial_data
    sess = TS.InterpolationSession(pts, device="cpu")
    assert sess.precompile(buckets=[100, 3, 128, 500], warm=True) == \
        [64, 128, 512]
    assert sess.stats["aot_buckets"] == 0
    assert sess.stats["batches"] == 3
    assert sess.stats["bucket_hits"] == 3 and sess.stats["bucket_misses"] == 0
    assert sess.registry.snapshot()["gauges"]["compiled_buckets"] == 0.0
    assert "session/compile_s" not in sess.registry.snapshot()["histograms"]
    assert sess.graph_launches() == {}
    for n in (40, 100, 300):
        sess.query(qs[:n])
    assert sess.stats["bucket_hits"] == 6 and sess.stats["bucket_misses"] == 0
    sess.query(np.concatenate([qs, qs]))
    assert sess.stats["bucket_misses"] == 1
    with pytest.raises(ValueError, match="compiler_options"):
        sess.precompile(max_queries=64, compiler_options={})


def test_no_cuda_and_no_device_raises(spatial_data, monkeypatch):
    """Without a card the port refuses rather than quietly using the CPU."""
    pts, qs = spatial_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.InterpolationSession(pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.plan(pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.aidw_improved(pts, qs)


def test_original_and_standard_idw_match_reference(spatial_data):
    pts, qs = spatial_data
    jres = JP.aidw_original(pts, qs)
    tres = TP.aidw_original(pts, qs, device="cpu")
    _close(tres.r_obs, jres.r_obs, R_TOL)
    _close(tres.alpha, jres.alpha, R_TOL)
    np.testing.assert_allclose(tres.values.numpy(), np.asarray(jres.values),
                               rtol=VAL_TOL, atol=VAL_TOL)
    for cfg in ({}, {"stage2": "tiled"}):
        want = JP.idw_standard(pts, qs, 2.5, JP.AidwConfig(**cfg))
        got = TP.idw_standard(pts, qs, 2.5, TP.AidwConfig(**cfg),
                              device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=VAL_TOL, atol=VAL_TOL)


def test_config_round_trips():
    """Every reference AidwConfig field exists in the port, 'global' is
    normalised the same way."""
    jf = JP.AidwConfig.__dataclass_fields__
    assert set(TP.AidwConfig.__dataclass_fields__) == set(jf)
    cfg = JP.AidwConfig(stage2="global", k=7, tile_q=64)
    tcfg = TP.AidwConfig(**{f: getattr(cfg, f) for f in jf})
    assert tcfg.stage2 == "naive" and tcfg.k == 7 and tcfg.tile_q == 64


@pytest.mark.parametrize("kw", [{}, {"clustered": True}, {"noise": 0.1}])
def test_data_generators_identical(kw):
    assert np.array_equal(TD.spatial_points(777, seed=3, **kw),
                          JD.spatial_points(777, seed=3, **kw))
    assert np.array_equal(TD.spatial_queries(99, seed=4),
                          JD.spatial_queries(99, seed=4))


def test_histogram_matches_reference():
    rng = np.random.default_rng(0)
    th, jh = TM.Histogram(), JM.Histogram()
    for s in rng.lognormal(-6, 2, 500):
        th.record(s)
        jh.record(s)
    snap = jh.snapshot()
    assert th.snapshot() == {k: snap[k] for k in th.snapshot()}
    reg = TM.Registry()
    reg.set("compiled_buckets", 3, merge="max")
    reg.observe("session/query_s", 0.01)
    assert reg.snapshot()["gauges"] == {"compiled_buckets": 3.0}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_imports_neither_jax_nor_reference():
    """No file of the port, not chip_smoke.py and no script under tools/
    imports jax or repro."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("*.py"))]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, name)
