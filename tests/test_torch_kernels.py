"""Port parity: the Stage-2 kernel ops of repro_torch against repro's Pallas
ops (run in interpret mode), on the CPU, where every wrapper takes its plain
PyTorch twin.

Tolerances: tiled values within 2e-5 (another summation order, the
reference's own kernel tolerance), bf16 within 5e-2, the local path bitwise
against the reference's top-k path (same sequential op order and libm pow).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import aidw as JA, brute_knn  # noqa: E402
from repro.kernels.aidw import ops as jops, ref as jref  # noqa: E402
from repro_torch.core import aidw as TA  # noqa: E402
from repro_torch.kernels.aidw import ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels.aidw.aidw_kernel import (  # noqa: E402
    local_interpolate_kernel, reset_launches, tiled_interpolate_kernel)

TOL = 2e-5


def _data(n, m, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.random((n, 2)).astype(np.float32)
    p = rng.random((m, 2)).astype(np.float32)
    z = np.sin(rng.random(m) * 7).astype(np.float32)
    a = rng.uniform(0.5, 4.0, n).astype(np.float32)
    return q, p, z, a


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("n,m,tq,td", [
    (256, 512, 256, 512),     # exact tile fit
    (700, 1300, 256, 512),    # ragged both axes
    (64, 100, 8, 128),        # tiny tiles
    (1024, 256, 512, 128),    # more queries than data
    (1, 1, 8, 128),           # degenerate
])
def test_tiled_interpolate_shapes(n, m, tq, td):
    q, p, z, a = _data(n, m)
    jout, jzero = jops.tiled_interpolate(jnp.asarray(q), jnp.asarray(p),
                                         jnp.asarray(z), jnp.asarray(a),
                                         tile_q=tq, tile_d=td, interpret=True)
    out, zero = tops.tiled_interpolate(_t(q), _t(p), _t(z), _t(a),
                                       tile_q=tq, tile_d=td)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    assert np.array_equal(zero.numpy(), np.asarray(jzero))
    np.testing.assert_allclose(
        out.numpy(), tref.interpolate_ref(_t(q), _t(p), _t(z), _t(a)).numpy(),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
def test_tiled_interpolate_dtypes(dtype, tol):
    q, p, z, a = _data(300, 600)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jout, _ = jops.tiled_interpolate(jnp.asarray(q, jd), jnp.asarray(p, jd),
                                     jnp.asarray(z, jd), jnp.asarray(a, jd),
                                     tile_q=128, tile_d=256, interpret=True)
    out, _ = tops.tiled_interpolate(_t(q, td), _t(p, td), _t(z, td),
                                    _t(a, td), tile_q=128, tile_d=256)
    assert out.dtype == td
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=tol, atol=tol)
    want = jref.interpolate_ref(jnp.asarray(q, jd), jnp.asarray(p, jd),
                                jnp.asarray(z, jd), jnp.asarray(a, jd))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_fused_stage2_matches_reference():
    q, p, z, _ = _data(300, 600, seed=3)
    r_obs = np.random.default_rng(4).uniform(0, 0.1, 300).astype(np.float32)
    want = jref.fused_stage2_ref(jnp.asarray(q), jnp.asarray(p),
                                 jnp.asarray(z), jnp.asarray(r_obs),
                                 n_points=600, area=1.0)
    jout, _ = jops.fused_stage2(jnp.asarray(q), jnp.asarray(p),
                                jnp.asarray(z), jnp.asarray(r_obs),
                                n_points=600, area=1.0, tile_q=128,
                                tile_d=256, interpret=True)
    out, zero = tops.fused_stage2(_t(q), _t(p), _t(z), _t(r_obs),
                                  n_points=600, area=1.0, tile_q=128,
                                  tile_d=256)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        out.numpy(), tref.fused_stage2_ref(_t(q), _t(p), _t(z), _t(r_obs),
                                           n_points=600, area=1.0).numpy(),
        rtol=TOL, atol=TOL)
    assert not zero.any()


@pytest.mark.parametrize("n,m,k", [
    (256, 512, 15), (300, 600, 7), (33, 90, 15), (1, 64, 3)])
def test_local_interpolate_bitwise_vs_reference_topk(n, m, k):
    """The local op equals the reference's top-k path bit for bit (and the
    reference's Pallas local kernel, which equals that path too)."""
    q, p, z, a = _data(n, m, seed=5)
    d2, idx = brute_knn(jnp.asarray(p), jnp.asarray(q), k)
    swz, sw = JA.topk_weighted_partial_sums(d2, jnp.asarray(z)[idx],
                                            jnp.asarray(a))
    want, wzero = JA.guarded_values(swz, sw)
    out, zero = tops.local_interpolate(_t(d2), _t(idx, torch.int64), _t(z),
                                       _t(a), tile_q=64)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert np.array_equal(zero.numpy(), np.asarray(wzero))
    jout, _ = jops.local_interpolate(d2, idx, jnp.asarray(z), jnp.asarray(a),
                                     tile_q=64, interpret=True)
    assert np.array_equal(out.numpy(), np.asarray(jout))


def test_fused_local_stage2_bitwise():
    """In-kernel alpha (the fused twin) is bitwise the host adaptive_alpha ->
    unfused chain, and the reference's fused local kernel."""
    q, p, z, _ = _data(300, 600, seed=6)
    d2, idx = brute_knn(jnp.asarray(p), jnp.asarray(q), 15)
    r_obs = np.asarray(jnp.sqrt(jnp.maximum(d2, 0.0)).mean(axis=1))
    td2, tidx = _t(d2), _t(idx, torch.int32)
    fused, fzero = tops.fused_local_stage2(td2, tidx, _t(z), _t(r_obs),
                                           n_points=600, area=1.0,
                                           tile_q=128)
    alpha = TA.adaptive_alpha(_t(r_obs), 600, 1.0)
    unf, uzero = tops.local_interpolate(td2, tidx, _t(z), alpha, tile_q=128)
    assert np.array_equal(fused.numpy(), unf.numpy())
    assert np.array_equal(fzero.numpy(), uzero.numpy())
    jout, _ = jops.fused_local_stage2(d2, idx, jnp.asarray(z),
                                      jnp.asarray(r_obs),
                                      n_points=jnp.float32(600),
                                      area=jnp.float32(1.0), tile_q=128,
                                      interpret=True)
    assert np.array_equal(fused.numpy(), np.asarray(jout))


def test_tiled_zero_weight_sentinel():
    """A query beyond f32 range from all data underflows every weight: 0.0
    and a raised mask bit, never NaN (as the reference)."""
    q = np.array([[1e18, 1e18], [0.5, 0.5]], np.float32)
    p = np.random.default_rng(8).random((64, 2)).astype(np.float32)
    z = np.ones(64, np.float32)
    jout, jzero = jops.tiled_interpolate(jnp.asarray(q), jnp.asarray(p),
                                         jnp.asarray(z), 4.0, tile_q=8,
                                         tile_d=128, interpret=True)
    out, zero = tops.tiled_interpolate(_t(q), _t(p), _t(z), 4.0, tile_q=8,
                                       tile_d=128)
    assert not np.isnan(out.numpy()).any()
    assert zero[0] and out[0] == 0.0 and not zero[1]
    assert np.array_equal(zero.numpy(), np.asarray(jzero))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)


def test_local_zero_weight_sentinel():
    """All-inf neighbour distances: the 0.0 sentinel and a raised mask bit."""
    d2 = np.full((4, 8), np.inf, np.float32)
    idx = np.zeros((4, 8), np.int32)
    z = np.ones(16, np.float32)
    jout, jzero = jops.local_interpolate(jnp.asarray(d2), jnp.asarray(idx),
                                         jnp.asarray(z), 2.0, tile_q=8,
                                         interpret=True)
    out, zero = tops.local_interpolate(_t(d2), _t(idx, torch.int32), _t(z),
                                       2.0, tile_q=8)
    assert zero.all() and (out == 0.0).all()
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(zero.numpy(), np.asarray(jzero))


def test_launch_counters_stay_zero_on_cpu():
    """On CPU tensors the wrappers run their twins and count no launch."""
    reset_launches()
    q, p, z, a = _data(64, 128)
    tops.tiled_interpolate(_t(q), _t(p), _t(z), _t(a), tile_q=32, tile_d=64)
    tops.fused_stage2(_t(q), _t(p), _t(z), _t(a) * 0.01, n_points=128,
                      area=1.0, tile_q=32, tile_d=64)
    d2 = torch.rand(64, 5)
    idx = torch.randint(0, 128, (64, 5), dtype=torch.int32)
    tops.local_interpolate(d2, idx, _t(z), _t(a))
    tops.fused_local_stage2(d2, idx, _t(z), _t(a) * 0.01, n_points=128,
                            area=1.0)
    assert tiled_interpolate_kernel.launches == 0
    assert local_interpolate_kernel.launches == 0


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA reaches no path."""
    meta = torch.empty(8, device="meta")
    stats = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tiled_interpolate_kernel(meta, meta, meta, stats, meta, meta, meta,
                                 tile_q=8, tile_d=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        local_interpolate_kernel(torch.empty(8, 3, device="meta"),
                                 torch.empty(8, 3, dtype=torch.int32,
                                             device="meta"),
                                 meta, stats, meta)
