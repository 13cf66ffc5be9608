"""The tiled Stage-2 kernel's data-axis split, on the CPU: the split planner
as a pure function, and the twin's split summation order against the JAX
package's Pallas ops (interpret mode) on the same seeded numpy inputs.

Tolerances: values within 2e-5 (another summation order, the reference's
own kernel tolerance); zero-weight masks equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.aidw import ops as jops  # noqa: E402
from repro_torch.kernels.aidw import aidw_kernel as AK  # noqa: E402
from repro_torch.kernels.aidw import ops as tops  # noqa: E402

TOL = 2e-5
H100_SMS = AK.REFERENCE_SMS
# the default tiles: 256 queries a CTA at 2 a thread, 512 points a tile
H100_CTAS = AK.reference_ctas_per_sm(2, 128, 512, True)

# cudaOccupancyMaxActiveBlocksPerMultiprocessor on an NVIDIA H100 80GB HBM3
# for the built kernel, as tools/tiled_sweep.py prints it:
# (q, threads, tile_d, fused, resident CTAs per SM)
H100_OCCUPANCY = [
    (1, 256, 512, False, 5), (1, 256, 512, True, 5), (1, 8, 128, False, 32),
    (1, 8, 128, True, 32), (1, 128, 256, False, 10), (1, 128, 256, True, 10),
    (1, 256, 3072, False, 4), (1, 256, 3072, True, 4), (1, 64, 128, False, 20),
    (1, 64, 128, True, 20), (1, 1024, 512, False, 1), (1, 1024, 512, True, 1),
    (2, 128, 512, False, 12), (2, 128, 512, True, 12), (2, 4, 128, False, 32),
    (2, 4, 128, True, 32), (2, 64, 256, False, 24), (2, 64, 256, True, 24),
    (2, 128, 3072, False, 4), (2, 128, 3072, True, 4), (2, 32, 128, False, 32),
    (2, 32, 128, True, 32), (2, 512, 512, False, 3), (2, 512, 512, True, 3),
    (4, 64, 512, False, 20), (4, 64, 512, True, 20), (4, 2, 128, False, 32),
    (4, 2, 128, True, 32), (4, 32, 256, False, 32), (4, 32, 256, True, 32),
    (4, 64, 3072, False, 4), (4, 64, 3072, True, 4), (4, 16, 128, False, 32),
    (4, 16, 128, True, 32), (4, 256, 512, False, 5), (4, 256, 512, True, 5)]


def _data(n, m, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.random((n, 2)).astype(np.float32)
    p = rng.random((m, 2)).astype(np.float32)
    z = np.sin(rng.random(m) * 7).astype(np.float32)
    a = rng.uniform(0.5, 4.0, n).astype(np.float32)
    return q, p, z, a


def _t(a):
    return torch.from_numpy(np.array(a))


def _plan(n, m, tile_q=256, tile_d=512):
    return AK.plan_splits(n, m, tile_q, tile_d, sms=H100_SMS,
                          ctas_per_sm=H100_CTAS)


@pytest.mark.parametrize("q,threads,tile_d,fused,ctas", H100_OCCUPANCY)
def test_reference_occupancy_matches_the_card(q, threads, tile_d, fused,
                                              ctas):
    """The CPU path's occupancy model gives what the occupancy API gave on
    the card for these instances and tiles."""
    assert AK.reference_ctas_per_sm(q, threads, tile_d, fused) == ctas


def test_planner_keeps_the_largest_batch_in_one_launch():
    assert H100_CTAS == 12
    assert _plan(262_144, 262_144) == 1
    assert _plan(131_072, 262_144) > 1


@pytest.mark.parametrize("n", [1, 1_000, 1_024])
def test_planner_splits_small_batches(n):
    assert _plan(n, 262_144) > 1
    assert _plan(n, 65_536) > 1


@pytest.mark.parametrize("n,m,tile_q,tile_d", [
    (1, 262_144, 256, 512), (1_024, 65_536, 256, 512), (8, 128, 8, 128),
    (64, 1_024, 8, 128), (4_096, 3_072, 256, 3_072), (0, 512, 256, 512),
    (1, 0, 256, 512)])
def test_planner_never_exceeds_the_data_tiles(n, m, tile_q, tile_d):
    s = AK.plan_splits(n, m, tile_q, tile_d, sms=H100_SMS,
                       ctas_per_sm=H100_CTAS)
    assert 1 <= s <= max(1, m // tile_d)


@pytest.mark.parametrize("m,sms,ctas", [(262_144, 132, H100_CTAS),
                                        (65_536, 132, H100_CTAS),
                                        (262_144, 8, 3), (4_096, 132, 32)])
def test_planner_is_non_increasing_in_n(m, sms, ctas):
    got = [AK.plan_splits(n, m, 256, 512, sms=sms, ctas_per_sm=ctas)
           for n in range(256, 1_200_000, 1024)]
    assert all(a >= b for a, b in zip(got, got[1:]))
    assert got[-1] == 1


@pytest.mark.parametrize("tile_q,q", [(256, 2), (1024, 4), (512, 4),
                                      (600, 4), (384, 2), (258, 2),
                                      (128, 1), (64, 1), (8, 1), (1, 1),
                                      (100, 1)])
def test_queries_per_thread_keeps_four_warps(tile_q, q):
    assert AK.queries_per_thread(tile_q) == q
    assert tile_q % q == 0


@pytest.mark.parametrize("splits", [1, 2, 7])
@pytest.mark.parametrize("fused", [False, True])
def test_split_twin_matches_reference(splits, fused):
    """The twin's split order agrees with the JAX Pallas op (interpret
    mode): 700 queries, 1,300 points in 3 tiles of 512 (the last padded),
    so 7 splits clamp to the 3 tiles' chunk bounds."""
    n, m, tq, td = 700, 1300, 256, 512
    q, p, z, a = _data(n, m, seed=11)
    r_obs = np.random.default_rng(12).uniform(0, 0.1, n).astype(np.float32)
    aux = r_obs if fused else a
    if fused:
        jout, jzero = jops.fused_stage2(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(z),
            jnp.asarray(r_obs), n_points=m, area=1.0, tile_q=tq, tile_d=td,
            interpret=True)
        stats = tops.stats_tensor(m, 1.0, "cpu")
    else:
        jout, jzero = jops.tiled_interpolate(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(z), jnp.asarray(a),
            tile_q=tq, tile_d=td, interpret=True)
        stats = tops.stats_tensor(1.0, 1.0, "cpu")
    args = tops.tiled_inputs(_t(q), _t(p), _t(z), _t(aux), tile_q=tq,
                             tile_d=td)
    out, sw = AK.tiled_interpolate_plain(*args[:3], stats, *args[3:],
                                         fused=fused, splits=splits,
                                         tile_d=td)
    np.testing.assert_allclose(out[:n].numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    assert np.array_equal((sw[:n] <= 0).numpy(), np.asarray(jzero))


def test_split_twin_default_is_one_running_sum():
    """``splits=1`` (the default) is bitwise the unsplit order, and a split
    changes the bits only within rounding."""
    q, p, z, a = _data(300, 5000, seed=13)
    args = tops.tiled_inputs(_t(q), _t(p), _t(z), _t(a), tile_q=64,
                             tile_d=256)
    stats = tops.stats_tensor(1.0, 1.0, "cpu")
    base = AK.tiled_interpolate_plain(*args[:3], stats, *args[3:])
    one = AK.tiled_interpolate_plain(*args[:3], stats, *args[3:], splits=1,
                                     tile_d=256)
    assert torch.equal(base[0], one[0]) and torch.equal(base[1], one[1])
    for splits in (2, 7, 20):
        out, sw = AK.tiled_interpolate_plain(*args[:3], stats, *args[3:],
                                             splits=splits, tile_d=256)
        torch.testing.assert_close(out, base[0], rtol=TOL, atol=TOL)
        torch.testing.assert_close(sw, base[1], rtol=TOL, atol=0)


def test_cpu_wrapper_adds_in_the_planned_order():
    """On a CPU tensor the kernel wrapper runs the twin with the splits the
    planner gives the reference card, so its bits are the twin's at that
    split."""
    q, p, z, a = _data(1000, 20_000, seed=14)
    args = tops.tiled_inputs(_t(q), _t(p), _t(z), _t(a), tile_q=256,
                             tile_d=512)
    stats = tops.stats_tensor(1.0, 1.0, "cpu")
    n, m = args[0].shape[0], args[3].shape[0]
    splits = AK.tiled_splits(n, m, tile_q=256, tile_d=512)
    assert splits == _plan(n, m) > 1
    out, sw = AK.tiled_interpolate_kernel(*args[:3], stats, *args[3:],
                                          tile_q=256, tile_d=512)
    want, wsw = AK.tiled_interpolate_plain(*args[:3], stats, *args[3:],
                                           splits=splits, tile_d=512)
    assert torch.equal(out, want) and torch.equal(sw, wsw)
