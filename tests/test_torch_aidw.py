"""Port parity: AIDW math (Eqs. 1-6) of repro_torch against repro, on the CPU.

The same seeded numpy inputs go through ``repro.core.aidw`` and
``repro_torch.core.aidw``.  Tolerances: alpha within 1e-6 (cos may differ
by an ulp across frameworks), weighted sums within 2e-5 (another summation
order).  Power-form weights agree within 1 ulp: PyTorch's vectorised CPU
``pow`` and XLA's are two f32 implementations, neither always correctly
rounded, which round ~2% of contiguous inputs one ulp apart.  The
sequential top-k sums are taken in the same order, so they differ by no
more than those weight ulps propagate (:func:`sums_bound`).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import aidw as JA  # noqa: E402
from repro_torch.core import aidw as TA  # noqa: E402

ALPHA_TOL = 1e-6
SUM_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def max_ulps(a, b) -> int:
    """Largest distance in f32 units in the last place (inf == inf)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def sums_bound(w, z):
    """How far two sequential sums of ``w * z`` over the last axis may drift
    when every weight may be one ulp off: (k + 2) ulps of sum |w z|."""
    k = w.shape[-1]
    return (k + 2) * 2.0 ** -23 * np.abs(np.asarray(w, np.float64)
                                         * np.asarray(z, np.float64)).sum(-1)


@pytest.mark.parametrize("r", [-1.0, 0.0, 0.5, 1.0, 1.5, 2.0, 5.0])
def test_fuzzy_membership_endpoints(r):
    want = float(JA.fuzzy_membership(jnp.float32(r)))
    got = float(TA.fuzzy_membership(torch.tensor(r, dtype=torch.float32)))
    assert got == pytest.approx(want, abs=ALPHA_TOL)


@pytest.mark.parametrize("mu,expect", [
    (0.0, 0.5), (0.1, 0.5), (0.2, 0.75), (0.3, 1.0), (0.4, 1.5), (0.5, 2.0),
    (0.6, 2.5), (0.7, 3.0), (0.8, 3.5), (0.9, 4.0), (1.0, 4.0)])
def test_alpha_triangular_breakpoints(mu, expect):
    want = float(JA.alpha_from_membership(jnp.float32(mu)))
    got = float(TA.alpha_from_membership(torch.tensor(mu, dtype=torch.float32)))
    assert got == pytest.approx(want, abs=ALPHA_TOL)
    assert got == pytest.approx(expect, abs=1e-5)


@pytest.mark.parametrize("n_points,area", [(1000, 1.0), (2048, 1.37),
                                           (65536, 0.25)])
def test_adaptive_alpha_matches_reference(n_points, area):
    rng = np.random.default_rng(n_points)
    r_exp = 1.0 / (2.0 * np.sqrt(n_points / area))
    r_obs = (rng.uniform(0.0, 2.5, 4000) * r_exp).astype(np.float32)
    r_obs[:3] = [0.0, 2 * r_exp, 1e18]
    want = np.asarray(JA.adaptive_alpha(jnp.asarray(r_obs),
                                        jnp.float32(n_points), area))
    got = TA.adaptive_alpha(_t(r_obs), n_points, area).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ALPHA_TOL)
    alphas = (0.25, 1.5, 2.0, 2.5, 5.0)
    want = np.asarray(JA.adaptive_alpha(jnp.asarray(r_obs),
                                        jnp.float32(n_points), area,
                                        alphas=alphas, r_min=0.1, r_max=1.8))
    got = TA.adaptive_alpha(_t(r_obs), n_points, area, alphas=alphas,
                            r_min=0.1, r_max=1.8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ALPHA_TOL)


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.random((n, 2)).astype(np.float32)
    p = rng.random((m, 2)).astype(np.float32)
    z = np.sin(rng.random(m) * 7).astype(np.float32)
    a = rng.uniform(0.5, 4.0, n).astype(np.float32)
    return q, p, z, a


@pytest.mark.parametrize("n,m,block,data_block", [
    (300, 700, 1024, 0), (300, 700, 64, 0), (300, 700, 64, 100),
    (129, 1000, 1000, 333)])
def test_weighted_partial_sums(n, m, block, data_block):
    q, p, z, a = _inputs(n, m, seed=n + m)
    jswz, jsw = JA.weighted_partial_sums(jnp.asarray(q), jnp.asarray(p),
                                         jnp.asarray(z), jnp.asarray(a),
                                         block, data_block)
    tswz, tsw = TA.weighted_partial_sums(_t(q), _t(p), _t(z), _t(a),
                                         block, data_block)
    np.testing.assert_allclose(tswz.numpy(), np.asarray(jswz), rtol=SUM_TOL,
                               atol=SUM_TOL)
    np.testing.assert_allclose(tsw.numpy(), np.asarray(jsw), rtol=SUM_TOL,
                               atol=SUM_TOL)
    want = np.asarray(JA.weighted_interpolate(jnp.asarray(q), jnp.asarray(p),
                                              jnp.asarray(z), jnp.asarray(a),
                                              block, data_block))
    got = TA.weighted_interpolate(_t(q), _t(p), _t(z), _t(a), block,
                                  data_block).numpy()
    np.testing.assert_allclose(got, want, rtol=SUM_TOL, atol=SUM_TOL)


def test_guarded_values_zero_sentinel():
    swz = np.array([1.0, 0.0, -2.0, 3.0], np.float32)
    sw = np.array([2.0, 0.0, 4.0, 0.0], np.float32)
    jv, jz = JA.guarded_values(jnp.asarray(swz), jnp.asarray(sw))
    tv, tz = TA.guarded_values(_t(swz), _t(sw))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tz.numpy(), np.asarray(jz))
    assert not np.isnan(tv.numpy()).any()


@pytest.mark.parametrize("k", [1, 7, 15])
def test_topk_weighted_partial_sums(k):
    rng = np.random.default_rng(k)
    d2 = (rng.random((500, k)) ** 2 * 1e-2).astype(np.float32)
    d2[:5, -1] = np.inf
    d2[5, 0] = 0.0
    z = rng.normal(size=(500, k)).astype(np.float32)
    a = rng.uniform(0.5, 4.0, 500).astype(np.float32)
    jswz, jsw = JA.topk_weighted_partial_sums(jnp.asarray(d2), jnp.asarray(z),
                                              jnp.asarray(a))
    tswz, tsw = TA.topk_weighted_partial_sums(_t(d2), _t(z), _t(a))
    w = np.asarray(JA.idw_weights_sq(jnp.asarray(d2), jnp.asarray(a)[:, None]))
    assert np.all(np.abs(tswz.numpy() - np.asarray(jswz)) <= sums_bound(w, z))
    assert np.all(np.abs(tsw.numpy() - np.asarray(jsw))
                  <= sums_bound(w, np.ones_like(z)))
    # the left-to-right order itself: the port's sums are bitwise a numpy
    # sequential sum of the port's own weights
    tw = TA.idw_weights_sq(_t(d2), _t(a)[:, None]).numpy()
    seq = tw[:, 0] * z[:, 0]
    for i in range(1, k):
        seq = (seq + tw[:, i] * z[:, i]).astype(np.float32)
    assert np.array_equal(tswz.numpy(), seq)


@pytest.mark.parametrize("per_query", [False, True])
def test_idw_weights_sq_within_one_ulp(per_query):
    rng = np.random.default_rng(3)
    d2 = np.concatenate([(rng.random(1000) ** 3).astype(np.float32),
                         np.array([0.0, np.inf, 1e-13], np.float32)])
    a = rng.uniform(0.5, 4.0, d2.shape).astype(np.float32) if per_query \
        else np.float32(2.7)
    want = np.asarray(JA.idw_weights_sq(jnp.asarray(d2), jnp.asarray(a)))
    got = TA.idw_weights_sq(_t(d2), _t(a)).numpy()
    assert max_ulps(got, want) <= 1
    assert got[-2] == want[-2] == 0.0      # d2 = inf weighs exactly 0
