"""Flat-API dense-layout bridge (round-4 VERDICT #6).

A user porting reference code calls the flat (packed) API; when the
packed layout provably is a flat view of a dense ray-major fixed-K
buffer (iota-like ``ray_indices`` or ``packed_info`` rows ``[r*K, K]``),
the flat entry points reroute to the dense row-op twins (row cumsums
instead of per-sample gathers). These tests pin: detection
(positive and negative), exactness of the rerouted result against the
forced segmented path, and that traced (jit) calls skip the value-based
check without error.

Reference call shapes matched: reference ``nerfacc/
vol_rendering.py:201-449`` (ray_indices/packed_info kwargs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nerfacc_tpu.vol_rendering as vr
from nerfacc_tpu import (
    accumulate_along_rays,
    loss_distortion,
    ray_resampling,
    render_visibility,
    render_weight_from_alpha,
    render_weight_from_density,
)
from nerfacc_tpu.vol_rendering import _detect_dense_layout


def _fixture(R=6, K=8, seed=0):
    rng = np.random.RandomState(seed)
    ts = jnp.asarray(np.sort(rng.rand(R, K), axis=1), jnp.float32)
    te = ts + jnp.asarray(rng.rand(R, K) * 0.1 + 0.01, jnp.float32)
    sig = jnp.asarray(rng.rand(R, K) * 3, jnp.float32)
    m = jnp.asarray(rng.rand(R, K) < 0.7)
    idx = jnp.repeat(jnp.arange(R, dtype=jnp.int32), K)
    info = jnp.stack(
        [jnp.arange(R, dtype=jnp.int32) * K,
         jnp.full((R,), K, jnp.int32)], axis=-1,
    )
    return ts, te, sig, m, idx, info


def test_detection_positive_and_negative():
    ts, te, sig, m, idx, info = _fixture()
    R, K = sig.shape
    N = R * K
    assert _detect_dense_layout(idx, None, N, R) == (K, R)
    assert _detect_dense_layout(None, info, N, R) == (K, R)
    # ragged packed_info: no reroute
    ragged = jnp.asarray([[0, 3], [3, 5]], jnp.int32)
    assert _detect_dense_layout(None, ragged, 8, None) is None
    # non-iota ray_indices of the right cardinality: no reroute
    bad = idx.at[3].set(5)
    assert _detect_dense_layout(bad, None, N, R) is None
    # wrong divisibility: no reroute
    assert _detect_dense_layout(idx[:-1], None, N - 1, R) is None
    # traced: no reroute, no error
    traced_seen = []

    @jax.jit
    def f(i):
        traced_seen.append(_detect_dense_layout(i, None, N, R))
        return i

    f(idx)
    assert traced_seen == [None]


@pytest.mark.parametrize("via", ["ray_indices", "packed_info"])
def test_bridged_results_match_segmented(via):
    ts, te, sig, m, idx, info = _fixture()
    R, K = sig.shape
    kw = (
        dict(ray_indices=idx, n_rays=R)
        if via == "ray_indices"
        else dict(packed_info=info)
    )
    alphas = 1 - jnp.exp(-sig * 0.05)

    def run_all():
        w = render_weight_from_density(
            ts.reshape(-1, 1), te.reshape(-1, 1), sig.reshape(-1, 1),
            masks=m.reshape(-1), **kw,
        )
        wa = render_weight_from_alpha(
            alphas.reshape(-1, 1), masks=m.reshape(-1), **kw
        )
        vis = render_visibility(
            alphas.reshape(-1, 1), masks=m.reshape(-1),
            early_stop_eps=0.05, alpha_thre=0.1, **kw,
        )
        acc = accumulate_along_rays(
            w.reshape(-1), idx, values=jnp.ones((R * K, 3)), n_rays=R,
            masks=m.reshape(-1),
        )
        dist = loss_distortion(
            kw.get("packed_info"), w.reshape(-1), ts.reshape(-1, 1),
            te.reshape(-1, 1), masks=m.reshape(-1),
            **({} if via == "packed_info" else kw),
        )
        rs = ray_resampling(
            kw.get("packed_info"), ts.reshape(-1, 1), te.reshape(-1, 1),
            jnp.where(m, sig, 0.0).reshape(-1), 16,
            masks=m.reshape(-1),
            **({} if via == "packed_info" else kw),
        )
        return w, wa, vis, acc, dist, rs

    got = run_all()  # bridge on (default)
    vr.DENSE_BRIDGE = False
    try:
        want = run_all()  # forced segmented path
    finally:
        vr.DENSE_BRIDGE = True

    for g, w_ in zip(got[:2], want[:2]):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w_), rtol=1e-5, atol=1e-6
        )
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(
        np.asarray(got[3]), np.asarray(want[3]), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got[4]), np.asarray(want[4]), rtol=1e-4, atol=1e-6
    )
    for g, w_ in zip(got[5], want[5]):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w_), rtol=1e-4, atol=1e-5
        )


def test_bridge_gradients_match_segmented():
    ts, te, sig, m, idx, _ = _fixture(seed=3)
    R, K = sig.shape

    def loss(s, bridged):
        vr.DENSE_BRIDGE = bridged
        try:
            # eager (non-jit) grad still traces; the bridge decision is
            # made at call time on concrete idx only outside grad -- so
            # exercise the eager-value path via np before/after instead
            w = render_weight_from_density(
                ts.reshape(-1, 1), te.reshape(-1, 1), s.reshape(-1, 1),
                ray_indices=idx, n_rays=R, masks=m.reshape(-1),
            )
            return jnp.sum(w ** 2)
        finally:
            vr.DENSE_BRIDGE = True

    g1 = jax.grad(lambda s: loss(s, True))(sig)
    g0 = jax.grad(lambda s: loss(s, False))(sig)
    np.testing.assert_allclose(
        np.asarray(g1), np.asarray(g0), rtol=1e-4, atol=1e-6
    )
