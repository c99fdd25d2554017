"""Tests for the static-shape fast-path primitives: bit-table lookups, slot
selection (stream compaction without scatters), dense-row gathering, and
the dense (n_rays, K) rendering path — checked against the flat segmented
reference implementations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerfacc_tpu import (
    accumulate_along_rays,
    accumulate_along_rays_dense,
    create_grid,
    dilate_binary,
    gather_rows_dense,
    render_visibility,
    render_visibility_dense,
    render_weight_from_alpha,
    render_weight_from_alpha_dense,
    render_weight_from_density,
    render_weight_from_density_dense,
    select_slots,
    with_binary,
)
from nerfacc_tpu.lookup import bit_lookup, flat_lookup, pack_bits


def test_pack_bits_roundtrip():
    rng = np.random.RandomState(0)
    vals = rng.rand(5000) < 0.3
    table = pack_bits(jnp.asarray(vals))
    idx = jnp.asarray(rng.randint(0, 5000, size=777), jnp.int32)
    got = np.asarray(bit_lookup(table, idx))
    np.testing.assert_array_equal(got, vals[np.asarray(idx)])


def test_flat_lookup_matches_gather():
    rng = np.random.RandomState(1)
    vals = jnp.asarray(rng.randn(1000), jnp.float32)
    idx = jnp.asarray(rng.randint(0, 1000, size=333), jnp.int32)
    np.testing.assert_allclose(
        np.asarray(flat_lookup(vals, idx)), np.asarray(vals)[np.asarray(idx)]
    )


def test_select_slots_first_k():
    rng = np.random.RandomState(2)
    valid = rng.rand(37, 300) < 0.15
    pos, ok, scale = select_slots(jnp.asarray(valid), 16, decimate=False)
    pos, ok, scale = np.asarray(pos), np.asarray(ok), np.asarray(scale)
    for r in range(37):
        live = np.nonzero(valid[r])[0]
        k = min(16, len(live))
        assert ok[r, :k].all() and not ok[r, k:].any()
        np.testing.assert_array_equal(pos[r, :k], live[:16][:k])
        assert (scale[r, :k] == 1).all()


def test_select_slots_decimates():
    """Rows with more live entries than slots cover the whole live range
    with stride ceil(count / K); slot scales sum to the live count."""
    rng = np.random.RandomState(8)
    valid = rng.rand(23, 300) < 0.5  # ~150 live >> 16 slots
    K = 16
    pos, ok, scale = select_slots(jnp.asarray(valid), K)
    pos, ok, scale = np.asarray(pos), np.asarray(ok), np.asarray(scale)
    for r in range(23):
        live = np.nonzero(valid[r])[0]
        s = -(-len(live) // K)
        want_ranks = np.arange(K) * s
        real = want_ranks < len(live)
        np.testing.assert_array_equal(ok[r], real)
        np.testing.assert_array_equal(pos[r][real], live[want_ranks[real]])
        assert scale[r][real].sum() == len(live)
        # coverage: last selected sample is near the end of the live range
        assert pos[r][real][-1] >= live[-s]


def test_select_slots_all_and_none():
    valid = jnp.ones((4, 256), bool)
    pos, ok, scale = select_slots(valid, 8, decimate=False)
    np.testing.assert_array_equal(np.asarray(pos), np.tile(np.arange(8), (4, 1)))
    assert np.asarray(ok).all()
    pos, ok, scale = select_slots(jnp.zeros((4, 256), bool), 8)
    assert not np.asarray(ok).any()


def test_gather_rows_dense():
    rng = np.random.RandomState(3)
    vals = jnp.asarray(rng.randn(9, 40), jnp.float32)
    idx = jnp.asarray(rng.randint(0, 40, size=(9, 7)), jnp.int32)
    got = np.asarray(gather_rows_dense(vals, idx))
    want = np.take_along_axis(np.asarray(vals), np.asarray(idx), axis=1)
    np.testing.assert_allclose(got, want)


def test_dilate_binary():
    b = np.zeros((8, 8, 8), bool)
    b[4, 4, 4] = True
    d = np.asarray(dilate_binary(jnp.asarray(b)))
    want = np.zeros((8, 8, 8), bool)
    want[3:6, 3:6, 3:6] = True
    np.testing.assert_array_equal(d, want)
    # no wraparound at edges
    b2 = np.zeros((8, 8, 8), bool)
    b2[0, 0, 0] = True
    d2 = np.asarray(dilate_binary(jnp.asarray(b2)))
    assert not d2[-1].any() and not d2[:, -1].any() and not d2[:, :, -1].any()


def test_query_occ_fast_matches_query_occ():
    rng = np.random.RandomState(4)
    binary = rng.rand(16, 16, 16) < 0.4
    grid = with_binary(
        create_grid([0, 0, 0, 1, 1, 1], resolution=16), jnp.asarray(binary)
    )
    x = jnp.asarray(rng.rand(500, 3) * 1.4 - 0.2, jnp.float32)  # some outside
    np.testing.assert_array_equal(
        np.asarray(grid.query_occ_fast(x)), np.asarray(grid.query_occ(x))
    )


def _dense_fixture(seed=0, R=5, K=13):
    rng = np.random.RandomState(seed)
    t_starts = jnp.asarray(np.sort(rng.rand(R, K), axis=1), jnp.float32)
    t_ends = t_starts + jnp.asarray(rng.rand(R, K) * 0.1 + 0.01, jnp.float32)
    sigmas = jnp.asarray(rng.rand(R, K) * 3, jnp.float32)
    masks = jnp.asarray(rng.rand(R, K) < 0.7)
    return t_starts, t_ends, sigmas, masks


@pytest.fixture(autouse=True)
def _force_segmented_path():
    """These tests compare the flat segmented-scan implementation against
    the dense twins; the dense-layout bridge would reroute the flat calls
    to the very twin under comparison (vacuous). Force the segmented
    path."""
    import nerfacc_tpu.vol_rendering as vr

    old = vr.DENSE_BRIDGE
    vr.DENSE_BRIDGE = False
    yield
    vr.DENSE_BRIDGE = old


def _flatten(x):
    return x.reshape(-1, 1)


def _ray_ids(R, K):
    return jnp.repeat(jnp.arange(R, dtype=jnp.int32), K)


def test_dense_weights_match_flat():
    t_starts, t_ends, sigmas, masks = _dense_fixture()
    R, K = sigmas.shape
    w_dense = render_weight_from_density_dense(t_starts, t_ends, sigmas, masks)
    w_flat = render_weight_from_density(
        _flatten(t_starts), _flatten(t_ends), _flatten(sigmas),
        ray_indices=_ray_ids(R, K), n_rays=R, masks=masks.reshape(-1),
    )
    np.testing.assert_allclose(
        np.asarray(w_dense).reshape(-1), np.asarray(w_flat)[:, 0],
        rtol=1e-5, atol=1e-6,
    )


def test_dense_weights_from_alpha_match_flat():
    _, _, sigmas, masks = _dense_fixture(seed=1)
    alphas = 1 - jnp.exp(-sigmas * 0.05)
    R, K = alphas.shape
    w_dense = render_weight_from_alpha_dense(alphas, masks)
    w_flat = render_weight_from_alpha(
        _flatten(alphas), ray_indices=_ray_ids(R, K), n_rays=R,
        masks=masks.reshape(-1),
    )
    np.testing.assert_allclose(
        np.asarray(w_dense).reshape(-1), np.asarray(w_flat)[:, 0],
        rtol=1e-5, atol=1e-6,
    )


def test_dense_visibility_matches_flat():
    _, _, sigmas, masks = _dense_fixture(seed=2)
    alphas = 1 - jnp.exp(-sigmas * 0.3)
    R, K = alphas.shape
    v_dense = render_visibility_dense(alphas, masks, early_stop_eps=0.05,
                                      alpha_thre=0.2)
    v_flat = render_visibility(
        _flatten(alphas), ray_indices=_ray_ids(R, K), n_rays=R,
        masks=masks.reshape(-1), early_stop_eps=0.05, alpha_thre=0.2,
    )
    np.testing.assert_array_equal(
        np.asarray(v_dense).reshape(-1), np.asarray(v_flat)
    )


def test_dense_accumulate_matches_flat():
    rng = np.random.RandomState(5)
    R, K = 4, 9
    w = jnp.asarray(rng.rand(R, K), jnp.float32)
    vals = jnp.asarray(rng.rand(R, K, 3), jnp.float32)
    masks = jnp.asarray(rng.rand(R, K) < 0.6)
    got = accumulate_along_rays_dense(w, vals, masks)
    want = accumulate_along_rays(
        w.reshape(-1), _ray_ids(R, K), vals.reshape(-1, 3), n_rays=R,
        masks=masks.reshape(-1),
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)


@pytest.mark.slow
def test_dense_weight_gradients_match_flat():
    t_starts, t_ends, sigmas, masks = _dense_fixture(seed=6)
    R, K = sigmas.shape

    def loss_dense(s):
        w = render_weight_from_density_dense(t_starts, t_ends, s, masks)
        return jnp.sum(w * jnp.cos(jnp.arange(K, dtype=jnp.float32)))

    def loss_flat(s):
        w = render_weight_from_density(
            _flatten(t_starts), _flatten(t_ends), _flatten(s),
            ray_indices=_ray_ids(R, K), n_rays=R, masks=masks.reshape(-1),
        )
        c = jnp.tile(jnp.cos(jnp.arange(K, dtype=jnp.float32)), R)
        return jnp.sum(w[:, 0] * c)

    g_dense = jax.grad(loss_dense)(sigmas)
    g_flat = jax.grad(lambda s: loss_flat(s))(sigmas)
    np.testing.assert_allclose(
        np.asarray(g_dense), np.asarray(g_flat), rtol=1e-4, atol=1e-6
    )


def test_dense_alpha_gradients_numeric():
    _, _, sigmas, masks = _dense_fixture(seed=7, R=3, K=6)
    alphas = 1 - jnp.exp(-sigmas * 0.2)

    def loss(a):
        w = render_weight_from_alpha_dense(a, masks)
        return jnp.sum(w ** 2)

    g = np.asarray(jax.grad(loss)(alphas))
    # numerical check
    eps = 1e-4
    a0 = np.asarray(alphas)
    for r, k in [(0, 0), (1, 3), (2, 5)]:
        ap = a0.copy(); ap[r, k] += eps
        am = a0.copy(); am[r, k] -= eps
        want = (loss(jnp.asarray(ap)) - loss(jnp.asarray(am))) / (2 * eps)
        np.testing.assert_allclose(g[r, k], float(want), rtol=1e-2, atol=1e-4)


@pytest.mark.slow
def test_render_rays_dnerf_timestamps():
    """The dense pipeline threads per-ray timestamps through the
    D-NeRF field (reference examples/utils.py:50-76 conditioning)."""
    from nerfacc_tpu.models import DNeRFRadianceField
    from nerfacc_tpu.utils import render_rays

    rng = np.random.RandomState(0)
    n = 8
    rays_o = jnp.asarray(rng.rand(n, 3), jnp.float32)
    rays_d = jnp.asarray(rng.randn(n, 3), jnp.float32)
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    ts = jnp.asarray(rng.rand(n, 1), jnp.float32)

    field = DNeRFRadianceField()
    params = field.init(
        jax.random.PRNGKey(0),
        jnp.zeros((4, 3)), jnp.zeros((4, 1)), jnp.zeros((4, 3)),
    )
    colors, opacities, depths, n_live = render_rays(
        params, field, rays_o, rays_d,
        near_plane=0.1, far_plane=1.0, render_step_size=0.05,
        max_samples_per_ray=32, timestamps=ts,
    )
    assert colors.shape == (n, 3) and opacities.shape == (n, 1)
    assert np.isfinite(np.asarray(colors)).all()
    assert int(n_live) > 0
    # different timestamps change the output (warp is time-dependent)
    colors2, _, _, _ = render_rays(
        params, field, rays_o, rays_d,
        near_plane=0.1, far_plane=1.0, render_step_size=0.05,
        max_samples_per_ray=32, timestamps=ts + 0.5,
    )
    assert not np.allclose(np.asarray(colors), np.asarray(colors2))


def test_dynamic_ray_bucketer():
    from nerfacc_tpu.utils import DynamicRayBucketer

    b = DynamicRayBucketer(target_samples=1 << 16, init_num_rays=4096)
    assert b.num_rays == 4096
    # 32 live samples/ray -> wants 65536/32 = 2048 rays
    for _ in range(20):
        n = b.update(b.num_rays * 32, b.num_rays)
    assert n == 2048
    # very sparse scene: 4 samples/ray -> wants 16384
    for _ in range(40):
        n = b.update(b.num_rays * 4, b.num_rays)
    assert n == 16384
    assert n in b.buckets


@pytest.mark.slow
def test_render_image_matches_render_rays():
    """Chunked + padded whole-image rendering equals one-shot rendering."""
    from nerfacc_tpu.models import TensoCPRadianceField
    from nerfacc_tpu.utils import render_image, render_rays

    rng = np.random.RandomState(1)
    n = 50  # not a multiple of the chunk size -> exercises padding
    rays_o = jnp.asarray(rng.rand(n, 3) * 2 - 1, jnp.float32)
    rays_d = jnp.asarray(rng.randn(n, 3), jnp.float32)
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    aabb = jnp.asarray([-1.5] * 3 + [1.5] * 3)

    field = TensoCPRadianceField(
        aabb=(-1.5,) * 3 + (1.5,) * 3, levels=((16, 8),)
    )
    params = field.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.zeros((4, 3)))
    grid = create_grid([-1.5] * 3 + [1.5] * 3, resolution=16, occupied=True)

    kwargs = dict(
        grid=grid, scene_aabb=aabb, render_step_size=5e-2,
        max_samples_per_ray=64, render_bkgd=jnp.ones(3),
    )
    c1, o1, d1 = render_image(
        params, field, rays_o, rays_d,
        test_chunk_size=16, eval_samples_per_ray=64, **kwargs,
    )
    c2, o2, d2, _ = render_rays(
        params, field, rays_o, rays_d, samples_budget=n * 64, **kwargs,
    )
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_compact_rays_matches_full_render():
    """Empty-ray compaction (hit-test -> render only hitting rays ->
    expand) produces the same image as the full render when the hit
    budget is sufficient; gradients flow to the field either way."""
    from nerfacc_tpu.models import TensoCPRadianceField
    from nerfacc_tpu.utils import render_rays

    rng = np.random.RandomState(2)
    n = 64
    rays_o = jnp.asarray(rng.rand(n, 3) * 3 - 1.5, jnp.float32)
    rays_d = jnp.asarray(rng.randn(n, 3), jnp.float32)
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    aabb = jnp.asarray([-1.0] * 3 + [1.0] * 3)

    field = TensoCPRadianceField(aabb=(-1.0,) * 3 + (1.0,) * 3, levels=((16, 8),))
    params = field.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.zeros((4, 3)))
    # half-occupied grid so a solid share of rays miss
    binary = np.zeros((16, 16, 16), bool)
    binary[4:12, 4:12, 4:12] = True
    grid = with_binary(
        create_grid([-1.0] * 3 + [1.0] * 3, resolution=16), jnp.asarray(binary)
    )
    # no samples_budget: every ray gets all S slots in both runs, so no
    # decimation and the outputs must match exactly (a budget would be
    # re-spread over the compacted rays, changing decimation subsets)
    kwargs = dict(
        grid=grid, scene_aabb=aabb, render_step_size=2e-2,
        max_samples_per_ray=128,
        coarse_stride=4, render_bkgd=jnp.ones(3),
    )
    c_full, o_full, d_full, n_full = render_rays(
        params, field, rays_o, rays_d, **kwargs
    )
    c_cmp, o_cmp, d_cmp, n_cmp = render_rays(
        params, field, rays_o, rays_d, compact_rays_fraction=0.9, **kwargs
    )
    hit = np.asarray(o_full[:, 0]) > 0
    np.testing.assert_allclose(
        np.asarray(c_cmp)[hit], np.asarray(c_full)[hit], rtol=1e-4, atol=1e-5
    )
    # non-hit rays are exactly background
    np.testing.assert_allclose(np.asarray(c_cmp)[~hit], 1.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(o_cmp)[~hit], 0.0, atol=1e-7)
    assert int(n_cmp) >= int(n_full) - 1

    def loss(p, frac):
        c, _, _, _ = render_rays(
            params=p, field=field, rays_o=rays_o, rays_d=rays_d,
            compact_rays_fraction=frac, **kwargs,
        )
        return jnp.sum(c ** 2)

    g = jax.grad(lambda p: loss(p, 0.9))(params)
    leaves = jax.tree_util.tree_leaves(g)
    assert any(float(jnp.abs(l).sum()) > 0 for l in leaves)


@pytest.mark.slow
def test_make_field_fns_closure_contract():
    """The reference's sigma_fn/rgb_sigma_fn closure contract
    (examples/utils.py:50-76) drives the flat ray_marching path."""
    from nerfacc_tpu import ray_marching
    from nerfacc_tpu.models import VanillaNeRFRadianceField
    from nerfacc_tpu.utils import make_field_fns

    rng = np.random.RandomState(0)
    rays_o = jnp.asarray(rng.rand(4, 3), jnp.float32)
    rays_d = jnp.asarray(rng.randn(4, 3), jnp.float32)
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    field = VanillaNeRFRadianceField(net_depth=2, net_width=16)
    params = field.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2, 3)))
    sigma_fn, rgb_sigma_fn = make_field_fns(field, params, rays_o, rays_d)
    out = ray_marching(
        rays_o, rays_d, near_plane=0.1, far_plane=1.0,
        render_step_size=0.05, max_samples_per_ray=32,
        sigma_fn=sigma_fn,
    )
    assert np.asarray(out.masks).any()
    rgbs, sigmas = rgb_sigma_fn(out.t_starts, out.t_ends, out.ray_indices)
    assert rgbs.shape == (out.t_starts.shape[0], 3)
    assert np.isfinite(np.asarray(rgbs)).all()


def test_dense_saturated_alpha_exclusive_transmittance():
    """A sample whose alpha saturates to exactly 1.0 in f32 must keep its
    own full weight (T_i * 1) and visibility — the old cumprod/(1-alpha)
    trick returned 0 for the opaque sample itself and let content behind
    it leak through (advisor round-1 finding)."""
    alphas = jnp.array([[0.3, 1.0, 0.5, 0.2]], jnp.float32)
    masks = jnp.ones_like(alphas, bool)
    w_dense = np.asarray(render_weight_from_alpha_dense(alphas, masks))[0]
    # exclusive transmittance: [1, .7, 0, 0]
    np.testing.assert_allclose(w_dense, [0.3, 0.7, 0.0, 0.0], atol=1e-6)
    # packed twin agrees
    ray_indices = jnp.zeros(4, jnp.int32)
    w_flat = np.asarray(
        render_weight_from_alpha(
            alphas.reshape(-1), ray_indices=ray_indices, n_rays=1
        )
    )
    np.testing.assert_allclose(w_dense, w_flat.reshape(-1), atol=1e-6)
    vis = np.asarray(render_visibility_dense(alphas, masks))[0]
    # opaque sample is visible; everything strictly behind it is not
    assert vis.tolist() == [True, True, False, False]
    # transmittance twin: true exclusive product
    from nerfacc_tpu.vol_rendering import (
        render_transmittance_from_alpha_dense,
    )

    trans = np.asarray(render_transmittance_from_alpha_dense(alphas, masks))[0]
    np.testing.assert_allclose(trans, [1.0, 0.7, 0.0, 0.0], atol=1e-6)


@pytest.mark.slow
def test_render_image_keeps_caller_visible_budget():
    """render_image must not silently override a caller's
    visible_samples_budget (advisor round-1 weak finding): rescaling is
    opt-in via eval_visible_samples_per_ray."""
    from nerfacc_tpu.models import VanillaNeRFRadianceField
    from nerfacc_tpu.utils import render_image, render_rays

    rng = np.random.RandomState(11)
    n = 32
    rays_o = jnp.asarray(rng.rand(n, 3) * 0.5, jnp.float32)
    rays_d = jnp.asarray(rng.randn(n, 3), jnp.float32)
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    field = VanillaNeRFRadianceField(net_depth=1, net_width=16)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.zeros((4, 3))
    )
    grid = create_grid([-1.5] * 3 + [1.5] * 3, resolution=8, occupied=True)
    aabb = jnp.asarray([-1.5] * 3 + [1.5] * 3)
    kwargs = dict(
        grid=grid, scene_aabb=aabb, render_step_size=5e-2,
        max_samples_per_ray=64, render_bkgd=jnp.ones(3),
        visible_samples_budget=n * 16,
    )
    c1, _, _ = render_image(
        params, field, rays_o, rays_d,
        test_chunk_size=n, eval_samples_per_ray=64, **kwargs,
    )
    # same budget passed straight through render_rays
    c2, _, _, _ = render_rays(
        params, field, rays_o, rays_d, samples_budget=n * 64, **kwargs,
    )
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), atol=1e-5)


def test_bucketer_budget_coupling_keeps_slots_constant():
    """Round-5 regression (the 800x800 gate failure): when dynamic ray
    batching changes the batch size, the per-ray slot count K must stay
    constant — a fixed budget under growing rays collapses K and
    decimates every ray (measured 18.3 PSNR / 110 ms steps). This pins
    the coupling rule the trainer uses: budget scales linearly with the
    bucket."""
    base_rays, base_budget = 4096, 131072  # K = 32
    k0 = -(-base_budget // base_rays)
    for n_rays in (1024, 4096, 16384, 65536):
        budget = n_rays * k0
        # render_rays' K formula
        K = min(1024, max(1, -(-budget // n_rays)))
        assert K == k0, (n_rays, K)
