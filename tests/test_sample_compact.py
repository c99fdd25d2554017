"""Live-sample compaction (ops/sample_compact.py): the compacted field
evaluation must be EXACTLY the dense evaluation — same colors, same
loss, same parameter gradients — whenever the budget covers the live
count, and degrade gracefully (masked drops, finite outputs) when it
doesn't.

Reference behavior matched: the CUDA toolbox evaluates the field only on
live samples by construction (exact packing from the count-then-allocate
marcher, reference ``cuda/csrc/ray_marching.cu:194-289``); this is
the static slot-layout recovery of that property.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerfacc_tpu import create_grid, with_binary
from nerfacc_tpu.ops.sample_compact import compact_live_slots, expand_compact
from nerfacc_tpu.utils import render_rays


def test_compact_live_slots_roundtrip():
    rng = np.random.RandomState(0)
    masks = jnp.asarray(rng.rand(16, 32) < 0.4)
    n_live = int(masks.sum())
    M = n_live + 5
    pos, ok, rank, keep, dropped = compact_live_slots(masks, M)
    assert bool((keep == masks).all())  # no drops at this budget
    assert int(dropped) == 0
    assert int(ok.sum()) == n_live
    # pos lists the live flat slots in order
    flat = np.flatnonzero(np.asarray(masks).reshape(-1))
    np.testing.assert_array_equal(np.asarray(pos)[:n_live], flat)
    # expand(gather(x)) == x on live slots, 0 elsewhere
    x = jnp.asarray(rng.randn(16 * 32, 3), jnp.float32)
    vals = jnp.stack([x[:, d][pos] for d in range(3)], axis=1)
    dense = expand_compact(vals, rank, keep.reshape(-1), pos, ok)
    np.testing.assert_allclose(
        np.asarray(dense),
        np.where(np.asarray(masks).reshape(-1, 1), np.asarray(x), 0.0),
    )


def test_compact_live_slots_overflow_drops_proportionally():
    """Over budget, every ray keeps a front-to-back prefix under the
    proportional quota — no batch-tail ray is silently zeroed (round-4
    advisor finding)."""
    masks = jnp.ones((4, 8), bool)
    pos, ok, rank, keep, dropped = compact_live_slots(masks, 10)
    k = np.asarray(keep)
    # quota = floor(8 * 10/32) = 2 per ray, front slots kept
    np.testing.assert_array_equal(k, np.tile(np.arange(8) < 2, (4, 1)))
    assert int(dropped) == 32 - int(k.sum())
    assert int(ok.sum()) == int(k.sum())
    # pos lists exactly the kept flat slots in order
    np.testing.assert_array_equal(
        np.asarray(pos)[: int(k.sum())], np.flatnonzero(k.reshape(-1))
    )


def test_compact_live_slots_overflow_keeps_every_live_ray():
    """Rays with few samples keep at least one under heavy overflow; the
    compact buffer never overflows."""
    rng = np.random.RandomState(7)
    masks = jnp.asarray(rng.rand(32, 16) < 0.6)
    # one-sample rays mixed in
    m = np.asarray(masks).copy()
    m[5] = False
    m[5, 3] = True
    masks = jnp.asarray(m)
    M = 40  # well below the ~300 live
    pos, ok, rank, keep, dropped = compact_live_slots(masks, M)
    k = np.asarray(keep)
    assert int(k.sum()) <= M
    assert int(dropped) == int(masks.sum()) - int(k.sum())
    live_rays = np.asarray(masks).any(axis=1)
    # every ray that had samples still has at least one (the backstop
    # can only trim when sum(quota) > M, impossible at these sizes)
    assert bool(k.any(axis=1)[live_rays].all())
    # kept slots are a front-to-back prefix of each ray's live slots
    for r in range(32):
        lv = np.flatnonzero(np.asarray(masks)[r])
        kv = np.flatnonzero(k[r])
        np.testing.assert_array_equal(kv, lv[: len(kv)])


def test_expand_compact_gradient_is_selection_gather():
    """d/d_vals of sum(f(expand(vals))) must equal gathering the dense
    cotangent at the selected positions — the injective-transpose
    property the custom VJP encodes."""
    rng = np.random.RandomState(1)
    masks = jnp.asarray(rng.rand(8, 16) < 0.5)
    M = int(masks.sum()) + 3
    pos, ok, rank, keep, _ = compact_live_slots(masks, M)
    vals = jnp.asarray(rng.randn(M, 2), jnp.float32)
    w = jnp.asarray(rng.randn(8 * 16, 2), jnp.float32)

    def f(v):
        return jnp.sum(w * expand_compact(v, rank, keep.reshape(-1), pos, ok))

    g = jax.grad(f)(vals)
    expected = np.asarray(w)[np.asarray(pos)] * np.asarray(ok)[:, None]
    np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-6)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(3)
    n_rays = 64
    aabb = jnp.asarray([-1.5] * 3 + [1.5] * 3)
    grid = create_grid(aabb, resolution=32, occupied=True)
    b = np.zeros((32, 32, 32), bool)
    b[8:24, 8:24, 8:24] = True
    grid = with_binary(grid, jnp.asarray(b))
    o = jnp.asarray(rng.rand(n_rays, 3) * 2 - 1, jnp.float32)
    d = jnp.asarray(rng.randn(n_rays, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return aabb, grid, o, d


@pytest.mark.slow
@pytest.mark.parametrize("model", ["mlp", "ngp"])
def test_render_rays_field_budget_matches_dense(scene, model):
    aabb, grid, o, d = scene
    if model == "ngp":
        from nerfacc_tpu.models import NGPRadianceField

        field = NGPRadianceField(aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5))
    else:
        from nerfacc_tpu.models import VanillaNeRFRadianceField

        field = VanillaNeRFRadianceField(net_depth=2, net_width=32)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3))
    )
    n_rays, K = o.shape[0], 32
    kw = dict(
        scene_aabb=aabb, render_step_size=2e-2, max_samples_per_ray=256,
        samples_budget=n_rays * K, coarse_stride=8, probe_dilation=2,
        probe_groups=16,
    )

    def run(fsb):
        def loss_fn(p):
            c, op, dp, n = render_rays(
                p, field, o, d, grid=grid, render_bkgd=jnp.ones(3),
                field_samples_budget=fsb, **kw,
            )
            return jnp.sum(c ** 2) + jnp.sum(op) + jnp.sum(dp), (c, n)

        (l, (c, n)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return l, c, n, g

    l0, c0, n0, g0 = run(None)
    l1, c1, n1, g1 = run(n_rays * K)  # full budget: no drops possible
    assert int(n0) == int(n1)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b_ in zip(jax.tree.flatten(g0)[0], jax.tree.flatten(g1)[0]):
        np.testing.assert_allclose(
            np.asarray(b_), np.asarray(a), rtol=1e-5, atol=1e-7
        )
    # overflow: tiny budget trims the sample set but stays finite
    l2, c2, n2, _ = run(32)
    assert int(n2) <= 32
    assert bool(np.isfinite(np.asarray(c2)).all())


def test_render_rays_field_budget_two_stage(scene):
    """The compacted two-stage (cull-then-render) path matches its dense
    twin: stage-1 density pass and stage-2 grad-tracked pass both
    compact, same colors and grads when the budget covers live."""
    from nerfacc_tpu.models import VanillaNeRFRadianceField

    aabb, grid, o, d = scene
    field = VanillaNeRFRadianceField(net_depth=2, net_width=32)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3))
    )
    n_rays, K = o.shape[0], 32
    kw = dict(
        scene_aabb=aabb, render_step_size=2e-2, max_samples_per_ray=256,
        samples_budget=n_rays * K, visible_samples_budget=n_rays * 16,
        coarse_stride=8, probe_dilation=2, probe_groups=16,
    )

    def run(fsb):
        def loss_fn(p):
            c, op, dp, n = render_rays(
                p, field, o, d, grid=grid, render_bkgd=jnp.ones(3),
                field_samples_budget=fsb, **kw,
            )
            return jnp.sum(c ** 2) + jnp.sum(op), (c, n)

        (l, (c, n)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return l, c, n, g

    l0, c0, n0, g0 = run(None)
    l1, c1, n1, g1 = run(n_rays * K)
    assert int(n0) == int(n1)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c0), rtol=1e-6, atol=1e-6)
    for a, b_ in zip(jax.tree.flatten(g0)[0], jax.tree.flatten(g1)[0]):
        np.testing.assert_allclose(
            np.asarray(b_), np.asarray(a), rtol=1e-5, atol=1e-7
        )
