"""Occupancy grid update/query (reference tests/test_grid.py oracles)."""

import jax
import jax.numpy as jnp
import numpy as np

from nerfacc_tpu import ContractionType, create_grid, query_grid, update_grid


def occ_eval_fn(x):
    """Pseudo occupancy: occupied inside a sphere of radius 0.5 at origin."""
    return (jnp.linalg.norm(x, axis=-1, keepdims=True) < 0.5).astype(jnp.float32)


def test_grid_update_and_query():
    grid = create_grid(roi_aabb=[-1, -1, -1, 1, 1, 1], resolution=16)
    key = jax.random.PRNGKey(0)
    # warmup path (all cells)
    grid = update_grid(grid, key, step=0, occ_eval_fn=occ_eval_fn)
    assert grid.binary.shape == (16, 16, 16)
    assert bool(grid.binary.any())
    # occupied cells concentrate inside the sphere
    samples = jnp.array(np.random.RandomState(0).uniform(-1, 1, (256, 3)), jnp.float32)
    occ = grid.query_occ(samples)
    r = np.linalg.norm(np.asarray(samples), axis=-1)
    got = np.asarray(occ)
    assert got[r < 0.3].all()
    assert not got[r > 0.8].any()
    # post-warmup sampled path
    grid2 = update_grid(grid, jax.random.PRNGKey(1), step=300, occ_eval_fn=occ_eval_fn)
    assert grid2.binary.shape == (16, 16, 16)


def test_query_grid_outside_roi_is_empty():
    grid = create_grid(roi_aabb=[-1, -1, -1, 1, 1, 1], resolution=8, occupied=True)
    pts = jnp.array([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    occ = query_grid(pts, grid.roi_aabb, grid.binary, ContractionType.AABB)
    assert bool(occ[0]) and not bool(occ[1])


def test_grid_ema_decay():
    grid = create_grid(roi_aabb=[-1, -1, -1, 1, 1, 1], resolution=8)
    key = jax.random.PRNGKey(0)
    grid = update_grid(grid, key, step=0, occ_eval_fn=lambda x: jnp.ones((x.shape[0], 1)))
    assert np.allclose(np.asarray(grid.occs), 1.0)
    # now the field goes empty: occs decay by 0.95 per update
    grid = update_grid(grid, key, step=16, occ_eval_fn=lambda x: jnp.zeros((x.shape[0], 1)))
    assert np.allclose(np.asarray(grid.occs), 0.95)


def test_grid_pytree_roundtrip_under_jit():
    """OccupancyGrid is a pytree of its arrays; resolution and contraction
    type are static metadata that survive jit and select the trace."""
    grid = create_grid([0, 0, 0, 1, 1, 1], resolution=(8, 8, 4),
                       contraction_type=ContractionType.UN_BOUNDED_SPHERE)
    leaves, treedef = jax.tree_util.tree_flatten(grid)
    assert len(leaves) == 7  # roi, occs, binary and the four bit tables
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.resolution == (8, 8, 4)
    assert back.contraction_type == ContractionType.UN_BOUNDED_SPHERE

    traces = []

    @jax.jit
    def bump(g):
        traces.append(g.resolution)
        return g.replace(occs=g.occs + 1.0)

    out = bump(grid)
    assert out.resolution == (8, 8, 4)
    assert out.contraction_type == ContractionType.UN_BOUNDED_SPHERE
    np.testing.assert_array_equal(np.asarray(out.occs), 1.0)
    np.testing.assert_array_equal(np.asarray(out.binary),
                                  np.asarray(grid.binary))
    bump(out)  # same static fields: no retrace
    bump(create_grid([0, 0, 0, 1, 1, 1], resolution=4))  # new static fields
    assert traces == [(8, 8, 4), (4, 4, 4)]
