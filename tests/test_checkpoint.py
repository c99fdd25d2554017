"""Checkpoint round-trip: params + grid + step survive save/restore."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerfacc_tpu import create_grid, update_grid
from nerfacc_tpu.checkpoint import CheckpointManager
from nerfacc_tpu.models import VanillaNeRFRadianceField


def test_checkpoint_roundtrip():
    field = VanillaNeRFRadianceField(net_depth=2, net_width=16)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.zeros((4, 3))
    )
    grid = create_grid([-1, -1, -1, 1, 1, 1], resolution=8)
    grid = update_grid(
        grid, jax.random.PRNGKey(1), step=0,
        occ_eval_fn=lambda x: (jnp.linalg.norm(x, axis=-1, keepdims=True) < 0.5).astype(jnp.float32),
    )
    state = {"params": params, "grid": grid, "step": 123}

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(123, state, wait=True)
        assert mgr.latest_step() == 123

        template = {
            "params": jax.tree.map(jnp.zeros_like, params),
            "grid": create_grid([-1, -1, -1, 1, 1, 1], resolution=8),
            "step": 0,
        }
        restored = mgr.restore(template)
        mgr.close()

    chex_equal = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b)
    )
    jax.tree.map(chex_equal, restored["params"], params)
    np.testing.assert_array_equal(
        np.asarray(restored["grid"].binary), np.asarray(grid.binary)
    )
    chex_equal(restored["grid"].occs, grid.occs)
    assert int(restored["step"]) == 123


def test_checkpoint_keeps_newest_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"w": jnp.full((3,), float(step)), "step": step})
    assert mgr.all_steps() == [3, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_3.npz", "ckpt_4.npz",
    ]
    template = {"w": jnp.zeros((3,)), "step": 0}
    assert int(mgr.restore(template)["step"]) == 4
    old = mgr.restore(template, step=3)
    np.testing.assert_array_equal(np.asarray(old["w"]), 3.0)
    assert isinstance(old["step"], int)


def test_checkpoint_save_replaces_atomically(tmp_path):
    """A save writes a temporary file and renames it over the final name:
    re-saving a step replaces it whole, no temporary is left behind, and
    a temporary left by a crashed save is never taken for a checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"w": jnp.zeros((2,))})
    mgr.save(5, {"w": jnp.ones((2,))})
    (tmp_path / "ckpt_9.npz.tmp").write_bytes(b"truncated")
    assert mgr.latest_step() == 5
    assert not list(tmp_path.glob("ckpt_5*.tmp"))
    got = mgr.restore({"w": jnp.zeros((2,))})
    np.testing.assert_array_equal(np.asarray(got["w"]), 1.0)
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore({"v": jnp.zeros((2,))})
