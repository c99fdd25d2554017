"""Worker for the 2-process CPU "multi-host" test (one rank per
invocation; see tests/test_multihost.py).

Each process owns 4 virtual CPU devices; together they form a
2-host x 4-chip mesh over gloo collectives — the standard JAX way to
exercise the multi-host code paths (init_distributed, host x chip mesh,
process-local batch sharding, hierarchical psum) without a cluster.

Runs a real sharded render + gradient step on a tiny Vanilla field and
prints the psum'd loss; the parent test compares ranks against the
single-process result.
"""

import os
import sys

import re as _re

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = _re.sub(
    r"--xla_force_host_platform_device_count=\d+", "",
    os.environ.get("XLA_FLAGS", ""),
)
os.environ["XLA_FLAGS"] = (
    _flags + " --xla_force_host_platform_device_count=4"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from nerfacc_tpu import create_grid
from nerfacc_tpu.models import VanillaNeRFRadianceField
from nerfacc_tpu.parallel import (
    batch_axes,
    init_distributed,
    make_host_mesh,
    psum_hierarchical,
    shard_host_batch,
)
from nerfacc_tpu.utils import render_rays


def local_batch(process_id: int, local_n: int):
    """Deterministic per-process ray shard (global batch = rank-ordered
    concatenation, matching tests/test_multihost.py's reference)."""
    rng = np.random.RandomState(100 + process_id)
    rays_o = (rng.rand(local_n, 3) * 2 - 1).astype(np.float32)
    rays_d = rng.randn(local_n, 3).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    pixels = rng.rand(local_n, 3).astype(np.float32)
    return rays_o, rays_d, pixels


def main():
    port, pid = sys.argv[1], int(sys.argv[2])
    assert init_distributed(
        coordinator_address=f"localhost:{port}", num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2
    mesh = make_host_mesh()
    assert mesh.devices.shape == (2, 4)

    field = VanillaNeRFRadianceField(net_depth=2, net_width=32)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.zeros((4, 3))
    )
    grid = create_grid([-1.5] * 3 + [1.5] * 3, resolution=8, occupied=True)
    aabb = jnp.asarray([-1.5] * 3 + [1.5] * 3)

    local_n = 32  # 8 rays per device
    batch = shard_host_batch(local_batch(pid, local_n), mesh)

    def shard_step(params, grid, o, d, px):
        def loss_fn(p):
            colors, _, _, _ = render_rays(
                p, field, o, d, grid=grid, render_bkgd=jnp.ones(3),
                scene_aabb=aabb, render_step_size=5e-2,
                max_samples_per_ray=64, samples_budget=o.shape[0] * 64,
            )
            return jnp.sum((colors - px) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = psum_hierarchical(loss, mesh)
        grads = psum_hierarchical(grads, mesh)
        return loss, grads

    spec_b = P(batch_axes(mesh))
    step = jax.jit(
        jax.shard_map(
            shard_step, mesh=mesh,
            in_specs=(P(), P(), spec_b, spec_b, spec_b),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )
    loss, grads = step(params, grid, *batch)
    gnorm = jax.tree_util.tree_reduce(
        lambda a, x: a + jnp.sum(x * x), grads, 0.0
    )
    print(f"RESULT {pid} {float(loss):.6f} {float(gnorm):.6f}", flush=True)


if __name__ == "__main__":
    main()
