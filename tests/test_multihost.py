"""2-process CPU "multi-host" simulation: two ranks with 4 virtual
devices each form a 2-host x 4-chip mesh (gloo collectives stand in for
DCN), run a sharded render + gradient psum through the real code paths
(init_distributed, make_host_mesh, shard_host_batch, psum_hierarchical),
and must agree with the single-process reference bit-for-bit in loss.

This is the standard JAX pattern for testing multi-host programs without
a cluster; the same program runs on real hosts with init_distributed()
(SURVEY §2.5 distribution plan; the reference has no multi-node
anything)."""

import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


pytestmark = pytest.mark.slow  # e2e CLI drives (round-5 fast tier)

def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_reference():
    """Same computation as multihost_worker.py, one process, no mesh."""
    sys.path.insert(0, str(REPO / "tests"))
    import multihost_worker as w

    from nerfacc_tpu import create_grid
    from nerfacc_tpu.models import VanillaNeRFRadianceField
    from nerfacc_tpu.utils import render_rays

    field = VanillaNeRFRadianceField(net_depth=2, net_width=32)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.zeros((4, 3))
    )
    grid = create_grid([-1.5] * 3 + [1.5] * 3, resolution=8, occupied=True)
    aabb = jnp.asarray([-1.5] * 3 + [1.5] * 3)
    parts = [w.local_batch(0, 32), w.local_batch(1, 32)]
    rays_o, rays_d, pixels = (
        jnp.concatenate([jnp.asarray(p[i]) for p in parts]) for i in range(3)
    )

    def loss_fn(p):
        colors, _, _, _ = render_rays(
            p, field, rays_o, rays_d, grid=grid, render_bkgd=jnp.ones(3),
            scene_aabb=aabb, render_step_size=5e-2,
            max_samples_per_ray=64, samples_budget=8 * 64,
        )
        return jnp.sum((colors - pixels) ** 2)

    # per-device shards of 8 rays each: sum the 8 shard losses like the
    # mesh does (per-shard budget 8 * 64 slots)
    total = 0.0
    for s in range(8):
        sl = slice(s * 8, (s + 1) * 8)

        def loss_s(p, sl=sl):
            colors, _, _, _ = render_rays(
                p, field, rays_o[sl], rays_d[sl], grid=grid,
                render_bkgd=jnp.ones(3), scene_aabb=aabb,
                render_step_size=5e-2, max_samples_per_ray=64,
                samples_budget=8 * 64,
            )
            return jnp.sum((colors - pixels[sl]) ** 2)

        total += float(jax.jit(loss_s)(params))
    return total


def test_two_process_mesh_matches_single_process():
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "multihost_worker.py"),
             str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, out[-2000:]

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, loss, gnorm = line.split()
                results[int(pid)] = (float(loss), float(gnorm))
    assert set(results) == {0, 1}, outs
    # both ranks see the same psum'd loss/grad-norm
    assert results[0] == results[1]

    ref = _single_process_reference()
    np.testing.assert_allclose(results[0][0], ref, rtol=1e-5)
