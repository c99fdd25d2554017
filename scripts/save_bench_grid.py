"""Save a *trained* occupancy-grid binary for bench.py --grid trained.

The default bench grid is a synthetic half-occupied cube; VERDICT r1
asked for culling ratios that match a real scene. This script runs the
flagship procedural training config (TensoCP + occupancy grid, the same
recipe as ``examples/train_ngp_nerf.py``) long enough for the grid to
converge to the scene's true topology, then stores the 128^3 binary +
its EMA occupancies in ``bench_assets/trained_grid.npz``.

    python scripts/save_bench_grid.py [--steps 2000]

The asset is committed so bench runs are reproducible without a
training pass; re-run this script to regenerate it.
"""

from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nerfacc_tpu import create_grid, update_grid
from nerfacc_tpu.compile_cache import setup_compile_cache
from nerfacc_tpu.datasets import ProceduralScene
from nerfacc_tpu.models import TensoCPRadianceField
from nerfacc_tpu.utils import render_rays


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--num_rays", type=int, default=8192)
    ap.add_argument("--out", type=str,
                    default=str(REPO / "bench_assets" / "trained_grid.npz"))
    args = ap.parse_args()
    setup_compile_cache()

    scene = ProceduralScene(n_views=24, width=128, height=128)
    aabb = tuple(float(v) for v in np.asarray(scene.aabb))
    field = TensoCPRadianceField(aabb=aabb)
    key = jax.random.PRNGKey(42)
    key, k_init = jax.random.split(key)
    params = field.init(k_init, jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    grid = create_grid(aabb, resolution=128)
    optimizer = optax.adam(1e-2, eps=1e-15)
    opt_state = optimizer.init(params)

    import math

    diag = math.dist(aabb[:3], aabb[3:])
    render_kwargs = dict(
        scene_aabb=jnp.asarray(aabb),
        render_step_size=diag * math.sqrt(3) / 1024,
        max_samples_per_ray=1024,
        samples_budget=1 << 18,
        visible_samples_budget=1 << 16,
        coarse_stride=8,
        probe_dilation=2,
        probe_groups=64,
    )

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, grid, rays_o, rays_d, pixels, bkgd, key):
        def loss_fn(p):
            colors, opacities, _, n = render_rays(
                p, field, rays_o, rays_d, grid=grid, render_bkgd=bkgd,
                stratified=True, key=key, **render_kwargs,
            )
            alive = (opacities[:, 0] > 0).astype(jnp.float32)
            per_ray = ((colors - pixels) ** 2).mean(-1)
            return (per_ray * alive).sum() / jnp.maximum(alive.sum(), 1.0), n

        (loss, n), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    @functools.partial(jax.jit, static_argnames=("warmup",))
    def grid_update(params, grid, key, warmup: bool):
        def occ_eval_fn(x):
            density = field.apply(params, x, method=field.query_density)
            return density * render_kwargs["render_step_size"]

        return update_grid(
            grid, key, step=0 if warmup else 10**9,
            occ_eval_fn=occ_eval_fn, occ_thre=1e-2,
        )

    for step in range(args.steps):
        key, k_grid, k_render = jax.random.split(key, 3)
        if step % 16 == 0:
            grid = grid_update(params, grid, k_grid, step < 256)
        rays, pixels = scene.sample_batch(args.num_rays)
        params, opt_state, loss = train_step(
            params, opt_state, grid, rays.origins, rays.viewdirs, pixels,
            scene.bkgd, k_render,
        )
        if step % 500 == 0:
            print(f"step={step} loss={float(loss):.5f} "
                  f"occ={int(grid.binary.sum())}/{grid.binary.size}")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    binary = np.asarray(grid.binary)
    np.savez_compressed(out, binary=binary, occs=np.asarray(grid.occs))
    frac = binary.mean()
    print(f"saved {out}: {binary.sum()} occupied ({100 * frac:.1f}%)")


if __name__ == "__main__":
    main()
