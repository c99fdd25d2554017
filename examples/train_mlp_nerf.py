"""Train a vanilla NeRF with occupancy-grid ray marching.

Re-creation of reference ``examples/train_mlp_nerf.py`` for the JAX stack:
same per-step cadence (grid EMA update every 16 steps -> march with
sigma-culling -> grad-tracked composite -> smooth-L1 on alive rays), with
static-shape ray batches / sample budgets instead of the reference's
dynamic batch resizing.

Runs on CPU (low res) or a GPU unchanged:
    python examples/train_mlp_nerf.py --scene procedural --max_steps 2000
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nerfacc_tpu import create_grid, update_grid
from nerfacc_tpu.compile_cache import setup_compile_cache
from nerfacc_tpu.datasets import ProceduralScene
from nerfacc_tpu.models import VanillaNeRFRadianceField
from nerfacc_tpu.utils import render_image, render_rays


def huber(x, y, delta: float = 1.0):
    d = jnp.abs(x - y)
    return jnp.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def main(argv=None):
    setup_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--scene", type=str, default="procedural")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=5000)
    p.add_argument("--num_rays", type=int, default=1024)
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--render_step_size", type=float, default=5e-3)
    p.add_argument("--max_samples_per_ray", type=int, default=1024)
    p.add_argument("--samples_budget", type=int, default=1 << 16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--test_chunk_size", type=int, default=4096)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--eval_views", type=int, default=2)
    p.add_argument(
        "--coarse_stride", type=int, default=1,
        help="occupancy-probe stride (1 = exact per-sample; >1 probes the "
        "dilated grid every C-th candidate and selects chunk-level - "
        "faster march, slightly coarser sample placement)",
    )
    p.add_argument(
        "--probe_groups", type=int, default=0,
        help="adaptive-stride probing: fixed probe-group count per ray "
        "with per-ray stride sized to the in-range span (0 = fixed "
        "stride = coarse_stride)",
    )
    args = p.parse_args(argv)

    # a given --data_root ALWAYS routes through the on-disk loader
    # (round-5 fix, see train_ngp_nerf.py)
    if args.scene == "procedural" and args.data_root is None:
        scene = ProceduralScene(width=args.image_size, height=args.image_size)
    else:
        from nerfacc_tpu.datasets.nerf_synthetic import SubjectLoader

        scene = SubjectLoader(
            subject_id=args.scene, root_fp=args.data_root, split="train"
        )
        test_scene = SubjectLoader(
            subject_id=args.scene, root_fp=args.data_root, split="test"
        )
        scene.test_poses = test_scene.test_poses
        scene.test_images = test_scene.test_images
    scene_aabb = scene.aabb
    render_bkgd = scene.bkgd

    field = VanillaNeRFRadianceField()
    key = jax.random.PRNGKey(42)
    key, k_init = jax.random.split(key)
    params = field.init(k_init, jnp.zeros((8, 3)), jnp.zeros((8, 3)))

    grid = create_grid(scene_aabb, resolution=args.grid_resolution)

    # lr schedule mirrors the reference MultiStepLR at 1/2, 3/4, 9/10 x 0.33
    ms = args.max_steps
    sched = optax.piecewise_constant_schedule(
        args.lr, {ms // 2: 0.33, ms * 3 // 4: 0.33, ms * 9 // 10: 0.33}
    )
    optimizer = optax.adam(sched)
    opt_state = optimizer.init(params)

    render_kwargs = dict(
        scene_aabb=scene_aabb,
        near_plane=None,
        far_plane=None,
        render_step_size=args.render_step_size,
        cone_angle=0.0,
        alpha_thre=0.0,
        max_samples_per_ray=args.max_samples_per_ray,
        samples_budget=args.samples_budget,
        coarse_stride=args.coarse_stride,
        probe_groups=args.probe_groups or None,
    )

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, grid, rays_o, rays_d, pixels, key):
        def loss_fn(p):
            colors, opacities, _, n = render_rays(
                p, field, rays_o, rays_d, grid=grid,
                render_bkgd=render_bkgd, stratified=True, key=key,
                **render_kwargs,
            )
            alive = (opacities[:, 0] > 0).astype(jnp.float32)
            per_ray = huber(colors, pixels).mean(-1)
            loss = (per_ray * alive).sum() / jnp.maximum(alive.sum(), 1.0)
            return loss, n

        (loss, n), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, n

    def occ_eval_fn(params):
        def fn(x):
            return field.apply(
                params, x, args.render_step_size, method=field.query_opacity
            )
        return fn

    @functools.partial(jax.jit, static_argnames=("warmup",))
    def grid_update(params, grid, key, warmup: bool):
        return update_grid(
            grid, key, step=0 if warmup else 10**9,
            occ_eval_fn=occ_eval_fn(params), occ_thre=1e-2,
        )

    t_start = time.perf_counter()
    for step in range(args.max_steps):
        key, k_grid, k_render = jax.random.split(key, 3)
        if step % 16 == 0:
            grid = grid_update(params, grid, k_grid, step < 256)
        rays, pixels = scene.sample_batch(args.num_rays)
        params, opt_state, loss, n = train_step(
            params, opt_state, grid, rays.origins, rays.viewdirs, pixels, k_render
        )
        if step % 500 == 0 or step == args.max_steps - 1:
            el = time.perf_counter() - t_start
            print(
                f"step={step} loss={float(loss):.5f} "
                f"n_samples={int(n)} elapsed={el:.1f}s"
            )

    # eval PSNR on held-out views
    psnrs = []
    for i in range(min(args.eval_views, scene.test_poses.shape[0])):
        rays = scene.rays_for_view(scene.test_poses[i])
        eval_kwargs = dict(render_kwargs, coarse_stride=1)
        colors, _, _ = render_image(
            params, field, rays.origins, rays.viewdirs,
            grid=grid, render_bkgd=render_bkgd,
            test_chunk_size=args.test_chunk_size, **eval_kwargs,
        )
        gt = scene.test_images[i].reshape(-1, 3)
        mse = float(jnp.mean((colors - gt) ** 2))
        psnrs.append(-10.0 * np.log10(mse))
    train_time = time.perf_counter() - t_start
    print(f"PSNR: {np.mean(psnrs):.2f} (views: {[f'{x:.2f}' for x in psnrs]})")
    print(f"train_time_s: {train_time:.1f}")
    return np.mean(psnrs)


if __name__ == "__main__":
    main()
