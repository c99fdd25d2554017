"""Op-level micro-benchmark harness.

Replaces the reference's ``scripts/run_profiler.py`` (torch.profiler
around fwd+bwd of weight-from-density at 81,920 rays) with a
``block_until_ready`` timing harness plus optional ``jax.profiler`` trace
capture for xprof/tensorboard.

    python scripts/run_profiler.py [--trace DIR] [--ops all]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


class Timer:
    """warmup + repeat wall timing of a jitted thunk (device-synced)."""

    def __init__(self, warmup: int = 3, repeat: int = 10):
        self.warmup, self.repeat = warmup, repeat

    def time(self, name: str, fn, *args):
        f = jax.jit(fn)
        for _ in range(self.warmup):
            out = f(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(self.repeat):
            out = f(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / self.repeat
        print(f"{name:42s} {dt * 1e3:9.3f} ms")
        return dt


def main():
    from nerfacc_tpu.compile_cache import setup_compile_cache

    setup_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--n_rays", type=int, default=81920)
    p.add_argument("--samples_per_ray", type=int, default=16)
    p.add_argument("--trace", type=str, default=None)
    args = p.parse_args()

    from nerfacc_tpu import (
        ray_marching, ray_resampling, ray_resampling_dense,
        render_weight_from_density, render_weight_from_density_dense,
        loss_distortion, loss_distortion_dense, create_grid,
    )
    from nerfacc_tpu.ray_marching import march_rays
    from nerfacc_tpu.intersection import ray_aabb_intersect

    n_rays, S = args.n_rays, args.samples_per_ray
    N = n_rays * S
    rng = np.random.RandomState(0)
    seg = jnp.repeat(jnp.arange(n_rays, dtype=jnp.int32), S)
    t_starts = jnp.asarray(
        np.sort(rng.rand(n_rays, S), axis=-1).reshape(N, 1), jnp.float32
    )
    t_ends = t_starts + 0.01
    sigmas = jnp.asarray(rng.rand(N, 1), jnp.float32)
    weights = jnp.asarray(rng.rand(N), jnp.float32)

    timer = Timer()
    ctx = (
        jax.profiler.trace(args.trace)
        if args.trace
        else __import__("contextlib").nullcontext()
    )
    with ctx:
        print(f"== packed ops at {n_rays} rays x {S} samples ==")
        timer.time(
            "render_weight_from_density fwd",
            lambda s: render_weight_from_density(
                t_starts, t_ends, s, ray_indices=seg, n_rays=n_rays
            ),
            sigmas,
        )
        timer.time(
            "render_weight_from_density fwd+bwd",
            jax.grad(
                lambda s: render_weight_from_density(
                    t_starts, t_ends, s, ray_indices=seg, n_rays=n_rays
                ).sum()
            ),
            sigmas,
        )
        timer.time(
            "ray_resampling (32/ray)",
            lambda w: ray_resampling(
                None, t_starts, t_ends, w, 32,
                ray_indices=seg, n_rays=n_rays,
            ).t_starts,
            weights,
        )
        timer.time(
            "loss_distortion",
            lambda w: loss_distortion(
                None, w, t_starts, t_ends, ray_indices=seg, n_rays=n_rays
            ),
            weights,
        )

        # the dense (n_rays, K) fast paths the training hot loop uses
        print(f"== dense ops at {n_rays} rays x {S} slots ==")
        ts2 = t_starts.reshape(n_rays, S)
        te2 = t_ends.reshape(n_rays, S)
        sig2 = sigmas.reshape(n_rays, S)
        w2 = weights.reshape(n_rays, S)
        timer.time(
            "render_weight_from_density_dense fwd",
            lambda s: render_weight_from_density_dense(ts2, te2, s),
            sig2,
        )
        timer.time(
            "render_weight_from_density_dense fwd+bwd",
            jax.grad(
                lambda s: render_weight_from_density_dense(ts2, te2, s).sum()
            ),
            sig2,
        )
        timer.time(
            "ray_resampling_dense (32/ray)",
            lambda w: ray_resampling_dense(ts2, te2, w, 32)[0],
            w2,
        )
        timer.time(
            "loss_distortion_dense",
            lambda w: loss_distortion_dense(w, ts2, te2),
            w2,
        )

        grid = create_grid([-1.5] * 3 + [1.5] * 3, resolution=128, occupied=True)
        rays_o = jnp.asarray(rng.rand(8192, 3) * 2 - 1, jnp.float32)
        rays_d = jnp.asarray(rng.randn(8192, 3), jnp.float32)
        rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
        aabb = jnp.asarray([-1.5] * 3 + [1.5] * 3)
        dt = timer.time(
            "ray_marching 8192 rays (grid 128^3)",
            lambda o, d: ray_marching(
                o, d, scene_aabb=aabb, grid=grid, render_step_size=5e-3,
                max_samples_per_ray=1024, samples_budget=1 << 18,
            ).t_starts,
            rays_o, rays_d,
        )
        print(f"marching throughput: {8192 / dt / 1e6:.2f} M rays/s")


if __name__ == "__main__":
    main()
