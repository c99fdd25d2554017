"""Unbounded-360 infra diagnostic: render the ANALYTIC scene through the
occupancy-grid march/render path (no training anywhere) and score it
against the exact GT renderer.

Purpose (round-4, VERDICT #3): separate "the unbounded cone-march render
path is geometrically broken" from "occupancy-grid 360 *training*
dynamics collapse" for the q_cone360 = 5.42 PSNR result. The analytic
field (``nerfacc_tpu/datasets/procedural.py``) plus a far environment
shell stands in for a perfectly-trained model; whatever PSNR this
script reports is the infra's ceiling for that config.

The far field: GT composites the directional environment at infinity
(``render_gt_env``). The stand-in field places that radiance on a dense
shell at radius R_ENV; a correct unbounded march must (a) REACH the
shell within its ``max_samples_per_ray`` lattice cap and (b) composite
it through the sphere contraction. The closed-form reach of the cone
lattice from t_min=0.2 at dt=1e-2:

    cone 0:      t(S) = 0.2 + S * 0.01          (S=1024 -> t = 10.4)
    cone 0.004:  230 linear steps to t=2.5, then geometric *1.004
                 (S=1024 -> t = 59.6;  S=4096 -> beyond far plane)

so at the round-3 driver's config (S=1024) NEITHER variant can reach a
far environment — each grid cell the march CAN reach must fake it,
which is exactly the per-view-inconsistent radiance a collapse smells
like. This script quantifies that ceiling per (cone, S).

Usage: python scripts/diag_360.py [--r_env 1000] [--views 2]
Reference behavior: reference examples/train_ngp_nerf.py:87-94
(unbounded marching config), cuda/csrc/ray_marching.cu:139-161 (calc_dt
cone recurrence — unbounded per-ray while loop, NO sample cap).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np

from nerfacc_tpu import ContractionType, create_grid
from nerfacc_tpu.datasets.procedural import (
    Procedural360Scene, env_color, field_density, field_rgb,
)
from nerfacc_tpu.utils import render_rays


class AnalyticEnvField:
    """Duck-typed radiance field: analytic content + env shell at r=R."""

    def __init__(self, r_env, shell_sigma=50.0):
        self.r_env = r_env
        self.shell_sigma = shell_sigma

    def _sigma(self, x):
        # field_density returns (N, 1); keep that shape throughout
        r = jnp.linalg.norm(x, axis=-1, keepdims=True)
        shell = (r >= self.r_env).astype(jnp.float32) * self.shell_sigma
        return field_density(x) + shell

    def _rgb(self, x, d):
        r = jnp.linalg.norm(x, axis=-1, keepdims=True)
        env = env_color(x / jnp.maximum(r, 1e-6))
        inside = (r < self.r_env).astype(jnp.float32)
        return field_rgb(x, d) * inside + env * (1.0 - inside)

    # render_rays field protocol
    def apply(self, params, x, d=None, method=None):
        # bound-method identity is unreliable (`a.f is a.f` is False);
        # match by name
        if getattr(method, "__name__", method) == "query_density":
            return self._sigma(x)
        return self._rgb(x, d), self._sigma(x)

    def query_density(self, x):  # name marker for method=
        return self._sigma(x)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--r_env", type=float, default=1000.0)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--image_size", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=192)
    ap.add_argument(
        "--configs", default="0:1024,0.004:1024,0.004:4096",
        help="comma list of cone:max_samples pairs to evaluate",
    )
    args = ap.parse_args()

    scene = Procedural360Scene(
        n_views=8, width=args.image_size, height=args.image_size
    )
    aabb = tuple(float(v) for v in np.asarray(scene.aabb))
    field = AnalyticEnvField(args.r_env)
    grid = create_grid(
        aabb, resolution=64,
        contraction_type=ContractionType.UN_BOUNDED_SPHERE, occupied=True,
    )

    import functools
    import jax

    @functools.partial(jax.jit, static_argnames=("cone", "S"))
    def render_chunk(o, d, cone, S):
        c, _, _, _ = render_rays(
            None, field, o, d,
            grid=grid, scene_aabb=None,
            near_plane=0.2, far_plane=1e4,
            render_step_size=1e-2, cone_angle=cone,
            alpha_thre=0.0,
            max_samples_per_ray=S,
            samples_budget=args.chunk * args.slots,
            coarse_stride=1, render_bkgd=None,
        )
        return c

    configs = [
        (float(c), int(s))
        for c, s in (pair.split(":") for pair in args.configs.split(","))
    ]
    for cone, S in configs:
            print(f"config cone={cone} S={S} ...", flush=True)
            psnrs = []
            for v in range(min(args.views, scene.test_poses.shape[0])):
                rays = scene.rays_for_view(scene.test_poses[v])
                outs = []
                n = rays.origins.shape[0]
                for i in range(0, n, args.chunk):
                    c = render_chunk(
                        rays.origins[i : i + args.chunk],
                        rays.viewdirs[i : i + args.chunk],
                        cone=cone, S=S,
                    )
                    outs.append(np.asarray(c))
                img = np.concatenate(outs)
                gt = np.asarray(scene.test_images[v]).reshape(-1, 3)
                mse = float(np.mean((img - gt) ** 2))
                psnrs.append(-10.0 * np.log10(mse))
            print(
                f"cone={cone:<6} S={S:<5} slots={args.slots} "
                f"PSNR={np.mean(psnrs):.2f} "
                f"(views: {[f'{p:.2f}' for p in psnrs]})",
                flush=True,
            )


if __name__ == "__main__":
    main()
