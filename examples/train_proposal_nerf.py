"""Train a NeRF with proposal-network sampling (grid-free).

The MipNeRF-360-style alternative to occupancy grids: a cheap density-only
proposal field redistributes a fixed per-ray sample budget toward surfaces
by inverse-CDF resampling (``nerfacc_tpu.sampling`` — the reference ships
this capability only as a broken sketch, ``nerfacc/sampling.py:101-187``).

Both fields train photometrically: the proposal renders its own (coarse)
color prediction, like the classic NeRF coarse/fine scheme, while the main
field renders from the resampled, surface-focused intervals. The
distortion regularizer (MipNeRF-360 Eq. 15) suppresses floaters.

    python examples/train_proposal_nerf.py --max_steps 2000
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

from nerfacc_tpu import (
    loss_distortion_dense,
    proposal_sampling_with_filter,
    sample_along_rays,
)
from nerfacc_tpu.compile_cache import setup_compile_cache
from nerfacc_tpu.datasets import ProceduralScene
from nerfacc_tpu.intersection import ray_aabb_intersect
from nerfacc_tpu.models import TensoCPRadianceField
from nerfacc_tpu.vol_rendering import (
    accumulate_along_rays_dense,
    render_weight_from_density_dense,
)


def huber(x, y, delta: float = 1.0):
    d = jnp.abs(x - y)
    return jnp.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def main(argv=None):
    setup_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--max_steps", type=int, default=2000)
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--train_views", type=int, default=24)
    p.add_argument("--n_coarse", type=int, default=64)
    p.add_argument("--n_fine", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument(
        "--distortion_loss", type=float, default=-1.0,
        help="MipNeRF-360 Eq.15 weight; default -1 = auto (1e-3 bounded, "
        "1e-2 unbounded). In unbounded mode the regularizer is computed "
        "in normalized disparity coordinates s, as in the paper - raw-t "
        "distortion at far-field scale is ~20x over-weighted and "
        "destabilizes training (measured: 14 vs 39 test PSNR).",
    )
    p.add_argument(
        "--unbounded", action="store_true",
        help="360 mode: sphere contraction + uniform-in-disparity coarse "
        "intervals on [near_plane, far_plane] (the MipNeRF-360 recipe - "
        "proposal sampling is the right tool for unbounded scenes, where "
        "occupancy-grid pruning dynamics break down; see the grid "
        "example's unbounded flags for that investigation)",
    )
    p.add_argument("--near_plane", type=float, default=1.0)
    p.add_argument(
        "--prop_grid", type=int, default=64,
        help="proposal-field grid nodes per axis (raise for unbounded: "
        "the contracted far-field shell is thin and a coarse proposal "
        "cannot steer samples into it)",
    )
    p.add_argument("--far_plane", type=float, default=64.0)
    p.add_argument(
        "--scene", type=str, default="procedural",
        choices=["procedural", "procedural360"],
    )
    p.add_argument("--eval_views", type=int, default=2)
    p.add_argument("--test_chunk_size", type=int, default=4096)
    args = p.parse_args(argv)

    if args.scene == "procedural360":
        from nerfacc_tpu.datasets import Procedural360Scene

        scene = Procedural360Scene(
            n_views=args.train_views, width=args.image_size,
            height=args.image_size,
        )
    else:
        scene = ProceduralScene(
            n_views=args.train_views, width=args.image_size,
            height=args.image_size,
        )
    has_bkgd = scene.bkgd is not None
    dist_w = args.distortion_loss
    if dist_w < 0:
        dist_w = 1e-2 if args.unbounded else 1e-3
    aabb = tuple(float(v) for v in np.asarray(scene.aabb))
    aabb_j = jnp.asarray(aabb)

    field = TensoCPRadianceField(aabb=aabb, unbounded=args.unbounded)
    # density-capacity-light proposal; renders its own coarse color for a
    # classic coarse/fine photometric loss
    proposal = TensoCPRadianceField(
        aabb=aabb, levels=((args.prop_grid, 32),), use_viewdirs=False,
        geo_feat_dim=7, unbounded=args.unbounded,
    )
    key = jax.random.PRNGKey(42)
    key, k1, k2 = jax.random.split(key, 3)
    params = {
        "field": field.init(k1, jnp.zeros((4, 3)), jnp.zeros((4, 3))),
        "proposal": proposal.init(k2, jnp.zeros((4, 3)), None),
    }
    optimizer = optax.adam(
        optax.cosine_decay_schedule(args.lr, args.max_steps, 0.1), eps=1e-15
    )
    opt_state = optimizer.init(params)

    def dense_density(module, mparams, rays_o, rays_d, t_starts, t_ends):
        tm = (t_starts + t_ends) * 0.5
        x = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
        R, K = tm.shape
        sig = module.apply(
            mparams, x.reshape(-1, 3), method=module.query_density
        )
        return sig.reshape(R, K)

    def dense_rgb_sigma(module, mparams, rays_o, rays_d, t_starts, t_ends):
        tm = (t_starts + t_ends) * 0.5
        x = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
        R, K = tm.shape
        d = jnp.broadcast_to(rays_d[:, None, :], (R, K, 3)).reshape(-1, 3)
        rgb, sig = module.apply(mparams, x.reshape(-1, 3), d)
        return rgb.reshape(R, K, 3), sig.reshape(R, K)

    # note: the proposal round re-evaluates its density with gradients
    # inside proposal_sampling_with_filter; w_prop is grad-tracked

    def forward(p, rays_o, rays_d, key):
        if args.unbounded:
            # uniform-in-disparity coarse interval edges on
            # [near, far] (MipNeRF-360: linear sampling in 1/t covers
            # near content finely and the contracted far field coarsely),
            # lattice jittered per ray within one disparity bin
            R = rays_o.shape[0]
            K = args.n_coarse
            u = jax.random.uniform(key, (R, 1)) / K
            s = jnp.clip(
                jnp.linspace(0.0, 1.0, K + 1)[None, :] + u, 0.0, 1.0
            )
            inv = (1.0 - s) / args.near_plane + s / args.far_plane
            t_edges = 1.0 / inv
            from nerfacc_tpu.ray_marching import RaySegments

            segs0 = RaySegments(
                t_starts=t_edges[:, :-1], t_ends=t_edges[:, 1:],
                deltas=t_edges[:, 1:] - t_edges[:, :-1],
                masks=jnp.ones((R, K), bool),
            )
        else:
            t_min, t_max = ray_aabb_intersect(rays_o, rays_d, aabb_j)
            t_min = t_min + jax.random.uniform(key, t_min.shape) * 0.02
            # coarse uniform intervals across the per-ray box span
            segs0 = sample_along_rays(
                rays_o, rays_d, t_min, t_max,
                step_size=float(np.linalg.norm(np.asarray(aabb[3:]) -
                                               np.asarray(aabb[:3]))) / args.n_coarse,
                num_steps=args.n_coarse,
            )

        def prop_sigma_fn(ts, te):
            return dense_density(proposal, p["proposal"], rays_o, rays_d, ts, te)

        segs, prop_rounds = proposal_sampling_with_filter(
            segs0,
            proposal_sigma_fns=[prop_sigma_fn],
            proposal_n_samples=[args.n_fine],
            proposal_require_grads=True,
            early_stop_eps=0.0,  # no visibility culling: the budget is
            alpha_thre=0.0,      # redistributed by the CDF anyway
        )
        # proposal's own (coarse) render for its photometric loss
        (ts0, te0, w_prop, m0) = prop_rounds[0]
        rgb_prop, _ = dense_rgb_sigma(
            proposal, p["proposal"], rays_o, rays_d, ts0, te0
        )
        colors_prop = accumulate_along_rays_dense(w_prop, rgb_prop, masks=m0)
        opac_prop = accumulate_along_rays_dense(w_prop, masks=m0)
        if has_bkgd:
            colors_prop = colors_prop + 1.0 * (1.0 - opac_prop)
        # main render on the surface-focused intervals
        rgbs, sigmas = dense_rgb_sigma(
            field, p["field"], rays_o, rays_d, segs.t_starts, segs.t_ends
        )
        w = render_weight_from_density_dense(
            segs.t_starts, segs.t_ends, sigmas, masks=segs.masks
        )
        colors = accumulate_along_rays_dense(w, rgbs, masks=segs.masks)
        opac = accumulate_along_rays_dense(w, masks=segs.masks)
        if has_bkgd:
            colors = colors + 1.0 * (1.0 - opac)  # white bkgd
        if args.unbounded:
            # distortion in normalized disparity coordinates (MipNeRF-360
            # Eq. 15 uses normalized ray distance): raw-t distortion at
            # far-plane scale dominates the photometric loss and sets off
            # a density race that wrecks the main field
            inv_n, inv_f = 1.0 / args.near_plane, 1.0 / args.far_plane

            def to_s(t):
                return (inv_n - 1.0 / jnp.maximum(t, 1e-6)) / (inv_n - inv_f)

            dist = loss_distortion_dense(
                w, to_s(segs.t_starts), to_s(segs.t_ends), segs.masks
            )
        else:
            dist = loss_distortion_dense(
                w, segs.t_starts, segs.t_ends, segs.masks
            )
        return colors, opac, dist, colors_prop

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, rays_o, rays_d, pixels, key):
        def loss_fn(p):
            colors, opac, dist, colors_prop = forward(p, rays_o, rays_d, key)
            loss = huber(colors, pixels).mean()
            loss_prop = huber(colors_prop, pixels).mean()
            return loss + loss_prop + dist_w * dist.mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    t0 = time.perf_counter()
    t_warm = t0  # re-set after step 0 so samples/s excludes the compile
    for step in range(args.max_steps):
        key, k_r = jax.random.split(key)
        rays, pixels = scene.sample_batch(args.num_rays)
        params, opt_state, loss = train_step(
            params, opt_state, rays.origins, rays.viewdirs, pixels, k_r
        )
        if step == 0:
            float(loss)  # sync: step 0 = compile + first execution
            t_warm = time.perf_counter()
        if step % 500 == 0 or step == args.max_steps - 1:
            print(f"step={step} loss={float(loss):.5f} "
                  f"elapsed={time.perf_counter()-t0:.1f}s")
    float(loss)  # sync before reading the train clock
    train_elapsed = time.perf_counter() - t0
    # rendered samples/step: proposal coarse pass + main fine pass (both
    # composited) — the proposal-path analogue of bench.py's metric.
    # Clock starts after step 0 (compile excluded), like bench.py's.
    steady = time.perf_counter() - t_warm
    sps = (args.max_steps - 1) * args.num_rays * (
        args.n_coarse + args.n_fine
    ) / max(steady, 1e-9)
    print(f"train_samples_per_s: {sps:.0f}")

    # eval
    @jax.jit
    def render_chunk(params, o, d, key):
        colors, _, _, _ = forward(params, o, d, key)
        return colors

    psnrs = []
    for i in range(min(args.eval_views, scene.test_poses.shape[0])):
        rays = scene.rays_for_view(scene.test_poses[i])
        n = rays.origins.shape[0]
        chunk = args.test_chunk_size
        pad = (-n) % chunk
        o = jnp.concatenate([rays.origins, jnp.zeros((pad, 3))])
        d = jnp.concatenate(
            [rays.viewdirs, jnp.ones((pad, 3)) / np.sqrt(3.0)]
        )
        outs = [
            render_chunk(params, o[j:j+chunk], d[j:j+chunk],
                         jax.random.PRNGKey(0))
            for j in range(0, n + pad, chunk)
        ]
        colors = jnp.concatenate(outs)[:n]
        gt = scene.test_images[i].reshape(-1, 3)
        mse = float(jnp.mean((colors - gt) ** 2))
        psnrs.append(-10.0 * np.log10(mse))
    print(f"PSNR: {np.mean(psnrs):.2f} (views: {[f'{x:.2f}' for x in psnrs]})")
    print(f"train_time_s: {time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
