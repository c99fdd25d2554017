"""Train an Instant-NGP radiance field.

Re-creation of reference ``examples/train_ngp_nerf.py``: hash-grid field,
occupancy grid with sigma-culling (alpha_thre/early_stop_eps), bounded and
unbounded (--unbounded: sphere contraction, cone-angle step growth, per-ray
near/far from AABB intersection) configurations, Adam(1e-2, eps=1e-15).

    python examples/train_ngp_nerf.py --scene procedural --max_steps 2000
"""

from __future__ import annotations

import argparse
import functools
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nerfacc_tpu import ContractionType, create_grid, update_grid
from nerfacc_tpu.compile_cache import setup_compile_cache
from nerfacc_tpu.datasets import ProceduralScene
from nerfacc_tpu.models import NGPRadianceField, TensoCPRadianceField
from nerfacc_tpu.utils import DynamicRayBucketer, render_image, render_rays


def huber(x, y, delta: float = 1.0):
    d = jnp.abs(x - y)
    return jnp.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


# MipNeRF-360 capture names (reference train_ngp_nerf.py scene choices):
# these route --data_root through the COLMAP loader
_MIPNERF360_SCENES = (
    "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
)


def main(argv=None):
    setup_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--scene", type=str, default="procedural")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument(
        "--dataset", type=str, default="auto",
        choices=["auto", "blender", "360"],
        help="loader for --data_root scenes: blender transforms.json or "
        "COLMAP 360_v2. auto = 360 for the MipNeRF-360 capture names, "
        "blender otherwise",
    )
    p.add_argument("--unbounded", action="store_true")
    p.add_argument(
        "--factor", type=int, default=0,
        help="image downscale factor for --data_root loaders (0 = the "
        "loader default: 4 for 360 captures via images_4/, 1 for "
        "blender)",
    )
    p.add_argument("--max_steps", type=int, default=20000)
    p.add_argument("--num_rays", type=int, default=8192)
    p.add_argument(
        "--grid_resolution", type=int, default=None,
        help="occupancy grid resolution (default: 128 bounded, 256 "
        "unbounded — the reference's per-mode defaults)",
    )
    p.add_argument("--max_samples_per_ray", type=int, default=1024)
    p.add_argument("--samples_budget", type=int, default=1 << 18)
    p.add_argument("--visible_samples_budget", type=int, default=1 << 16)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--test_chunk_size", type=int, default=8192)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--train_views", type=int, default=24)
    p.add_argument(
        "--levels", type=str, default="128x64,512x128",
        help="TensoCP level spec: comma-separated GRIDxRANK",
    )
    p.add_argument("--lr_decay", action="store_true", help="cosine lr decay to 0.1x over max_steps")
    p.add_argument("--eval_views", type=int, default=2)
    p.add_argument(
        "--cone_angle", type=float, default=None,
        help="per-ray step growth (default: 0 bounded, 0.004 unbounded "
        "— the reference's per-mode defaults; pass an explicit 0 to "
        "disable cone stepping in unbounded mode)",
    )
    p.add_argument(
        "--quant_int8", action="store_true",
        help="TensoCP: int8 forward contractions (models/tensorf.py)",
    )
    p.add_argument(
        "--auto_aabb", action="store_true",
        help="infer the scene aabb from the camera positions "
        "(reference train_ngp_nerf.py:125-132)",
    )
    p.add_argument(
        "--ckpt_dir", type=str, default=None,
        help="checkpoint directory; saves every --ckpt_every steps "
        "and resumes from the latest checkpoint if one exists",
    )
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument(
        "--seed", type=int, default=42,
        help="PRNG seed (init + stratified jitter + grid-update cells); "
        "vary to measure quality-gate noise",
    )
    p.add_argument(
        "--target_sample_batch_size", type=int, default=0,
        help="if > 0, adapt the ray-batch size (bucketed, recompile-free "
        "after warmup) to keep live samples/batch near this target — the "
        "reference's update_num_rays (train_ngp_nerf.py:236-241)",
    )
    p.add_argument(
        "--model", type=str, default="tensorf", choices=["ngp", "tensorf"],
        help="radiance field: 'tensorf' (CP hat-basis matmuls, an "
        "NGP-class field) or 'ngp' (the reference's hash grid)",
    )
    p.add_argument(
        "--distortion_loss", type=float, default=0.0,
        help="weight of the MipNeRF-360 distortion regularizer "
        "(loss_distortion_dense over the rendered weights)",
    )
    p.add_argument(
        "--compact_rays", type=float, default=0.0,
        help="if > 0, drop rays that hit no occupancy before per-sample "
        "work and re-spread the sample budget over this fraction of the "
        "batch (size it above the scene's hit rate; overflow rays render "
        "as background with no gradient)",
    )
    p.add_argument(
        "--probe_dilation", type=int, default=2,
        help="dilation radius of the probed occupancy table; stride "
        "validity needs coarse_stride * step / 2 <= radius * voxel",
    )
    p.add_argument(
        "--exact_recheck", type=int, default=1,
        help="re-check the exact (undilated) grid at selected slots, "
        "masking dilation-shell samples (1 = reference-parity behavior; "
        "0 skips the second occupancy lookup pass, ~30%% faster steps — "
        "shell samples then carry gradients and self-train to zero "
        "density)",
    )
    p.add_argument(
        "--far_plane", type=float, default=0.0,
        help="override the unbounded far plane (default: the "
        "reference's 1e4)",
    )
    p.add_argument(
        "--near_plane", type=float, default=0.0,
        help="override the unbounded near plane (default: the "
        "reference's 0.2). For cameras far from the content a slack "
        "near plane opens a camera-local volume where per-view floaters "
        "can hide; set it near the scene scale.",
    )
    p.add_argument(
        "--fixed_occ_thre", type=int, default=0,
        help="binarize occupancy at the fixed occ_thre after warmup "
        "instead of the reference's adaptive min(mean(occs), occ_thre) - "
        "the adaptive rule keeps every cell occupied when the field "
        "trains through a uniform-fog phase (see grid.update_grid)",
    )
    p.add_argument(
        "--occ_cone_coupling", type=int, default=0,
        help="couple the occupancy estimate to the cone-marching step "
        "(density * dist * cone_angle, reference train_ngp_nerf.py:"
        "190-213). Default OFF: the coupled estimate lowers the "
        "occupancy bar, the grid stops pruning, and the slot marcher "
        "then decimates heavily - measured to collapse eval quality "
        "(7.7 vs 34.5 PSNR on the cone-angle procedural config). Turn "
        "on only for true far-field content with generous sample budgets.",
    )
    p.add_argument(
        "--probe_groups", type=int, default=0,
        help="adaptive-stride probing: fixed number of probe groups per "
        "ray with per-ray stride sized to the in-range span (0 = fixed "
        "stride = coarse_stride; coverage caps at probe_groups * "
        "coarse_stride candidates per ray)",
    )
    p.add_argument(
        "--coarse_stride", type=int, default=8,
        help="occupancy-probe stride (1 = exact per-sample; >1 probes the "
        "dilated grid every C-th candidate and selects chunk-level - "
        "faster march, slightly coarser sample placement)",
    )
    p.add_argument(
        "--field_budget_ratio", type=float, default=-1.0,
        help="compact the radiance-field evaluation to ratio * "
        "samples_budget march-live slots (ops/sample_compact.py; exact "
        "— test-enforced). Default -1 = auto: 0.5 for --model ngp "
        "(per-slot gathers), off for tensorf (per-slot matmuls)",
    )
    p.add_argument(
        "--distortion_warmup", type=int, default=0,
        help="ramp the distortion weight in linearly over "
        "[warmup, 2*warmup] steps (0 = on from step 0, the measured "
        "default: on the 360 recipe EVERY warmup variant collapsed "
        "(12.8-13.3 vs 35.1 from-step-0) — early distortion prevents "
        "the floater basin from forming; delayed distortion cannot "
        "dismantle it. Kept for experimentation)",
    )
    p.add_argument(
        "--eval_on_train_views", action="store_true",
        help="diagnostic: score the eval render on TRAIN views (a model "
        "with low train loss must score high here unless the eval path "
        "diverges from the train-time render)",
    )
    p.add_argument(
        "--opacity_entropy", type=float, default=0.0,
        help="weight of a binary-entropy regularizer on per-ray opacity "
        "(-o log o - (1-o) log(1-o)): pushes rays to fully-opaque or "
        "fully-transparent, suppressing the per-view fog/floater basin "
        "of the unbounded grid recipe (round-5 robustness probe)",
    )
    p.add_argument(
        "--occ_ema_decay", type=float, default=0.95,
        help="occupancy-grid EMA decay (reference grid.py:232 uses "
        "0.95). Lower values forget the fog phase faster (round-5 "
        "robustness probe)",
    )
    p.add_argument(
        "--ngp_gather_mode", type=str, default="packed",
        choices=["packed", "per_level"],
        help="--model ngp: forward gather formulation (see bench.py)",
    )
    p.add_argument(
        "--ngp_log2_size", type=int, default=19,
        help="--model ngp: log2 hash-table size per level (L/T frontier)",
    )
    p.add_argument(
        "--ngp_levels", type=int, default=16,
        help="--model ngp: number of hash levels",
    )
    p.add_argument(
        "--ngp_features", type=int, default=2,
        help="--model ngp: features per level (4 with --ngp_levels 8 = "
        "full capacity at half the backward sort volume)",
    )
    args = p.parse_args(argv)

    # a given --data_root ALWAYS routes through the on-disk loaders
    # (round-5 fix: the name-keyed branch silently ignored data_root,
    # so every "fixture-backed" trainer run — including the round-3
    # realdata drill and the first 800x800 gate — actually trained
    # the in-memory procedural scene)
    if args.scene == "procedural" and args.data_root is None:
        scene = ProceduralScene(
            n_views=args.train_views,
            width=args.image_size, height=args.image_size,
        )
    elif args.scene == "procedural360" and args.data_root is None:
        from nerfacc_tpu.datasets import Procedural360Scene

        # directional-environment variant (bkgd None: the model owns the
        # far field) - the honest unbounded benchmark; constant-background
        # scenes let per-view fog composite for free in unbounded mode
        scene = Procedural360Scene(
            n_views=args.train_views,
            width=args.image_size, height=args.image_size,
        )
    else:
        # reference train_ngp_nerf.py keys the loader off the scene name:
        # MipNeRF-360 captures go through the COLMAP loader, everything
        # else through the blender loader. --dataset overrides for
        # non-standard scene names.
        is_360 = args.dataset == "360" or (
            args.dataset == "auto" and args.scene in _MIPNERF360_SCENES
        )
        if is_360:
            from nerfacc_tpu.datasets.nerf_360_v2 import SubjectLoader
        else:
            from nerfacc_tpu.datasets.nerf_synthetic import SubjectLoader

        loader_kw = {"factor": args.factor} if args.factor else {}
        scene = SubjectLoader(
            subject_id=args.scene, root_fp=args.data_root, split="train",
            **loader_kw,
        )
        # evaluate on the real test split (the train loader's test_* alias
        # its own train views)
        test_scene = SubjectLoader(
            subject_id=args.scene, root_fp=args.data_root, split="test",
            **loader_kw,
        )
        scene.test_poses = test_scene.test_poses
        scene.test_images = test_scene.test_images
    if args.auto_aabb:
        # reference train_ngp_nerf.py:125-132: bound the scene by the
        # camera positions
        cams = np.concatenate(
            [np.asarray(scene.train_poses)[:, :3, -1],
             np.asarray(scene.test_poses)[:, :3, -1]]
        )
        aabb = tuple(cams.min(0)) + tuple(cams.max(0))
        print("Using auto aabb", aabb)
    else:
        aabb = tuple(float(v) for v in np.asarray(scene.aabb))
    render_bkgd = scene.bkgd

    if args.unbounded:
        # reference train_ngp_nerf.py:87-94: unbounded config. Explicitly
        # passed --grid_resolution / --cone_angle / --far_plane override
        # the reference defaults (256 / 0.004 / 1e4) — smoke tests and
        # small captures don't need a 256^3 grid, and the cone-angle
        # quality A/B needs an honest `--cone_angle 0`.
        contraction = ContractionType.UN_BOUNDED_SPHERE
        near_plane = args.near_plane or 0.2
        far_plane = args.far_plane or 1e4
        render_step_size = 1e-2
        alpha_thre = 1e-2
        cone_angle = 0.004 if args.cone_angle is None else args.cone_angle
        grid_res = args.grid_resolution or 256
        scene_aabb = None
        # the reference's unbounded marcher has NO per-ray sample cap
        # (ray_marching.cu:139-161 marches until t_max); our static
        # lattice must be SIZED to cover [near, far] or the far field is
        # unreachable and training collapses to a per-view fake
        # (measured: 5-16 PSNR starved vs 42.5 infra ceiling covered —
        # scripts/diag_360.py, docs/benchmarks.md round-4)
        from nerfacc_tpu import samples_needed_for_range

        S_need = samples_needed_for_range(
            near_plane, far_plane, render_step_size, cone_angle
        )
        C = max(args.coarse_stride, 1)
        if args.max_samples_per_ray < S_need:
            if S_need <= 8192:
                new_s = -(-(S_need + C) // C) * C  # jitter margin, % C == 0
                print(
                    f"[unbounded] max_samples_per_ray {args.max_samples_per_ray} "
                    f"cannot cover [near={near_plane}, far={far_plane}] at "
                    f"step={render_step_size}, cone={cone_angle} "
                    f"(needs {S_need}); auto-raising to {new_s}"
                )
                args.max_samples_per_ray = new_s
            else:
                print(
                    f"WARNING: [unbounded] lattice needs {S_need} samples to "
                    f"cover [near={near_plane}, far={far_plane}] at "
                    f"step={render_step_size}, cone={cone_angle} — beyond the "
                    "8192 auto-cap. The far field is UNSAMPLABLE and training "
                    "will collapse (measured 5-16 PSNR; scripts/diag_360.py). "
                    + ("Set --cone_angle > 0: cone stepping is what makes "
                       "unbounded ranges coverable (reference default 0.004)."
                       if cone_angle <= 0 else
                       "Raise --max_samples_per_ray, or shrink the range "
                       "with --near_plane/--far_plane (the unbounded base "
                       "step is fixed at 1e-2, the reference's).")
                )
        if args.probe_groups and args.probe_groups * C < args.max_samples_per_ray:
            new_g = -(-args.max_samples_per_ray // C)
            print(
                f"[unbounded] probe_groups {args.probe_groups} x stride {C} "
                f"truncates the {args.max_samples_per_ray}-sample lattice; "
                f"raising probe_groups to {new_g}"
            )
            args.probe_groups = new_g
    else:
        # bounded: step = diag * sqrt(3) / 1024 (train_ngp_nerf.py:149-153)
        contraction = ContractionType.AABB
        near_plane, far_plane = None, None
        diag = math.dist(aabb[:3], aabb[3:])
        render_step_size = diag * math.sqrt(3) / 1024
        alpha_thre = 0.0
        cone_angle = args.cone_angle or 0.0
        grid_res = args.grid_resolution or 128
        scene_aabb = jnp.asarray(aabb)

    p_levels = tuple(
        (int(g), int(r))
        for g, r in (lv.split("x") for lv in args.levels.split(","))
    )
    if args.model == "tensorf":
        field = TensoCPRadianceField(
            aabb=aabb, unbounded=args.unbounded, levels=p_levels,
            quant_int8=args.quant_int8,
        )
    else:
        field = NGPRadianceField(
            aabb=aabb, unbounded=args.unbounded,
            gather_mode=args.ngp_gather_mode,
            log2_hashmap_size=args.ngp_log2_size,
            n_levels=args.ngp_levels,
            n_features=args.ngp_features,
        )
    key = jax.random.PRNGKey(args.seed)
    key, k_init = jax.random.split(key)
    params = field.init(k_init, jnp.zeros((8, 3)), jnp.zeros((8, 3)))

    grid = create_grid(aabb, resolution=grid_res, contraction_type=contraction)

    if args.lr_decay:
        sched = optax.cosine_decay_schedule(args.lr, args.max_steps, 0.1)
        optimizer = optax.adam(sched, eps=1e-15)
    else:
        optimizer = optax.adam(args.lr, eps=1e-15)
    opt_state = optimizer.init(params)

    render_kwargs = dict(
        scene_aabb=scene_aabb,
        near_plane=near_plane,
        far_plane=far_plane,
        render_step_size=render_step_size,
        cone_angle=cone_angle,
        alpha_thre=alpha_thre,
        max_samples_per_ray=args.max_samples_per_ray,
        samples_budget=args.samples_budget,
        coarse_stride=args.coarse_stride,
        probe_dilation=args.probe_dilation,
        compact_rays_fraction=args.compact_rays or None,
        visible_samples_budget=args.visible_samples_budget,
        exact_recheck=bool(args.exact_recheck),
        probe_groups=args.probe_groups or None,
    )
    field_ratio = args.field_budget_ratio
    if field_ratio < 0:
        field_ratio = 0.5 if args.model == "ngp" else 0.0
    if field_ratio > 0:
        render_kwargs["field_samples_budget"] = int(
            args.samples_budget * field_ratio
        )

    has_bkgd = render_bkgd is not None

    # Dynamic ray batching must scale the sample budgets WITH the bucket:
    # a fixed samples_budget under a growing num_rays shrinks the per-ray
    # slot count K = budget / n_rays — measured on the 800x800 full-
    # protocol gate as a death spiral (rays -> 65536, K -> 4, decimation
    # crushes live samples-per-ray, the controller raises rays further;
    # 18.3 PSNR @ 110 ms/step). The reference's update_num_rays
    # (train_ngp_nerf.py:236-241) never had this coupling because its
    # marcher has no budget. Keep the slots-per-ray ratios of the BASE
    # config constant across buckets.
    _k_slots = -(-args.samples_budget // args.num_rays)
    _kv_slots = -(-args.visible_samples_budget // args.num_rays)
    _kf_ratio = (
        render_kwargs.get("field_samples_budget", 0) / args.samples_budget
    )

    def _bucket_kwargs(n_rays):
        if args.target_sample_batch_size <= 0:
            return render_kwargs
        kw = dict(render_kwargs)
        kw["samples_budget"] = n_rays * _k_slots
        kw["visible_samples_budget"] = n_rays * _kv_slots
        if _kf_ratio > 0:
            kw["field_samples_budget"] = int(
                n_rays * _k_slots * _kf_ratio
            )
        return kw

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(
        params, opt_state, grid, rays_o, rays_d, pixels, bkgd, key, dist_w
    ):
        def loss_fn(p):
            colors, opacities, _, n, extras = render_rays(
                p, field, rays_o, rays_d, grid=grid,
                render_bkgd=bkgd if has_bkgd else None,
                stratified=True, key=key,
                return_extras=True, **_bucket_kwargs(rays_o.shape[0]),
            )
            per_ray = huber(colors, pixels).mean(-1)
            if has_bkgd:
                # bounded scenes composite non-hit rays onto the known
                # background exactly; excluding them from the loss skips
                # useless gradient (reference train_ngp_nerf.py:199-202)
                alive = (opacities[:, 0] > 0).astype(jnp.float32)
                loss = (per_ray * alive).sum() / jnp.maximum(
                    alive.sum(), 1.0
                )
            else:
                # bkgd=None (unbounded: the model owns the far field): a
                # dead ray renders black, NOT the GT — masking it out of
                # the loss locks in density collapse (measured: the
                # distortion-loss death spiral where rays that fall
                # under alpha_thre exit the loss and never recover).
                # Every ray stays in the photometric loss.
                loss = per_ray.mean()
            if args.distortion_loss > 0:
                from nerfacc_tpu import loss_distortion_dense

                ts0 = extras["t_starts"]
                ts1 = extras["t_starts"] + extras["deltas"]
                if args.unbounded:
                    # normalized disparity coordinates (MipNeRF-360
                    # Eq. 15 uses normalized ray distance): raw-t
                    # distortion at far-plane scale dominates the
                    # photometric loss (train_proposal_nerf.py, same
                    # rationale)
                    inv_n = 1.0 / near_plane
                    inv_f = 1.0 / far_plane

                    def to_s(t):
                        return (inv_n - 1.0 / jnp.maximum(t, 1e-6)) / (
                            inv_n - inv_f
                        )

                    ts0, ts1 = to_s(ts0), to_s(ts1)
                dist = loss_distortion_dense(
                    extras["weights"], ts0, ts1, masks=extras["masks"]
                )
                loss = loss + dist_w * dist.mean()
            if args.opacity_entropy > 0:
                o = jnp.clip(opacities[:, 0], 1e-5, 1.0 - 1e-5)
                ent = -(o * jnp.log(o) + (1.0 - o) * jnp.log(1.0 - o))
                loss = loss + args.opacity_entropy * ent.mean()
            return loss, (n, extras["field_budget_dropped"])

        (loss, (n, dropped)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, n, dropped

    cam_origins = jnp.asarray(np.asarray(scene.train_poses)[:, :3, -1])

    @functools.partial(jax.jit, static_argnames=("warmup",))
    def grid_update(params, grid, key, warmup: bool):
        def occ_eval_fn(x):
            if cone_angle > 0.0 and args.occ_cone_coupling:
                # couple the occupancy estimate to the cone-marching step
                # actually used at that distance from a (random) camera
                # (reference train_ngp_nerf.py:190-213)
                ids = jax.random.randint(
                    key, (x.shape[0],), 0, cam_origins.shape[0]
                )
                t = jnp.linalg.norm(
                    cam_origins[ids] - x, axis=-1, keepdims=True
                )
                step = jnp.maximum(t * cone_angle, render_step_size)
                if near_plane is not None and far_plane is not None:
                    step = jnp.where(
                        (t > near_plane) & (t < far_plane), step, 0.0
                    )
            else:
                step = render_step_size
            density = field.apply(
                params, x, method=field.query_density
            )
            return density * step
        return update_grid(
            grid, key, step=0 if warmup else 10**9,
            occ_eval_fn=occ_eval_fn, occ_thre=1e-2,
            ema_decay=args.occ_ema_decay,
            adaptive_thre=not args.fixed_occ_thre,
        )

    bucketer = (
        DynamicRayBucketer(
            args.target_sample_batch_size, init_num_rays=args.num_rays
        )
        if args.target_sample_batch_size > 0
        else None
    )
    num_rays = args.num_rays

    # checkpoint/resume (the reference has no checkpointing; SURVEY §5)
    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        from nerfacc_tpu.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            template = {
                "params": params, "opt_state": opt_state, "grid": grid,
                "step": 0,
            }
            restored = ckpt.restore(template)
            params = restored["params"]
            opt_state = restored["opt_state"]
            grid = restored["grid"]
            start_step = int(restored["step"]) + 1
            print(f"resumed from step {start_step - 1}")

    t_start = time.perf_counter()
    t_first = None  # end of the first step, which includes its compiles
    losses = {}  # loss at each printed step
    for step in range(start_step, args.max_steps):
        key, k_grid, k_render = jax.random.split(key, 3)
        if step % 16 == 0:
            grid = grid_update(params, grid, k_grid, step < 256)
        rays, pixels = scene.sample_batch(num_rays)
        # distortion warmup — measured HARMFUL on the 360 recipe (every
        # warmup variant collapsed; from-step-0 3e-2 works: early
        # distortion prevents the floater basin from forming, delayed
        # distortion cannot dismantle it). Default 0 = no warmup.
        w = args.distortion_warmup
        dw = args.distortion_loss * (
            min(1.0, max(0.0, (step - w) / max(w, 1))) if w > 0 else 1.0
        )
        params, opt_state, loss, n, dropped = train_step(
            params, opt_state, grid,
            rays.origins, rays.viewdirs, pixels,
            scene.bkgd if has_bkgd else jnp.zeros(3), k_render,
            jnp.float32(dw),
        )
        if step == 0 and int(dropped) > 0:
            print(
                f"WARNING: field_samples_budget trims {int(dropped)} live "
                "samples on step 0 (drops spread proportionally across "
                "rays); raise --field_budget_ratio to cover the live count"
            )
        if bucketer is not None:
            num_rays = bucketer.update(int(n), num_rays)
        if ckpt is not None and (
            step % args.ckpt_every == 0 or step == args.max_steps - 1
        ):
            ckpt.save(
                step,
                {"params": params, "opt_state": opt_state, "grid": grid,
                 "step": step},
            )
        if step % 1000 == 0 or step == args.max_steps - 1:
            losses[step] = float(loss)
            el = time.perf_counter() - t_start
            print(
                f"step={step} loss={losses[step]:.5f} "
                f"n_samples={int(n)} elapsed={el:.1f}s"
                + (f" budget_dropped={int(dropped)}" if int(dropped) else "")
            )
        if step == start_step:
            jax.block_until_ready(loss)
            t_first = time.perf_counter()
    # the last step printed its loss, so the device has finished it
    t_loop = time.perf_counter()
    n_steady = args.max_steps - start_step - 1
    steady_step_s = (t_loop - t_first) / n_steady if n_steady > 0 else None
    if t_first is not None:
        print(
            f"step_time_s: first {t_first - t_start:.3f} (with compiles), "
            + (f"steady {steady_step_s:.5f}" if steady_step_s else "steady -")
        )

    psnrs = []
    eval_poses, eval_images = scene.test_poses, scene.test_images
    if args.eval_on_train_views:
        # diagnostic: render TRAIN views through the eval path. A model
        # that fits its training pixels (low train loss) must score high
        # here unless the eval render path diverges from the train
        # render on the same rays — separates overfitting/floaters from
        # a train/eval render mismatch.
        eval_poses, eval_images = scene.train_poses, scene.images
        if eval_images.shape[-1] == 4:
            # blender loaders keep train images RGBA; composite onto the
            # eval background (white) so the GT matches the eval render
            rgb, a = eval_images[..., :3], eval_images[..., 3:]
            eval_images = rgb * a + (1.0 - a)
    print(
        f"eval: {min(args.eval_views, eval_poses.shape[0])} of "
        f"{eval_poses.shape[0]} test poses "
        f"({eval_images.shape[1]}x{eval_images.shape[2]})"
    )
    for i in range(min(args.eval_views, eval_poses.shape[0])):
        rays = scene.rays_for_view(eval_poses[i])
        eval_kwargs = dict(render_kwargs, coarse_stride=1)
        colors, _, _ = render_image(
            params, field, rays.origins, rays.viewdirs,
            grid=grid, render_bkgd=jnp.ones(3) if has_bkgd else None,
            test_chunk_size=args.test_chunk_size,
            eval_visible_samples_per_ray=64, **eval_kwargs,
        )
        gt = eval_images[i].reshape(-1, 3)
        mse = float(jnp.mean((colors - gt) ** 2))
        psnrs.append(-10.0 * np.log10(mse))
    train_time = time.perf_counter() - t_start
    print(f"PSNR: {np.mean(psnrs):.2f} (views: {[f'{x:.2f}' for x in psnrs]})")
    print(f"train_time_s: {train_time:.1f}")
    return {
        "psnr": float(np.mean(psnrs)),
        "losses": losses,
        "first_step_s": None if t_first is None else t_first - t_start,
        "steady_step_s": steady_step_s,
        "eval_s": time.perf_counter() - t_loop,
    }


if __name__ == "__main__":
    main()
