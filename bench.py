"""Benchmark: end-to-end train-step throughput on the accelerator.

Measures samples/s through the full differentiable render path (occupancy
grid march -> sigma-culling -> grad-tracked composite -> backward + adam),
the workload the reference's headline "NGP Lego 20k steps / 287 s" number
is made of. ``vs_baseline`` divides by the reference's own published
anchor: 2^18 samples/batch over 20k steps in 287 s on its TITAN RTX
(~1.83e7 samples/s), a number of the reference on its card, not of this
program.

All data stays device-resident during the timing loop; the live-sample
counter is accumulated on device and read once. Prints ONE JSON line,
naming the device it ran on.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax

# the reference's published anchor (TITAN RTX, BASELINE.md)
REFERENCE_SAMPLES_PER_S = (1 << 18) * 20_000 / 287.0  # ~1.83e7


def _device() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main(argv=None):
    from nerfacc_tpu import create_grid, with_binary
    from nerfacc_tpu.compile_cache import setup_compile_cache
    from nerfacc_tpu.models import NGPRadianceField, TensoCPRadianceField
    from nerfacc_tpu.utils import render_rays

    setup_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--model", choices=["tensorf", "ngp"], default="tensorf",
        help="'tensorf' (CP hat-basis matmuls, the NGP-class flagship) or "
        "'ngp' (the reference's hash-grid field)",
    )
    ap.add_argument(
        "--grid", choices=["halfcube", "trained"], default="halfcube",
        help="occupancy: synthetic half-occupied cube, or the binary "
        "saved from a trained procedural run (bench_assets/"
        "trained_grid.npz) so culling ratios match a real scene",
    )
    ap.add_argument("--iters", type=int, default=0, help="0 = per-model default")
    ap.add_argument("--n_rays", type=int, default=16384)
    ap.add_argument(
        "--quant_int8", action="store_true",
        help="with --model tensorf: run the CP forward contractions in "
        "int8 (basis quantization = 1/127-voxel positional rounding, "
        "exact bf16 backward)",
    )
    ap.add_argument(
        "--visible_budget_ratio", type=float, default=0.0,
        help="> 0 enables the two-stage cull-then-render path (the "
        "flagship quality config uses 0.5): stage-1 density-only pass + "
        "visibility culling, then the grad-tracked render on "
        "ratio * samples_budget re-selected visible slots",
    )
    ap.add_argument(
        "--field_budget_ratio", type=float, default=-1.0,
        help="compact the radiance-field evaluation to ratio * "
        "samples_budget march-live slots (ops/sample_compact.py): the "
        "hash encoder pays its gathers per slot, live or dead. Default "
        "-1 = auto: 0.5 for ngp, off for tensorf",
    )
    ap.add_argument(
        "--mode", choices=["train", "eval"], default="train",
        help="train: full differentiable step (the headline metric); "
        "eval: forward-only render (inference rays/s + samples/s)",
    )
    ap.add_argument(
        "--trace", type=str, default=None, metavar="DIR",
        help="capture a jax.profiler trace of the timed loop into DIR, "
        "with the step's optimized HLO beside it (scripts/xplane.py sums "
        "its device time per layer)",
    )
    ap.add_argument(
        "--ngp_gather_mode", type=str, default="packed",
        choices=["packed", "per_level"],
        help="with --model ngp: forward gather formulation (per_level = "
        "L gathers over per-level slices of the table)",
    )
    ap.add_argument(
        "--ngp_log2_size", type=int, default=19,
        help="with --model ngp: log2 hash-table size per level (the L/T "
        "quality-throughput frontier; reference uses 19)",
    )
    ap.add_argument(
        "--ngp_levels", type=int, default=16,
        help="with --model ngp: number of hash levels (reference: 16)",
    )
    ap.add_argument(
        "--ngp_features", type=int, default=2,
        help="with --model ngp: features per level (4 + 8 levels = the "
        "capacity-preserving half-corner config)",
    )
    args = ap.parse_args(argv)

    n_rays = args.n_rays
    samples_budget = n_rays * 48  # K=48 slots/ray pre-compaction
    aabb = jnp.asarray([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5])

    # flagship NGP-class field (the reference's headline workload is the
    # NGP hash-grid example; TensoCP is the matmul-based equivalent)
    if args.model == "tensorf":
        field = TensoCPRadianceField(
            aabb=tuple(float(v) for v in np.asarray(aabb)),
            quant_int8=args.quant_int8,
        )
        iters = args.iters or 30
    else:
        field = NGPRadianceField(
            aabb=tuple(float(v) for v in np.asarray(aabb)),
            gather_mode=args.ngp_gather_mode,
            log2_hashmap_size=args.ngp_log2_size,
            n_levels=args.ngp_levels,
            n_features=args.ngp_features,
        )
        iters = args.iters or 20
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3))
    )
    grid = create_grid(aabb, resolution=128, occupied=True)
    if args.grid == "trained":
        # occupancy binary from a converged procedural training run
        # (scripts/save_bench_grid.py) — realistic sparsity + topology
        asset = Path(__file__).parent / "bench_assets" / "trained_grid.npz"
        if not asset.exists():
            raise SystemExit(
                f"{asset} missing — generate it first: "
                "python scripts/save_bench_grid.py --steps 2000"
            )
        binary = np.load(asset)["binary"]
    else:
        # half-occupied cube: synthetic but stable culling ratio
        binary = np.zeros((128, 128, 128), bool)
        binary[32:96, 32:96, 32:96] = True
    grid = with_binary(grid, jnp.asarray(binary))

    optimizer = optax.adam(5e-4)
    opt_state = optimizer.init(params)
    kwargs = dict(
        scene_aabb=aabb,
        render_step_size=5e-3,
        max_samples_per_ray=1024,
        samples_budget=samples_budget,
        coarse_stride=16,
        probe_dilation=2,  # C*dt/2 = 0.04 <= 2 voxels (0.047)
        # ~60% of rays hit the half-occupied cube; drop the rest before any
        # per-sample work and re-spread the budget over hitting rays
        compact_rays_fraction=0.75,
        # adaptive-stride probing: 32 groups/ray sized to each ray's
        # in-range span (vs 64 fixed-stride groups, most of them beyond
        # t_max) — fewer lookups and finer probes on short rays
        probe_groups=32,
    )
    if args.visible_budget_ratio > 0:
        kwargs["visible_samples_budget"] = int(
            samples_budget * args.visible_budget_ratio
        )
    field_ratio = args.field_budget_ratio
    if field_ratio < 0:
        field_ratio = 0.5 if args.model == "ngp" else 0.0
    if field_ratio > 0:
        kwargs["field_samples_budget"] = int(samples_budget * field_ratio)

    if args.mode == "eval":
        # inference path: forward-only render (no grad, no optimizer)
        @functools.partial(jax.jit, donate_argnums=(2,))
        def eval_step(params, grid, n_acc, rays_o, rays_d):
            colors, _, _, n = render_rays(
                params, field, rays_o, rays_d, grid=grid,
                render_bkgd=jnp.ones(3), **kwargs,
            )
            return n_acc + n, colors

        r = np.random.RandomState(0)
        o = jnp.asarray(r.rand(iters + 1, n_rays, 3) * 2 - 1, jnp.float32)
        d = jnp.asarray(r.randn(iters + 1, n_rays, 3), jnp.float32)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        n_acc = jnp.zeros((), jnp.int32)
        n_acc, colors = eval_step(params, grid, n_acc, o[0], d[0])
        np.asarray(colors[:1])  # true sync (host read)
        n_acc = jnp.zeros((), jnp.int32)
        t0 = time.perf_counter()
        for i in range(1, iters + 1):
            n_acc, colors = eval_step(params, grid, n_acc, o[i], d[i])
        n_total = int(np.asarray(n_acc))
        dt = time.perf_counter() - t0
        print(
            json.dumps(
                {
                    "metric": "eval_samples_per_s_per_chip",
                    "value": round(n_total / dt, 1),
                    "unit": "samples/s",
                    "vs_baseline": round(
                        n_total / dt / REFERENCE_SAMPLES_PER_S, 3
                    ),
                    "rays_per_s": round(iters * n_rays / dt, 1),
                    "model": args.model,
                    "grid": args.grid,
                    "device": _device(),
                }
            )
        )
        return

    # donating params/opt_state/n_acc lets XLA update them in place
    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def train_step(params, opt_state, n_acc, rays_o, rays_d, pixels):
        def loss_fn(p):
            # compact path: non-hit rays render exactly the background,
            # so the full-batch MSE is recovered algebraically without
            # the expand-back scatter (see render_rays(return_compact=True))
            colors, _, _, n, sel = render_rays(
                p, field, rays_o, rays_d, grid=grid,
                render_bkgd=jnp.ones(3), aux=pixels,
                return_compact=True, **kwargs,
            )
            p_h, okm = sel["aux"], sel["ray_ok"][:, None]
            sh = jnp.sum(jnp.where(okm, (colors - p_h) ** 2, 0.0))
            sbg = jnp.sum((1.0 - pixels) ** 2) - jnp.sum(
                jnp.where(okm, (1.0 - p_h) ** 2, 0.0)
            )
            return (sh + sbg) / pixels.size, n

        (loss, n), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        with jax.named_scope("optimizer"):
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        return params, opt_state, n_acc + n, loss

    r = np.random.RandomState(0)
    o = jnp.asarray(r.rand(iters + 1, n_rays, 3) * 2 - 1, jnp.float32)
    d = jnp.asarray(r.randn(iters + 1, n_rays, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    px = jnp.asarray(r.rand(iters + 1, n_rays, 3), jnp.float32)
    n_acc = jnp.zeros((), jnp.int32)

    # compile once; the same executable runs the warmup and the timed loop
    t_c = time.perf_counter()
    train_step = train_step.lower(
        params, opt_state, n_acc, o[0], d[0], px[0]
    ).compile()
    compile_s = time.perf_counter() - t_c
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        (Path(args.trace) / "train_step.hlo.txt").write_text(
            train_step.as_text()
        )
    # warmup + true sync via host read
    params, opt_state, n_acc, loss = train_step(
        params, opt_state, n_acc, o[0], d[0], px[0]
    )
    np.asarray(loss)
    n_acc = jnp.zeros((), jnp.int32)

    import contextlib

    trace_cm = (
        jax.profiler.trace(args.trace)
        if args.trace
        else contextlib.nullcontext()
    )
    t0 = time.perf_counter()
    with trace_cm:
        for i in range(1, iters + 1):
            params, opt_state, n_acc, loss = train_step(
                params, opt_state, n_acc, o[i], d[i], px[i]
            )
        n_total = int(np.asarray(n_acc))  # device->host read: real sync
    dt = time.perf_counter() - t0

    samples_per_s = n_total / dt
    print(
        json.dumps(
            {
                "metric": "train_samples_per_s_per_chip",
                "value": round(samples_per_s, 1),
                "unit": "samples/s",
                "vs_baseline": round(samples_per_s / REFERENCE_SAMPLES_PER_S, 3),
                "model": args.model,
                "grid": args.grid,
                "quant_int8": args.quant_int8,
                "visible_budget_ratio": args.visible_budget_ratio,
                "field_budget_ratio": field_ratio,
                "iters": iters,
                "compile_s": round(compile_s, 3),
                "device": _device(),
            }
        )
    )


if __name__ == "__main__":
    main()
