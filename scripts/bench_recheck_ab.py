"""Round-3 experiment (VERDICT #7): the exact per-slot re-check tail.

The strided-probe march tests a *dilated* occupancy table per probe group
(recall 1), then re-checks the exact grid at the K selected slots to drop
dilation-shell positives (reference exact semantics:
reference ``cuda/csrc/ray_marching.cu:27-45``). The re-check
measured ~2 ms (~11%) of the round-2 step; removing it costs -6.6 dB.

Candidate middle ground (the VERDICT's suggestion): re-check only slots
whose probe group straddles an occupancy boundary. Implemented here with
an ERODED bit table — a group whose probe center passes the
radius-r-eroded exact grid is entirely inside occupied space (every
sample of the group lies within r voxels of the probe center, the same
geometry that makes the dilated probe recall-1), so its slots can accept
without the exact bit. Slots of straddling groups still need the exact
gather.

What this script measures (march-only, bench shapes):

  A. march_rays default          (exact re-check at all K slots)
  B. march_rays exact_recheck=0  (the floor: no re-check at all)
  C. boundary-scoped variant     (eroded safe-bit | exact bit)

Expected outcome (recorded either way in docs/benchmarks.md): the
re-check is gather-ISSUE-bound — one bit-table row gather per selected
slot — and XLA's static shapes mean variant C still issues the exact
gather for every slot (``safe | exact`` cannot elide lanes), PLUS the
(R, G) eroded probe lookups. C can only be >= A; the experiment exists
to measure the delta and close VERDICT #7 with a number instead of an
argument. C's masks are asserted identical to A's first. The geometric
invariant behind "safe => exact": every sample of a group lies within
probe_dilation voxels of the group's probe center — which holds only for
groups fully inside the ray's [t_min, t_max] range, because the t_max
clamp can move a straddling group's probe center up to s*dt away from
its first in-range sample; such groups are explicitly marked unsafe
(advisor round-3 finding).
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from nerfacc_tpu import create_grid
from nerfacc_tpu.grid import with_binary
from nerfacc_tpu.intersection import ray_aabb_intersect
from nerfacc_tpu.lookup import pack_bits
from nerfacc_tpu.ray_marching import (
    MAX_DIST,
    RaySegments,
    _lattice_k,
    _lattice_t,
    _probe_layout,
    gather_rows_dense,
    march_rays,
    probe_live_groups,
    select_slots_grouped,
)


def erode_binary(binary: jnp.ndarray) -> jnp.ndarray:
    """3x3x3 box (min) erosion — the dual of ``grid.dilate_binary`` with
    an all-empty boundary (conservative: edge cells erode away)."""
    x = binary
    for axis in range(3):
        sl = (slice(None),) * axis
        lo = jnp.roll(x, 1, axis=axis).at[sl + (0,)].set(False)
        hi = jnp.roll(x, -1, axis=axis).at[sl + (-1,)].set(False)
        x = x & lo & hi
    return x


def march_boundary_recheck(
    rays_o, rays_d, t_min, t_max, grid, safe_bits, *,
    render_step_size, max_samples_per_ray, slots_per_ray, coarse_stride,
    probe_dilation, probe_groups, return_safe=False,
):
    """march_rays' grouped path with the re-check scoped to straddling
    groups via the eroded ``safe_bits`` table (same exact semantics)."""
    S, K, C = max_samples_per_ray, slots_per_ray, coarse_stride
    dt = render_step_size
    live_g = probe_live_groups(
        rays_o, rays_d, t_min, t_max, grid, render_step_size=dt,
        max_samples_per_ray=S, coarse_stride=C,
        probe_dilation=probe_dilation, probe_groups=probe_groups,
    )
    k_in = jnp.clip(
        jnp.ceil(_lattice_k(t_min, t_max, dt, 0.0, MAX_DIST) - 0.5), 0, S
    ).astype(jnp.int32)
    G, s = _probe_layout(k_in, S, C, probe_groups)
    # per-group safety: eroded-table lookup at the group probe centers
    g = jnp.arange(G, dtype=jnp.int32)[None, :]
    kc = (g * s).astype(jnp.float32) + (s.astype(jnp.float32) - 1.0) / 2.0 + 0.5
    t_probe = _lattice_t(t_min[:, None], kc, dt, 0.0, MAX_DIST)
    t_probe = jnp.minimum(t_probe, t_max[:, None] - 0.5 * dt)
    xyz_p = rays_o[:, None, :] + t_probe[..., None] * rays_d[:, None, :]
    safe_grid = grid.replace(bits=safe_bits)
    safe_g = safe_grid.query_occ_fast(xyz_p)  # (R, G) exact-table semantics
    # groups straddling t_max are never safe: the clamp above can move the
    # probe center up to s*dt (> the erosion radius at this config) away
    # from the group's first in-range sample, so the within-r-voxels
    # geometry that justifies "safe => exact" does not hold for them
    # (advisor round-3 finding)
    safe_g = safe_g & ((g + 1) * s <= k_in[:, None])

    pos, ok, scale = select_slots_grouped(live_g, s, K)
    gidx = pos // s  # (R, K) each slot's probe group
    t_starts = _lattice_t(t_min[:, None], pos.astype(jnp.float32), dt, 0.0, MAX_DIST)
    t_ends = _lattice_t(
        t_min[:, None], pos.astype(jnp.float32) + 1.0, dt, 0.0, MAX_DIST
    )
    deltas = (
        _lattice_t(
            t_min[:, None], (pos + scale).astype(jnp.float32), dt, 0.0, MAX_DIST
        )
        - t_starts
    )
    # boundary-scoped re-check: safe groups accept outright
    safe_slot = gather_rows_dense(safe_g, gidx)
    mid = (t_starts + t_ends) * 0.5
    xyz = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
    exact = grid.query_occ_fast(xyz)
    masks = ok & (safe_slot | exact)
    seg = RaySegments(t_starts=t_starts, t_ends=t_ends, deltas=deltas, masks=masks)
    if return_safe:
        return seg, ok & safe_slot
    return seg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_rays", type=int, default=12288)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    aabb = jnp.asarray([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5])
    grid = create_grid(aabb, resolution=128, occupied=True)
    binary = np.zeros((128, 128, 128), bool)
    binary[32:96, 32:96, 32:96] = True
    grid = with_binary(grid, jnp.asarray(binary))
    # radius-2 erosion to match probe_dilation=2 (same coverage geometry)
    safe_bits = pack_bits(erode_binary(erode_binary(grid.binary)))

    r = np.random.RandomState(0)
    R = args.n_rays
    rays_o = jnp.asarray(r.rand(R, 3) * 2 - 1, jnp.float32)
    rays_d = r.randn(R, 3)
    rays_d = jnp.asarray(
        rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True), jnp.float32
    )
    t_min, t_max = ray_aabb_intersect(rays_o, rays_d, aabb)
    t_min = jnp.maximum(t_min, 0.0)
    t_max = jnp.minimum(t_max, 6.0)

    cfg = dict(
        render_step_size=5e-3, max_samples_per_ray=1024, slots_per_ray=64,
        coarse_stride=16, probe_dilation=2, probe_groups=32,
    )

    fA = jax.jit(lambda o, d, a, b: march_rays(
        o, d, a, b, grid=grid, exact_recheck=True, **cfg))
    fB = jax.jit(lambda o, d, a, b: march_rays(
        o, d, a, b, grid=grid, exact_recheck=False, **cfg))
    fC = jax.jit(lambda o, d, a, b: march_boundary_recheck(
        o, d, a, b, grid, safe_bits, **cfg))

    segA = fA(rays_o, rays_d, t_min, t_max)
    segC = fC(rays_o, rays_d, t_min, t_max)
    same = bool(jnp.all(segA.masks == segC.masks))
    nA = int(jnp.sum(segA.masks))
    print(f"masks identical A==C: {same} (live slots: {nA})")
    assert same, "boundary-scoped re-check changed the sample set"
    # diagnostic: the fraction of live slots the eroded safe bit accepts
    # without the exact gather — the headroom variant C is playing for
    _, safe_slots = march_boundary_recheck(
        rays_o, rays_d, t_min, t_max, grid, safe_bits, return_safe=True,
        **cfg,
    )
    safe_fr = float(jnp.sum(safe_slots & segC.masks)) / max(nA, 1)
    print(f"safe-group slot fraction (of live slots): {safe_fr:.3f}")

    results = {}
    for name, f in [("A_exact_recheck", fA), ("B_no_recheck", fB),
                    ("C_boundary_recheck", fC)]:
        seg = f(rays_o, rays_d, t_min, t_max)  # warm
        jax.block_until_ready(seg.masks)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            seg = f(rays_o, rays_d, t_min, t_max)
        jax.block_until_ready(seg.masks)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        results[name] = ms
        print(f"{name}: {ms:.3f} ms/march ({R} rays x {cfg['slots_per_ray']} slots)")
    a, b, c = (results[k] for k in
               ("A_exact_recheck", "B_no_recheck", "C_boundary_recheck"))
    print(
        f"re-check cost (A-B): {a - b:.3f} ms; boundary variant vs A: "
        f"{c - a:+.3f} ms ({'WINS' if c < a else 'REJECTED'})"
    )


if __name__ == "__main__":
    main()
