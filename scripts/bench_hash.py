"""Hash-encoder measurement harness: gather and scatter floors, the
encoder unit, and the NGP train step, at bench scale.

    python scripts/bench_hash.py primitives   # gather/scatter floors
    python scripts/bench_hash.py bisect       # e2e step decomposition
    python scripts/bench_hash.py pairgather   # wide-element gathers
    python scripts/bench_hash.py r5gather     # full-table vs per-level

Each bench runs K iterations inside one jitted ``lax.scan`` whose body is
isolated with ``optimization_barrier`` and reduced with a full ``jnp.sum``
(so XLA cannot delete the op), then syncs with one host readback. Big
constants are jit arguments, not closed-over arrays (a closed-over table
would be constant-folded into the program). Times taken on an earlier
accelerator are not kept; measure on the GPU.

Reference workload: tcnn hash grid,
reference ``examples/radiance_fields/ngp.py:108-145``.
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

from nerfacc_tpu.compile_cache import setup_compile_cache

REPS = 2
L = 16
T = 1 << 19


def timeit_scan(name, fn, *args, reps=REPS):
    """Scan-isolated, DCE-proof, host-read-synced timing (see module
    docstring for why every piece is load-bearing)."""

    @jax.jit
    def run(args):
        def body(c, _):
            a = jax.lax.optimization_barrier(args)
            out = fn(*a)
            tot = sum(
                jnp.sum(leaf.astype(jnp.float32))
                for leaf in jax.tree_util.tree_leaves(out)
            )
            return c + tot, None

        c, _ = jax.lax.scan(
            body, jnp.zeros((), jnp.float32), None, length=reps
        )
        return c

    np.asarray(run(args))  # compile + sync
    best = 1e30
    for _ in range(2):
        t0 = time.perf_counter()
        np.asarray(run(args))
        best = min(best, (time.perf_counter() - t0) / reps)
    print(f"{name:46s} {best * 1e3:9.1f} ms", flush=True)
    return best


def cmd_primitives(args):
    """Gather + scatter floors at bench scale (primitives3/4/6 core)."""
    rng = np.random.RandomState(0)
    n8 = args.n_samples * 8  # corners per level

    # G1: the shipped forward unit — one u32 gather over the flat table
    idx_all = jnp.asarray(
        rng.randint(0, L * T, (args.n_samples, L * 8)), jnp.int32
    )
    table_u32 = jnp.asarray(
        rng.randint(0, 2**31, L * T).astype(np.uint32)
    )

    def g1(t, i):
        return t[i]

    timeit_scan(
        f"G1 u32 gather (N={args.n_samples}, L*8)", g1, table_u32, idx_all
    )

    # S2: the shipped backward unit — per-level scatters, 2 features
    idx_l = jnp.asarray(rng.randint(0, T, (L, n8)), jnp.int32)
    v0_l = jnp.asarray(rng.rand(L, n8), jnp.float32)
    v1_l = jnp.asarray(rng.rand(L, n8), jnp.float32)

    def s2(idx_l, v0_l, v1_l):
        outs = []
        for lev in range(L):
            outs.append(
                jnp.zeros((T,), jnp.float32).at[idx_l[lev]].add(v0_l[lev])
            )
            outs.append(
                jnp.zeros((T,), jnp.float32).at[idx_l[lev]].add(v1_l[lev])
            )
        return outs

    timeit_scan(f"S2 per-level 16x[{n8/1e6:.1f}M->524k] x2", s2,
                idx_l, v0_l, v1_l)

    # S4: single-scatter size curve (superlinearity check)
    off = (jnp.arange(L, dtype=jnp.int32) * T)[:, None]
    flat_idx = (idx_l + off).reshape(-1)
    fv0 = v0_l.reshape(-1)
    for m in (1, 4, 16):
        n = min(n8 * m, flat_idx.shape[0])

        def s4(idx, v):
            return jnp.zeros((L * T,), jnp.float32).at[idx].add(v)

        timeit_scan(f"S4 one scatter @{n/1e6:.1f}M -> 8.4M", s4,
                    flat_idx[:n], fv0[:n])


def cmd_bisect(args):
    """End-to-end NGP step decomposition at bench shapes (bisect_ngp4)."""
    import optax

    from nerfacc_tpu import create_grid, with_binary
    from nerfacc_tpu.models import NGPRadianceField
    from nerfacc_tpu.models.hash_encoding import HashEncoder
    from nerfacc_tpu.utils import render_rays

    rng = np.random.RandomState(0)
    n_rays = args.n_rays
    samples_budget = n_rays * 48
    aabb = jnp.asarray([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5])
    field = NGPRadianceField(aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5))
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3))
    )
    grid = create_grid(aabb, resolution=128, occupied=True)
    binary = np.zeros((128, 128, 128), bool)
    binary[32:96, 32:96, 32:96] = True
    grid = with_binary(grid, jnp.asarray(binary))
    optimizer = optax.adam(5e-4)
    opt_state = optimizer.init(params)

    base_kwargs = dict(
        scene_aabb=aabb, render_step_size=5e-3, max_samples_per_ray=1024,
        samples_budget=samples_budget, coarse_stride=16, probe_dilation=2,
        compact_rays_fraction=0.75, probe_groups=32,
    )
    if args.field_budget_ratio > 0:
        base_kwargs["field_samples_budget"] = int(
            samples_budget * args.field_budget_ratio
        )
    o = jnp.asarray(rng.rand(n_rays, 3) * 2 - 1, jnp.float32)
    d = jnp.asarray(rng.randn(n_rays, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    px = jnp.asarray(rng.rand(n_rays, 3), jnp.float32)

    def fwd_only(params, rays_o, rays_d):
        colors, _, _, n = render_rays(
            params, field, rays_o, rays_d, grid=grid,
            render_bkgd=jnp.ones(3), **base_kwargs,
        )
        return colors, n

    timeit_scan("E render fwd only (bench shapes)", fwd_only, params, o, d)

    n_enc = samples_budget
    if args.field_budget_ratio > 0:
        n_enc = int(samples_budget * args.field_budget_ratio)
    x = jnp.asarray(rng.rand(n_enc, 3), jnp.float32)
    enc = HashEncoder()
    ep = enc.init(jax.random.PRNGKey(0), x[:8])

    def enc_grad(p, xx):
        return jax.grad(lambda pp: jnp.sum(enc.apply(pp, xx) ** 2))(p)

    timeit_scan(f"B encoder fwd+bwd @{n_enc/1e6:.2f}M pts", enc_grad, ep, x)

    def enc_fwd(p, xx):
        return enc.apply(p, xx)

    timeit_scan(f"B2 encoder fwd only @{n_enc/1e6:.2f}M pts", enc_fwd, ep, x)

    def train_step(params, opt_state, rays_o, rays_d, pixels):
        def loss_fn(p):
            colors, _, _, n, sel = render_rays(
                p, field, rays_o, rays_d, grid=grid,
                render_bkgd=jnp.ones(3), aux=pixels,
                return_compact=True, **base_kwargs,
            )
            p_h, okm = sel["aux"], sel["ray_ok"][:, None]
            sh = jnp.sum(jnp.where(okm, (colors - p_h) ** 2, 0.0))
            sbg = jnp.sum((1.0 - pixels) ** 2) - jnp.sum(
                jnp.where(okm, (1.0 - p_h) ** 2, 0.0)
            )
            return (sh + sbg) / pixels.size, n

        (loss, n), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_opt, n, loss

    timeit_scan("C bench train_step (verbatim)", train_step,
                params, opt_state, o, d, px)


def cmd_pairgather(args):
    """Wide-element gather probe: one u32 gather against an 8-byte
    complex64 gather carrying both features of two corners."""
    rng = np.random.RandomState(0)
    n = args.n_samples * 8 * L
    idx = jnp.asarray(rng.randint(0, L * T, size=n), jnp.int32)
    table_u32 = jnp.asarray(rng.randint(0, 2**31, L * T).astype(np.uint32))

    def g(t, i):
        return t[i]

    timeit_scan(f"u32 gather, {n/1e6:.1f}M idx", g, table_u32, idx)

    if args.try_c64:
        table_c64 = jnp.asarray(
            rng.randn(L * T).astype(np.float32)
            + 1j * rng.randn(L * T).astype(np.float32),
            jnp.complex64,
        )

        def gc(t, i):
            x = t[i]
            return jnp.real(x) + jnp.imag(x)

        try:
            timeit_scan(f"c64 gather, {n/1e6:.1f}M idx", gc, table_c64, idx)
        except Exception as e:  # noqa: BLE001
            print(f"c64 gather FAILED: {type(e).__name__}: {str(e)[:100]}")


def cmd_r5gather(args):
    """Forward-gather experiments.

    (a) full-table vs per-level-operand u32 gathers at stream scale;
    (b) the T-size curve of the per-level rate (the L/T frontier's
        throughput axis);
    (c) the real encoder unit (hash_encode_lookup) fwd and fwd+bwd in
        both gather modes, including the (L, 8N) relayout transposes.
    """
    rng = np.random.RandomState(0)
    N = args.n_samples
    n8 = N * 8

    table_u32 = jnp.asarray(rng.randint(0, 2**31, L * T).astype(np.uint32))
    idx_all = jnp.asarray(rng.randint(0, L * T, (N, L * 8)), jnp.int32)

    def g_full(t, i):
        return t[i]

    tb = timeit_scan(f"G full-table u32 gather ({N*L*8/1e6:.1f}M idx)",
                     g_full, table_u32, idx_all)

    idx_l = jnp.asarray(rng.randint(0, T, (L, n8)), jnp.int32)

    def g_per_level(t, il):
        outs = []
        for lev in range(L):
            tl = jax.lax.dynamic_slice_in_dim(t, lev * T, T)
            outs.append(tl[il[lev]])
        return outs

    tp = timeit_scan(f"G per-level 16x({n8/1e6:.1f}M idx over 2MB)",
                     g_per_level, table_u32, idx_l)
    print(f"  -> full {tb/ (N*L*8) * 1e9:.2f} ns/idx, "
          f"per-level {tp / (N*L*8) * 1e9:.2f} ns/idx", flush=True)

    # (b) T-size curve at constant index volume
    for log2t in (15, 17, 19):
        Ts = 1 << log2t
        ix = jnp.asarray(rng.randint(0, Ts, (L, n8)), jnp.int32)

        def g_t(t, il, Ts=Ts):
            return [
                jax.lax.dynamic_slice_in_dim(t, lev * Ts, Ts)[il[lev]]
                for lev in range(L)
            ]

        tt = timeit_scan(f"G per-level T=2^{log2t}", g_t, table_u32, ix)
        print(f"  -> {tt / (N*L*8) * 1e9:.2f} ns/idx", flush=True)

    # (c) the real encoder unit in both modes
    from nerfacc_tpu.ops.hash_gather import hash_encode_lookup

    table = jnp.asarray(rng.randn(2 * L * T).astype(np.float32) * 1e-2)
    cw = jnp.asarray(rng.rand(N, L * 8).astype(np.float32))
    fi = idx_all

    for mode, label in ((True, "packed"), ("per_level", "per_level")):
        def e_fwd(t, i, w, mode=mode):
            return hash_encode_lookup(t, i, w, T, mode)

        timeit_scan(f"E lookup fwd [{label}]", e_fwd, table, fi, cw)

        def e_grad(t, i, w, mode=mode):
            return jax.grad(
                lambda tt: jnp.sum(
                    hash_encode_lookup(tt, i, w, T, mode) ** 2
                )
            )(t)

        timeit_scan(f"E lookup fwd+bwd [{label}]", e_grad, table, fi, cw)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("primitives", help="gather/scatter floors")
    p.add_argument("--n_samples", type=int, default=786432)
    p.set_defaults(fn=cmd_primitives)

    p = sub.add_parser("bisect", help="e2e NGP step decomposition")
    p.add_argument("--n_rays", type=int, default=16384)
    p.add_argument(
        "--field_budget_ratio", type=float, default=0.0,
        help="also size the encoder microbench to the compacted point "
        "count (matches bench.py --field_budget_ratio)",
    )
    p.set_defaults(fn=cmd_bisect)

    p = sub.add_parser("r5gather", help="forward-gather experiments")
    p.add_argument("--n_samples", type=int, default=786432)
    p.set_defaults(fn=cmd_r5gather)

    p = sub.add_parser("pairgather", help="wide-element gather probe")
    p.add_argument("--n_samples", type=int, default=131072)
    p.add_argument(
        "--try_c64", action="store_true",
        help="also time the complex64 gather",
    )
    p.set_defaults(fn=cmd_pairgather)

    args = ap.parse_args()
    setup_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
