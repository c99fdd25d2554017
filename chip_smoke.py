"""Smoke run of the training and render path on a GPU.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: the sharded step only

One process drives the card(s). Phases, in order:

1. device: refuses to run unless JAX finds a GPU; prints the card's name
   and power limit, the JAX version and the compile-cache directory.
2. flagship train: ``examples/train_ngp_nerf.py``'s ``main(argv)`` with the
   TensoCP field at its default widths and the reference's batch of 2^18
   samples, then one held-out view rendered.
3. hash-grid train: the same entry point with the hash-grid field at the
   reference's published widths (L=16, F=2, T=2^19).
4. reference: the timed path against the repo's plain references at real
   widths — march + composite against the float64 oracle of the
   reference's serial kernels, the bf16 TensoCP field against its float32
   self, and the hash encoder's forward and table gradient against a
   plain gather plus autodiff. Reference sides run under
   ``jax.default_matmul_precision("highest")``.

The last line is one JSON object, ``{"ok": true, "device": {...}}``, and
is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import reference_oracle as oracle  # noqa: E402
from nerfacc_tpu import (  # noqa: E402
    create_grid,
    ray_aabb_intersect,
    with_binary,
)
from nerfacc_tpu.compile_cache import setup_compile_cache  # noqa: E402
from nerfacc_tpu.models.hash_encoding import hash_corners  # noqa: E402
from nerfacc_tpu.models.module import Module  # noqa: E402
from nerfacc_tpu.models.tensorf import TensoCPRadianceField  # noqa: E402
from nerfacc_tpu.ops.hash_gather import (  # noqa: E402
    hash_encode_lookup,
    hash_encode_reference,
)
from nerfacc_tpu.utils import render_rays  # noqa: E402

# the flagship gate's flags (TensoCP at default widths, 2^18 samples/batch)
FLAGSHIP_ARGV = [
    "--model", "tensorf", "--max_steps", "50", "--num_rays", "8192",
    "--image_size", "128", "--grid_resolution", "128",
    "--samples_budget", "262144", "--visible_samples_budget", "131072",
    "--test_chunk_size", "4096", "--eval_views", "1",
]
# the hash-grid field at the reference's widths: L=16, F=2, T=2^19
HASH_ARGV = [
    "--model", "ngp", "--ngp_levels", "16", "--ngp_features", "2",
    "--ngp_log2_size", "19", "--max_steps", "40", "--num_rays", "8192",
    "--image_size", "128", "--grid_resolution", "128",
    "--samples_budget", "262144", "--visible_samples_budget", "65536",
    "--test_chunk_size", "4096", "--eval_views", "1",
]


class SmokeError(RuntimeError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def peak_memory_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def ok_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def _load_trainer():
    path = ROOT / "examples" / "train_ngp_nerf.py"
    spec = importlib.util.spec_from_file_location("train_ngp_nerf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_phase(name: str, argv) -> dict:
    """Train through the CLI's ``main(argv)`` and render its eval view;
    fails unless the loss is finite and falls."""
    stats = _load_trainer().main(list(argv))
    losses = stats["losses"]
    steps = sorted(losses)
    first, last = losses[steps[0]], losses[steps[-1]]
    peak = peak_memory_bytes()
    print(
        f"[{name}] loss first {first:.6f} (step {steps[0]}) last "
        f"{last:.6f} (step {steps[-1]}); PSNR {stats['psnr']:.3f}; first "
        f"step {stats['first_step_s']:.3f} s (with compiles); steady step "
        f"{stats['steady_step_s']} s; eval {stats['eval_s']:.3f} s; peak "
        f"device memory so far "
        + (f"{peak} bytes" if peak is not None else "not reported"),
        flush=True,
    )
    _check(math.isfinite(first) and math.isfinite(last),
           f"{name}: loss not finite")
    _check(last < first, f"{name}: loss did not fall ({first} -> {last})")
    _check(math.isfinite(stats["psnr"]), f"{name}: eval PSNR not finite")
    return stats


def _report(name: str, err: float, tol: float, why: str) -> bool:
    ok = bool(err <= tol)
    print(f"[reference] {name}: max error {err:.3e} tolerance {tol:.3e} "
          f"({why}) {'ok' if ok else 'FAILED'}", flush=True)
    return ok


class AnalyticField(Module):
    """Parameter-free density/color field, the same function the oracle
    evaluates in float64."""

    def query_density(self, x):
        return 30.0 * jnp.exp(-10.0 * jnp.sum((x - 0.5) ** 2, -1))[:, None]

    def __call__(self, x, d=None):
        rgb = 0.5 + 0.5 * jnp.sin(7.0 * x + jnp.asarray([0.0, 2.1, 4.2]))
        return rgb, self.query_density(x)


def _analytic_np(x):
    sigma = 30.0 * np.exp(-10.0 * np.sum((x - 0.5) ** 2, axis=1))
    rgb = 0.5 + 0.5 * np.sin(7.0 * x + np.array([0.0, 2.1, 4.2]))
    return sigma, rgb


def _blob_grid(res: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    g = (np.arange(res) + 0.5) / res
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    binary = np.zeros((res,) * 3, bool)
    for _ in range(5):
        c = rng.rand(3) * 0.8 + 0.1
        r = 0.08 + rng.rand() * 0.18
        binary |= (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2 < r**2
    return binary


def march_composite_check(n_rays: int = 4096, res: int = 128,
                          seed: int = 0) -> bool:
    """``render_rays`` on the dense path (every candidate probed, no
    decimation, no culling) against the reference's serial march and
    compositor in float64 on the same rays, grid and field."""
    rng = np.random.RandomState(seed)
    theta = rng.rand(n_rays) * 2 * np.pi
    phi = np.arccos(rng.rand(n_rays) * 2 - 1)
    o = 0.5 + 2.0 * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
         np.cos(phi)], axis=1)
    d = 0.25 + 0.5 * rng.rand(n_rays, 3) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    binary = _blob_grid(res, seed)
    aabb = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    diag = math.sqrt(3.0)
    step = diag * math.sqrt(3.0) / 1024  # the trainer's rule
    S = 1 << int(math.ceil(math.log2(diag / step + 2)))  # covers a diagonal
    grid = with_binary(create_grid(list(aabb), resolution=res),
                       jnp.asarray(binary))
    bkgd = np.ones(3)

    @jax.jit
    def render(o, d):
        colors, opac, _, _, ex = render_rays(
            {"params": {}}, AnalyticField(), o, d, grid=grid,
            scene_aabb=jnp.asarray(aabb, jnp.float32), render_step_size=step,
            render_bkgd=jnp.asarray(bkgd, jnp.float32),
            max_samples_per_ray=S, samples_budget=n_rays * S,
            coarse_stride=1, early_stop_eps=0.0, prefilter_sigma=False,
            return_extras=True,
        )
        return colors, opac, ex["masks"].sum(1)

    colors, opac, counts = (np.asarray(a) for a in render(o, d))
    t_min, t_max = (np.asarray(a, np.float64) for a in ray_aabb_intersect(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb, jnp.float32)))
    t0 = time.perf_counter()
    ri, ts, te = oracle.ray_marching(o, d, t_min, t_max, aabb, binary, step)
    x = o[ri] + ((ts + te) * 0.5)[:, None] * d[ri]
    sig, rgb = _analytic_np(x.astype(np.float64))
    colors_o, opac_o, _, _ = oracle.rendering_forward(
        oracle.pack_info(ri, n_rays), ri, ts, te, sig, rgb, n_rays,
        render_bkgd=bkgd)
    counts_o = np.bincount(ri, minlength=n_rays)
    same = counts == counts_o
    print(f"[reference] march+composite: {n_rays} rays, {res}^3 grid, "
          f"{len(ri)} oracle samples, oracle {time.perf_counter() - t0:.1f} "
          f"s; {int((~same).sum())} rays with another sample count",
          flush=True)
    # A midpoint within float32 rounding of a voxel face can land in the
    # other voxel than in float64; such a ray keeps or loses one sample.
    ok = _report("rays whose sample count differs (fraction)",
                 float((~same).mean()), 2e-3,
                 "float32 vs float64 voxel index of a midpoint on a face")
    err_c = float(np.abs(colors - colors_o)[same].max())
    err_o = float(np.abs(opac - opac_o)[same].max())
    why = ("float32 lattice and row scans against float64 serial "
           "accumulation, up to ~600 samples per ray")
    ok &= _report("color", err_c, 2e-4, why)
    ok &= _report("opacity", err_o, 2e-4, why)
    return ok


def tensocp_check(n: int = 65536, levels=((128, 64), (512, 128)),
                  seed: int = 0) -> bool:
    """The bf16 TensoCP field against the same field in float32."""
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    field = TensoCPRadianceField(aabb=aabb, levels=tuple(levels))
    ref_field = dataclasses.replace(field, compute_dtype=jnp.float32)
    key_p, key_x, key_d = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = field.init(key_p, jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    # scale the factor tables so each per-axis feature is O(1), as after
    # training, instead of the 0.2-scale init
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 5.0 if "axis" in jax.tree_util.keystr(p) else v,
        params)
    x = jax.random.uniform(key_x, (n, 3), minval=-1.5, maxval=1.5)
    d = jax.random.normal(key_d, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rgb, sigma = jax.jit(field.apply)(params, x, d)
    with jax.default_matmul_precision("highest"):
        rgb_r, sigma_r = jax.jit(ref_field.apply)(params, x, d)
    err_rgb = float(jnp.abs(rgb - rgb_r).max())
    err_sig = float((jnp.abs(sigma - sigma_r) / sigma_r).max())
    why = "bf16 features and heads against float32"
    ok = _report("TensoCP rgb", err_rgb, 1e-2, why)
    ok &= _report("TensoCP density (relative)", err_sig, 5e-2, why)
    return ok


def hash_check(n: int = 131072, n_levels: int = 16, n_features: int = 2,
               log2_size: int = 19, seed: int = 0) -> bool:
    """``hash_encode_lookup`` forward and table gradient against the plain
    gather + autodiff reference."""
    T = 1 << log2_size
    k_t, k_x, k_g = jax.random.split(jax.random.PRNGKey(seed), 3)
    table = jax.random.uniform(k_t, (n_features * n_levels * T,),
                               minval=-1.0, maxval=1.0)
    x = jax.random.uniform(k_x, (n, 3))
    flat_idx, cw = jax.jit(
        lambda x: hash_corners(x, n_levels, log2_size))(x)
    g = jax.random.normal(k_g, (n, n_features * n_levels))

    def vjp_of(fn, table, flat_idx, cw, g):
        out, pull = jax.vjp(lambda t: fn(t, flat_idx, cw, T), table)
        return out, pull(g)[0]

    run = jax.jit(vjp_of, static_argnums=0)
    out, grad = run(hash_encode_lookup, table, flat_idx, cw, g)
    with jax.default_matmul_precision("highest"):
        out_r, grad_r = run(hash_encode_reference, table, flat_idx, cw, g)
        # per-entry scale of the gradient: the sum of |contributions|
        _, grad_abs = run(hash_encode_reference, table, flat_idx,
                          jnp.abs(cw), jnp.abs(g))
    err_f = float(jnp.abs(out - out_r).max())
    err_g = float((jnp.abs(grad - grad_r) / (grad_abs + 1e-30)).max())
    ok = _report("hash encoder forward", err_f, 2.0 ** -8,
                 "the packed gathers read the table in bf16 (table in "
                 "[-1, 1], corner weights sum to 1)")
    ok &= _report("hash table gradient (relative to sum |contributions|)",
                  err_g, 2.0 ** -9,
                  "the corner-sum cotangent matmul at default precision "
                  "and atomics that sum in another order on each run")
    return ok


def run_phase(name: str, fn, failures: list):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    try:
        out = fn()
        if out is False:
            raise SmokeError(f"{name}: a comparison is out of tolerance")
    except Exception:  # noqa: BLE001 - report every phase, then fail
        traceback.print_exc()
        failures.append(name)
        out = None
    print(f"== phase {name} done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the ray-sharded data-parallel step on four GPUs "
        "and its comparison with a single-card run",
    )
    args = ap.parse_args(argv)

    device = device_info()
    if device["platform"] != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {device}", file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if device["count"] < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found {device['count']}",
              file=sys.stderr)
        return 2
    cache = setup_compile_cache()
    print(f"device: {device['kind']} x{device['count']}")
    print(f"nvidia-smi: {gpu_name_and_power_limit()}")
    print(f"jax {jax.__version__}; compile cache {cache}", flush=True)

    failures: list = []
    if args.four_cards:
        import __graft_entry__

        run_phase("four-card sharded step", lambda: __graft_entry__.
                  dryrun_multichip(4, rays_per_device=16384), failures)
    else:
        run_phase("flagship train",
                  lambda: train_phase("flagship", FLAGSHIP_ARGV), failures)
        run_phase("hash-grid train",
                  lambda: train_phase("hash-grid", HASH_ARGV), failures)
        run_phase("reference march+composite", march_composite_check,
                  failures)
        run_phase("reference TensoCP", tensocp_check, failures)
        run_phase("reference hash encoder", hash_check, failures)
    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1
    print(ok_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
