"""Procedural analytic scene: ground-truth images without external data.

The real nerf_synthetic scenes are blender renders that may not be on disk;
this module defines an *analytic* radiance field (smooth density blobs +
position-dependent colors inside the unit-ish box) and renders ground-truth
images with dense stratified sampling through the exact field. The result
is a fully self-contained end-to-end benchmark: train a NeRF against these
images and measure PSNR + rays/s, exercising precisely the code paths the
reference's Lego benchmark exercises.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..intersection import ray_aabb_intersect
from .rays import Rays, generate_rays, look_at_poses

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def field_density(x: jnp.ndarray) -> jnp.ndarray:
    """Analytic density (N, 3) -> (N, 1): three smooth blobs + a slab."""
    def blob(c, r, amp, sharp=24.0):
        d = jnp.linalg.norm(x - jnp.asarray(c), axis=-1, keepdims=True)
        return amp * jax.nn.sigmoid(sharp * (r - d))

    sigma = (
        blob((0.0, 0.0, 0.0), 0.5, 40.0)
        + blob((0.7, 0.3, 0.2), 0.25, 80.0)
        + blob((-0.5, -0.6, 0.4), 0.3, 60.0)
        # thin ground slab at z ~ -0.8
        + 30.0
        * jax.nn.sigmoid(40.0 * (0.05 - jnp.abs(x[..., 2:3] + 0.8)))
        * jax.nn.sigmoid(8.0 * (1.0 - jnp.linalg.norm(x[..., :2], axis=-1, keepdims=True)))
    )
    return sigma


def field_rgb(x: jnp.ndarray, d: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Analytic albedo (N, 3) -> (N, 3), mildly view-dependent."""
    base = 0.5 + 0.5 * jnp.sin(
        jnp.asarray([[3.0, 5.0, 7.0]]) * x + jnp.asarray([[0.0, 1.0, 2.0]])
    )
    if d is not None:
        base = base * (0.75 + 0.25 * jnp.abs(d[..., 2:3]))
    return jnp.clip(base, 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("n_samples",))
def render_gt(rays_o, rays_d, bkgd, n_samples: int = 512):
    """Exact volumetric render of the analytic field (dense sampling)."""
    aabb = jnp.asarray(AABB)
    t_min, t_max = ray_aabb_intersect(rays_o, rays_d, aabb)
    hit = t_max < 1e9
    t_min = jnp.where(hit, t_min, 0.0)
    t_max = jnp.where(hit, t_max, 1e-3)
    ts = t_min[:, None] + (t_max - t_min)[:, None] * jnp.linspace(
        0.0, 1.0, n_samples + 1
    )
    t0, t1 = ts[:, :-1], ts[:, 1:]
    tm = (t0 + t1) / 2
    x = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
    sigma = field_density(x.reshape(-1, 3)).reshape(tm.shape)
    rgb = field_rgb(
        x.reshape(-1, 3),
        jnp.broadcast_to(rays_d[:, None, :], x.shape).reshape(-1, 3),
    ).reshape(tm.shape + (3,))
    delta = t1 - t0
    sd = sigma * delta
    trans = jnp.exp(-(jnp.cumsum(sd, axis=-1) - sd))
    weights = trans * (1.0 - jnp.exp(-sd))
    color = (weights[..., None] * rgb).sum(axis=1)
    opacity = weights.sum(axis=1, keepdims=True)
    return color + bkgd * (1.0 - opacity)


class ProceduralScene:
    """Self-contained trainable scene: GT images from the analytic field.

    API shaped like the reference's SubjectLoader: random-pixel ray batches
    across all training views (``nerf_synthetic.py:160-189``).
    """

    def __init__(
        self,
        n_views: int = 24,
        width: int = 128,
        height: int = 128,
        bkgd: float = 1.0,
        n_test_views: int = 4,
        seed: int = 0,
    ):
        self.width, self.height = width, height
        focal = 0.5 * width / np.tan(0.5 * np.deg2rad(45.0))
        self.K = jnp.asarray(
            [[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
            jnp.float32,
        )
        self.bkgd = jnp.full((3,), bkgd, jnp.float32)
        self.aabb = jnp.asarray(AABB)
        # two elevation rings, test views interleaved among train views so
        # eval measures interpolation (not extrapolation past the arc)
        n_total = n_views + n_test_views
        ring_a = look_at_poses((n_total + 1) // 2, radius=3.2, elevation_deg=20.0)
        ring_b = look_at_poses(n_total // 2, radius=3.2, elevation_deg=42.0)
        poses = jnp.concatenate([ring_a, ring_b], axis=0)
        idx = np.arange(n_total)
        test_idx = idx[:: max(n_total // max(n_test_views, 1), 1)][:n_test_views]
        train_idx = np.setdiff1d(idx, test_idx)
        self.train_poses = poses[train_idx]
        self.test_poses = poses[test_idx]
        self.images = self._render_views(self.train_poses)
        self.test_images = self._render_views(self.test_poses)
        self._rng = np.random.RandomState(seed)
        # host-side copies for the native batch assembler
        self._images_np = np.ascontiguousarray(np.asarray(self.images), np.float32)
        self._poses_np = np.ascontiguousarray(np.asarray(self.train_poses), np.float32)
        self._intrin_np = np.asarray(
            [self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]], np.float32
        )

    def _render_views(self, poses):
        h, w = self.height, self.width
        y, x = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        images = []
        for i in range(poses.shape[0]):
            rays = generate_rays(
                x.reshape(-1), y.reshape(-1), poses[i], self.K
            )
            img = render_gt(rays.origins, rays.viewdirs, self.bkgd)
            images.append(np.asarray(img).reshape(h, w, 3))
        return jnp.asarray(np.stack(images))

    def rays_for_view(self, pose) -> Rays:
        h, w = self.height, self.width
        y, x = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        return generate_rays(x.reshape(-1), y.reshape(-1), pose, self.K)

    def sample_batch(self, num_rays: int):
        """Random pixels across all training images -> (rays, pixels).

        Uses the native host assembler (csrc/raygen.cpp) when available:
        one C call replaces eager device-side gathers.
        """
        from .. import data_io

        if data_io.lib() is not None:
            o, d, px = data_io.sample_ray_batch(
                self._images_np, self._poses_np, self._intrin_np,
                np.asarray(self.bkgd, np.float32),
                seed=int(self._rng.randint(0, 2**31)), num_rays=num_rays,
                opengl=True,
            )
            return Rays(jnp.asarray(o), jnp.asarray(d)), jnp.asarray(px)
        n, h, w = self.images.shape[:3]
        img_idx = self._rng.randint(0, n, (num_rays,))
        ys = self._rng.randint(0, h, (num_rays,))
        xs = self._rng.randint(0, w, (num_rays,))
        pixels = self.images[img_idx, ys, xs]
        rays = generate_rays(
            jnp.asarray(xs), jnp.asarray(ys), self.train_poses[img_idx], self.K
        )
        return rays, pixels


# ---------------------------------------------------------------------------
# Time-varying variant (for D-NeRF end-to-end without external data)
# ---------------------------------------------------------------------------


def _shift(t: jnp.ndarray) -> jnp.ndarray:
    """Rigid scene translation over time (exactly representable by a
    D-NeRF warp field): (..., 1) time -> (..., 3) offset."""
    return jnp.concatenate(
        [
            0.35 * jnp.sin(2.0 * jnp.pi * t),
            0.25 * (jnp.cos(2.0 * jnp.pi * t) - 1.0),
            jnp.zeros_like(t),
        ],
        axis=-1,
    )


@functools.partial(jax.jit, static_argnames=("n_samples",))
def render_gt_dynamic(rays_o, rays_d, bkgd, t, n_samples: int = 512):
    """Exact render of the analytic field rigidly shifted by time ``t``
    ((n_rays, 1) per-ray timestamps)."""
    aabb = jnp.asarray(AABB)
    t_min, t_max = ray_aabb_intersect(rays_o, rays_d, aabb)
    hit = t_max < 1e9
    t_min = jnp.where(hit, t_min, 0.0)
    t_max = jnp.where(hit, t_max, 1e-3)
    ts = t_min[:, None] + (t_max - t_min)[:, None] * jnp.linspace(
        0.0, 1.0, n_samples + 1
    )
    t0, t1 = ts[:, :-1], ts[:, 1:]
    tm = (t0 + t1) / 2
    x = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
    xc = x - _shift(t)[:, None, :]  # into the canonical frame
    sigma = field_density(xc.reshape(-1, 3)).reshape(tm.shape)
    rgb = field_rgb(
        xc.reshape(-1, 3),
        jnp.broadcast_to(rays_d[:, None, :], x.shape).reshape(-1, 3),
    ).reshape(tm.shape + (3,))
    delta = t1 - t0
    sd = sigma * delta
    trans = jnp.exp(-(jnp.cumsum(sd, axis=-1) - sd))
    weights = trans * (1.0 - jnp.exp(-sd))
    color = (weights[..., None] * rgb).sum(axis=1)
    opacity = weights.sum(axis=1, keepdims=True)
    return color + bkgd * (1.0 - opacity)


class ProceduralDynamicScene(ProceduralScene):
    """Time-varying analytic scene: one timestamp per view (like the
    D-NeRF dataset's per-frame timestamps, ``dnerf_synthetic.py:34-57``).

    ``sample_batch`` returns (rays, pixels, timestamps); ``timestamps``
    holds the unique train-frame times for grid updates.
    """

    def __init__(self, *args, **kwargs):
        self._dynamic_ready = False
        super().__init__(*args, **kwargs)
        n_train = self.train_poses.shape[0]
        n_test = self.test_poses.shape[0]
        self.timestamps = jnp.linspace(0.0, 1.0, n_train)
        self.test_timestamps = jnp.linspace(0.05, 0.95, n_test)
        self._dynamic_ready = True
        self.images = self._render_views_t(self.train_poses, self.timestamps)
        self.test_images = self._render_views_t(
            self.test_poses, self.test_timestamps
        )

    def _render_views_t(self, poses, times):
        h, w = self.height, self.width
        y, x = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        images = []
        for i in range(poses.shape[0]):
            rays = generate_rays(x.reshape(-1), y.reshape(-1), poses[i], self.K)
            t = jnp.full((rays.origins.shape[0], 1), times[i], jnp.float32)
            img = render_gt_dynamic(rays.origins, rays.viewdirs, self.bkgd, t)
            images.append(np.asarray(img).reshape(h, w, 3))
        return jnp.asarray(np.stack(images))

    def sample_batch(self, num_rays: int):
        n, h, w = self.images.shape[:3]
        img_idx = self._rng.randint(0, n, (num_rays,))
        ys = self._rng.randint(0, h, (num_rays,))
        xs = self._rng.randint(0, w, (num_rays,))
        pixels = self.images[img_idx, ys, xs]
        rays = generate_rays(
            jnp.asarray(xs), jnp.asarray(ys), self.train_poses[img_idx], self.K
        )
        t = self.timestamps[img_idx][:, None]
        return rays, pixels, t


def env_color(d: jnp.ndarray) -> jnp.ndarray:
    """Directional environment radiance (N, 3): sky/ground gradient plus
    azimuthal color bands. High-frequency in *direction*, constant in
    position — the analytic analogue of a 360 capture's background.

    A constant background lets an unbounded model hide per-view fog at
    zero training cost (the fog just has to composite to the constant);
    a directional environment forces a genuine far-field reconstruction.
    """
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    up = d[..., 2:3]
    m = 0.5 + 0.5 * jnp.tanh(4.0 * up)
    sky = jnp.asarray([0.55, 0.68, 0.92])
    ground = jnp.asarray([0.42, 0.33, 0.24])
    base = m * sky + (1.0 - m) * ground
    az = jnp.arctan2(d[..., 1:2], d[..., 0:1])
    bands = 0.18 * jnp.sin(az * jnp.asarray([[5.0, 9.0, 13.0]]) +
                           jnp.asarray([[0.0, 1.3, 2.1]]))
    return jnp.clip(base + bands * (1.0 - jnp.abs(up)), 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("n_samples",))
def render_gt_env(rays_o, rays_d, n_samples: int = 512):
    """Exact render of the analytic field over the directional
    environment (the 360-style ground truth)."""
    bg = env_color(rays_d)
    aabb = jnp.asarray(AABB)
    t_min, t_max = ray_aabb_intersect(rays_o, rays_d, aabb)
    hit = t_max < 1e9
    t_min = jnp.where(hit, t_min, 0.0)
    t_max = jnp.where(hit, t_max, 1e-3)
    ts = t_min[:, None] + (t_max - t_min)[:, None] * jnp.linspace(
        0.0, 1.0, n_samples + 1
    )
    t0, t1 = ts[:, :-1], ts[:, 1:]
    tm = (t0 + t1) / 2
    x = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
    sigma = field_density(x.reshape(-1, 3)).reshape(tm.shape)
    rgb = field_rgb(
        x.reshape(-1, 3),
        jnp.broadcast_to(rays_d[:, None, :], x.shape).reshape(-1, 3),
    ).reshape(tm.shape + (3,))
    delta = t1 - t0
    sd = sigma * delta
    trans = jnp.exp(-(jnp.cumsum(sd, axis=-1) - sd))
    weights = trans * (1.0 - jnp.exp(-sd))
    color = (weights[..., None] * rgb).sum(axis=1)
    opacity = weights.sum(axis=1, keepdims=True)
    return color + bg * (1.0 - opacity)


class Procedural360Scene(ProceduralScene):
    """360-style unbounded benchmark scene: the bounded analytic content
    over a *directional* environment background (:func:`env_color`).

    ``bkgd`` is ``None`` — there is no constant background to composite;
    an unbounded model must place the environment in its far field (the
    contracted outer shell), exactly like a real 360 capture. Rays never
    see a constant they could fake with camera-local fog, which is the
    failure mode constant-background synthetic scenes invite (measured:
    per-view floaters reach train loss 1e-4 with test PSNR ~9 on the
    white-background scene in unbounded mode).
    """

    def __init__(self, *args, **kwargs):
        kwargs.pop("bkgd", None)
        super().__init__(*args, **kwargs)
        self.bkgd = None

    def _render_views(self, poses):
        h, w = self.height, self.width
        y, x = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        images = []
        for i in range(poses.shape[0]):
            rays = generate_rays(x.reshape(-1), y.reshape(-1), poses[i], self.K)
            img = render_gt_env(rays.origins, rays.viewdirs)
            images.append(np.asarray(img).reshape(h, w, 3))
        return jnp.asarray(np.stack(images))
