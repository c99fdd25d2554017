"""MipNeRF-360 dataset loader (COLMAP scenes, unbounded).

Re-creation of reference ``examples/datasets/nerf_360_v2.py`` using the
self-contained :mod:`nerfacc_tpu.datasets.colmap` parser instead of the
pycolmap git submodule. Pinhole-only; split = every 8th image to test;
downscale factor in {1, 2, 4, 8} using the ``images_{factor}`` dirs;
OpenCV camera convention (+z forward), unlike the blender loaders.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from .colmap import SceneManager
from .rays import Rays

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)  # roi for the contraction


def _load_colmap(root_fp: str, subject_id: str, split: str, factor: int = 1):
    import imageio.v2 as imageio

    assert factor in (1, 2, 4, 8)
    data_dir = Path(root_fp) / subject_id
    manager = SceneManager(str(data_dir / "sparse" / "0"))
    manager.load_cameras()
    manager.load_images()

    cam = next(iter(manager.cameras.values()))
    assert cam.model in ("SIMPLE_PINHOLE", "PINHOLE"), (
        "Only support pinhole camera model."
    )
    K = cam.K
    K[:2, :] /= factor

    names, c2ws = [], []
    for im in manager.images.values():
        R = im.R()
        t = im.tvec.reshape(3, 1)
        w2c = np.concatenate(
            [np.concatenate([R, t], axis=1), [[0, 0, 0, 1]]], axis=0
        )
        c2ws.append(np.linalg.inv(w2c))
        names.append(im.name)
    order = np.argsort(names)
    c2ws = np.stack(c2ws)[order]
    names = [names[i] for i in order]

    suffix = f"_{factor}" if factor > 1 else ""
    colmap_dir = data_dir / "images"
    image_dir = data_dir / ("images" + suffix)
    colmap_files = sorted(p.name for p in colmap_dir.iterdir())
    image_files = sorted(p.name for p in image_dir.iterdir())
    mapping = dict(zip(colmap_files, image_files))
    images = np.stack(
        [imageio.imread(image_dir / mapping[n]) for n in names]
    ).astype(np.float32) / 255.0

    # Normalize over ALL poses before the split selection: train and
    # test must share one world frame (a per-split normalization would
    # evaluate in a different frame than training).
    c2ws = _normalize_poses(c2ws[:, :3, :4].astype(np.float32))
    idx = np.arange(len(images))
    sel = idx[idx % 8 == 0] if split == "test" else idx[idx % 8 != 0]
    return images[sel], c2ws[sel], K


def _normalize_poses(c2ws: np.ndarray):
    """Recenter/rescale so cameras fit in the unit box (the reference
    relies on scene-specific aabbs; we normalize to the contraction roi)."""
    center = c2ws[:, :, 3].mean(axis=0)
    scale = 1.0 / max(np.abs(c2ws[:, :, 3] - center).max(), 1e-6)
    out = c2ws.copy()
    out[:, :, 3] = (c2ws[:, :, 3] - center) * scale
    return out


class SubjectLoader:
    """Random-pixel ray batches over a 360 scene
    (reference ``nerf_360_v2.py:145-296``)."""

    SPLITS = ["train", "test"]
    SUBJECT_IDS = [
        "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
    ]
    OPENGL_CAMERA = False  # COLMAP/OpenCV: +z forward, y down

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str = "train",
        color_bkgd_aug: str = "random",
        factor: int = 4,
        seed: int = 0,
    ):
        images, c2ws, K = _load_colmap(root_fp, subject_id, split, factor)
        self.images = jnp.asarray(images[..., :3])
        self.train_poses = jnp.asarray(c2ws)
        self.test_poses = self.train_poses
        self.test_images = self.images
        self.K = jnp.asarray(K, jnp.float32)
        self.height, self.width = images.shape[1:3]
        self.training = split == "train"
        self.color_bkgd_aug = color_bkgd_aug
        self.aabb = jnp.asarray(AABB)
        self._rng = np.random.RandomState(seed)
        self.bkgd = jnp.zeros(3, jnp.float32)
        # host-side copies: batch assembly is numpy on the host (eager
        # jnp gathers would dispatch several device programs per step)
        self._images_np = np.ascontiguousarray(images[..., :3], np.float32)
        self._poses_np = np.ascontiguousarray(c2ws, np.float32)

    def _rays(self, x, y, poses):
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        dirs = jnp.stack(
            [
                (x + 0.5 - cx) / fx,
                (y + 0.5 - cy) / fy,  # OpenCV: +y down, +z forward
                jnp.ones_like(jnp.asarray(x, jnp.float32)),
            ],
            axis=-1,
        )
        rot = poses[..., :3, :3]
        d = jnp.einsum("...ij,...j->...i", rot, dirs)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        o = jnp.broadcast_to(poses[..., :3, 3], d.shape)
        return Rays(origins=o, viewdirs=d)

    def rays_for_view(self, pose) -> Rays:
        h, w = self.height, self.width
        y, x = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        return self._rays(x.reshape(-1), y.reshape(-1), pose)

    def sample_batch(self, num_rays: int):
        n, h, w = self._images_np.shape[:3]
        img_idx = self._rng.randint(0, n, (num_rays,))
        ys = self._rng.randint(0, h, (num_rays,))
        xs = self._rng.randint(0, w, (num_rays,))
        pixels = jnp.asarray(self._images_np[img_idx, ys, xs])
        rays = self._rays(
            jnp.asarray(xs), jnp.asarray(ys),
            jnp.asarray(self._poses_np[img_idx]),
        )
        return rays, pixels
