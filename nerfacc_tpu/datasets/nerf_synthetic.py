"""NeRF-Synthetic (blender) dataset loader.

Re-creation of reference ``examples/datasets/nerf_synthetic.py`` without
torch: numpy + imageio host-side, jax arrays out. Blender convention:
``transforms_{split}.json`` with ``camera_angle_x`` and per-frame
``transform_matrix`` (OpenGL camera-to-world); 800x800 RGBA images;
NEAR/FAR = 2.0/6.0; white/black/random background augmentation during
training; random-pixel ray batches across all images.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .rays import Rays, generate_rays

NEAR, FAR = 2.0, 6.0
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def _load_split(root: Path, subject_id: str, split: str, factor: int = 1):
    import imageio.v2 as imageio

    meta = json.loads((root / subject_id / f"transforms_{split}.json").read_text())
    images, poses = [], []
    for frame in meta["frames"]:
        fname = root / subject_id / (frame["file_path"] + ".png")
        rgba = imageio.imread(fname)
        if factor > 1:
            rgba = rgba[::factor, ::factor]
        images.append(rgba)
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
    images = np.stack(images).astype(np.float32) / 255.0  # (n, h, w, 4)
    poses = np.stack(poses)[:, :3, :4]  # (n, 3, 4)
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.asarray(
        [[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float32
    )
    return images, poses, K


class SubjectLoader:
    """Random-pixel ray batches over a blender subject
    (reference ``nerf_synthetic.py:68-189``)."""

    SPLITS = ["train", "val", "trainval", "test"]

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str = "train",
        color_bkgd_aug: str = "white",  # white | black | random
        factor: int = 1,
        seed: int = 0,
    ):
        assert split in self.SPLITS
        root = Path(root_fp)
        if split == "trainval":
            i1, p1, K = _load_split(root, subject_id, "train", factor)
            i2, p2, _ = _load_split(root, subject_id, "val", factor)
            images = np.concatenate([i1, i2])
            poses = np.concatenate([p1, p2])
        else:
            images, poses, K = _load_split(root, subject_id, split, factor)
        self.images = jnp.asarray(images)  # rgba in [0, 1]
        self.train_poses = jnp.asarray(poses)
        self.test_poses = self.train_poses
        self.K = jnp.asarray(K)
        self.height, self.width = images.shape[1:3]
        self.color_bkgd_aug = color_bkgd_aug
        self.training = split in ("train", "trainval")
        self.aabb = jnp.asarray(AABB)
        self.near, self.far = NEAR, FAR
        self._rng = np.random.RandomState(seed)
        self.bkgd = jnp.ones(3, jnp.float32)
        # pre-composited test images on white
        rgb, a = images[..., :3], images[..., 3:]
        self.test_images = jnp.asarray(rgb * a + (1 - a))
        # host-side copies for the native batch assembler
        self._images_np = np.ascontiguousarray(images, np.float32)
        self._poses_np = np.ascontiguousarray(poses, np.float32)
        self._intrin_np = np.asarray(
            [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32
        )

    def _bkgd(self):
        if not self.training or self.color_bkgd_aug == "white":
            return jnp.ones(3, jnp.float32)
        if self.color_bkgd_aug == "black":
            return jnp.zeros(3, jnp.float32)
        return jnp.asarray(self._rng.rand(3), jnp.float32)

    def rays_for_view(self, pose) -> Rays:
        h, w = self.height, self.width
        y, x = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        return generate_rays(x.reshape(-1), y.reshape(-1), pose, self.K)

    def sample_batch(self, num_rays: int):
        """Random pixels across all images -> (rays, rgb pixels composited
        on this step's augmentation background)."""
        from .. import data_io

        if data_io.lib() is not None:
            self.bkgd = self._bkgd()
            o, d, px = data_io.sample_ray_batch(
                self._images_np, self._poses_np, self._intrin_np,
                np.asarray(self.bkgd, np.float32),
                seed=int(self._rng.randint(0, 2**31)), num_rays=num_rays,
                opengl=True,
            )
            return Rays(jnp.asarray(o), jnp.asarray(d)), jnp.asarray(px)
        # host-side numpy batch assembly (eager jnp gathers would
        # dispatch several device programs per step)
        n, h, w = self._images_np.shape[:3]
        img_idx = self._rng.randint(0, n, (num_rays,))
        ys = self._rng.randint(0, h, (num_rays,))
        xs = self._rng.randint(0, w, (num_rays,))
        rgba = self._images_np[img_idx, ys, xs]
        self.bkgd = self._bkgd()
        bkgd = np.asarray(self.bkgd)
        pixels = jnp.asarray(
            rgba[:, :3] * rgba[:, 3:] + bkgd * (1 - rgba[:, 3:])
        )
        rays = generate_rays(
            jnp.asarray(xs), jnp.asarray(ys),
            jnp.asarray(self._poses_np[img_idx]), self.K,
        )
        return rays, pixels
