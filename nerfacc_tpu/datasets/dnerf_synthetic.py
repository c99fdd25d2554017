"""D-NeRF synthetic dataset loader (time-conditioned scenes).

Re-creation of reference ``examples/datasets/dnerf_synthetic.py``: same
blender format as nerf_synthetic plus a per-frame ``time`` float in
[0, 1] used to condition the deformation field.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from .nerf_synthetic import SubjectLoader as _Base
from .rays import generate_rays


def _load_split(root: Path, subject_id: str, split: str, factor: int = 1):
    import imageio.v2 as imageio

    meta = json.loads((root / subject_id / f"transforms_{split}.json").read_text())
    images, poses, times = [], [], []
    for frame in meta["frames"]:
        fname = root / subject_id / (frame["file_path"] + ".png")
        rgba = imageio.imread(fname)
        if factor > 1:
            rgba = rgba[::factor, ::factor]
        images.append(rgba)
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
        times.append(float(frame.get("time", 0.0)))
    images = np.stack(images).astype(np.float32) / 255.0
    poses = np.stack(poses)[:, :3, :4]
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.asarray(
        [[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float32
    )
    return images, poses, np.asarray(times, np.float32), K


class SubjectLoader(_Base):
    """nerf_synthetic loader + per-frame timestamps
    (reference ``dnerf_synthetic.py:34-57``)."""

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str = "train",
        color_bkgd_aug: str = "white",
        factor: int = 1,
        seed: int = 0,
    ):
        root = Path(root_fp)
        images, poses, times, K = _load_split(root, subject_id, split, factor)
        # reuse base init plumbing by assigning directly
        self.images = jnp.asarray(images)
        self.train_poses = jnp.asarray(poses)
        self.test_poses = self.train_poses
        self.timestamps = jnp.asarray(times)
        self.K = jnp.asarray(K)
        self.height, self.width = images.shape[1:3]
        self.color_bkgd_aug = color_bkgd_aug
        self.training = split in ("train", "trainval")
        from .nerf_synthetic import AABB, FAR, NEAR

        self.aabb = jnp.asarray(AABB)
        self.near, self.far = NEAR, FAR
        self._rng = np.random.RandomState(seed)
        self.bkgd = jnp.ones(3, jnp.float32)
        rgb, a = images[..., :3], images[..., 3:]
        self.test_images = jnp.asarray(rgb * a + (1 - a))
        # host-side copies: batch assembly is numpy on the host (eager
        # jnp gathers would dispatch several device programs per step)
        self._images_np = np.ascontiguousarray(images, np.float32)
        self._poses_np = np.ascontiguousarray(poses, np.float32)
        self._times_np = np.asarray(times, np.float32)

    def sample_batch(self, num_rays: int):
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
        timestamps = jnp.asarray(self._times_np[img_idx][:, None])
        return rays, pixels, timestamps
