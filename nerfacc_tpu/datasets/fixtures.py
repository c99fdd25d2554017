"""On-disk dataset fixtures in the reference's real formats.

The published nerf_synthetic / d-nerf / 360_v2 datasets cannot be
downloaded in this environment, but the *loaders* must still be proven
end-to-end (reference formats: blender ``transforms_{split}.json`` +
RGBA PNGs, ``examples/datasets/nerf_synthetic.py:17-50``; the same plus
per-frame ``time`` for D-NeRF, ``dnerf_synthetic.py:34-57``; COLMAP
``sparse/0`` binary model + ``images/`` for 360_v2,
``nerf_360_v2.py:133-296``). This module renders the analytic
:mod:`procedural` scene to disk in those exact formats, so the real
``SubjectLoader`` code paths — JSON/PNG/COLMAP parsing, OpenGL/OpenCV
ray conventions, alpha compositing, split handling — can be driven by
tests and by the training CLIs via ``--data_root``.

The oracle is self-validating: the images are rendered *from the same
analytic field* the loaders' rays will be re-rendered through, so any
sign or convention error in the loader chain shows up as an image
mismatch.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from .procedural import render_gt, render_gt_dynamic, render_gt_env
from .rays import generate_rays, look_at_poses


def _rgba_views(poses, K, height, width, times=None, chunk=65536):
    """Render straight-alpha RGBA views of the analytic field.

    Foreground color and opacity are recovered from two composites
    (black and white backgrounds) of the exact volumetric render:
    ``alpha = 1 - (c_white - c_black)`` and ``fg = c_black / alpha``.

    Rays are rendered in fixed-size jitted chunks so full-protocol
    resolutions (800x800 = 640k rays x 512 samples) fit in HBM — one
    view in one shot is a ~4 GB positions intermediate.
    """
    import jax

    h, w = height, width
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")

    if times is None:
        @jax.jit
        def _chunk_fn(o, d):
            return (
                render_gt(o, d, jnp.zeros(3)),
                render_gt(o, d, jnp.ones(3)),
            )
    else:
        @jax.jit
        def _chunk_fn_t(o, d, t):
            return (
                render_gt_dynamic(o, d, jnp.zeros(3), t),
                render_gt_dynamic(o, d, jnp.ones(3), t),
            )

    def _render_view(origins, viewdirs, t_val):
        n = origins.shape[0]
        c = min(chunk, n)  # small views: one chunk of their own size
        pad = (-n) % c
        if pad:
            # tile-pad (pad may exceed n when n barely exceeds c)
            reps = -(-pad // n)
            origins = jnp.concatenate(
                [origins, jnp.tile(origins, (reps, 1))[:pad]]
            )
            viewdirs = jnp.concatenate(
                [viewdirs, jnp.tile(viewdirs, (reps, 1))[:pad]]
            )
        cb, cw = [], []
        for s in range(0, origins.shape[0], c):
            o, d = origins[s:s + c], viewdirs[s:s + c]
            if times is None:
                b_, w_ = _chunk_fn(o, d)
            else:
                t = jnp.full((c, 1), t_val, jnp.float32)
                b_, w_ = _chunk_fn_t(o, d, t)
            cb.append(np.asarray(b_))
            cw.append(np.asarray(w_))
        return (
            np.concatenate(cb)[:n],
            np.concatenate(cw)[:n],
        )

    out = []
    for i in range(poses.shape[0]):
        rays = generate_rays(
            jnp.asarray(x.reshape(-1)), jnp.asarray(y.reshape(-1)),
            poses[i], K,
        )
        c_black, c_white = _render_view(
            rays.origins, rays.viewdirs,
            None if times is None else times[i],
        )
        alpha = np.clip(1.0 - (c_white - c_black).mean(-1, keepdims=True),
                        0.0, 1.0)
        fg = np.where(alpha > 1e-4, c_black / np.maximum(alpha, 1e-4), 0.0)
        rgba = np.concatenate([np.clip(fg, 0.0, 1.0), alpha], axis=-1)
        out.append(rgba.reshape(h, w, 4))
    return np.stack(out)


def _write_png(path: Path, img01: np.ndarray):
    import imageio.v2 as imageio

    imageio.imwrite(path, (img01 * 255.0 + 0.5).astype(np.uint8))


def write_blender_fixture(
    root,
    subject_id: str = "procedural",
    n_train: int = 12,
    n_val: int = 2,
    n_test: int = 4,
    width: int = 64,
    height: int = 64,
    dynamic: bool = False,
    camera_radius: float = 3.5,
    hemisphere: bool = False,
) -> Path:
    """Write a blender-format dataset of the procedural scene.

    Layout (exactly what the reference loaders parse):
    ``{root}/{subject_id}/transforms_{train,val,test}.json`` with
    ``camera_angle_x`` and per-frame OpenGL ``transform_matrix`` (4x4) +
    ``./{split}/r_{i}`` file paths; RGBA PNGs. With ``dynamic=True``
    each frame carries a ``time`` field and views are rendered through
    the time-shifted field (D-NeRF format).

    Camera radius 3.5 keeps all content beyond the loaders' NEAR=2.0.
    """
    root = Path(root)
    subj = root / subject_id
    fov_x = np.deg2rad(45.0)
    focal = 0.5 * width / np.tan(0.5 * fov_x)
    K = jnp.asarray(
        [[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]],
        jnp.float32,
    )
    counts = {"train": n_train, "val": n_val, "test": n_test}
    elev = {"train": 25.0, "val": 35.0, "test": 32.0}
    hemi_seed = {"train": 100, "val": 200, "test": 300}
    for split, n in counts.items():
        if n == 0:
            continue
        if hemisphere:
            # real NeRF-Synthetic distribution: random upper-hemisphere
            # viewpoints per split (disjoint seeds)
            poses = look_at_poses(
                n, radius=camera_radius, hemisphere_seed=hemi_seed[split]
            )
        else:
            poses = look_at_poses(n, radius=camera_radius,
                                  elevation_deg=elev[split])
        if dynamic:
            times = np.linspace(0.0, 1.0, n) if n > 1 else np.asarray([0.0])
        else:
            times = None
        rgba = _rgba_views(poses, K, height, width, times=times)
        img_dir = subj / split
        img_dir.mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(n):
            _write_png(img_dir / f"r_{i}.png", rgba[i])
            mat = np.eye(4, dtype=np.float64)
            mat[:3, :4] = np.asarray(poses[i])
            frame = {
                "file_path": f"./{split}/r_{i}",
                "transform_matrix": mat.tolist(),
            }
            if dynamic:
                frame["time"] = float(times[i])
            frames.append(frame)
        meta = {"camera_angle_x": float(fov_x), "frames": frames}
        (subj / f"transforms_{split}.json").write_text(json.dumps(meta))
    return subj


# ---------------------------------------------------------------------------
# COLMAP (360_v2) fixture
# ---------------------------------------------------------------------------


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            w = (R[2, 1] - R[1, 2]) / s
            x = 0.25 * s
            y = (R[0, 1] + R[1, 0]) / s
            z = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            w = (R[0, 2] - R[2, 0]) / s
            x = (R[0, 1] + R[1, 0]) / s
            y = 0.25 * s
            z = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            w = (R[1, 0] - R[0, 1]) / s
            x = (R[0, 2] + R[2, 0]) / s
            y = (R[1, 2] + R[2, 1]) / s
            z = 0.25 * s
    q = np.asarray([w, x, y, z])
    return q / np.linalg.norm(q)


def opencv_circle_poses(n_views: int, radius: float,
                        elevation_deg: float = 25.0) -> np.ndarray:
    """(n, 3, 4) camera-to-world poses on a circle looking at the origin
    in the OpenCV convention (+z forward, +y down) used by COLMAP."""
    phis = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    theta = np.deg2rad(elevation_deg)
    poses = []
    for phi in phis:
        eye = radius * np.array(
            [np.cos(phi) * np.cos(theta), np.sin(phi) * np.cos(theta),
             np.sin(theta)]
        )
        forward = -eye / np.linalg.norm(eye)  # +z: towards the origin
        up_world = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up_world)
        right = right / np.linalg.norm(right)
        down = np.cross(forward, right)  # +y: image down
        R = np.stack([right, down, forward], axis=-1)
        poses.append(np.concatenate([R, eye[:, None]], axis=-1))
    return np.stack(poses).astype(np.float32)


def write_cameras_bin(path: Path, cams):
    """COLMAP cameras.bin (https://colmap.github.io/format.html)."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for cam_id, model_id, w, h, params in cams:
            fh.write(struct.pack("<iiQQ", cam_id, model_id, w, h))
            fh.write(struct.pack(f"<{len(params)}d", *params))


def write_images_bin(path: Path, images):
    """COLMAP images.bin: (image_id, qvec, tvec, camera_id, name, n_pts)."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for image_id, qvec, tvec, camera_id, name, n_pts in images:
            fh.write(struct.pack("<i", image_id))
            fh.write(struct.pack("<4d", *qvec))
            fh.write(struct.pack("<3d", *tvec))
            fh.write(struct.pack("<i", camera_id))
            fh.write(name.encode() + b"\x00")
            fh.write(struct.pack("<Q", n_pts))
            fh.write(b"\x00" * (24 * n_pts))


def normalize_poses(c2ws: np.ndarray) -> np.ndarray:
    """The 360 loader's pose normalization (recenter + rescale into the
    unit box) — imported, not copied, so fixtures can never drift from
    the frame the loader actually emits rays in."""
    from .nerf_360_v2 import _normalize_poses

    return _normalize_poses(c2ws)


def write_colmap_fixture(
    root,
    subject_id: str = "procedural360",
    n_images: int = 16,
    width: int = 64,
    height: int = 64,
    camera_radius: float = 3.2,
) -> Path:
    """Write a 360_v2-format COLMAP dataset of the procedural scene.

    Layout: ``{root}/{subject_id}/sparse/0/{cameras,images}.bin`` +
    ``{root}/{subject_id}/images/*.png`` (factor 1). Images are rendered
    through the directional environment (:func:`procedural.env_color`)
    from the *raw* (un-normalized) camera rays, OpenCV convention.

    Frame note for oracles: the loader recenters/rescales pose origins
    into the unit box (:func:`normalize_poses`; directions are
    unchanged). To re-render loader rays through the analytic field,
    map their origins back to the raw frame first
    (``o_raw = o_loaded / scale + center`` with the constants
    :func:`normalize_poses` derives from the raw poses).
    """
    root = Path(root)
    subj = root / subject_id
    sparse = subj / "sparse" / "0"
    img_dir = subj / "images"
    sparse.mkdir(parents=True, exist_ok=True)
    img_dir.mkdir(parents=True, exist_ok=True)

    focal = 0.5 * width / np.tan(0.5 * np.deg2rad(45.0))
    write_cameras_bin(
        sparse / "cameras.bin",
        [(1, 1, width, height,
          [float(focal), float(focal), width / 2.0, height / 2.0])],
    )

    c2ws = opencv_circle_poses(n_images, radius=camera_radius)
    entries = []
    y, x = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    for i in range(n_images):
        c2w4 = np.concatenate(
            [c2ws[i], np.asarray([[0.0, 0.0, 0.0, 1.0]])], axis=0
        )
        w2c = np.linalg.inv(c2w4)
        qvec = _rotmat_to_qvec(w2c[:3, :3])
        tvec = w2c[:3, 3]
        name = f"img_{i:04d}.png"
        entries.append((i + 1, qvec, tvec, 1, name, 0))
        # OpenCV rays through pixel centers (the loader's convention)
        dirs = np.stack(
            [
                (x.reshape(-1) + 0.5 - width / 2.0) / focal,
                (y.reshape(-1) + 0.5 - height / 2.0) / focal,
                np.ones(height * width),
            ],
            axis=-1,
        )
        d = dirs @ c2ws[i][:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(c2ws[i][:3, 3], d.shape)
        img = np.asarray(
            render_gt_env(
                jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
            )
        ).reshape(height, width, 3)
        _write_png(img_dir / name, np.clip(img, 0.0, 1.0))
    write_images_bin(sparse / "images.bin", entries)
    return subj


def write_blender_fixture_in_child(root, **kwargs) -> None:
    """:func:`write_blender_fixture` in a child process that exits before
    this returns. The fixture is rendered with JAX; a launcher that calls
    this never starts JAX itself, so a trainer it starts next has the
    accelerator (and its memory) to itself."""
    import json
    import subprocess
    import sys

    code = (
        "import json, sys\n"
        "from nerfacc_tpu.datasets.fixtures import write_blender_fixture\n"
        "write_blender_fixture(sys.argv[1], **json.loads(sys.argv[2]))\n"
    )
    repo = Path(__file__).resolve().parents[2]
    subprocess.run(
        [sys.executable, "-c", code, str(root), json.dumps(kwargs)],
        check=True, cwd=str(repo),
    )
