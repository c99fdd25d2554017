"""End-to-end validation of the real-dataset loaders via on-disk
fixtures in the reference formats (blender transforms.json + RGBA PNGs,
D-NeRF time fields, COLMAP sparse/0 binary model).

The oracle is the analytic procedural field the fixture images were
rendered from: re-rendering the *loader's own reconstructed rays*
through that field must reproduce the loaded pixels — any sign or
convention error in JSON/PNG/COLMAP parsing, the OpenGL/OpenCV ray
math, or the alpha compositing breaks the match. A short training run
through the actual CLI (`--data_root`) closes the loop.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from nerfacc_tpu.datasets.fixtures import (
    normalize_poses,
    opencv_circle_poses,
    write_blender_fixture,
    write_colmap_fixture,
)
from nerfacc_tpu.datasets.procedural import (
    render_gt,
    render_gt_dynamic,
    render_gt_env,
)

REPO = Path(__file__).resolve().parent.parent


pytestmark = pytest.mark.slow  # e2e CLI drives (round-5 fast tier)

@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("blender")
    write_blender_fixture(root, "procedural", n_train=6, n_val=2, n_test=3,
                          width=48, height=48)
    return root


@pytest.fixture(scope="module")
def dnerf_root(tmp_path_factory):
    # 12 views = 12 distinct timestamps: with one view per timestamp the
    # warp field must interpolate in time to render the novel test
    # (time, pose) pairs — 6 views overfit (test PSNR ~10)
    root = tmp_path_factory.mktemp("dnerf")
    write_blender_fixture(root, "procedural", n_train=12, n_val=0, n_test=3,
                          width=48, height=48, dynamic=True)
    return root


@pytest.fixture(scope="module")
def colmap_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("colmap360")
    write_colmap_fixture(root, "procedural360", n_images=16,
                         width=48, height=48)
    return root


def test_blender_loader_roundtrip(blender_root):
    from nerfacc_tpu.datasets.nerf_synthetic import SubjectLoader

    test = SubjectLoader("procedural", str(blender_root), split="test")
    assert test.test_images.shape == (3, 48, 48, 3)
    # full-chain oracle: loader rays -> analytic render == loaded pixels
    # (white-composited, like test_images)
    for i in range(test.test_poses.shape[0]):
        rays = test.rays_for_view(test.test_poses[i])
        img = np.asarray(
            render_gt(rays.origins, rays.viewdirs, jnp.ones(3))
        ).reshape(48, 48, 3)
        got = np.asarray(test.test_images[i])
        # PNG quantization + alpha recomposition: allow ~2/255
        assert np.abs(img - got).mean() < 0.01
        assert np.abs(img - got).max() < 0.1

    # trainval concatenates train + val
    trainval = SubjectLoader("procedural", str(blender_root),
                             split="trainval")
    assert trainval.images.shape[0] == 8


def test_blender_loader_sample_batch(blender_root):
    from nerfacc_tpu.datasets.nerf_synthetic import SubjectLoader

    train = SubjectLoader("procedural", str(blender_root), split="train",
                          color_bkgd_aug="random", seed=3)
    rays, pixels = train.sample_batch(256)
    assert rays.origins.shape == (256, 3) and pixels.shape == (256, 3)
    # random-pixel oracle: analytic render at the sampled rays over this
    # step's augmentation background
    want = np.asarray(
        render_gt(rays.origins, rays.viewdirs, train.bkgd)
    )
    assert np.abs(want - np.asarray(pixels)).mean() < 0.01


def test_dnerf_loader_roundtrip(dnerf_root):
    from nerfacc_tpu.datasets.dnerf_synthetic import SubjectLoader

    test = SubjectLoader("procedural", str(dnerf_root), split="test")
    assert test.timestamps.shape == (3,)
    assert float(test.timestamps[0]) == 0.0
    assert float(test.timestamps[-1]) == 1.0
    for i in range(3):
        rays = test.rays_for_view(test.test_poses[i])
        t = jnp.full((rays.origins.shape[0], 1), test.timestamps[i])
        img = np.asarray(
            render_gt_dynamic(rays.origins, rays.viewdirs, jnp.ones(3), t)
        ).reshape(48, 48, 3)
        got = np.asarray(test.test_images[i])
        assert np.abs(img - got).mean() < 0.01

    train = SubjectLoader("procedural", str(dnerf_root), split="train")
    rays, pixels, ts = train.sample_batch(128)
    assert ts.shape == (128, 1)
    want = np.asarray(
        render_gt_dynamic(rays.origins, rays.viewdirs, train.bkgd,
                          jnp.asarray(ts))
    )
    assert np.abs(want - np.asarray(pixels)).mean() < 0.01


def test_colmap_360_loader_roundtrip(colmap_root):
    from nerfacc_tpu.datasets.nerf_360_v2 import SubjectLoader

    train = SubjectLoader("procedural360", str(colmap_root), split="train",
                          factor=1)
    test = SubjectLoader("procedural360", str(colmap_root), split="test",
                         factor=1)
    # every-8th-image split over 16 images
    assert test.images.shape[0] == 2
    assert train.images.shape[0] == 14

    # normalization constants (shared train/test frame; computed from the
    # raw fixture poses exactly as the loader does)
    raw = opencv_circle_poses(16, radius=3.2)
    center = raw[:, :, 3].mean(axis=0)
    scale = 1.0 / max(np.abs(raw[:, :, 3] - center).max(), 1e-6)
    norm = normalize_poses(raw)

    # train and test share one world frame
    np.testing.assert_allclose(
        np.asarray(test.train_poses)[0], norm[0], atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(train.train_poses)[0], norm[1], atol=1e-5
    )

    # full-chain oracle: loader rays, origins mapped back to the raw
    # frame, re-rendered through the analytic env field == loaded pixels
    for loader, sel in ((test, [0, 8]), (train, [1, 9])):
        for j, i_raw in enumerate(sel[:1]):
            rays = loader.rays_for_view(loader.test_poses[j])
            o_raw = np.asarray(rays.origins) / scale + center
            img = np.asarray(
                render_gt_env(jnp.asarray(o_raw, jnp.float32),
                              rays.viewdirs)
            ).reshape(48, 48, 3)
            got = np.asarray(loader.images[j])
            assert np.abs(img - got).mean() < 0.01


def _run_script(script, args, timeout=1200):
    # Hermetic: the subprocess runs on the CPU like the rest of the suite,
    # and never takes an accelerator another process may be using.
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / script)] + args,
        capture_output=True, text=True, timeout=timeout,
        env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    psnr = None
    for line in proc.stdout.splitlines():
        if line.startswith("PSNR:"):
            psnr = float(line.split()[1])
    assert psnr is not None, proc.stdout[-2000:]
    return psnr


def test_train_ngp_on_blender_fixture(blender_root):
    """The NGP CLI driven through the real blender SubjectLoader
    (--data_root) must converge: loader -> rays -> march -> render ->
    grads all through the on-disk format."""
    psnr = _run_script(
        "train_ngp_nerf.py",
        ["--scene", "procedural", "--data_root", str(blender_root),
         "--max_steps", "300", "--num_rays", "512",
         "--grid_resolution", "64", "--max_samples_per_ray", "512",
         "--samples_budget", "16384", "--visible_samples_budget", "8192",
         "--test_chunk_size", "1152", "--eval_views", "1",
         "--levels", "32x16,128x32"],
    )
    assert psnr > 22.0, f"NGP on blender fixture converged to {psnr}"


def test_train_dnerf_on_fixture(dnerf_root):
    """The D-NeRF CLI through the real time-conditioned loader."""
    # render_step_size must satisfy step * max_samples >= the box chord
    # (~5.2 for the +-1.5 aabb): at the script's 5e-3 default, 256 slots
    # cover only 1.28 units of t-range and rays truncate mid-scene
    # (PSNR ~10); 0.02 covers the span and reaches ~19
    psnr = _run_script(
        "train_mlp_dnerf.py",
        ["--scene", "procedural", "--data_root", str(dnerf_root),
         "--max_steps", "300", "--num_rays", "512",
         "--grid_resolution", "32", "--max_samples_per_ray", "256",
         "--render_step_size", "0.02", "--samples_budget", "16384",
         "--test_chunk_size", "1152", "--eval_views", "1"],
    )
    assert psnr > 16.0, f"D-NeRF on fixture converged to {psnr}"


def test_train_ngp_unbounded_on_colmap_fixture(colmap_root):
    """The NGP CLI in --unbounded mode through the real COLMAP loader
    (--dataset 360): COLMAP binary parsing -> shared-frame pose
    normalization -> OpenCV rays -> sphere contraction -> cone marching
    all through the on-disk format. Smoke thresholds: 200 steps on the
    48x48 fixture reaches ~15 PSNR (the loader *correctness* oracle is
    test_colmap_360_loader_roundtrip; this closes the training loop)."""
    psnr = _run_script(
        "train_ngp_nerf.py",
        ["--scene", "procedural360", "--dataset", "360",
         "--data_root", str(colmap_root), "--unbounded", "--factor", "1",
         "--max_steps", "200", "--num_rays", "256",
         "--grid_resolution", "64", "--far_plane", "30",
         "--max_samples_per_ray", "1024",
         "--samples_budget", "16384", "--visible_samples_budget", "8192",
         "--test_chunk_size", "1152", "--eval_views", "1",
         "--levels", "32x16,128x32"],
    )
    assert psnr > 13.0, f"unbounded NGP on COLMAP fixture: {psnr}"


def test_fixture_written_in_child_process(tmp_path):
    """Launchers render their fixtures through a child process, so they
    never hold the accelerator themselves; the files match an in-process
    write of the same scene."""
    import json

    from nerfacc_tpu.datasets.fixtures import write_blender_fixture_in_child

    kw = dict(n_train=2, n_val=0, n_test=1, width=8, height=8)
    write_blender_fixture_in_child(tmp_path / "child", **kw)
    write_blender_fixture(tmp_path / "here", **kw)
    for split in ("train", "test"):
        a = json.loads((tmp_path / "child" / "procedural" /
                        f"transforms_{split}.json").read_text())
        b = json.loads((tmp_path / "here" / "procedural" /
                        f"transforms_{split}.json").read_text())
        assert a == b
    png = sorted((tmp_path / "child" / "procedural" / "train").iterdir())
    assert len(png) == 2
