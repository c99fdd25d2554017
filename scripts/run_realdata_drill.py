"""Real-data readiness drill (round-3, VERDICT #8).

The CI e2e fixture tests train 300 CPU steps to PSNR > 22 through the
real blender loader (tests/test_e2e_dataset.py:190). This drill is the
longer on-chip version: write a larger on-disk blender fixture
(96x96, 24 train views), then drive the REAL CLI through the real
loader + raygen batch path for 1000 steps and require PSNR > 25 —
deep enough that a loader-math sign error (pose convention, ray
direction, principal point) cannot hide behind smoke steps.
Reference analogue: examples/datasets/nerf_synthetic.py:160-189
(random-pixel batches across images).

Usage: python scripts/run_realdata_drill.py [--max_steps 1000]
Prints the trainer's output; exits nonzero if PSNR <= 25.
"""

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max_steps", type=int, default=1000)
    ap.add_argument("--threshold", type=float, default=25.0)
    ap.add_argument("--image_size", type=int, default=96)
    args = ap.parse_args()

    from nerfacc_tpu.datasets.fixtures import write_blender_fixture_in_child

    # rendered in a child process: this launcher never starts JAX, so the
    # trainer below has the accelerator to itself
    root = REPO / "build" / "fixtures" / "blender_drill"
    shutil.rmtree(root, ignore_errors=True)
    write_blender_fixture_in_child(
        root, n_train=24, n_test=4,
        height=args.image_size, width=args.image_size,
    )

    cmd = [
        sys.executable, str(REPO / "examples" / "train_ngp_nerf.py"),
        "--scene", "procedural", "--data_root", str(root),
        "--max_steps", str(args.max_steps), "--num_rays", "4096",
        "--grid_resolution", "96", "--max_samples_per_ray", "512",
        "--samples_budget", "131072", "--visible_samples_budget", "65536",
        "--test_chunk_size", "4096", "--eval_views", "2",
    ]
    print(" ".join(cmd), flush=True)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    sys.stdout.write(proc.stdout[-4000:])
    sys.stderr.write(proc.stderr[-2000:])
    if proc.returncode != 0:
        sys.exit(proc.returncode)
    psnr = None
    for line in proc.stdout.splitlines():
        if line.startswith("PSNR:"):
            psnr = float(line.split()[1])
    print(f"drill PSNR={psnr} (threshold {args.threshold})", flush=True)
    sys.exit(0 if psnr is not None and psnr > args.threshold else 1)


if __name__ == "__main__":
    main()
