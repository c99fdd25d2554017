"""Quality benchmark: train-to-PSNR on the self-contained procedural scene.

Runs the example training CLIs at fixed configs and reports PSNR +
wall-clock per config as JSON lines — the analogue of the reference's
published benchmark tables (``docs/source/examples/*.rst``; its scenes
need dataset downloads, the procedural scene does not).

    python scripts/run_quality.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_TENSORF_BASE = [
    "examples/train_ngp_nerf.py", "--model", "tensorf",
    "--num_rays", "8192", "--image_size", "128",
    "--grid_resolution", "128", "--samples_budget", "393216",
    "--visible_samples_budget", "196608",
    "--test_chunk_size", "4096", "--eval_views", "3",
    # adaptive-stride probing: measured faster AND better than fixed
    # stride (34.45 vs 33.91 PSNR at 1k steps, 85 vs 110 s)
    "--coarse_stride", "16", "--probe_groups", "32",
]

CONFIGS = {
    "tensorf_1k": _TENSORF_BASE + ["--max_steps", "1000"],
    "tensorf_1k_compact": _TENSORF_BASE
    + ["--max_steps", "1000", "--compact_rays", "0.9"],
    "tensorf_10k_64views": _TENSORF_BASE
    + [
        "--max_steps", "10000", "--compact_rays", "0.9",
        "--train_views", "64", "--lr_decay", "--eval_views", "4",
    ],
    # cone-angle marching on the occupancy-grid path (VERDICT #5): the
    # lattice march diverges from the reference by not resetting the
    # step-growth clock inside skipped space (ray_marching.py module
    # docstring); these two configs measure that divergence's quality
    # cost against the cone=0 baseline on the same scene + step budget.
    "tensorf_cone_1k": _TENSORF_BASE
    + ["--max_steps", "1000", "--cone_angle", "0.004"],
    "tensorf_cone_unbounded_2k": [
        "examples/train_ngp_nerf.py", "--model", "tensorf",
        "--scene", "procedural360", "--unbounded",
        "--max_steps", "2000", "--num_rays", "4096",
        "--image_size", "96", "--grid_resolution", "128",
        "--samples_budget", "262144", "--visible_samples_budget", "131072",
        "--test_chunk_size", "2048", "--eval_views", "3",
        "--train_views", "64", "--coarse_stride", "16",
        "--probe_groups", "32", "--fixed_occ_thre", "1", "--occ_cone_coupling", "1",
    ],
    "vanilla_2k": [
        "examples/train_mlp_nerf.py",
        "--max_steps", "2000", "--num_rays", "4096",
        "--image_size", "128", "--grid_resolution", "128",
        "--samples_budget", "131072",
        "--test_chunk_size", "4096", "--eval_views", "3",
    ],
    "proposal360_4k": [
        "examples/train_proposal_nerf.py", "--scene", "procedural360",
        "--unbounded", "--max_steps", "4000", "--num_rays", "4096",
        "--image_size", "96", "--train_views", "64", "--eval_views", "3",
        "--test_chunk_size", "2048", "--lr", "5e-3", "--prop_grid", "192",
        "--n_coarse", "96", "--n_fine", "48",
    ],
    "proposal_2k": [
        "examples/train_proposal_nerf.py",
        "--max_steps", "2000", "--num_rays", "4096",
        "--image_size", "128", "--train_views", "64",
        "--eval_views", "3",
    ],
    "dnerf_2k": [
        "examples/train_mlp_dnerf.py",
        "--max_steps", "2000", "--num_rays", "2048",
        "--image_size", "96", "--grid_resolution", "96",
        "--samples_budget", "65536",
        "--test_chunk_size", "2048", "--eval_views", "2",
    ],
}

QUICK = {
    "tensorf_1k": CONFIGS["tensorf_1k"],
}


def run_one(name: str, argv: list) -> dict:
    proc = subprocess.run(
        [sys.executable] + argv, cwd=ROOT, capture_output=True, text=True,
        timeout=3600,
    )
    out = proc.stdout + proc.stderr
    psnr = re.search(r"PSNR: ([0-9.]+)", out)
    tsec = re.search(r"train_time_s: ([0-9.]+)", out)
    rec = {
        "config": name,
        "psnr": float(psnr.group(1)) if psnr else None,
        "train_time_s": float(tsec.group(1)) if tsec else None,
        "ok": proc.returncode == 0 and psnr is not None,
    }
    return rec


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    args = p.parse_args()
    configs = QUICK if args.quick else CONFIGS
    for name, argv in configs.items():
        print(json.dumps(run_one(name, argv)), flush=True)


if __name__ == "__main__":
    main()
