"""Full-protocol north-star gate (round-5, VERDICT r4 #2).

The reference's headline anchor is NGP x Lego: 800x800, 100 train views,
20k steps -> 35.50 PSNR / 287 s on a TITAN RTX
(reference ``docs/source/examples/ngp.rst:25-36``). The actual
NeRF-Synthetic download was attempted this round and the box has ZERO
egress — recorded verbatim (2026-08-20):

    $ curl -sv https://drive.google.com/
    * Could not resolve host: drive.google.com
    $ curl -sv http://cseweb.ucsd.edu/~viscomp/.../nerf_example_data.zip
    * Could not resolve host: cseweb.ucsd.edu
    $ python -c "socket.create_connection(('8.8.8.8', 53), 10)"
    ConnectionRefusedError: [Errno 111] Connection refused

Fallback (this script): a FULL-PROTOCOL on-disk blender fixture of the
analytic procedural scene — 800x800, 100 train views, 8 test views,
rendered in a child process that exits before training starts, so the
trainer has the accelerator to itself — driven through the REAL loader +
the REAL CLI at
the reference's protocol scale (20k steps, 2^18-sample dynamic batches).
Everything except the pixels themselves matches the reference protocol;
the per-scene table row this produces is the honest stand-in the
environment permits.

Usage:
    python scripts/run_fullprotocol_gate.py --model tensorf
    python scripts/run_fullprotocol_gate.py --model ngp --max_steps 20000
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FIXTURE = REPO / "build" / "fixtures" / "nerfsynth800" / "procedural"


def ensure_fixture(height=800, width=800, n_train=100, n_test=8):
    marker = FIXTURE / "transforms_train.json"
    if marker.exists():
        meta = json.loads(marker.read_text())
        if len(meta["frames"]) == n_train:
            print(f"fixture exists: {FIXTURE}", flush=True)
            return
    from nerfacc_tpu.datasets.fixtures import write_blender_fixture_in_child

    t0 = time.perf_counter()
    write_blender_fixture_in_child(
        FIXTURE.parent, n_train=n_train, n_val=0, n_test=n_test,
        height=height, width=width, hemisphere=True,
    )
    print(f"fixture rendered in {time.perf_counter() - t0:.1f}s "
          f"({n_train} train + {n_test} test views @ {width}x{height})",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", type=str, default="tensorf",
                    choices=["tensorf", "ngp"])
    ap.add_argument("--max_steps", type=int, default=20000)
    ap.add_argument("--num_rays", type=int, default=8192)
    ap.add_argument("--image_size", type=int, default=800)
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--eval_views", type=int, default=8)
    ap.add_argument("--gen_only", action="store_true")
    ap.add_argument("--extra", type=str, default="",
                    help="extra args appended to the train CLI")
    args = ap.parse_args()

    ensure_fixture(args.image_size, args.image_size, args.n_train,
                   max(args.eval_views, 1))
    if args.gen_only:
        return

    cmd = [
        sys.executable, str(REPO / "examples" / "train_ngp_nerf.py"),
        "--scene", "procedural", "--data_root", str(FIXTURE.parent),
        "--model", args.model,
        "--max_steps", str(args.max_steps),
        "--num_rays", str(args.num_rays),
        # reference protocol: 128^3 grid, 2^18-sample dynamic batches
        # (train_ngp_nerf.py:91), cosine decay stands in for MultiStep
        "--grid_resolution", "128",
        "--max_samples_per_ray", "1024",
        "--samples_budget", str(1 << 18),
        "--visible_samples_budget", str(1 << 17),
        "--target_sample_batch_size", str(1 << 18),
        "--lr_decay",
        "--test_chunk_size", "8192",
        "--eval_views", str(args.eval_views),
        "--coarse_stride", "16", "--probe_groups", "32",
    ] + ([a for a in args.extra.split() if a])
    print(" ".join(cmd), flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=8 * 3600)
    wall = time.perf_counter() - t0
    sys.stdout.write(proc.stdout[-6000:])
    sys.stderr.write(proc.stderr[-2000:])
    if proc.returncode != 0:
        sys.exit(proc.returncode)
    psnr = train_s = None
    for line in proc.stdout.splitlines():
        if line.startswith("PSNR:"):
            psnr = float(line.split()[1])
        if line.startswith("train_time_s:"):
            train_s = float(line.split()[1])
    print(json.dumps({
        "gate": "fullprotocol800",
        "model": args.model,
        "steps": args.max_steps,
        "psnr": psnr,
        "train_time_s": train_s,
        "wall_s": round(wall, 1),
        "reference_anchor": {"psnr": 35.50, "time_s": 287,
                             "source": "ngp.rst:33-35 (TITAN RTX)"},
    }), flush=True)


if __name__ == "__main__":
    main()
