"""The NGP trainer CLI runs in-process through ``main(argv)``."""

import importlib.util
import math
from pathlib import Path

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "train_ngp_nerf.py"


def test_train_ngp_main_in_process():
    spec = importlib.util.spec_from_file_location("train_ngp_nerf", EXAMPLE)
    trainer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trainer)
    stats = trainer.main([
        "--max_steps", "2", "--num_rays", "32", "--image_size", "16",
        "--grid_resolution", "16", "--samples_budget", "2048",
        "--visible_samples_budget", "1024", "--test_chunk_size", "256",
        "--eval_views", "1", "--train_views", "2", "--levels", "8x4",
    ])
    assert sorted(stats["losses"]) == [0, 1]
    assert all(math.isfinite(v) for v in stats["losses"].values())
    assert math.isfinite(stats["psnr"])
    assert stats["first_step_s"] > 0 and stats["steady_step_s"] > 0
