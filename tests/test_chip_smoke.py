"""chip_smoke.py's phases at tiny sizes on the CPU.

On a GPU the script runs them at real widths; here each phase function is
called with small sizes, and ``main`` must refuse the CPU backend.
"""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

TINY_TRAIN = [
    "--max_steps", "40", "--num_rays", "256", "--image_size", "16",
    "--grid_resolution", "16", "--samples_budget", "16384",
    "--visible_samples_budget", "8192", "--test_chunk_size", "256",
    "--eval_views", "1", "--train_views", "4",
]


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_cpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_device_info_names_the_backend():
    info = chip_smoke.device_info()
    assert info == {"platform": "cpu", "kind": "cpu", "count": 8}


def test_ok_line_format():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.ok_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": dev}


def test_gpu_name_and_power_limit_is_a_line():
    out = chip_smoke.gpu_name_and_power_limit()
    assert isinstance(out, str) and out


def test_train_phase_trains_and_renders():
    stats = chip_smoke.train_phase(
        "flagship", ["--model", "tensorf", "--levels", "16x8,32x8"] + TINY_TRAIN
    )
    assert sorted(stats["losses"]) == [0, 39]
    assert stats["steady_step_s"] > 0 and stats["first_step_s"] > 0


def test_train_phase_fails_when_loss_rises(monkeypatch):
    class Trainer:
        @staticmethod
        def main(argv):
            return {"psnr": 10.0, "losses": {0: 0.1, 9: 0.2},
                    "first_step_s": 1.0, "steady_step_s": 0.1, "eval_s": 1.0}

    monkeypatch.setattr(chip_smoke, "_load_trainer", lambda: Trainer)
    with pytest.raises(chip_smoke.SmokeError, match="did not fall"):
        chip_smoke.train_phase("fake", [])


def test_march_composite_check_small():
    assert chip_smoke.march_composite_check(n_rays=64, res=16) is True


def test_tensocp_check_small():
    assert chip_smoke.tensocp_check(n=512, levels=((16, 8), (32, 8))) is True


@pytest.mark.parametrize("n_levels,n_features", [(4, 2), (4, 4)])
def test_hash_check_small(n_levels, n_features):
    assert chip_smoke.hash_check(
        n=512, n_levels=n_levels, n_features=n_features, log2_size=10
    ) is True


def test_run_phase_records_failure(capsys):
    failures = []

    def broken():
        raise ValueError("boom")

    assert chip_smoke.run_phase("broken", broken, failures) is None
    assert chip_smoke.run_phase("out of tolerance", lambda: False,
                                failures) is None
    assert chip_smoke.run_phase("fine", lambda: 3, failures) == 3
    assert failures == ["broken", "out of tolerance"]
    assert "ValueError: boom" in capsys.readouterr().err
