"""The check on the card at a size a test run holds: a sound run of the
tiny cells through the kernels is correct, and the control (the
reference in float8) is not.  Skips without a CUDA device."""
import time
from pathlib import Path

import pytest

from pbench import check, runner

TINY = Path(__file__).resolve().parent / "tiny"


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-ssm"])
def test_sound_run_on_the_card_is_correct(cell, cuda_device):
    c = runner.load_cell(cell, bench_path=TINY / "none", directory=TINY)
    out = runner.run(c, seed=2**31 + 9, seconds=1, trace=True,
                     t0=time.perf_counter(), device=cuda_device,
                     log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0, out["device"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-ssm"])
def test_control_on_the_card_is_not_correct(cell, cuda_device):
    c = runner.load_cell(cell, bench_path=TINY / "none", directory=TINY)
    batches = c.mix.warmup_batches(9, c.model["vocab_size"])[:3]
    ref = runner.reference_readings(c, 9, batches, cuda_device)
    ctrl = runner.reference_readings(c, 9, batches, cuda_device,
                                     precision="fp8")
    ok, checks = check.judge(check.compare(ctrl, ref), c.workload["checks"])
    assert not ok, checks
