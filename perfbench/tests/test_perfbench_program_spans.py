"""The program's own spans in the traced stretch, and the readers of the
program's counters.

While ``torch.profiler`` records, the port's spans (``repro_torch.obs``)
are host ranges ``repro_torch.<name>`` with no device copy: the device
events, busy time, span times and idle total of a trace are those of the
same kernels without them, and the idle gaps inside the step take the
name of the innermost program span on the main thread.  On the card a
traced run of a tiny cell shows both."""
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from pbench import runner, trace

TINY = Path(__file__).resolve().parent / "tiny"


class _Event:
    def __init__(self, name, start, end, tid=1, device=False):
        self._n, self._s, self._e, self._t = name, start, end, tid
        self._d = device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def start_thread_id(self):
        return self._t

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


# one step of the stretch: host events on the main thread (1) and on
# autograd's device thread (2), the device's kernels
HOST = [_Event(trace.STRETCH, 0, 1000), _Event(trace.STEP, 10, 990),
        _Event("aten::mm", 20, 30), _Event("perfbench.flash.fwd", 40, 60)]
DEVICE = [_Event("perfbench.flash.fwd", 100, 400, device=True),
          _Event("marker", 100, 110, device=True),
          _Event("flash_fwd_tc_kernel", 120, 300, device=True),
          _Event("copy", 310, 350, device=True),
          _Event("marker", 390, 400, device=True),
          _Event("gemm", 500, 700, device=True),
          _Event("adamw_add", 800, 850, device=True)]
PROGRAM = [_Event("repro_torch.execute", 15, 980),
           _Event("repro_torch.forward", 16, 300),
           _Event("repro_torch.backward", 310, 720),
           _Event("repro_torch.recompute", 320, 400, tid=2),
           _Event("repro_torch.update", 730, 900),
           _Event("repro_torch.sync", 901, 979)]


def test_program_ranges_leave_every_device_reading_as_it_was():
    plain = trace.spans(_prof(HOST + DEVICE))
    spanned = trace.spans(_prof(HOST + PROGRAM + DEVICE))
    assert spanned[0] == plain[0] and spanned[1] == plain[1]
    assert sum(v for _, v in spanned[2]) == pytest.approx(
        sum(v for _, v in plain[2]))
    busy_plain = trace.busy(_prof(DEVICE), 1.0)
    busy_spanned = trace.busy(_prof(PROGRAM + DEVICE), 1.0)
    assert busy_spanned == busy_plain
    assert not any(name.startswith("repro_torch.")
                   for name, _ in busy_spanned[3])


def test_program_ranges_name_the_idle_gaps_inside_the_step():
    plain = dict(trace.spans(_prof(HOST + DEVICE))[2])
    named = dict(trace.spans(_prof(HOST + PROGRAM + DEVICE))[2])
    # idle, by the midpoint's innermost range: 0-100 the flash call's,
    # 110-120 forward, 300-310 execute between forward and backward,
    # 350-390 and 400-500 backward, 700-800 update, 850-1000 sync; all
    # but the first the harness's step range without the program's
    assert plain == {"perfbench.flash.fwd": pytest.approx(100e-9),
                     trace.STEP: pytest.approx(410e-9)}
    assert named == {"perfbench.flash.fwd": pytest.approx(100e-9),
                     "repro_torch.forward": pytest.approx(10e-9),
                     "repro_torch.execute": pytest.approx(10e-9),
                     "repro_torch.backward": pytest.approx(140e-9),
                     "repro_torch.update": pytest.approx(100e-9),
                     "repro_torch.sync": pytest.approx(150e-9)}


def _run(steps):
    return SimpleNamespace(window=steps)


def _step(plan_s, ok=True):
    stats = SimpleNamespace(plan_time_s=plan_s) if ok else None
    return runner.StepRecord(ok, 0.1, [3], 1.0 if ok else None, stats)


def test_plan_ms_is_the_mean_plan_time_of_the_steps_that_ran():
    read = runner.load_reader("plan_ms").read
    assert read(_run([_step(0.001), _step(0.003), _step(9.0, ok=False)])) \
        == pytest.approx(2.0)
    assert read(_run([_step(9.0, ok=False)])) is None
    assert read(_run([])) is None


@pytest.mark.chip
def test_a_traced_run_on_the_card_names_its_gaps_by_the_programs_spans(
        cuda_device):
    c = runner.load_cell("tiny-dense", bench_path=TINY / "none",
                         directory=TINY)
    out = runner.run(c, seed=2**31 + 11, seconds=1, trace=True,
                     t0=time.perf_counter(), device=cuda_device,
                     log=lambda s: None)
    assert out["correct"], out["checks"]
    gaps = [name for name, _ in out["breakdown"]["idle_gaps"]]
    ops = [name for name, _ in out["breakdown"]["device_ops"]]
    assert any(name.startswith("repro_torch.") for name in gaps), gaps
    assert not any(name.startswith("repro_torch.") for name in ops), ops
