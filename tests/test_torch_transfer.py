"""The port's transfer lane (``repro_torch.train.transfer``) against its
own contract, and its bandwidth calibration.

The reference's lane cannot be run as the oracle: it donates to host
memory, which fails on jax 0.9.0 (ROADMAP, "Faults in the reference").
So the lane is held to what its docstring promises: values come back
unchanged, bytes are counted per direction, at most ``depth`` copies
are in flight and the wait for a slot is charged to ``exposed_s``,
``exposed_s <= copy_s``, and every copy is a span on the transfer
track.  On the CPU a copy is a synchronous clone; the depth rule is
exercised with a copy that takes a set time (``SlowLane``).  The
calibration keeps the reference's hierarchy (``MIMOSE_PCIE_GBPS`` >
file > default) on a file of the port's own.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import bench_offload_bw
from repro_torch.obs import TRACK_TRANSFER, SpanTracer, Telemetry
from repro_torch.train import transfer as T
from repro_torch.train.transfer import (TransferLane, calibrated_pcie_gbps,
                                        measure_pcie_gbps, read_calibration,
                                        write_calibration)


def _x(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_returns_the_same_values(dtype):
    lane = TransferLane("cpu")
    x = _x(4, 33).to(dtype)
    h = lane.offload(x)
    host = lane.host_value(h)
    assert host.dtype == dtype and torch.equal(host, x)
    assert host.data_ptr() != x.data_ptr()          # a copy, not a view
    back = lane.fetch(h)
    assert torch.equal(back, x) and back.data_ptr() != host.data_ptr()
    st = lane.reset_stats()
    n = x.numel() * x.element_size()
    assert st["bytes_out"] == st["bytes_in"] == n
    assert st["transfers"] == 2
    assert st["exposed_s"] == 0.0 and st["copy_s"] >= 0.0
    assert lane.reset_stats()["bytes_out"] == 0       # zeroed


def test_upload_and_prefetch():
    lane = TransferLane("cpu")
    xs = [_x(8, 16, seed=i) for i in range(3)]
    ups = [lane.upload(x) for x in xs]
    for x, h in zip(xs, ups):
        assert not h.on_host and torch.equal(lane.fetch(h), x)
    hs = [lane.offload(x) for x in xs]
    pre = [lane.prefetch(h) for h in hs]
    assert all(h.released for h in hs)
    for x, h in zip(xs, pre):
        assert torch.equal(lane.fetch(h), x)
    with pytest.raises(RuntimeError, match="already fetched"):
        lane.prefetch(hs[0])
    st = lane.reset_stats()
    nb = sum(x.numel() * 4 for x in xs)
    assert st["bytes_out"] == nb and st["bytes_in"] == 2 * nb
    assert st["transfers"] == 9


class SlowCopy(T._Copy):
    """A copy that finishes ``dur`` seconds after it was enqueued."""

    def __init__(self, out, nbytes, direction, dur):
        super().__init__(out, nbytes, direction, host_s=dur)
        self.t_done = self.t_enq + dur

    def done(self):
        return time.perf_counter() >= self.t_done

    def wait(self):
        left = self.t_done - time.perf_counter()
        if left <= 0:
            return 0.0
        time.sleep(left)
        return left


class SlowLane(TransferLane):
    def __init__(self, dur, **kw):
        super().__init__("cpu", **kw)
        self.dur = dur

    def _start(self, src, direction):
        c = SlowCopy(src.clone(), src.numel() * src.element_size(),
                     direction, self.dur)
        self._in_flight.append(c)
        self._unaccounted.append(c)
        self.stats["bytes_out" if direction == "d2h" else "bytes_in"] += \
            c.nbytes
        return c


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_a_full_window_blocks_and_the_wait_is_charged(depth):
    """``depth`` copies go out without waiting; the next one waits for
    the oldest, and that wait — no more than the copy's own time — is
    charged to ``exposed_s``."""
    dur = 0.2
    tel = Telemetry(tracer=SpanTracer())
    lane = SlowLane(dur, depth=depth, telemetry=tel)
    t0 = time.perf_counter()
    hs = [lane.offload(_x(16)) for _ in range(depth)]
    assert time.perf_counter() - t0 < dur          # no wait yet
    assert lane.stats["exposed_s"] == 0.0
    hs.append(lane.offload(_x(16)))                 # window full: waits
    waited = lane.stats["exposed_s"]
    assert 0.5 * dur < waited <= dur + 1e-3
    for h in hs:
        lane.host_value(h)
    lane.drain()
    st = lane.reset_stats()
    assert st["transfers"] == depth + 1
    assert st["exposed_s"] <= st["copy_s"]
    assert tel.metrics.get("transfer_exposed_s").total() == pytest.approx(
        st["exposed_s"])
    names = {e["name"] for e in tel.tracer.events()
             if e.get("tid") == TRACK_TRANSFER and e["ph"] == "X"}
    assert {"copy_d2h", "exposed"} <= names


def test_lane_telemetry_counts_bytes_and_traces_copies():
    tel = Telemetry(tracer=SpanTracer())
    lane = TransferLane("cpu", telemetry=tel)
    x = _x(32, 32)
    lane.fetch(lane.offload(x))
    lane.reset_stats()
    reg = tel.metrics
    assert reg.get("transfer_bytes_out").total() == x.numel() * 4
    assert reg.get("transfer_bytes_in").total() == x.numel() * 4
    assert reg.get("transfer_copy_s").total() >= 0.0
    spans = [e for e in tel.tracer.events() if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["copy_d2h", "copy_h2d"]
    assert all(e["tid"] == TRACK_TRANSFER and e["args"]["bytes"]
               == x.numel() * 4 for e in spans)
    metas = [e for e in tel.tracer.events() if e["ph"] == "M"]
    assert metas[0]["args"]["name"] == "transfer"


def test_a_cuda_lane_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((RuntimeError, AssertionError)):
        TransferLane("cuda")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch, tmp_path):
    monkeypatch.delenv(T.PCIE_ENV, raising=False)
    monkeypatch.setenv(T.CALIBRATION_ENV, str(tmp_path / "cal.json"))
    return tmp_path / "cal.json"


def test_calibration_hierarchy(clean_env, monkeypatch):
    assert calibrated_pcie_gbps(54.4) == 54.4               # default
    write_calibration({"pcie_gbps": 21.5})
    assert json.loads(clean_env.read_text())["pcie_gbps"] == 21.5
    assert read_calibration()["pcie_gbps"] == 21.5
    assert calibrated_pcie_gbps(54.4) == 21.5               # file
    monkeypatch.setenv(T.PCIE_ENV, "7.25")
    assert calibrated_pcie_gbps(54.4) == 7.25               # env wins
    monkeypatch.setenv(T.PCIE_ENV, "not a number")
    assert calibrated_pcie_gbps(54.4) == 21.5


@pytest.mark.parametrize("content", ["not json", "[1, 2]",
                                     '{"pcie_gbps": 0}',
                                     '{"pcie_gbps": "x"}'])
def test_a_bad_calibration_file_falls_back_to_the_default(clean_env,
                                                          content):
    clean_env.write_text(content)
    assert calibrated_pcie_gbps(54.4) == 54.4


def test_the_reference_calibration_file_does_not_price_the_port(
        clean_env, monkeypatch, tmp_path):
    """A file the JAX package wrote (its own env var and name) is not
    the port's: the port's default path differs and its env var too."""
    ref = tmp_path / ".mimose_calibration.json"
    ref.write_text(json.dumps({"pcie_gbps": 3.0}))
    monkeypatch.setenv("MIMOSE_CALIBRATION", str(ref))
    assert T.DEFAULT_CALIBRATION_PATH != ".mimose_calibration.json"
    assert T.CALIBRATION_ENV != "MIMOSE_CALIBRATION"
    assert calibrated_pcie_gbps(54.4) == 54.4


def test_measure_reports_the_round_trip_harmonic():
    cal = measure_pcie_gbps(size_mb=1, repeats=2, device="cpu")
    out, back = cal["device_to_host_gbps"], cal["host_to_device_gbps"]
    assert out > 0 and back > 0
    # each figure is rounded to 1e-3 GB/s
    assert cal["pcie_gbps"] == pytest.approx(
        2.0 / (1.0 / out + 1.0 / back), rel=2e-3, abs=1.5e-3)
    assert cal["pinned_host"] is False and cal["device"] == "cpu"


def test_bench_offload_bw_writes_the_ports_file(clean_env, capsys):
    assert bench_offload_bw.main(["--device", "cpu", "--size-mb", "1",
                                  "--repeats", "1"]) == 0
    cal = json.loads(clean_env.read_text())
    assert cal["pcie_gbps"] > 0 and cal["size_mb"] == 1
    assert calibrated_pcie_gbps(54.4) == cal["pcie_gbps"]
    assert str(clean_env) in capsys.readouterr().out
    other = clean_env.parent / "other.json"
    bench_offload_bw.main(["--device", "cpu", "--size-mb", "1",
                           "--repeats", "1", "--out", str(other)])
    assert json.loads(other.read_text())["device"] == "cpu"
    os.remove(other)
    bench_offload_bw.main(["--device", "cpu", "--size-mb", "1",
                           "--repeats", "1", "--no-write", "--out",
                           str(other)])
    assert not other.exists()


def test_the_launcher_prices_offload_at_the_calibrated_rate(clean_env):
    from repro_torch.launch import train as launch_train
    write_calibration({"pcie_gbps": 12.5})
    tr = launch_train.main(["--device", "cpu", "--reduced", "--steps", "1",
                            "--offload", "--batch-size", "2"])
    assert tr.planner.pcie_gbps == 12.5
    assert tr.planner.link_bytes_per_s() == 12.5e9
    assert np.isfinite(tr.history[0].loss)
