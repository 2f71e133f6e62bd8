"""Double-buffered device <-> host transfer lane, the counterpart of the
reference's ``train/transfer.py`` on CUDA streams.

The simulator prices an OFFLOAD action at ``2 x bytes / pcie`` with a
``(1 - overlap)`` exposure factor; this module is the execution side:

* ``TransferLane`` issues every copy on ONE ``torch.cuda.Stream`` of
  its own, into (or out of) pinned host buffers kept in a pool by
  (shape, dtype), so a copy is asynchronous and no copy pays
  ``cudaHostAlloc`` twice.  A device -> host copy waits on the compute
  stream (``wait_stream``) for its source, and the source is
  ``record_stream``-ed on the copy stream, so the caching allocator
  does not hand its memory to a later kernel before the copy has read
  it.  A host -> device copy allocates its destination on the copy
  stream and ``record_stream``-s it on the compute stream, and
  ``fetch`` makes the compute stream ``wait_event`` the copy's end
  before anything reads it.
* At most ``depth`` (2: one copy draining while the next is queued)
  copies are in flight; a third enqueue blocks the host until the
  oldest has finished, and that wait is charged.
* Stats, per step (``reset_stats``) and into the telemetry registry:
  ``bytes_out`` / ``bytes_in`` (counted when a copy is enqueued),
  ``transfers`` and ``copy_s`` (counted when a copy has finished), and
  ``exposed_s``.  On CUDA ``copy_s`` is the copy's own device time,
  read from a pair of CUDA events recorded around it on the copy
  stream; ``exposed_s`` is host time blocked on the lane (a full
  window, ``host_value``, ``drain``), timed from the moment the copy
  stream reached the copy waited on (its start event), so compute the
  copy itself had to wait for is not charged, and ``exposed_s <=
  copy_s`` up to the host's wake-up latency.  ``stall_s`` is the device
  time the compute stream waited at a ``fetch`` for a copy to land
  (a CUDA event pair on the compute stream around the wait): the
  exposed transfer the device saw.  On the CPU there is no second
  stream: a copy is a synchronous clone timed by the host clock,
  nothing is pinned and nothing is exposed.

The calibration functions time a round trip through the lane and keep
the result in a JSON file of the port's own, so that ``--pcie-gbps``
defaults to the bandwidth this host measured: ``MIMOSE_PCIE_GBPS`` >
the calibration file (``MIMOSE_TORCH_CALIBRATION`` relocates it) > the
default (``launch/roofline.PCIE_BW``, measured on the H100).  The file
differs from the reference's, so a figure measured for the JAX package
on another host never prices this one.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.obs import TRACK_TRANSFER, Telemetry

# env overrides: the bandwidth wins outright, the path relocates the file
PCIE_ENV = "MIMOSE_PCIE_GBPS"
CALIBRATION_ENV = "MIMOSE_TORCH_CALIBRATION"
DEFAULT_CALIBRATION_PATH = ".mimose_torch_calibration.json"

# depth 2 == double buffering; a third enqueue blocks (and is charged)
DEFAULT_DEPTH = 2


class _Copy:
    """One enqueued copy: its destination, and how to wait for it."""

    __slots__ = ("out", "nbytes", "direction", "t_enq", "start", "end",
                 "host_s")

    def __init__(self, out, nbytes: int, direction: str, start=None,
                 end=None, host_s: float = 0.0):
        self.out = out
        self.nbytes = nbytes
        self.direction = direction          # "d2h" or "h2d"
        self.t_enq = time.perf_counter()
        self.start, self.end = start, end   # CUDA events, or None
        self.host_s = host_s                # a synchronous copy's time

    def done(self) -> bool:
        return self.end is None or self.end.query()

    def wait(self) -> float:
        """Block until the copy has finished; returns the seconds to
        charge: the wait after the copy stream reached the copy."""
        if self.done():
            return 0.0
        self.start.synchronize()
        t0 = time.perf_counter()
        self.end.synchronize()
        return time.perf_counter() - t0

    def seconds(self) -> float:
        """The copy's own time (device time on CUDA)."""
        if self.end is None:
            return self.host_s
        return self.start.elapsed_time(self.end) / 1e3


class HostHandle:
    """Ticket for one copy: ``value`` is its destination (a host buffer
    for ``offload``, a device tensor for ``upload`` / ``prefetch``),
    valid once the copy has finished."""

    __slots__ = ("copy", "released")

    def __init__(self, copy: _Copy):
        self.copy = copy
        self.released = False

    @property
    def value(self):
        return self.copy.out

    @property
    def on_host(self) -> bool:
        return self.copy.direction == "d2h"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class TransferLane:
    """Moves tensors device <-> host on one copy stream with a bounded
    in-flight depth (default 2).  ``device`` is the compute device; on
    a CPU device the copies are synchronous clones.

    stats (per step, zeroed by ``reset_stats``):
      bytes_out / bytes_in   bytes enqueued in each direction
      transfers              copies finished (both directions)
      copy_s                 the finished copies' own time
      exposed_s              host time blocked on the lane (module doc)
      stall_s                device time the compute stream waited at a
                             ``fetch`` (CUDA only)
    """

    def __init__(self, device=None, depth: int = DEFAULT_DEPTH,
                 telemetry: Optional[Telemetry] = None):
        self.device = torch.device(device if device is not None else
                                   ("cuda" if torch.cuda.is_available()
                                    else "cpu"))
        self.depth = max(int(depth), 1)
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry.disabled())
        self.cuda = self.device.type == "cuda"
        self.stream = (torch.cuda.Stream(self.device) if self.cuda
                       else None)
        self._in_flight: list = []          # oldest-first _Copy records
        self._unaccounted: list = []        # enqueued, copy_s not booked
        self._stalls: list = []             # (event, event) on compute
        self._free: Dict[tuple, list] = {}  # key -> [(buffer, _Copy)]
        self._owned: Dict[int, tuple] = {}  # data_ptr -> key (pool)
        self.pinned_bytes = 0               # host bytes the pool holds
        self.stats: Dict[str, Any] = self._zero()

    @staticmethod
    def _zero() -> Dict[str, Any]:
        return {"bytes_out": 0, "bytes_in": 0, "transfers": 0,
                "copy_s": 0.0, "exposed_s": 0.0, "stall_s": 0.0}

    # -- internal ------------------------------------------------------
    def _charge(self, dt: float) -> None:
        self.stats["exposed_s"] += float(dt)
        self.telemetry.metrics.counter(
            "transfer_exposed_s",
            "wall time callers spent blocked on the lane").inc(float(dt))
        if dt > 0.0:
            # retroactive span: the caller was blocked for the interval
            # ending now
            self.telemetry.tracer.complete(
                "exposed", time.perf_counter() - dt, dt, TRACK_TRANSFER)

    def _account(self) -> None:
        """Book ``copy_s`` of every finished copy, and the compute
        stream's finished fetch stalls."""
        tel = self.telemetry
        left = []
        for c in self._unaccounted:
            if not c.done():
                left.append(c)
                continue
            dt = c.seconds()
            self.stats["transfers"] += 1
            self.stats["copy_s"] += dt
            tel.metrics.counter("transfer_copy_s").inc(dt)
            tel.metrics.counter(
                "transfer_bytes_out" if c.direction == "d2h"
                else "transfer_bytes_in").inc(c.nbytes)
            # the span starts when the copy was enqueued and lasts its
            # own (device) time
            tel.tracer.complete("copy_" + c.direction, c.t_enq, dt,
                                TRACK_TRANSFER,
                                args={"bytes": c.nbytes}
                                if tel.trace_on else None)
        self._unaccounted = left
        stalls = []
        for a, b in self._stalls:
            if not b.query():
                stalls.append((a, b))
                continue
            dt = max(a.elapsed_time(b), 0.0) / 1e3
            self.stats["stall_s"] += dt
            tel.metrics.counter(
                "transfer_stall_s",
                "device time compute waited on a fetch").inc(dt)
        self._stalls = stalls

    def _reserve_slot(self) -> None:
        """Block until fewer than ``depth`` copies are in flight; the
        wait is exposed time."""
        while True:
            self._in_flight = [c for c in self._in_flight if not c.done()]
            if len(self._in_flight) < self.depth:
                return
            self._charge(self._in_flight[0].wait())

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        """A pinned host buffer from the pool, one whose last copy has
        finished, or a new one."""
        key = (tuple(shape), dtype)
        free = self._free.get(key, [])
        for i, (buf, last) in enumerate(free):
            if last is None or last.done():
                free.pop(i)
                return buf
        buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        self._owned[buf.data_ptr()] = key
        self.pinned_bytes += _nbytes(buf)
        return buf

    def _release(self, buf: torch.Tensor, last: _Copy) -> None:
        """Return a pool buffer; it is reused once ``last`` (the copy
        that reads it) has finished."""
        key = self._owned.get(buf.data_ptr()) if self.cuda else None
        if key is not None:
            self._free.setdefault(key, []).append((buf, last))

    def _start(self, src: torch.Tensor, direction: str) -> _Copy:
        nbytes = _nbytes(src)
        if not self.cuda:
            t0 = time.perf_counter()
            out = src.detach().clone()
            c = _Copy(out, nbytes, direction,
                      host_s=time.perf_counter() - t0)
        else:
            compute = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if direction == "d2h":
                out = self._host_buffer(src.shape, src.dtype)
                # the source is produced on the compute stream
                self.stream.wait_stream(compute)
                with torch.cuda.stream(self.stream):
                    start.record()
                    out.copy_(src, non_blocking=True)
                    end.record()
                src.record_stream(self.stream)
            else:
                with torch.cuda.stream(self.stream):
                    out = torch.empty(src.shape, dtype=src.dtype,
                                      device=self.device)
                    start.record()
                    out.copy_(src, non_blocking=True)
                    end.record()
                out.record_stream(compute)
            c = _Copy(out, nbytes, direction, start, end)
        self._in_flight.append(c)
        self._unaccounted.append(c)
        self.stats["bytes_out" if direction == "d2h" else "bytes_in"] += \
            nbytes
        return c

    # -- API -----------------------------------------------------------
    def offload(self, x: torch.Tensor) -> HostHandle:
        """Start copying device tensor ``x`` to a pinned host buffer;
        returns at once unless ``depth`` copies are in flight.  ``x``'s
        memory goes back to the allocator when the caller drops it and
        the copy has read it."""
        self._reserve_slot()
        return HostHandle(self._start(x, "d2h"))

    def upload(self, host: torch.Tensor) -> HostHandle:
        """Start copying a host tensor to the device (the mirror of
        ``offload``); resolve with ``fetch``.  A pool buffer goes back
        to the pool."""
        self._reserve_slot()
        c = self._start(host, "h2d")
        self._release(host, c)
        return HostHandle(c)

    def host_value(self, handle: HostHandle) -> torch.Tensor:
        """The host buffer of an ``offload`` handle, once its copy has
        finished.  Only the wait is exposed."""
        self._charge(handle.copy.wait())
        return handle.value

    def prefetch(self, handle: HostHandle) -> HostHandle:
        """Start the return copy of an ``offload`` handle before its
        value is needed; the copy stream runs it after the outbound
        copy.  Returns the handle ``fetch`` resolves; the host buffer
        goes back to the pool."""
        if handle.released:
            raise RuntimeError("this offload handle was already fetched")
        handle.released = True
        return self.upload(handle.value)

    def fetch(self, handle: HostHandle) -> torch.Tensor:
        """The device tensor of a handle, usable on the compute stream:
        an ``offload`` handle is prefetched first.  On CUDA the compute
        stream waits for the copy on the device (the host does not);
        that wait is booked as ``stall_s``."""
        if handle.on_host:
            handle = self.prefetch(handle)
        c = handle.copy
        if self.cuda:
            compute = torch.cuda.current_stream(self.device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(compute)
            compute.wait_event(c.end)
            b.record(compute)
            self._stalls.append((a, b))
        return c.out

    def drain(self) -> None:
        """Wait for every in-flight copy (exposed: the step cannot end
        with the link still busy)."""
        pending, self._in_flight = self._in_flight, []
        for c in pending:
            self._charge(c.wait())
        self._account()

    def reset_stats(self) -> Dict[str, Any]:
        """Return the stats since the last reset and zero them (copies
        still running are booked at a later reset)."""
        self._account()
        out, self.stats = self.stats, self._zero()
        return out

    def close(self) -> None:
        self.drain()
        self._free.clear()
        self._owned.clear()


# ---------------------------------------------------------------------------
# bandwidth calibration
# ---------------------------------------------------------------------------

def calibration_path() -> str:
    return os.environ.get(CALIBRATION_ENV, DEFAULT_CALIBRATION_PATH)


def read_calibration(path: Optional[str] = None) -> Optional[dict]:
    p = path or calibration_path()
    try:
        with open(p) as f:
            cal = json.load(f)
        return cal if isinstance(cal, dict) else None
    except (OSError, ValueError):
        return None


def write_calibration(cal: dict, path: Optional[str] = None) -> str:
    p = path or calibration_path()
    with open(p, "w") as f:
        json.dump(cal, f, indent=2, sort_keys=True)
        f.write("\n")
    return p


def measure_pcie_gbps(size_mb: int = 64, repeats: int = 3,
                      device=None) -> dict:
    """Time ``size_mb`` float32s through the lane's copy path in both
    directions (host clock around each copy and its synchronise);
    reports the round-trip harmonic GB/s the simulator's ``2 x bytes /
    pcie`` pricing wants, best of ``repeats`` (bandwidth is a
    capability, not an average).  On a CPU device this measures a
    memory copy, and says so (``pinned_host`` false)."""
    lane = TransferLane(device)
    dev = lane.device
    n = int(size_mb) * (1 << 20) // 4
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    nbytes = float(n * 4)

    def sync():
        if lane.cuda:
            torch.cuda.synchronize(dev)

    best_out = best_in = 0.0
    for _ in range(max(int(repeats), 1)):
        sync()
        t0 = time.perf_counter()
        h = lane.offload(x)
        lane.host_value(h)
        sync()
        best_out = max(best_out, nbytes / (time.perf_counter() - t0) / 1e9)
        t0 = time.perf_counter()
        lane.fetch(h)
        sync()
        best_in = max(best_in, nbytes / (time.perf_counter() - t0) / 1e9)
    lane.close()
    rt = 2.0 / (1.0 / best_out + 1.0 / best_in)
    return {"pcie_gbps": round(rt, 3),
            "device_to_host_gbps": round(best_out, 3),
            "host_to_device_gbps": round(best_in, 3),
            "pinned_host": lane.cuda,
            "device": (torch.cuda.get_device_name(dev) if lane.cuda
                       else "cpu"),
            "size_mb": int(size_mb), "repeats": int(repeats)}


def calibrated_pcie_gbps(default: float) -> float:
    """The link bandwidth planning should price: ``MIMOSE_PCIE_GBPS``
    wins, then this host's calibration file, then ``default``."""
    env = os.environ.get(PCIE_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    cal = read_calibration()
    if cal:
        try:
            v = float(cal.get("pcie_gbps", 0.0))
            if v > 0.0:
                return v
        except (TypeError, ValueError):
            pass
    return float(default)
