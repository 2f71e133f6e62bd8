"""Measure the device <-> host bandwidth through the transfer lane and
write the port's calibration file, which ``--pcie-gbps`` of
``repro_torch.launch.train`` then defaults to (the port's counterpart
of the reference's ``tools/bench_offload_bw.py``):

    PYTHONPATH=src python -m repro_torch.launch.bench_offload_bw \\
        [--size-mb 64] [--repeats 3] [--out FILE] [--no-write] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (which times a host memory
copy and says so).  At plan time ``$MIMOSE_PCIE_GBPS`` beats the file
(``$MIMOSE_TORCH_CALIBRATION`` relocates it, default
``./.mimose_torch_calibration.json``), and the file beats
``launch/roofline.PCIE_BW``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.models.lm import resolve_device
from repro_torch.train.transfer import measure_pcie_gbps, write_calibration


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="measure device <-> host bandwidth and calibrate the "
                    "planner's link pricing")
    ap.add_argument("--size-mb", type=int, default=64,
                    help="payload per timed copy (float32 MiB)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats; the best is reported")
    ap.add_argument("--out", default=None,
                    help="calibration JSON path (default: "
                         "$MIMOSE_TORCH_CALIBRATION or "
                         "./.mimose_torch_calibration.json)")
    ap.add_argument("--no-write", action="store_true",
                    help="measure and print only")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cal = measure_pcie_gbps(size_mb=args.size_mb, repeats=args.repeats,
                            device=resolve_device(args.device))
    print(json.dumps(cal, indent=2, sort_keys=True))
    print(f"round-trip link: {cal['pcie_gbps']} GB/s (D2H "
          f"{cal['device_to_host_gbps']} / H2D "
          f"{cal['host_to_device_gbps']}, pinned_host="
          f"{'yes' if cal['pinned_host'] else 'no'}, {cal['device']})")
    if not args.no_write:
        print(f"wrote {write_calibration(cal, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
