"""The readings a cell's check limits are set from (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload stablelm3b-squad-tight \\
        --seeds 11,12,13 --control-seeds 11,12,13

For each seed, in one process: the program's first checked steps, run
as a benchmark run's set-up runs them (the cell's cap, planner and
kernels), against the plain float32 reference; then, on the control
seeds, the control (the reference in float8, one step below the
configuration's bfloat16) and the half-batch fault (the reference over
half of every batch, the mean over the rest), each against the float32
reference.  One JSON line per seed and reading on standard output.
Needs a CUDA device.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PERFBENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(PERFBENCH))
sys.path.insert(0, str(PERFBENCH.parent / "src"))


def _line(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    from pbench import env
    env.prepare(args.workload)
    import torch
    from pbench import check, runner

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 3
    cell = runner.load_cell(args.workload)
    dev = torch.device("cuda", torch.cuda.current_device())
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    log = lambda s: print(s, file=sys.stderr, flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        runner.cap_allocator(cell, dev, log)
        prog = runner.Program(cell, seed, dev)
        batches = cell.mix.warmup_batches(seed, cell.model["vocab_size"])
        warm = runner.warmup(prog, batches, log,
                             stop_after=runner.CHECKED_STEPS)
        prog.close()
        del prog
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        checked = [batches[i] for i in warm["checked"]]
        if len(checked) < runner.CHECKED_STEPS:
            _line(workload=cell.name, seed=seed, reading="program",
                  failed="fewer than three warm-up steps ran")
            continue
        ref = runner.reference_readings(cell, seed, checked, dev)
        torch.cuda.empty_cache()
        _line(workload=cell.name, seed=seed, reading="program",
              numbers=check.compare(warm["program"], ref),
              losses=warm["program"]["losses"], ref_losses=ref["losses"],
              seconds=time.perf_counter() - t)
        if seed not in controls:
            continue
        for reading, kw in (("control_fp8", {"precision": "fp8"}),
                            ("fault_half_batch", {"half_batch": True})):
            t = time.perf_counter()
            got = runner.reference_readings(cell, seed, checked, dev, **kw)
            torch.cuda.empty_cache()
            _line(workload=cell.name, seed=seed, reading=reading,
                  numbers=check.compare(got, ref), losses=got["losses"],
                  seconds=time.perf_counter() - t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
