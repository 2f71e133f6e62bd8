"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``): Mimose
training under a memory cap on one NVIDIA GPU.

    python3 perfbench/run.py --workload stablelm3b-squad-tight \\
        --seed 1234 --seconds 20 --trace 0

Runs one cell of ``BENCHMARK.json`` (``perfbench/workloads/<name>.json``
with its configuration, traffic mix and metric readers, all found by
name) and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number of the reference check beside its limit (also
the last lines of standard error).

Exits non-zero, printing no result, without a CUDA device, when the
program cannot be imported, and when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` is loaded once the window has closed.  Every
build and kernel cache stays inside the checkout (``build/``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PERFBENCH = Path(__file__).resolve().parent
ROOT = PERFBENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (PERFBENCH / "workloads" / f"{args.workload}.json").exists():
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(PERFBENCH))
    sys.path.insert(0, str(ROOT / "src"))
    from pbench import env
    env.prepare(args.workload)

    import torch
    from pbench import runner

    cell = runner.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" present", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (src/repro_torch) cannot be imported: {e}",
              file=sys.stderr)
        return 4
    result = runner.run(cell, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), t0=T0)
    loaded = runner.forbidden_modules()
    if loaded:
        print(f"modules that must not load were loaded: {loaded}",
              file=sys.stderr)
        return 5
    for name, d in result["checks"].items():
        print(f"check {name}: {d['value']!r} limit {d['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
