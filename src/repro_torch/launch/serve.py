"""Continuous-batching serve entry point.

Runs on CUDA unless ``--device cpu`` is given (and raises when no GPU is
present).  CPU example at reduced scale (the reference's reduction: 2
layers, d 128, d_ff 256, vocab 512, fp32):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch qwen3_1p7b --num-requests 8 --hbm-gb 0.5

On the GPU, full width and depth, a squad burst that must defer:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1p7b \\
        --dataset squad --num-requests 32 --rate-rps 0 \\
        --max-new-tokens 64 --max-slots 8 --hbm-gb 4.0

Builds the model (its own seeded parameters), generates a deterministic
open-loop trace (or loads one, ``--trace``, in the JSON format of
``tools/gen_trace.py``), serves it through
``repro_torch.train.engine.ServeEngine`` under the ``--hbm-gb`` budget,
and prints the serve report: tokens/s, TTFT and inter-token latency
percentiles, the admission ledger (admitted / deferred / rejected,
predicted against tensor-byte peak, and the allocator's peak on CUDA)
and the geometries served.  The budget is input-aware: the engine's
``PolyEstimator`` predicts each admission's cache bytes before
allocating, so an over-subscribed trace defers instead of running out
of memory, and a request that can never fit is rejected.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.data.pipeline import DISTRIBUTIONS
from repro_torch.data.trace import TraceRequest, gen_trace
from repro_torch.launch.report import serve_report
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.obs import build_telemetry, flush_telemetry
from repro_torch.train.engine import ServeEngine


def main(argv=None):
    """Returns ``(engine, result)`` of the run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--dataset", default="swag", choices=list(DISTRIBUTIONS))
    ap.add_argument("--hbm-gb", type=float, default=0.5,
                    help="serve memory budget (params + caches + workspace)")
    ap.add_argument("--quantum", type=int, default=64,
                    help="cache bucket granularity (padded total length)")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="per-bucket batch-slot ceiling")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="largest prefill chunk (power of two)")
    ap.add_argument("--decode-steps", type=int, default=4,
                    help="decode iterations per scheduler loop")
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--rate-rps", type=float, default=8.0,
                    help="Poisson arrival rate; <=0 = burst at t=0")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--prompt-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="JSON trace in tools/gen_trace.py's format "
                         "(overrides the generator knobs)")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the model for CPU runs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--save", default=None,
                    help="write the run summary as JSON")
    # telemetry (repro_torch.obs), the flags of launch/train.py
    ap.add_argument("--metrics", default=None,
                    help="write the final metrics snapshot here at exit "
                         "(.json = JSON doc, else Prometheus text)")
    ap.add_argument("--events-out", default=None,
                    help="JSONL event log: admit/defer/reject decisions "
                         "with predicted bytes, pool grows, completions")
    ap.add_argument("--trace-out", default=None,
                    help="Chrome trace_event JSON (Perfetto): per-request "
                         "queue-wait, prefill-chunk and decode-batch spans")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=2, d_model=128, d_ff=256,
                          vocab_size=512, dtype="float32")
    lm = LM(cfg, device=args.device, seed=0)
    print(f"serving {cfg.name} (family={cfg.family}, "
          f"{cfg.num_layers}L d={cfg.d_model}) on {lm.device} under "
          f"{args.hbm_gb:.3f} GB, quantum={args.quantum}, "
          f"max_slots={args.max_slots}")

    if args.trace:
        with open(args.trace) as f:
            trace = [TraceRequest.from_json(r) for r in json.load(f)]
    else:
        trace = gen_trace(num_requests=args.num_requests,
                          vocab_size=cfg.vocab_size, dataset=args.dataset,
                          rate_rps=args.rate_rps,
                          max_new_tokens=args.max_new_tokens,
                          prompt_scale=args.prompt_scale, seed=args.seed)
    lens = [len(r.prompt) for r in trace]
    print(f"trace: {len(trace)} requests, prompt lens "
          f"{min(lens)}..{max(lens)}, "
          f"last arrival {trace[-1].arrival_s:.2f}s")

    telemetry = build_telemetry(metrics_path=args.metrics,
                                events_path=args.events_out,
                                trace_path=args.trace_out)
    engine = ServeEngine(lm, hbm_bytes=args.hbm_gb * 1e9,
                         quantum=args.quantum, max_slots=args.max_slots,
                         prefill_chunk=args.prefill_chunk,
                         decode_steps=args.decode_steps,
                         telemetry=telemetry)
    t0 = time.time()
    result = engine.run(trace)
    print(f"served in {time.time() - t0:.2f}s\n")
    print(serve_report(engine, result))
    if args.save:
        with open(args.save, "w") as f:
            json.dump(result.summary(), f, indent=2)
        print(f"\nsummary written to {args.save}")
    for kind, path in flush_telemetry(telemetry).items():
        print(f"{kind} written to {path}")
    return engine, result


if __name__ == "__main__":
    main()
