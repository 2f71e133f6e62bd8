#!/usr/bin/env python
"""Write a deterministic open-loop serve trace as JSON (PyTorch port).

Thin CLI over ``repro_torch.data.trace.gen_trace``, the same as
``tools/gen_trace.py``: for the same arguments it writes the same
bytes, so ``repro_torch.launch.serve --trace`` and the reference's
serve bench consume one trace from one seed.  Imports numpy and the
port's trace module only:

    python tools/torch_gen_trace.py --num-requests 32 \
        --vocab-size 512 --rate-rps 8 --seed 0 -o trace.json

The JSON is a list of ``{rid, arrival_s, prompt, max_new_tokens}``
records (``TraceRequest.to_json``); load with
``[TraceRequest.from_json(r) for r in json.load(f)]``.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.data.trace import gen_trace  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-requests", type=int, default=32)
    ap.add_argument("--vocab-size", type=int, default=512)
    ap.add_argument("--dataset", default="swag")
    ap.add_argument("--rate-rps", type=float, default=8.0,
                    help="Poisson arrival rate; <=0 = burst at t=0")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--min-new-tokens", type=int, default=0,
                    help="when set, decode lengths are uniform in "
                         "[min, max] instead of exactly max")
    ap.add_argument("--prompt-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--out", default="-",
                    help="output path (default: stdout)")
    args = ap.parse_args(argv)

    trace = gen_trace(num_requests=args.num_requests,
                      vocab_size=args.vocab_size, dataset=args.dataset,
                      rate_rps=args.rate_rps,
                      max_new_tokens=args.max_new_tokens,
                      min_new_tokens=args.min_new_tokens,
                      prompt_scale=args.prompt_scale, seed=args.seed)
    recs = [r.to_json() for r in trace]
    if args.out == "-":
        json.dump(recs, sys.stdout, indent=None)
        print()
    else:
        Path(args.out).write_text(json.dumps(recs))
        lens = [len(r.prompt) for r in trace]
        print(f"wrote {len(recs)} requests to {args.out} "
              f"(prompt lens {min(lens)}..{max(lens)}, "
              f"last arrival {trace[-1].arrival_s:.2f}s)")


if __name__ == "__main__":
    main()
