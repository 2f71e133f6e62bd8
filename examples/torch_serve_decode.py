"""Serving example (PyTorch port): continuous batching by default,
classic batched prefill + decode with ``--sequential``.

    PYTHONPATH=src python examples/torch_serve_decode.py --arch qwen3-1.7b
    PYTHONPATH=src python examples/torch_serve_decode.py --arch mamba2-1.3b
    PYTHONPATH=src python examples/torch_serve_decode.py --sequential
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu \
        --num-requests 2 --new-tokens 4

The counterpart of ``examples/serve_decode.py``, at its reduced sizes
(4 layers, d 256, fp32).  The default path drives
``repro_torch.train.engine.ServeEngine`` with a concurrent open-loop
trace (Poisson arrivals): requests of different lengths share bucketed
cache pools, admission is input-aware under ``--hbm-gb``, and the
report shows tokens/s, latency percentiles and the admission ledger.
``--sequential`` keeps the one-request-batch ``generate`` path, then
times the steady-state decode step.  Runs on CUDA unless ``--device
cpu`` is given, and raises when no GPU is present.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data.trace import gen_trace
from repro_torch.launch.report import serve_report
from repro_torch.models import build_model
from repro_torch.models.registry import get_config
from repro_torch.train.engine import ServeEngine
from repro_torch.train.serve import cached_serve_step, generate


def _sync(lm) -> None:
    if lm.device.type == "cuda":
        torch.cuda.synchronize(lm.device)


def main(argv=None):
    """Returns ``(engine, result)`` in engine mode, the generated
    tokens with ``--sequential``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--sequential", action="store_true",
                    help="one batched generate(), no engine")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--num-requests", type=int, default=12)
    ap.add_argument("--rate-rps", type=float, default=16.0)
    ap.add_argument("--hbm-gb", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(num_layers=4, d_model=256,
                                        dtype="float32")
    lm = build_model(cfg, device=args.device)
    print(f"serving {cfg.name} (reduced: {cfg.num_layers}L "
          f"d={cfg.d_model}, family={cfg.family})")

    if args.sequential:
        gen = torch.Generator().manual_seed(1)
        prompt = torch.randint(1, cfg.vocab_size,
                               (args.batch, args.prompt_len),
                               generator=gen).to(lm.device)
        t0 = time.time()
        out = generate(lm, prompt, args.new_tokens, temperature=0.8)
        _sync(lm)
        dt = time.time() - t0
        total = args.batch * args.new_tokens
        print(f"generated {tuple(out.shape)} in {dt:.2f}s "
              f"({total / dt:.1f} tok/s incl. prefill)")

        # steady-state decode rate on the serve step
        step = cached_serve_step(lm)
        cache = lm.init_cache(args.batch,
                              args.prompt_len + args.new_tokens + 8)
        tok = prompt[:, :1]
        logits, cache = step(tok, cache, 0)           # warm-up
        _sync(lm)
        t0 = time.time()
        N = 20
        for i in range(N):
            logits, cache = step(tok, cache, i + 1)
        _sync(lm)
        dt = time.time() - t0
        print(f"steady-state decode: {1e3 * dt / N:.1f} ms/step "
              f"({args.batch * N / dt:.1f} tok/s)")
        print("sample tokens:", out[0, :16].tolist())
        return out

    trace = gen_trace(num_requests=args.num_requests,
                      vocab_size=cfg.vocab_size, rate_rps=args.rate_rps,
                      max_new_tokens=args.new_tokens, prompt_scale=0.25,
                      seed=1)
    lens = [len(r.prompt) for r in trace]
    print(f"trace: {len(trace)} concurrent requests, prompt lens "
          f"{min(lens)}..{max(lens)}")
    engine = ServeEngine(lm, hbm_bytes=args.hbm_gb * 1e9, quantum=64,
                         max_slots=4)
    result = engine.run(trace)
    print(serve_report(engine, result))
    rid = trace[0].rid
    print("sample tokens (rid 0):",
          np.asarray(result.outputs.get(rid, []))[:16].tolist())
    return engine, result


if __name__ == "__main__":
    main()
