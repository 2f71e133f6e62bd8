"""End-to-end training entry point with the Mimose planner on the critical
path.

Runs on CUDA unless ``--device cpu`` is given (and raises when no GPU is
present).  On the H100, with the hand-written kernels (flash attention
for ``bert_base_paper``, the SSD chunk scan for ``mamba2_1p3b``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch bert_base_paper \\
        --dataset squad --planner mimose --attn-impl flash --budget-mb 3000 \\
        --steps 16 --batch-size 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_1p3b \\
        --dataset squad --planner mimose --attn-impl flash --budget-mb 30000 \\
        --steps 16 --batch-size 8

CPU demo at reduced scale:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 3
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.planner import MimosePlanner, NonePlanner
from repro_torch.data.pipeline import DISTRIBUTIONS, make_batches
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import Trainer


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert_base_paper")
    ap.add_argument("--dataset", default="swag", choices=list(DISTRIBUTIONS))
    ap.add_argument("--planner", default="mimose", choices=["mimose", "none"])
    ap.add_argument("--attn-impl", default="xla", choices=["xla", "flash"],
                    help="flash = the hand-written CUDA kernels of every "
                         "mixer: flash attention, the SSD chunk scan (on "
                         "CPU tensors their plain versions)")
    ap.add_argument("--budget-mb", type=float, default=0.0,
                    help="device memory budget; 0 = unlimited")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quantum", type=int, default=32)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced model variant (CPU demo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        # an attention-free config keeps d_ff = 0 (no MLPs), and scan
        # mode keeps two chunks
        cfg = cfg.reduced(num_layers=4, d_model=256,
                          d_ff=512 if cfg.d_ff else 0, vocab_size=1024,
                          dtype="float32", remat_mode=cfg.remat_mode,
                          scan_chunks=2)
    lm = LM(cfg, attn_impl=args.attn_impl, device=args.device)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"units={lm.num_plan_units()} device={lm.device} "
          f"attn={args.attn_impl}")

    budget = args.budget_mb * 2**20 if args.budget_mb else 1e18
    if args.planner == "mimose":
        planner = MimosePlanner(lm, budget, quantum=args.quantum,
                                warmup_samples=3)
    else:
        planner = NonePlanner(lm)
    opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps))
    trainer = Trainer(lm, planner, opt)
    batches = make_batches(args.dataset, batch_size=args.batch_size,
                           vocab_size=cfg.vocab_size,
                           num_batches=args.steps, quantum=args.quantum,
                           seed=0)
    t0 = time.time()
    opt_state = opt.init(trainer.params)
    for i, batch in enumerate(batches):
        opt_state, loss = trainer.step(opt_state, batch)
        st = trainer.history[-1]
        source = ("hit" if st.cache_hit else
                  "collected" if st.collected else "predicted")
        print(f"step {i:4d} loss {loss:.4f} S={batch['tokens'].shape[1]} "
              f"bucket={st.bucket} remat={st.remat_units} plan={source} "
              f"step_s={st.step_time_s:.4f} "
              f"predicted_peak_mb={st.predicted_peak_bytes / 2**20:.1f} "
              f"max_alloc_mb={st.max_memory_bytes / 2**20:.1f}")
    print(f"done in {time.time() - t0:.1f}s")
    print("summary:", trainer.summary())
    if hasattr(planner, "stats"):
        print("planner:", planner.stats, "plans cached:", len(planner.cache))
    return trainer


if __name__ == "__main__":
    main()
