"""End-to-end example (PyTorch port): train the paper's ~110M-parameter
Bert-base trunk under a memory budget, with dynamic input sizes.

The full-size counterpart of torch_quickstart.py and of
``examples/dynamic_training_e2e.py``: the exact model the paper
evaluates (12 encoders, d=768, fp32, 110M params) on QQP lengths, the
attention through the hand-written flash kernels (their plain versions
on CPU tensors), AdamW on a cosine schedule, the final parameters saved
with ``repro_torch.train.checkpoint``.  On an H100:

    PYTHONPATH=src python examples/torch_dynamic_training_e2e.py --steps 200

Runs on CUDA unless ``--device cpu`` is given, and raises when no GPU is
present.
"""
import argparse
import os
import tempfile
import time

from repro_torch.core import MimosePlanner
from repro_torch.data.pipeline import make_batches
from repro_torch.models import build_model
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--budget-gb", type=float, default=2.5)
    ap.add_argument("--save", default=os.path.join(tempfile.gettempdir(),
                                                   "bert_base_mimose.pt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("bert_base_paper")          # full 110M config
    lm = build_model(cfg, attn_impl="flash", device=args.device)
    n = sum(p.numel() for p in lm.parameters())
    print(f"training {cfg.name}: {n / 1e6:.0f}M params, "
          f"{cfg.num_layers} encoders, budget {args.budget_gb} GB")

    planner = MimosePlanner(lm, args.budget_gb * 2**30, warmup_samples=3,
                            quantum=64)
    opt = AdamW(lr=cosine_schedule(1e-4, 20, args.steps))
    trainer = Trainer(lm, planner, opt)
    opt_state = opt.init(trainer.params)

    t0 = time.time()
    for i, batch in enumerate(make_batches(
            "qqp", batch_size=args.batch_size, vocab_size=cfg.vocab_size,
            num_batches=args.steps, quantum=64, seed=0)):
        opt_state, loss = trainer.step(opt_state, batch)
        if i % 10 == 0:
            st = trainer.history[-1]
            print(f"step {i:4d}  loss {loss:7.4f}  "
                  f"S={batch['tokens'].shape[1]:4d}"
                  f"  remat {st.remat_units:2d}/{lm.num_plan_units()}"
                  f"  {st.step_time_s:6.2f}s"
                  f"  plan {1e3 * st.plan_time_s:7.2f}ms")

    print(f"\n{args.steps} steps in {(time.time() - t0) / 60:.1f} min")
    print("summary:", trainer.summary())
    print("planner:", planner.stats)
    ckpt.save(args.save, trainer.params)
    print("checkpoint written to", args.save)
    return trainer


if __name__ == "__main__":
    main()
