"""Quickstart (PyTorch port): train a small causal LM under a memory
budget with the input-aware Mimose planner.

    PYTHONPATH=src python examples/torch_quickstart.py               # GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
        --num-batches 4

Runs on CUDA unless ``--device cpu`` is given, and raises when no GPU is
present.  The counterpart of ``examples/quickstart.py``: the same
reduced model, budget rule, planner settings and SWAG batches.
"""
import argparse

import torch

from repro_torch.core import MimosePlanner, ShuttlingCollector
from repro_torch.core.planner import fixed_train_bytes
from repro_torch.data.pipeline import make_batches
from repro_torch.models import build_model
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-batches", type=int, default=30)
    args = ap.parse_args(argv)

    # 1. a model (the paper's Bert-base trunk, reduced)
    cfg = get_config("bert_base_paper").reduced(
        num_layers=6, d_model=192, d_ff=384, vocab_size=512)
    lm = build_model(cfg, device=args.device)

    # 2. a memory budget: fixed state + 50% of the peak activation footprint
    fixed = fixed_train_bytes(lm.parameters())
    probe = {"tokens": torch.ones((8, 160), dtype=torch.long)}
    acts = ShuttlingCollector(lm).collect(probe).total_activation_bytes()
    budget = fixed + acts // 2
    print(f"budget: {budget / 2**20:.0f} MiB "
          f"(fixed {fixed / 2**20:.0f} + 50% of {acts / 2**20:.0f} "
          f"activation)")

    # 3. the input-aware planner + trainer
    planner = MimosePlanner(lm, budget, warmup_samples=3, quantum=32)
    trainer = Trainer(lm, planner, AdamW(lr=1e-3))

    # 4. train on dynamically-sized batches (SWAG length distribution)
    opt_state = trainer.optimizer.init(trainer.params)
    for batch in make_batches("swag", batch_size=8,
                              vocab_size=cfg.vocab_size,
                              num_batches=args.num_batches, quantum=32,
                              seed=0):
        opt_state, loss = trainer.step(opt_state, batch)
        st = trainer.history[-1]
        print(f"S={batch['tokens'].shape[1]:4d} loss={loss:6.3f} "
              f"remat={st.remat_units}/{lm.num_plan_units()} "
              f"plan={1e3 * st.plan_time_s:6.2f} ms")

    print("\nsummary:", trainer.summary())
    print("planner stats:", planner.stats)
    print(f"plans generated: {len(planner.cache)} "
          f"(cache hits: {planner.stats['cache_hits']})")
    return trainer


if __name__ == "__main__":
    main()
