"""End-to-end training entry point with the Mimose planner on the critical
path.

Runs on CUDA unless ``--device cpu`` is given (and raises when no GPU is
present).  ``--arch`` takes a registered id or its dashed name
(``models/registry.py``), bar the encoder-decoder and vision-language
families: their batches carry a stub frontend's output, which this
launcher does not build (nor does the reference's); they train through
``Trainer`` with ``make_batches(..., extra=...)`` functions.  On the
H100, with the hand-written kernels (flash attention for the attention
families, the SSD chunk scan for ``mamba2_1p3b``, both for the hybrid
``hymba_1p5b``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch bert_base_paper \\
        --dataset squad --planner mimose --attn-impl flash --budget-mb 3000 \\
        --steps 16 --batch-size 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_1p3b \\
        --dataset squad --planner mimose --attn-impl flash --budget-mb 30000 \\
        --steps 16 --batch-size 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1p5b \\
        --dataset squad --planner mimose --attn-impl flash --budget-mb 25000 \\
        --steps 8 --batch-size 8
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --dataset squad --planner mimose \\
        --attn-impl flash --budget-mb 19500 --steps 8 --batch-size 8

CPU demo at reduced scale, and the planner's decision space (the
Sublinear and DTR baselines, no checkpointing, adaptive microbatching
and the background solver):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --arch hymba_1p5b --attn-impl flash --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --arch granite_moe_1b_a400m --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 3 --planner dtr --budget-mb 120
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 3 --max-microbatches 4 --solver dp --budget-mb 120

Host offload (OFFLOAD units' input checkpoints, and with
``--opt-offload`` a unit's AdamW moments, in pinned host memory) and
the three telemetry sinks:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 4 --offload --opt-offload --budget-mb 30 \\
        --metrics m.json --events-out ev.jsonl --trace-out trace.json

Resilience: periodic atomic snapshots, kill-and-resume, and the OOM
watchdog (``--inject-oom`` drives deterministic faults; a real
``torch.OutOfMemoryError`` takes the same path):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 12 --checkpoint-dir ckpt --checkpoint-every-steps 6 \\
        --inject-oom 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 12 --checkpoint-dir ckpt --resume

Sharding-aware planning: ``--mesh-shape 4x2 --hbm-gb 16`` plans against
the per-device budget of a (data 4, model 2) mesh -- activations and
fixed bytes divided by their sharding divisors, ZeRO-1 aware with
``--zero1``; ``--budget-mb``, when given, overrides the per-device HBM.
A mesh this process can build (one device: ``1x1``) is built on a
``DeviceMesh`` and handed to the trainer; a larger one is planned per
device and executed on the one device, with the inputs replicated, as
the reference's launcher does.  ``--resume`` works across another
``--mesh-shape`` (the planner replays its samples under the new mesh):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
        --steps 3 --mesh-shape 4x2 --hbm-gb 0.05 --zero1

``--save PATH`` writes the final parameters with ``train/checkpoint.py``'s
save; ``checkpoint.load(PATH, like)`` reads them back, strictly, into a
model of the same configuration.

``--pcie-gbps`` defaults to ``MIMOSE_PCIE_GBPS``, else this host's
calibration file (``python -m repro_torch.launch.bench_offload_bw``
writes it), else ``launch/roofline.PCIE_BW``.  At exit the run prints
the engine report and writes the sinks; they change no value of the
run.
"""
from __future__ import annotations

import argparse
import itertools
import time

from torch import distributed as torch_dist

from repro_torch.core.baselines import DTRSimPlanner, SublinearPlanner
from repro_torch.core.planner import MimosePlanner, NonePlanner
from repro_torch.data.pipeline import (DISTRIBUTIONS, bucket_length,
                                       make_batches, top_buckets)
from repro_torch.launch.mesh import (MeshUnavailable, make_production_mesh,
                                     parse_mesh_shape)
from repro_torch.launch.report import engine_report
from repro_torch.launch.roofline import PCIE_BW
from repro_torch.models.lm import LM, configure_offload
from repro_torch.models.registry import (ARCH_IDS, REDUCED_ONLY,
                                         canonical, get_config)
from repro_torch.obs import build_telemetry, flush_telemetry
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.sharding.budget import MeshBudget
from repro_torch.train import checkpoint
from repro_torch.train.resilience import (FaultInjector, OOMWatchdog,
                                         SnapshotManager)
from repro_torch.train.trainer import Trainer
from repro_torch.train.transfer import calibrated_pcie_gbps

# the families whose batches carry a stub frontend's output, by key
STUB_INPUTS = {"encdec": "frames", "vlm": "vision_embeds"}


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert_base_paper",
                    help=f"a registered id or its dashed name: "
                         f"{', '.join(ARCH_IDS)}")
    ap.add_argument("--dataset", default="swag", choices=list(DISTRIBUTIONS))
    ap.add_argument("--planner", default="mimose",
                    choices=["mimose", "sublinear", "dtr", "none"])
    ap.add_argument("--attn-impl", default="xla", choices=["xla", "flash"],
                    help="flash = the hand-written CUDA kernels of every "
                         "mixer: flash attention, the SSD chunk scan (on "
                         "CPU tensors their plain versions)")
    ap.add_argument("--budget-mb", type=float, default=0.0,
                    help="device memory budget; 0 = unlimited (with "
                         "--mesh-shape: per device, overriding --hbm-gb)")
    ap.add_argument("--mesh-shape", default=None,
                    help="plan against a per-device mesh budget, e.g. 4x2 "
                         "(data x model) or 2x16x16 (pod x data x model)")
    ap.add_argument("--hbm-gb", type=float, default=16.0,
                    help="per-device memory (GiB) for --mesh-shape planning")
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1 optimizer-state sharding in the budget")
    ap.add_argument("--byte-only-remat", action="store_true",
                    help="paper's byte-only Algorithm 1 instead of "
                         "cost-aware (bytes per recompute-FLOP) selection")
    ap.add_argument("--offload", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="hybrid remat+offload plans: a unit's input "
                         "checkpoint may wait in pinned host memory "
                         "between its forward and its recompute when "
                         "that beats recompute")
    ap.add_argument("--pcie-gbps", type=float, default=None,
                    help="host <-> device link bandwidth (GB/s) OFFLOAD "
                         "is priced at; default: $MIMOSE_PCIE_GBPS, else "
                         "this host's calibration file, else PCIE_BW")
    ap.add_argument("--opt-offload", action="store_true",
                    help="a plan may park a unit's fp32 AdamW moments in "
                         "host memory for the whole step (needs --offload "
                         "and --planner mimose)")
    ap.add_argument("--max-microbatches", type=int, default=1,
                    help="adaptive microbatching: the planner may split "
                         "a bucket's step into up to K gradient-"
                         "accumulation microbatches when that wins on "
                         "simulated step time or alone fits the budget")
    ap.add_argument("--solver", default="off", choices=["off", "dp"],
                    help="optimal-plan tier: a background thread solves "
                         "each bucket's (k, action) assignment exactly and "
                         "swaps an improved plan into the cache")
    ap.add_argument("--solver-budget-ms", type=float, default=50.0,
                    help="wall-clock budget of one background solve")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quantum", type=int, default=32)
    ap.add_argument("--prewarm", type=int, default=0,
                    help="plan the K likeliest buckets before step 0 "
                         "(0 = off)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced model variant (CPU demo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--save", default=None,
                    help="write the final parameters to this file at exit "
                         "(train/checkpoint.py: load it back with "
                         "checkpoint.load into a model of the same "
                         "configuration)")
    # resilience (repro_torch.train.resilience)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for periodic full-state snapshots "
                         "(params + optimizer + planner state + data "
                         "cursor); atomic, hash-manifested, last-k kept")
    ap.add_argument("--checkpoint-every-steps", type=int, default=25,
                    help="snapshot cadence in steps (0 = off)")
    ap.add_argument("--checkpoint-every-secs", type=float, default=0.0,
                    help="wall-clock snapshot cadence in seconds (0 = off; "
                         "fires on the first step boundary past the mark)")
    ap.add_argument("--checkpoint-keep", type=int, default=3,
                    help="retain the newest K snapshots")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid snapshot from "
                         "--checkpoint-dir (params, optimizer, planner "
                         "state, data cursor) and continue")
    ap.add_argument("--max-oom-retries", type=int, default=3,
                    help="OOM watchdog: retries per step, each after a "
                         "DTR-style plan escalation (more remat -> "
                         "offload -> higher microbatch split)")
    ap.add_argument("--inject-oom", default=None,
                    help="deterministic fault injection for drills: an "
                         "int N (fail the first N step executions) or "
                         'JSON like {"bucket": {"1024": 2}}; also '
                         "readable from $MIMOSE_INJECT_OOM")
    # telemetry (repro_torch.obs): every sink is opt-in, and the run's
    # values are the same with them off
    ap.add_argument("--metrics", default=None,
                    help="write the final metrics snapshot here at exit "
                         "(.json = JSON, anything else = Prometheus text)")
    ap.add_argument("--events-out", default=None,
                    help="JSONL event log: every plan, drift point, refit, "
                         "solver swap and train step")
    ap.add_argument("--trace-out", default=None,
                    help="Chrome trace_event JSON (Perfetto): step, "
                         "planner, transfer and solver tracks")
    args = ap.parse_args(argv)
    if args.solver != "off" and args.planner != "mimose":
        ap.error("--solver needs --planner mimose (the solver tier swaps "
                 "plans into the Mimose bucket cache)")
    if args.max_microbatches < 1:
        ap.error("--max-microbatches must be >= 1")
    if args.offload and args.byte_only_remat:
        ap.error("--offload needs the cost-aware selector "
                 "(drop --byte-only-remat)")
    if args.opt_offload and not args.offload:
        ap.error("--opt-offload needs --offload (moment parking rides "
                 "the same host link)")
    if args.opt_offload and args.planner != "mimose":
        ap.error("--opt-offload needs --planner mimose")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")
    if args.pcie_gbps is None:
        # price the link at what this host measured
        args.pcie_gbps = calibrated_pcie_gbps(PCIE_BW / 1e9)

    cfg = get_config(args.arch)
    if cfg.family in STUB_INPUTS:
        # the reference's launcher builds no stub inputs either
        ap.error(f"--arch {args.arch} ({cfg.family}) needs a "
                 f"{STUB_INPUTS[cfg.family]!r} entry in every batch, which "
                 f"this launcher does not build: train it through "
                 f"repro_torch.train.trainer.Trainer with make_batches(..., "
                 f"extra={{{STUB_INPUTS[cfg.family]!r}: fn(B, S)}}) "
                 f"functions")
    if canonical(args.arch) in REDUCED_ONLY and not args.reduced:
        ap.error(f"--arch {args.arch} trains only with --reduced "
                 f"({REDUCED_ONLY[canonical(args.arch)]})")
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
    mesh_budget = mesh = None
    own_group = False
    if args.mesh_shape:
        shape = parse_mesh_shape(args.mesh_shape)
        mesh_budget = MeshBudget.from_shape(shape, args.hbm_gb * 2**30,
                                            zero1=args.zero1)
        # an explicit --budget-mb overrides the per-device HBM
        budget = args.budget_mb * 2**20 if args.budget_mb else None
        fresh = not torch_dist.is_initialized()
        try:
            mesh = make_production_mesh(shape=shape,
                                        device_type=lm.device.type)
        except MeshUnavailable as e:
            print(f"mesh {shape}: {e.needed} devices unavailable "
                  f"({e.present} present) -- planning per device, "
                  f"executing on one device")
        else:
            # make_production_mesh made the group when there was none
            own_group = fresh
            print(f"mesh {shape}: planning per device; the step runs under "
                  f"the {mesh.size()}-device mesh {mesh.mesh_dim_names} "
                  f"(inputs replicated)")
    try:
        return _train(args, cfg, lm, budget, mesh_budget, mesh)
    finally:
        if own_group:
            torch_dist.destroy_process_group()


def _train(args, cfg, lm, budget, mesh_budget, mesh) -> Trainer:
    """Plan and train as ``args`` say; the mesh, if any, is built."""
    dist = DISTRIBUTIONS[args.dataset]
    max_size = args.batch_size * bucket_length(dist.hi, args.quantum)
    if args.offload:
        configure_offload(lm)       # on one device it never degrades
    planner = {
        "mimose": lambda: MimosePlanner(
            lm, budget, quantum=args.quantum, warmup_samples=3,
            mesh_budget=mesh_budget,
            cost_aware=not args.byte_only_remat, offload=args.offload,
            opt_offload=args.opt_offload, pcie_gbps=args.pcie_gbps,
            max_microbatches=args.max_microbatches, solver=args.solver,
            solver_budget_ms=args.solver_budget_ms),
        "sublinear": lambda: SublinearPlanner(
            lm, budget, max_input_size=max_size, mesh_budget=mesh_budget,
            cost_aware=not args.byte_only_remat, offload=args.offload,
            pcie_gbps=args.pcie_gbps,
            max_microbatches=args.max_microbatches),
        "dtr": lambda: DTRSimPlanner(lm, budget, mesh_budget=mesh_budget,
                                     max_microbatches=args.max_microbatches),
        "none": lambda: NonePlanner(lm),
    }[args.planner]()
    opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps))
    snapshots = None
    if args.checkpoint_dir:
        snapshots = SnapshotManager(args.checkpoint_dir,
                                    every_steps=args.checkpoint_every_steps,
                                    every_secs=args.checkpoint_every_secs,
                                    keep=args.checkpoint_keep)
    injector = (FaultInjector(args.inject_oom) if args.inject_oom
                else FaultInjector.from_env())
    watchdog = OOMWatchdog(max_retries=args.max_oom_retries,
                           injector=injector)
    telemetry = build_telemetry(metrics_path=args.metrics,
                                events_path=args.events_out,
                                trace_path=args.trace_out)
    trainer = Trainer(lm, planner, opt, telemetry=telemetry,
                      watchdog=watchdog, snapshots=snapshots, mesh=mesh)
    batches = make_batches(args.dataset, batch_size=args.batch_size,
                           vocab_size=cfg.vocab_size,
                           num_batches=args.steps, quantum=args.quantum,
                           seed=0)
    t0 = time.time()
    opt_state = opt.init(trainer.params)
    if args.resume:
        opt_state, restored = trainer.restore(opt_state)
        # the batch stream is seeded: the cursor says how many batches
        # the snapshot already consumed
        batches = itertools.islice(iter(batches), restored.data_cursor,
                                   None)
        print(f"resumed {restored.path} at step {restored.step} "
              f"(cursor={restored.data_cursor}, "
              f"planner={restored.planner_summary})")
    if args.prewarm:
        likely = top_buckets(args.dataset, batch_size=args.batch_size,
                             quantum=max(args.quantum,
                                         getattr(planner, "quantum", 1)),
                             k=args.prewarm)
        tw = time.time()
        n = trainer.prewarm([S for S, _ in likely], args.batch_size)
        print(f"prewarmed {n} bucket(s) {[S for S, _ in likely]} "
              f"in {time.time() - tw:.1f}s")
    for batch in batches:
        opt_state, loss = trainer.step(opt_state, batch)
        st = trainer.history[-1]
        source = ("hit" if st.cache_hit else
                  "collected" if st.collected else "predicted")
        print(f"step {trainer.global_step - 1:4d} loss {loss:.4f} (ce {st.ce:.4f} aux "
              f"{st.aux:.4f}) S={batch['tokens'].shape[1]} "
              f"bucket={st.bucket} remat={st.remat_units} "
              f"offload={st.offload_units} opt_offload="
              f"{st.opt_offload_units} k={st.microbatches} plan={source} "
              f"step_s={st.step_time_s:.4f} "
              f"predicted_peak_mb={st.predicted_peak_bytes / 2**20:.1f} "
              f"max_alloc_mb={st.max_memory_bytes / 2**20:.1f}")
    bs = getattr(planner, "background_solver", None)
    if bs is not None:
        # let in-flight solves land so the summary sees them (bounded
        # wait; training is done), then end the solver's thread
        bs.drain(timeout=5.0)
        bs.close()
    if snapshots is not None:
        print("snapshot", trainer.save_snapshot(opt_state))
    if trainer.transfer_lane is not None:
        pinned = trainer.transfer_lane.pinned_bytes / 2**20
        print(f"transfer lane: {pinned:.1f} MiB of pinned host buffers "
              f"(host memory, outside the device budget)")
    print(f"done in {time.time() - t0:.1f}s")
    print("summary:", trainer.summary())
    print("\nengine report (where the padding went):")
    print(engine_report(trainer, planner))
    if hasattr(planner, "stats"):
        print("planner:", planner.stats, "plans cached:",
              len(getattr(planner, "cache", {})))
    if args.save:
        checkpoint.save(args.save, trainer.params)
        print("saved", args.save)
    for kind, path in flush_telemetry(telemetry).items():
        print(f"{kind} written to {path}")
    return trainer


if __name__ == "__main__":
    main()
