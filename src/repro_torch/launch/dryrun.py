"""Multi-pod dry run: prove every (arch x input-shape x mesh) builds,
runs and fits -- without the devices, the counterpart of the
reference's ``launch/dryrun.py``.

The reference forces 512 host devices through ``XLA_FLAGS``; here the
entry point (``main``), and nothing else, makes a ``fake`` process group
as large as the mesh (256, 512 or the ``--mesh-shape`` product), so one
process builds the full ``DeviceMesh``, and destroys it when done.
Importing this module makes no group.  Every tensor is a ``meta`` DTensor
shard: ``lower_s`` times ``build_setup`` (the model, the plan, the
placements) and ``compile_s`` times ``count_setup`` (one run of the step
on rank 0's shards, counting its FLOPs, bytes, collectives and memory).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b \\
        --shape train_4k --multi-pod --remat all --zero1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh-shape 4x2      # small fake mesh
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

from repro_torch.config import INPUT_SHAPES
from repro_torch.launch.mesh import make_production_mesh, parse_mesh_shape
from repro_torch.launch.roofline import analyse
from repro_torch.launch.steps import build_setup, count_setup, shape_applicable
from repro_torch.models.registry import ARCH_IDS, canonical, get_config

ASSIGNED = [a for a in ARCH_IDS if a != "bert_base_paper"]


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks (this process is
    rank 0; collectives move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_one(arch: str, shape_name: str, *, multi_pod: bool, remat: str,
            zero1: bool, seq_parallel: bool, logits_f32: bool,
            unroll: bool = False, mesh_shape=None, offload: bool = False,
            pcie_gbps: float = 16.0,
            max_microbatches: int = 1) -> dict:
    """One dry-run record.  Needs a process group of at least the mesh's
    size (``fake_group``)."""
    cfg = get_config(arch)
    if unroll:
        # the reference lowers the unrolled model for its roofline sweeps
        # (XLA counts a scan body once); the port counts every layer in
        # both modes, and the flag keeps the plan's per-layer units
        cfg = dataclasses.replace(cfg, remat_mode="unrolled")
    shape = INPUT_SHAPES[shape_name]
    if mesh_shape is not None:
        mesh_name = "x".join(str(s) for s in mesh_shape)
        chips = math.prod(mesh_shape)
    else:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        chips = 512 if multi_pod else 256
    rec = {"arch": canonical(arch), "shape": shape_name, "mesh": mesh_name,
           "remat": remat, "zero1": zero1, "seq_parallel": seq_parallel,
           "logits_f32": logits_f32, "unroll": unroll, "offload": offload,
           "max_microbatches": max_microbatches}

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    try:
        mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape,
                                    device_type="cpu")
        t0 = time.time()
        setup = build_setup(cfg, shape, mesh, remat=remat, zero1=zero1,
                            seq_parallel=seq_parallel, logits_f32=logits_f32,
                            offload=offload, pcie_gbps=pcie_gbps,
                            max_microbatches=max_microbatches)
        t_lower = time.time() - t0
        t0 = time.time()
        counts = count_setup(setup, mesh)
        t_compile = time.time() - t0
        roof = analyse(counts, arch=rec["arch"], shape_cfg=shape, cfg=cfg,
                       mesh_name=mesh_name, chips=chips)
        rec.update(status="ok", step=setup.name,
                   lower_s=round(t_lower, 1), compile_s=round(t_compile, 1),
                   flops_per_dev=roof.flops_per_dev,
                   bytes_per_dev=roof.bytes_per_dev,
                   coll_bytes_per_dev=roof.coll_bytes_per_dev,
                   coll_breakdown={k: round(v) for k, v in
                                   roof.coll_breakdown.items()},
                   model_flops=roof.model_flops,
                   # one digit per unit (0=KEEP 1=REMAT 2=OFFLOAD-to-host),
                   # with the gradient-accumulation split factor appended
                   # when the planner chose to microbatch (e.g. "0110x2")
                   remat_mask=(("".join(str(int(m)) for m in setup.remat_mask)
                                + (f"x{setup.microbatch}"
                                   if setup.microbatch > 1 else ""))
                               if setup.remat_mask else None),
                   microbatch=setup.microbatch,
                   **roof.row())
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc(limit=8))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="sweep all assigned arch x shape pairs")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="explicit mesh shape like 4x2 or 2x16x16 "
                         "(overrides --multi-pod; small shapes let the "
                         "dry run validate sharded plans on a small fake "
                         "group)")
    ap.add_argument("--remat", default="mimose",
                    choices=["none", "all", "mimose"])
    ap.add_argument("--offload", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="let the mimose plan OFFLOAD unit residuals to "
                         "pinned host memory (typed action plans)")
    ap.add_argument("--pcie-gbps", type=float, default=16.0,
                    help="host<->device link bandwidth the planner "
                         "prices OFFLOAD actions at")
    ap.add_argument("--max-microbatches", type=int, default=1,
                    help="let the mimose plan split the train step into "
                         "up to K gradient-accumulation microbatches "
                         "when that wins on simulated step time (the "
                         "mask string then shows the factor, e.g. "
                         "'0110x2')")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--logits-bf16", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="plan per layer (unrolled units)")
    ap.add_argument("--json", default=None, help="append JSONL records here")
    ap.add_argument("--resume", action="store_true",
                    help="skip pairs already recorded ok in --json")
    ap.add_argument("--keep-going", action="store_true",
                    help="exit 0 even when sweep points failed (the "
                         "failure summary still prints); default is a "
                         "non-zero exit so CI flags partial sweeps")
    args = ap.parse_args(argv)

    done = set()
    if args.resume and args.json and os.path.exists(args.json):
        for line in open(args.json):
            r = json.loads(line)
            if r.get("status") in ("ok", "skipped"):
                done.add((r["arch"], r["shape"], r["mesh"]))

    pairs = []
    if args.all:
        for a in ASSIGNED:
            for s in INPUT_SHAPES:
                pairs.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs.append((args.arch, args.shape))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    mesh_shape = (parse_mesh_shape(args.mesh_shape)
                  if args.mesh_shape else None)

    out = open(args.json, "a") if args.json else None
    n_ok = n_skip = 0
    failures = []
    # one fake group per mesh, as large as it (the counterpart of the
    # reference's forced host device count)
    for mp in meshes:
        chips = (math.prod(mesh_shape) if mesh_shape
                 else (512 if mp else 256))
        mesh_name = ("x".join(str(s) for s in mesh_shape) if mesh_shape
                     else ("2x16x16" if mp else "16x16"))
        with fake_group(chips):
            for arch, shape in pairs:
                key = (canonical(arch), shape, mesh_name)
                if key in done:
                    continue
                rec = run_one(arch, shape, multi_pod=mp, remat=args.remat,
                              zero1=args.zero1,
                              seq_parallel=args.seq_parallel,
                              logits_f32=not args.logits_bf16,
                              unroll=args.unroll, mesh_shape=mesh_shape,
                              offload=args.offload,
                              pcie_gbps=args.pcie_gbps,
                              max_microbatches=args.max_microbatches)
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
                if rec["status"] == "error":
                    failures.append(rec)
                elif rec["status"] == "skipped":
                    n_skip += 1
                else:
                    n_ok += 1
    if out:
        out.close()
    # failure summary: a long sweep's errors must not scroll away into
    # the per-point JSONL noise — CI readers (and humans) get one table
    if failures:
        print(f"\n{len(failures)} of {n_ok + n_skip + len(failures)} "
              "sweep point(s) FAILED:", file=sys.stderr)
        print(f"  {'arch':<24} {'shape':<12} {'mesh':<10} error",
              file=sys.stderr)
        for r in failures:
            err = r.get("error", "?")
            print(f"  {r['arch']:<24} {r['shape']:<12} {r['mesh']:<10} "
                  f"{err[:90]}", file=sys.stderr)
        if args.keep_going:
            print("--keep-going: exiting 0 despite failures",
                  file=sys.stderr)
    else:
        print(f"\nsweep clean: {n_ok} ok, {n_skip} skipped",
              file=sys.stderr)
    sys.exit(0 if (args.keep_going or not failures) else 1)


if __name__ == "__main__":
    main()
