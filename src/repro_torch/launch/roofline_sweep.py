"""Roofline sweep: compute / memory / collective terms per (arch x input
shape) on the single-pod production mesh, the counterpart of the
reference's ``launch/roofline_sweep.py``.

The reference works around XLA's cost analysis, which counts a scan
body once, by lowering the scanned model at K = 4 and K = 8 chunks and
extrapolating linearly:

    layer      = (m_K8 - m_K4) / 4
    non_block  = m_K4 - 4 * layer
    corrected  = non_block + num_layers * layer

(pattern-chunked models -- gemma3 / hymba's local:global mix -- measure
an all-local and an all-global variant and recombine by layer counts).
XLA counts a K-chunk scan as K layers; the port's count
(``launch/steps.count_setup``) sees every layer, so its counterpart of
the K-chunk lowering is the model cut to K layers, and the same algebra
then gives back the count of the whole model exactly.  Memory, argument
bytes and the collective breakdown come from one direct count of the
whole model (the reference takes them from its K = 8 lowering, which is
the whole model).  Decode and prefill shapes count the unrolled model
directly.  The methods and record keys are the reference's.  The entry
point makes a ``fake`` process group of 256 ranks for the 16x16 mesh
and destroys it when done.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline_sweep --json roofline.jsonl
    PYTHONPATH=src python -m repro_torch.launch.roofline_sweep --arch qwen3-1.7b \\
        --shape train_4k [--remat all|none|mimose] [--seq-parallel] ...
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

from repro_torch.config import INPUT_SHAPES
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import collective_bytes, collective_total
from repro_torch.launch.steps import build_setup, count_setup, shape_applicable
from repro_torch.models.registry import ARCH_IDS, canonical, get_config

ASSIGNED = [a for a in ARCH_IDS if a != "bert_base_paper"]


def _measure(cfg, shape, mesh, **opts):
    setup = build_setup(cfg, shape, mesh, **opts)
    counts = count_setup(setup, mesh)
    coll = collective_bytes(counts.collectives)
    return {
        "flops": counts.flops,
        "bytes": counts.bytes,
        "coll": collective_total(coll),
        "coll_breakdown": coll,
        "temp": counts.temp_bytes,
        "args": counts.arg_bytes,
        "mask": setup.remat_mask,
    }


def roofline_pair(arch: str, shape_name: str, *, remat: str = "all",
                  ssm_chunk: int = 0, moe_group: int = 0, **opts) -> dict:
    """One roofline record on the 16x16 mesh (needs a process group of
    256 ranks, ``dryrun.fake_group``)."""
    from repro_torch.launch.roofline import (HBM_BW, NVLINK_BW,
                                             model_flops_for,
                                             peak_flops_for)
    cfg0 = get_config(arch)
    if ssm_chunk:
        cfg0 = dataclasses.replace(cfg0, ssm_chunk=ssm_chunk)
    if moe_group:
        cfg0 = dataclasses.replace(cfg0, moe_group_size=moe_group)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(device_type="cpu")
    rec = {"arch": canonical(arch), "shape": shape_name, "mesh": "16x16",
           "remat": remat, **{k: v for k, v in opts.items()}}
    ok, why = shape_applicable(cfg0, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()

    def _extrapolate(cfg):
        """Counts of the model cut to 4 and 8 layers (one per chunk) ->
        per-layer terms (requires uniform, type-homogeneous layers)."""
        m = {}
        for K in (4, 8):
            c = dataclasses.replace(cfg, num_layers=K, scan_chunks=K)
            m[K] = _measure(c, shape, mesh, remat=remat, **opts)
        L = cfg.num_layers
        layer = {k: (m[8][k] - m[4][k]) / 4.0
                 for k in ("flops", "bytes", "coll")}
        nb = {k: m[4][k] - 4 * layer[k] for k in layer}
        corrected = {k: nb[k] + L * layer[k] for k in layer}
        return corrected, layer, nb

    try:
        hybrid_pattern = (shape.kind == "train"
                          and cfg0.remat_mode == "scan"
                          and cfg0.sliding_window and cfg0.global_interval)
        if hybrid_pattern:
            # pattern-chunked models keep their chunk structure whatever
            # scan_chunks says, so vary the pattern: the all-local and
            # all-global variants, recombined by layer counts
            n_global = sum((i + 1) % cfg0.global_interval == 0
                           for i in range(cfg0.num_layers))
            n_local = cfg0.num_layers - n_global
            cfg_l = dataclasses.replace(cfg0, global_interval=0)  # all local
            cfg_g = dataclasses.replace(cfg0, sliding_window=0)   # all global
            _, lay_l, nb_l = _extrapolate(cfg_l)
            _, lay_g, _ = _extrapolate(cfg_g)
            corrected = {k: nb_l[k] + n_local * lay_l[k] + n_global * lay_g[k]
                         for k in lay_l}
            rec["method"] = "pattern-composed(all-local,all-global)"
            rec["per_layer_flops"] = lay_l["flops"]
            rec["per_layer_flops_global"] = lay_g["flops"]
        elif shape.kind == "train" and cfg0.remat_mode == "scan":
            corrected, layer, _ = _extrapolate(cfg0)
            rec["method"] = "scan-extrapolated(K=4,8)"
            rec["per_layer_flops"] = layer["flops"]
        else:
            cfg = dataclasses.replace(cfg0, remat_mode="unrolled") \
                if shape.kind != "train" else cfg0
            mm = _measure(cfg, shape, mesh, remat=remat, **opts)
            corrected = {k: mm[k] for k in ("flops", "bytes", "coll")}
            temp, args_b, breakdown = mm["temp"], mm["args"], \
                mm["coll_breakdown"]
            rec["method"] = ("unrolled" if cfg.remat_mode == "unrolled"
                             else "direct")
        if rec["method"] not in ("unrolled", "direct"):
            # memory, arguments and the breakdown: the whole model
            m_direct = _measure(cfg0, shape, mesh, remat=remat, **opts)
            temp, args_b = m_direct["temp"], m_direct["args"]
            breakdown = m_direct["coll_breakdown"]

        mf = model_flops_for(cfg0, shape)
        peak = peak_flops_for(cfg0.dtype)
        t_c = corrected["flops"] / peak
        t_m = corrected["bytes"] / HBM_BW
        t_x = corrected["coll"] / NVLINK_BW
        terms = {"compute": t_c, "memory": t_m, "collective": t_x}
        bound = max(terms.values())
        rec.update(
            status="ok", wall_s=round(time.time() - t0, 1),
            flops_per_dev=corrected["flops"],
            bytes_per_dev=corrected["bytes"],
            coll_bytes_per_dev=corrected["coll"],
            coll_breakdown={k: round(v) for k, v in breakdown.items()},
            t_compute_ms=round(t_c * 1e3, 3),
            t_memory_ms=round(t_m * 1e3, 3),
            t_collective_ms=round(t_x * 1e3, 3),
            bottleneck=max(terms, key=terms.get),
            model_flops=mf,
            useful_flops_ratio=round(mf / (corrected["flops"] * 256), 3)
            if corrected["flops"] else 0.0,
            mfu_bound=round(mf / (256 * peak * bound), 4) if bound else 0,
            temp_gib_per_dev=round(temp / 2**30, 2),
            arg_gib_per_dev=round(args_b / 2**30, 2),
        )
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc(limit=6))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--remat", default="all",
                    choices=["none", "all", "mimose"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--logits-bf16", action="store_true")
    ap.add_argument("--attn-replicated", action="store_true")
    ap.add_argument("--prefill-last-only", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--moe-group", type=int, default=0)
    ap.add_argument("--remat-policy", default="",
                    help="a jax.checkpoint_policies name: refused (no "
                         "torch counterpart); kept for the reference's "
                         "command lines")
    ap.add_argument("--expert-2d", action="store_true",
                    help="shard expert weights over data x model")
    ap.add_argument("--json", default=None)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    pairs = ([(args.arch, args.shape)] if args.arch
             else [(a, s) for a in ASSIGNED for s in INPUT_SHAPES])
    done = set()
    if args.resume and args.json and os.path.exists(args.json):
        for line in open(args.json):
            r = json.loads(line)
            if r.get("status") in ("ok", "skipped"):
                done.add((r["arch"], r["shape"]))
    out = open(args.json, "a") if args.json else None
    fails = 0
    with fake_group(256):
        for arch, shape in pairs:
            if (canonical(arch), shape) in done:
                continue
            rec = roofline_pair(arch, shape, remat=args.remat,
                                ssm_chunk=args.ssm_chunk,
                                moe_group=args.moe_group,
                                zero1=args.zero1,
                                seq_parallel=args.seq_parallel,
                                logits_f32=not args.logits_bf16,
                                attn_replicated=args.attn_replicated,
                                prefill_last_only=args.prefill_last_only,
                                remat_policy=args.remat_policy,
                                expert_2d=args.expert_2d)
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            fails += rec["status"] == "error"
    if out:
        out.close()
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
