"""The engine report a training run prints at exit: a per-bucket table
(steps, gradient-accumulation split ``k``, padded vs effective tokens,
pad fraction), the step- and plan-cache counts, the background solver's
and the offload lane's totals, the resilience counters (snapshots,
restores, OOMs, escalations, retries), and the planner's
predicted-vs-actual peak bytes per bucket; and the serve report a serve
run prints.  Copied from the reference's ``launch/report.py``
(``engine_report``, ``drift_table``, ``serve_report``); built from the
run's ``MetricsRegistry`` snapshot, not from trainer internals.  And
the dry run's and roofline sweep's markdown tables from their JSONL
records (``load``, ``dryrun_table``, ``roofline_table``):

    PYTHONPATH=src python -m repro_torch.launch.report out.jsonl --kind dryrun
"""
from __future__ import annotations

import argparse
import json
from collections import OrderedDict


# -- metrics-snapshot accessors ---------------------------------------------
def _by_label(snap: dict, name: str, label: str = "bucket") -> dict:
    """``{int(label-value): value}`` for one metric in a registry
    snapshot (labels are stored as strings; buckets parse back to int)."""
    out: dict = {}
    for row in snap.get(name, {}).get("values", []):
        raw = row["labels"].get(label)
        if raw is None:
            continue
        try:
            key = int(raw)
        except (TypeError, ValueError):
            key = raw
        out[key] = out.get(key, 0) + row["value"]
    return {k: int(v) if float(v).is_integer() else v
            for k, v in out.items()}


def _total(snap: dict, name: str) -> int:
    return int(snap.get(name, {}).get("total", 0))


def _ftotal(snap: dict, name: str) -> float:
    return float(snap.get(name, {}).get("total", 0.0))


def drift_table(snap: dict) -> list:
    """Per-bucket predicted-vs-actual peak-bytes rows from the planner's
    drift gauges.  ``actual`` renders ``-`` for buckets that only ever
    ran responsive (predicted) plans and were never audited."""
    pred = _by_label(snap, "plan_predicted_peak_bytes")
    act = _by_label(snap, "plan_actual_peak_bytes")
    if not pred and not act:
        return []
    lines = ["", "| bucket S | predicted peak MB | actual peak MB "
                 "| drift % |", "|---|---|---|---|"]
    for b in sorted(set(pred) | set(act)):
        p = pred.get(b)
        a = act.get(b)
        p_s = f"{p / 1e6:.2f}" if p else "-"
        a_s = f"{a / 1e6:.2f}" if a else "-"
        d_s = f"{100.0 * (p - a) / a:+.2f}" if p and a else "-"
        lines.append(f"| {b} | {p_s} | {a_s} | {d_s} |")
    return lines


def engine_report(trainer, planner=None) -> str:
    """Markdown report of the compile-once engine's caches and padding.

    ``trainer``: a ``repro_torch.train.trainer.Trainer`` after some
    steps.
    ``planner``: optionally the planner, for the solver delta table
    (everything else comes from the trainer's metrics snapshot).
    """
    snap = trainer.telemetry.metrics.snapshot()
    bucket_steps = _by_label(snap, "train_bucket_steps")
    padded_by = _by_label(snap, "train_bucket_padded_tokens")
    eff_by = _by_label(snap, "train_bucket_tokens")
    k_by = _by_label(snap, "train_bucket_microbatch")
    lines = ["| bucket S | steps | k | padded tok | effective tok | pad % |",
             "|---|---|---|---|---|---|"]
    tot_pad = tot_eff = 0
    for bucket in sorted(bucket_steps):
        steps = bucket_steps[bucket]
        padded = padded_by.get(bucket, 0)
        eff = eff_by.get(bucket, 0)
        # gradient-accumulation split the planner picked for the bucket
        # (where adaptive microbatching kicked in; 1 = full-batch steps)
        k = k_by.get(bucket, 1)
        tot_pad += padded
        tot_eff += eff
        frac = 100.0 * (1.0 - eff / padded) if padded else 0.0
        lines.append(f"| {bucket} | {steps} | {k} | {padded} | {eff} "
                     f"| {frac:.1f} |")
    tot_frac = 100.0 * (1.0 - tot_eff / tot_pad) if tot_pad else 0.0
    lines.append(f"| **total** | {sum(bucket_steps.values())} | - "
                 f"| {tot_pad} | {tot_eff} | {tot_frac:.1f} |")
    lines.append("")
    lines.append(f"step cache: {_total(snap, 'train_jit_compiles')} built "
                 f"(+{_total(snap, 'train_jit_prewarm_compiles')} "
                 f"prewarmed), {_total(snap, 'train_jit_hits')} hits")
    # plan-cache metrics only exist when an input-aware planner was
    # bound (baselines have no stats), so baseline reports stay short
    if "plan_cache_hits" in snap:
        lines.append(f"plan cache: {_total(snap, 'plan_cache_hits')} hits, "
                     f"{_total(snap, 'plan_cache_misses')} misses, "
                     f"{_total(snap, 'planner_collections')} collections")
    # background-solver tier — only when solves actually ran, so runs
    # with --solver off keep the report unchanged
    if _total(snap, "solver_solves") or _total(snap, "solver_timeouts"):
        lines.append(f"solver: {_total(snap, 'solver_solves')} solve(s), "
                     f"{_total(snap, 'solver_wins')} win(s), "
                     f"{_total(snap, 'solver_swaps')} swap(s), "
                     f"{_total(snap, 'solver_timeouts')} timeout(s)")
        stats = getattr(planner, "stats", None) \
            if planner is not None else None
        deltas = (stats or {}).get("solver_delta_by_bucket", {})
        if deltas:
            lines.append("")
            lines.append("| bucket S | greedy overhead s | solved overhead s "
                         "| delta % |")
            lines.append("|---|---|---|---|")
            for b in sorted(deltas):
                d = deltas[b]
                lines.append(f"| {b} | {d['greedy_s']:.6f} "
                             f"| {d['solved_s']:.6f} "
                             f"| {d['improvement_pct']:.2f} |")
    # real-offload execution — only when something moved or degraded,
    # so remat-only runs keep the report unchanged
    degraded = _total(snap, "train_offload_degraded_steps")
    exposed = _ftotal(snap, "train_exposed_transfer_s")
    sim_x = _ftotal(snap, "train_sim_transfer_s")
    fallbacks = _total(snap, "offload_fallbacks")
    if exposed or sim_x or degraded or fallbacks:
        lines.append(f"offload: exposed transfer {exposed:.4f}s measured "
                     f"vs {sim_x:.4f}s simulated; lane copies "
                     f"{_ftotal(snap, 'transfer_copy_s'):.4f}s, "
                     f"{_total(snap, 'transfer_bytes_out') / 1e6:.1f} MB "
                     f"out, {_total(snap, 'transfer_bytes_in') / 1e6:.1f} "
                     f"MB in, compute stalled "
                     f"{_ftotal(snap, 'transfer_stall_s'):.4f}s on fetches")
    if degraded or fallbacks:
        lines.append(f"offload degraded to remat: {degraded} step(s), "
                     f"{fallbacks} fallback(s) (plans keep their typed "
                     f"actions)")
    # resilience counters — only when something happened, so quiet runs
    # keep a quiet report
    oom = _total(snap, "train_oom_events")
    snaps = _total(snap, "snapshots_written")
    restores = int(getattr(trainer, "restores", 0))
    if oom or snaps or restores:
        lines.append(f"resilience: {snaps} snapshot(s) written, "
                     f"{restores} restore(s), {oom} OOM event(s), "
                     f"{_total(snap, 'train_escalations')} escalation(s), "
                     f"{_total(snap, 'train_retry_successes')} retry "
                     f"success(es), "
                     f"{_total(snap, 'train_retry_failures')} retry "
                     "failure(s)")
        esc_by = _by_label(snap, "train_escalations")
        if esc_by:
            per = ", ".join(f"{b}: {n}" for b, n in sorted(esc_by.items()))
            lines.append(f"escalations by bucket: {per}")
    # input-aware memory drift: predicted vs audited per-device peak
    lines.extend(drift_table(snap))
    return "\n".join(lines)


def serve_report(engine, result) -> str:
    """Markdown report of one continuous-batching serve run.

    ``engine``: the ``repro_torch.train.engine.ServeEngine`` after
    ``run``; ``result``: the ``ServeResult`` it returned.  The
    reference's rows (throughput and latency percentiles, the admission
    ledger with predicted-vs-actual peak bytes, the geometries), plus
    the CUDA allocator's peak and the workspace charges measured for it
    where the run had one."""
    snap = engine.telemetry.metrics.snapshot()
    lines = ["| metric | value |", "|---|---|"]
    lines.append(f"| completed / rejected | {result.completed} / "
                 f"{result.rejected} |")
    lines.append(f"| tokens | {result.total_tokens} "
                 f"({result.tokens_per_s:.1f} tok/s) |")
    lines.append(f"| TTFT p50 / p99 | {result.ttft_p50_s * 1e3:.1f} / "
                 f"{result.ttft_p99_s * 1e3:.1f} ms |")
    lines.append(f"| inter-token p50 / p99 | {result.itl_p50_s * 1e3:.2f} / "
                 f"{result.itl_p99_s * 1e3:.2f} ms |")
    lines.append(f"| admission | {_total(snap, 'serve_admitted')} admitted, "
                 f"{_total(snap, 'serve_deferrals')} deferral(s), "
                 f"{_total(snap, 'serve_rejected')} rejected |")
    lines.append(f"| peak HBM predicted / actual | "
                 f"{_ftotal(snap, 'serve_peak_predicted_bytes') / 1e6:.2f} / "
                 f"{_ftotal(snap, 'serve_peak_actual_bytes') / 1e6:.2f} MB "
                 f"(budget {engine.hbm_bytes / 1e6:.0f} MB) |")
    if result.peak_allocated_bytes is not None:
        lines.append(f"| peak allocated (CUDA allocator) | "
                     f"{result.peak_allocated_bytes / 1e6:.2f} MB |")
        lines.append(f"| measured workspace charged | prefill "
                     f"{engine.prefill_ws / 1e6:.3f} MB/token, decode "
                     f"{engine.slot_ws / 1e6:.3f} MB/slot, beside the "
                     f"parameters {engine.fixed_bytes / 1e6:.2f} MB |")
    lines.append(f"| pools | {_total(snap, 'serve_pool_grows')} grow(s), "
                 f"{_total(snap, 'serve_decode_batches')} decode batch(es), "
                 f"{_total(snap, 'serve_prefill_chunks')} prefill chunk(s) |")
    comp = ", ".join(f"{k}: {v}" for k, v in
                     sorted(result.compile_counts.items()))
    lines.append(f"| compiled geometries | {comp} |")
    return "\n".join(lines)


def load(path):
    recs = [json.loads(l) for l in open(path)]
    seen = OrderedDict()
    for r in recs:                      # keep the latest record per key
        seen[(r["arch"], r["shape"], r.get("mesh", ""))] = r
    return list(seen.values())


def dryrun_table(recs):
    print("| arch | shape | mesh | status | step | compile_s | "
          "temp GiB/dev | args GiB/dev | remat plan |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r["status"] == "ok":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                  f"{r['step']} | {r['compile_s']} | "
                  f"{r['temp_gib_per_dev']} | {r['arg_gib_per_dev']} | "
                  f"`{r.get('remat_mask') or '-'}` |")
        else:
            reason = r.get("reason", r.get("error", ""))[:60]
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                  f"{r['status']} | - | - | - | - | {reason} |")


def roofline_table(recs):
    print("| arch | shape | t_compute ms | t_memory ms | t_coll ms | "
          "bottleneck | useful FLOPs | MFU bound | temp GiB/dev |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r["status"] != "ok":
            print(f"| {r['arch']} | {r['shape']} | - | - | - | "
                  f"{r['status']} | - | - | - |")
            continue
        print(f"| {r['arch']} | {r['shape']} | {r['t_compute_ms']} | "
              f"{r['t_memory_ms']} | {r['t_collective_ms']} | "
              f"**{r['bottleneck']}** | {r['useful_flops_ratio']} | "
              f"{r['mfu_bound']} | {r['temp_gib_per_dev']} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--kind", choices=["dryrun", "roofline"],
                    default="dryrun")
    args = ap.parse_args(argv)
    recs = load(args.path)
    (dryrun_table if args.kind == "dryrun" else roofline_table)(recs)


if __name__ == "__main__":
    main()
