#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. card identity (``nvidia-smi`` name and power limit);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel (flash forward, dq, dk/dv) against its plain PyTorch
   version on the card, over the reference suite's cases and the main
   path's shapes;
4. one full-width loss through the flash kernels against plain
   attention;
5. the main path: ``repro_torch.launch.train.main`` trains full-width
   ``bert_base_paper`` under the Mimose planner with ``--attn-impl
   flash``, with launch counts read around it;
6. where a warm step's device time goes (``torch.profiler``), and its
   device memory after the forward and at the backward's peak against
   the planner's prediction;
7. kernel timings (CUDA events) beside the plain version, the library
   call and the bound;

then prints the card line, one ``{"kernels": [...]}`` JSON line and, as
the last line, ``{"ok": true, "device": {...}}``.  Exits non-zero without
a CUDA device, and when the repository's ``src/`` is not beside it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA's data sheet): HBM 3.35 TB/s;
# fp32 outside the tensor cores 67 TFLOP/s.  The kernels compute fp32 on
# the CUDA cores (no TF32), so their operation bound uses the fp32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# main path: full-width bert_base_paper, squad lengths, batch 8
MAIN_ARGS = dict(arch="bert_base_paper", dataset="squad", batch_size=8,
                 steps=16, quantum=32)
# share of the first batch's collected activation bytes the budget
# leaves on top of the fixed bytes: the rest must be rematerialised
BUDGET_ACT_SHARE = 0.6

KERNELS = [
    # name, TPU kernel replaced (file:line of its body)
    ("flash_fwd", "src/repro/kernels/flash_attention.py:57"),
    ("flash_bwd_dq", "src/repro/kernels/flash_attention.py:163"),
    ("flash_bwd_dkv", "src/repro/kernels/flash_attention.py:205"),
]
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"

# (B, S, H, Hkv, hd, causal, window, dtype, ragged): the reference's
# FLASH_CASES (tests/test_kernels.py) and RAGGED_FLASH_CASES
# (tests/test_ragged.py); the main path's shapes are added at run time
REFERENCE_CASES = [
    (1, 64, 2, 2, 32, True, 0, "float32", False),
    (2, 128, 4, 2, 64, True, 0, "float32", False),
    (1, 256, 8, 1, 32, True, 0, "float32", False),
    (1, 96, 4, 4, 32, True, 32, "float32", False),
    (2, 128, 4, 2, 64, True, 64, "float32", False),
    (1, 128, 2, 2, 32, False, 0, "float32", False),
    (1, 128, 4, 2, 64, True, 0, "bfloat16", False),
    (1, 80, 2, 2, 16, True, 0, "float32", False),
    (2, 96, 4, 2, 32, True, 0, "float32", True),
    (2, 96, 4, 4, 32, True, 32, "float32", True),
    (2, 128, 8, 1, 16, True, 0, "float32", True),
    (2, 96, 2, 2, 32, False, 0, "float32", True),
    (2, 160, 4, 2, 128, True, 0, "float32", True),
    (2, 160, 4, 2, 64, True, 0, "bfloat16", True),
]
# |kernel - plain| <= atol + rtol * |plain|: fp32 sums in another order
# (forward), the exp(s - lse) recombination (backward), one bf16
# rounding of each output (bf16)
TOL = {"float32": {"fwd": (2e-4, 2e-5), "bwd": (2e-3, 2e-4)},
       "bfloat16": {"fwd": (3e-2, 3e-2), "bwd": (3e-2, 3e-2)}}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _err(a, b, rtol, atol):
    """(max |a - b|, worst (|a - b| - rtol |b|) - atol); raises on a
    value that is not finite."""
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("kernel or plain output is not finite")
    d = (a.float() - b.float()).abs()
    return float(d.max()), float((d - rtol * b.float().abs()).max() - atol)


def _valid_rows(x, lens):
    return torch.cat([x[b, :, :L].reshape(-1, x.shape[-1])
                      for b, L in enumerate(lens)])


def check_case(fa, case, lens=None, seed=0):
    """Run K1-K3 and their plain versions on one case; returns the max
    abs error per kernel.  Raises on a tolerance miss."""
    B, S, H, Hkv, hd, causal, window, dtype, ragged = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    q, k, v, do = rnd(B, H, S, hd), rnd(B, Hkv, S, hd), rnd(B, Hkv, S, hd), \
        rnd(B, H, S, hd)
    if lens is None:
        lens = ([int(x) for x in torch.randint(
            S // 3, S + 1, (B,), generator=gen, device="cuda")]
            if ragged else [S] * B)
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    valid = (torch.arange(S, device="cuda")[None, :]
             < kvl[:, None]).to(dt)
    do = do * valid[:, None, :, None]       # padded rows carry no gradient
    tol = TOL[dtype]
    errs = {}

    o, lse = fa.flash_fwd(q, k, v, kvl, causal, window)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, kvl, causal, window)
    torch.cuda.synchronize()
    e_o = _err(_valid_rows(o, lens), _valid_rows(o_p, lens), *tol["fwd"])
    e_l = _err(_valid_rows(lse[..., None], lens),
               _valid_rows(lse_p[..., None], lens), 2e-5, 2e-5)
    errs["flash_fwd"] = max(e_o[0], e_l[0])
    if max(e_o[1], e_l[1]) > 0:
        raise AssertionError(f"flash_fwd disagrees with plain on {case}: "
                             f"o {e_o}, lse {e_l}")

    delta = (do.float() * o.float()).sum(-1)
    dq = torch.empty_like(q)
    lib = fa.library()
    dims = (B, H, Hkv, S, hd, int(causal), int(window), 1.0 / math.sqrt(hd),
            fa._DTYPE_CODE[dt], torch.cuda.current_stream().cuda_stream)
    fa._raise_on(lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  do.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), kvl.data_ptr(),
                                  dq.data_ptr(), *dims), "flash_bwd_dq")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa._raise_on(lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), kvl.data_ptr(),
                                   dk.data_ptr(), dv.data_ptr(), *dims),
                 "flash_bwd_dkv")
    torch.cuda.synchronize()
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, kvl, causal, window)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, kvl, causal,
                                        window)
    torch.cuda.synchronize()
    e_q = _err(_valid_rows(dq, lens), _valid_rows(dq_p, lens), *tol["bwd"])
    e_k = _err(dk, dk_p, *tol["bwd"])
    e_v = _err(dv, dv_p, *tol["bwd"])
    errs["flash_bwd_dq"] = e_q[0]
    errs["flash_bwd_dkv"] = max(e_k[0], e_v[0])
    if e_q[1] > 0 or e_k[1] > 0 or e_v[1] > 0:
        raise AssertionError(f"backward disagrees with plain on {case}: "
                             f"dq {e_q}, dk {e_k}, dv {e_v}")
    for b, L in enumerate(lens):
        if bool(dk[b, :, L:].any()) or bool(dv[b, :, L:].any()):
            raise AssertionError(f"dk/dv not exactly 0 past length {L}: "
                                 f"{case}")
    # the public wrapper (backward through the same kernels) agrees too
    dq2, dk2, dv2 = fa.flash_bwd(q, k, v, o, lse, do, kvl, causal, window)
    torch.cuda.synchronize()
    if not (torch.equal(dq2, dq) and torch.equal(dk2, dk)
            and torch.equal(dv2, dv)):
        raise AssertionError(f"flash_bwd wrapper differs from the direct "
                             f"launches on {case}")
    return errs


def check_kernels(fa, cases, lens_of=None):
    """Every case in ``cases``; returns max abs error per kernel over the
    cases flagged as main-path cases in ``lens_of``."""
    main_errs = {name: 0.0 for name, _ in KERNELS}
    for case in cases:
        lens = (lens_of or {}).get(case)
        errs = check_case(fa, case, lens)
        log(f"kernel check {case}: "
            + " ".join(f"{n}={e:.3e}" for n, e in errs.items()))
        if lens is not None:
            for n, e in errs.items():
                main_errs[n] = max(main_errs[n], e)
    return main_errs


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def main_path_batches():
    from repro_torch.data.pipeline import make_batches
    from repro_torch.models.registry import get_config
    cfg = get_config(MAIN_ARGS["arch"])
    return list(make_batches(MAIN_ARGS["dataset"],
                             batch_size=MAIN_ARGS["batch_size"],
                             vocab_size=cfg.vocab_size,
                             num_batches=MAIN_ARGS["steps"],
                             quantum=MAIN_ARGS["quantum"], seed=0))


def derive_budget_mb(first_batch) -> float:
    """fixed bytes + BUDGET_ACT_SHARE x the first batch's collected
    activation bytes (the collector runs on meta tensors)."""
    from repro_torch.core.collector import (ShuttlingCollector,
                                           unit_residual_bytes)
    from repro_torch.core.planner import fixed_train_bytes
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    lm = LM(get_config(MAIN_ARGS["arch"]), attn_impl="flash", device="cpu")
    fixed = fixed_train_bytes(lm.parameters())
    B, S = first_batch["tokens"].shape
    tokens = {"tokens": torch.zeros((B, S), dtype=torch.long)}
    act = ShuttlingCollector(lm).collect(tokens).total_activation_bytes()
    budget = fixed + BUDGET_ACT_SHARE * act
    log(f"budget: fixed {fixed / 2**20:.1f} MiB (16 B/param: params, grads, "
        f"fp32 m and v) + {BUDGET_ACT_SHARE} x {act / 2**20:.1f} MiB "
        f"activations of the first batch (B={B}, S={S}, 12 blocks) = "
        f"{budget / 2**20:.1f} MiB")
    # what the planner's model leaves out (the measured peak's excess)
    unit = lm.plan_units(tokens)[0]
    shape = (B, S, lm.cfg.d_model)
    x_only = unit_residual_bytes(unit, shape, lm.dtype)["activation_bytes"]
    train = unit_residual_bytes(unit, shape, lm.dtype,
                                weight_grads=True)["activation_bytes"]
    log(f"residuals per block at S={S}: {x_only / 2**20:.2f} MiB counted "
        f"(input gradient only, as the reference) vs {train / 2**20:.2f} MiB "
        f"held in training (weight gradients too); fp32 logits "
        f"{B * S * lm.cfg.vocab_size * 4 / 2**20:.2f} MiB per copy, outside "
        f"every block")
    return budget / 2**20


def check_model(first_batch):
    """One full-width loss through the flash kernels against the plain
    attention path on the same weights and batch."""
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    from repro_torch.data.pipeline import pad_batch
    lm = LM(get_config(MAIN_ARGS["arch"]), attn_impl="flash", device="cuda")
    b = pad_batch(first_batch, MAIN_ARGS["quantum"])
    batch = {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in b.items()}
    batch["tokens"] = batch["tokens"].long()
    batch["labels"] = batch["labels"].long()
    with torch.no_grad():
        flash, _ = lm.loss(batch)
        lm.attn_impl = "xla"
        plain, _ = lm.loss(batch)
    torch.cuda.synchronize()
    flash, plain = float(flash), float(plain)
    log(f"model check: loss flash {flash:.6f} plain {plain:.6f}")
    if not (math.isfinite(flash) and abs(flash - plain) <= 1e-4 * abs(plain)):
        raise AssertionError("full-width loss: flash and plain disagree")
    del lm
    torch.cuda.empty_cache()


def run_main_path(budget_mb):
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    argv = ["--arch", MAIN_ARGS["arch"], "--dataset", MAIN_ARGS["dataset"],
            "--planner", "mimose", "--attn-impl", "flash",
            "--budget-mb", f"{budget_mb:.3f}",
            "--steps", str(MAIN_ARGS["steps"]),
            "--batch-size", str(MAIN_ARGS["batch_size"]),
            "--quantum", str(MAIN_ARGS["quantum"]), "--device", "cuda"]
    log("main path: python -m repro_torch.launch.train " + " ".join(argv))
    ops.reset_launches()
    trainer = launch_train.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_main_path(trainer, launches)
    return trainer, launches


def check_main_path(trainer, launches):
    """What the main path's run must show; raises otherwise."""
    h = trainer.history
    n_units = trainer.lm.num_plan_units()
    losses = [s.loss for s in h]
    log(f"main path launches: {launches}")
    checks = {
        "losses finite": all(math.isfinite(x) for x in losses),
        "sheltered collections": any(s.collected for s in h),
        "estimator ready": trainer.planner.estimator.ready,
        "predicted plan": any(not s.collected and not s.cache_hit
                              for s in h),
        "plan-cache hit": any(s.cache_hit for s in h),
        "mixed KEEP/REMAT plan": any(0 < s.remat_units < n_units for s in h),
        "every kernel launched": all(n > 0 for n in launches.values()),
        # the forward runs every block through K1 once, and each REMAT
        # block once more in the backward's recompute
        "K1 = sum(units + n_remat)": launches["flash_fwd"]
        == sum(n_units + s.remat_units for s in h),
        "K2 = K3 = units per step": launches["flash_bwd_dq"]
        == launches["flash_bwd_dkv"] == n_units * len(h),
    }
    log("main path checks: " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"main path checks failed: {checks}")
    summ = trainer.summary()
    log(f"main path: tokens/s over warm steps {summ['tokens_per_s']:.1f} "
        f"(padded {summ['padded_tokens_per_s']:.1f}), mean warm step "
        f"{summ['mean_step_s'] * 1e3:.2f} ms, plan time "
        f"{summ['total_plan_s'] * 1e3:.2f} ms total")


def profile_step(trainer, batch):
    """Where one warm training step's time goes: its host wall time
    (synchronised, profiler off), then the same step under
    ``torch.profiler`` for device time by kernel.  The device's busy
    share is device kernel time over the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    opt_state = trainer.optimizer.init(trainer.params)
    for _ in range(2):                      # warm, then the timed step
        opt_state, _ = trainer.step(opt_state, batch)
    st = trainer.history[-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt_state, _ = trainer.step(opt_state, batch)
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    wall_ms = st.step_time_s * 1e3
    if not dev_ms:
        log("profile: the profiler reported no device time; busy share "
            "not measured")
        return
    log(f"profile: one warm step (forward, backward, AdamW), S="
        f"{batch['tokens'].shape[1]}, n_remat={st.remat_units}: wall "
        f"{wall_ms:.2f} ms (profiler off), device kernels {dev_ms:.2f} ms "
        f"(profiler on), busy share {dev_ms / wall_ms:.3f}")
    groups = {"flash kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for ms, n, name in rows:
        low = name.lower()
        g = ("flash kernels" if "flash_" in name else
             "gemm" if any(k in low for k in ("gemm", "cutlass", "xmma"))
             else "other")
        groups[g] += ms
    log("profile groups (ms): " + json.dumps(
        {k: round(v, 3) for k, v in groups.items()}))
    for ms, n, name in rows[:12]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name[:110]}")


def memory_phase(trainer, batch):
    """Device memory over one step under its cached plan, against the
    planner's prediction: bytes held at the end of the forward (what
    the backward will read) and the backward's peak, both above what
    was resident before the step."""
    lm, dev = trainer.lm, trainer.lm.device
    tb = trainer._prepare(batch)
    actions, info = trainer.planner.plan(tb)
    plan = info.plan
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    loss, _ = lm.loss(tb, actions)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev) - base
    fwd_peak = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    loss.backward()
    torch.cuda.synchronize(dev)
    bwd_peak = torch.cuda.max_memory_allocated(dev) - base
    grads = sum(p.grad.numel() * p.grad.element_size()
                for p in lm.parameters())
    for p in lm.parameters():
        p.grad = None
    mib = 2 ** 20
    log(f"memory: S={tb['tokens'].shape[1]} n_remat={plan.n_remat}: "
        f"resident before the step {base / mib:.1f} MiB; held after the "
        f"forward {held / mib:.1f} MiB (planner: "
        f"{(plan.est_activation_bytes - plan.covered_bytes) / mib:.1f} MiB "
        f"of block residuals kept); forward peak {fwd_peak / mib:.1f} MiB; "
        f"backward peak {bwd_peak / mib:.1f} MiB above resident, of which "
        f"grads {grads / mib:.1f} MiB")


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------

def _time_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernels(fa, S, lens, H=12, hd=64):
    """Each kernel at the main path's shape (B = len(lens), S, H, hd,
    fp32, causal, these lengths), with its plain version, the library
    call (``scaled_dot_product_attention``, timed here only) and its
    bound."""
    import torch.nn.functional as F
    B = len(lens)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn((B, H, S, hd), generator=gen, device="cuda")
                   for _ in range(4))
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_fwd(q, k, v, kvl, True, 0)
    delta = (do * o).sum(-1)
    lib = fa.library()
    stream = torch.cuda.current_stream().cuda_stream
    dims = (B, H, H, S, hd, 1, 0, 1.0 / math.sqrt(hd), 0, stream)
    o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))

    def k1():
        return lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      kvl.data_ptr(), o2.data_ptr(), lse2.data_ptr(), *dims)

    def k2():
        return lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                         kvl.data_ptr(), dq.data_ptr(), *dims)

    def k3():
        return lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          kvl.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims)

    # the library yardstick: the same masked attention, forward, and its
    # backward (one autograd call computing dq, dk and dv together)
    pos = torch.arange(S, device="cuda")
    mask = ((pos[:, None] >= pos[None, :])[None]
            & (pos[None, None, :] < kvl[:, None, None]))[:, None]
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)

    def lib_bwd():
        torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)

    plain = {
        "flash_fwd": lambda: fa.flash_fwd_plain(q, k, v, kvl, True, 0),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse,
                                                      delta, kvl, True, 0),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, kvl, True, 0),
    }
    lib_ms = {"flash_fwd": _time_ms(lib_fwd, 20)}
    lib_ms["flash_bwd_dq"] = lib_ms["flash_bwd_dkv"] = _time_ms(lib_bwd, 20)

    # work this run's data needs: visible (q, k) pairs under the causal
    # mask and the lengths; FLOPs per pair per head: 4 hd (q.k, p.v)
    # forward, 6 hd for dq (q.k, do.v, ds.k), 8 hd for dk/dv
    pairs = H * sum(L * (L + 1) // 2 for L in lens)
    tensor = B * H * S * hd * 4
    rows = B * H * S * 4
    work = {
        "flash_fwd": (4 * hd * pairs, 3 * tensor + 4 * B + tensor + rows),
        "flash_bwd_dq": (6 * hd * pairs, 4 * tensor + 2 * rows + 4 * B
                         + tensor),
        "flash_bwd_dkv": (8 * hd * pairs, 4 * tensor + 2 * rows + 4 * B
                          + 2 * tensor),
    }
    out = {}
    for (name, _), fn in zip(KERNELS, (k1, k2, k3)):
        fa._raise_on(fn(), name)
        ms = _time_ms(fn, 20)
        plain_ms = _time_ms(plain[name], 5)
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms[name],
                         bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes", flops=flops, bytes=nbytes)
        log(f"timing {name} B={B} S={S} H={H} hd={hd} fp32 lens={lens}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib_ms[name]:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({out[name]['bound_by']}; {flops / 1e9:.3f} GFLOP at 67 TFLOP/s "
            f"fp32, {nbytes / 1e6:.2f} MB at 3.35 TB/s), "
            f"{flops / ms / 1e9:.2f} TFLOP/s achieved")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    path = fa.build_library()
    fa.library()
    log(f"build: {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    batches = main_path_batches()
    by_bucket = {}
    for b in batches:
        by_bucket.setdefault(b["tokens"].shape[1], [int(x) for x in
                                                    b["lengths"]])
    main_cases = {(MAIN_ARGS["batch_size"], S, 12, 12, 64, True, 0,
                   "float32", True): lens
                  for S, lens in sorted(by_bucket.items())}
    errs = check_kernels(fa, REFERENCE_CASES + list(main_cases), main_cases)
    log(f"kernel checks passed; max abs error at the main path's shapes: "
        f"{errs}")

    check_model(batches[0])
    budget_mb = derive_budget_mb(batches[0])
    trainer, launches = run_main_path(budget_mb)

    counts = {}
    for b in batches:
        counts[b["tokens"].shape[1]] = counts.get(b["tokens"].shape[1], 0) + 1
    S_main = max(counts, key=lambda s: (counts[s], s))
    main_batch = next(b for b in batches if b["tokens"].shape[1] == S_main)
    profile_step(trainer, main_batch)
    memory_phase(trainer, main_batch)
    timings = time_kernels(fa, S_main, by_bucket[S_main])

    kernels = []
    for name, replaces in KERNELS:
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
