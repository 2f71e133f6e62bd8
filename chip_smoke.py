#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. card identity (``nvidia-smi`` name and power limit);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source, all started together; log the flash instances'
   registers and stack (``cuobjdump -res-usage``), failing if a bf16
   hd-80 or hd-256 instance uses local memory (bf16 at 256 runs the
   wgmma kernels: the forward, dq and dk/dv), and each instance's
   threads per CTA (failing where it is not the kernel's: 256 for the
   wgmma kernels, 128 for the others), dynamic shared memory and
   registers; then the SSD tensor-core instances' registers and stack
   (failing on a stack or local size);
3. bert path: hold each flash kernel (the forward, dq and dk/dv kernels
   on the tensor cores, and the fp32 FMA kernels they replaced) against
   its plain PyTorch version on the card, and the tensor-core kernels
   against the FMA ones, over the reference suite's
   cases and the main path's shapes; the bitwise padded-versus-unpadded
   check on the forward, dq and dk/dv kernels; one full-width loss
   through the flash kernels against plain attention; then the main path:
   ``repro_torch.launch.train.main`` trains full-width
   ``bert_base_paper`` under the Mimose planner with ``--attn-impl
   flash``, with launch counts read around it (no FMA flash launch);
   where a warm step's device time goes (``torch.profiler``) and its
   memory against the planner's prediction; kernel timings (CUDA events; each tensor-core
   kernel and its FMA predecessor in turns) beside the plain version,
   the library call and the bound;
3b. planners path: full-width ``bert_base_paper`` through
   ``repro_torch.launch.train.main`` under ``--planner none``,
   ``sublinear``, ``dtr``, ``mimose`` and ``mimose --max-microbatches 4
   --solver dp`` at the main path's budget, then Mimose at a budget the
   simulator says no k = 1 plan meets, 8 steps each, with launch counts
   read around each run (K1 = sum k (12 + n_remat), K2 = K3 = sum 12 k);
   the k = 2 and k = 3 accumulated loss and gradients against the k = 1
   step's (k = 3 adds a pad row of length 0), and the flash kernels on a
   length-0 row; the three planning constants of
   ``launch/roofline.py`` measured (``launch/calibrate.py``);
3b2. sharding path (after the planners path; ``run_sharding_path``):
   (a) the main path again through ``launch.train.main`` with
   ``--mesh-shape 1x1 --hbm-gb 80`` at the main budget, a one-device
   ``DeviceMesh`` built, snapshots at step 8 and 16: every step's
   actions and loss bitwise the main path's, its launches by the main
   path's formula, the plan keys carrying ((data, 1), (model, 1)); (b)
   ``--resume`` from the step-8 snapshot under ``--mesh-shape 4x2
   --zero1 --hbm-gb`` (the main budget in GiB), planned per device and
   executed on this card: the mesh changed, every logged sample
   replayed, every stored plan dropped, no collection, no bucket
   rematerialising more units than under 1x1, each plan's simulated
   per-device peak within the per-device budget, the losses the
   uninterrupted run's (bitwise, else within ``OFFLOAD_TOL``), K1 = sum
   k (12 + recomputed layers), K2 = K3 = sum 12 k; the allocator's peak
   logged beside the per-device prediction; (c) on the host, full-depth
   ``gemma3_12b`` on ``meta`` planned for bucket 448 at B = 8 under 80
   GiB a device on (1,), (4, 2) and (4, 2) with ZeRO-1: fixed bytes per
   device within 1 % of 141.2, 70.6 and 35.3 GB, (1,) infeasible, (4,
   2) with ZeRO-1 feasible; each part's wall time;
3b3. distributed path (after the sharding path; ``run_distributed_path``,
   each phase's wall time logged): D1, ``launch.dryrun.run_one`` for
   ``qwen3_1p7b`` at ``train_4k`` and ``mamba2_1p3b`` at ``decode_32k``
   on the 16x16 mesh under a fake process group of 256 ranks, every
   tensor on ``meta``: each ``ok`` with FLOPs per device above 0, its
   record, useful-FLOPs ratio and bottleneck logged; D2, the bert main
   path's first 8 steps through ``launch.steps.build_setup``'s train
   step on a built (1, 1) ``nccl`` mesh (the main path's weights, plans
   and batches; the flash kernels on the heads through ``local_map``):
   every loss and the step-8 parameters bitwise the main path's (the
   sharding path's (a) snapshot; AdamW's kernels on the DTensors'
   shards, the clip scale from the sum of squares added over the mesh),
   K1 = sum (12 + REMAT units), K2 = K3
   = 12 a step; D3, the same step at (4, 2) with ZeRO-1 under a fake
   group of 8 ranks, rank 0's shards on this card (2 of 8 rows, 6 of
   12 heads, half of d_ff), one step per bucket under the sharding
   path's (b) plans: launches by the same formula, and each bucket's
   allocator peak logged beside the per-device simulated peak and
   prediction (the fake collectives leave the values meaningless);
3c. offload path: full-width ``bert_base_paper``, the first 8 batches,
   each run through ``repro_torch.launch.train.main`` with every
   telemetry sink on (``--metrics``, ``--events-out``, ``--trace-out``
   into a temporary directory) and launch counts read around it:
   (a) ``--offload --solver dp`` at a budget the simulator says no k = 1
   KEEP/REMAT plan meets and a hybrid one does; (b) ``--offload
   --opt-offload`` at a budget only parked moments meet (the planner's
   choice logged), then the plan it does not find (every unit OFFLOAD,
   the last OFFLOAD_OPT) through the trainer; (c) ``--max-microbatches
   4`` at (a)'s budget.  Checks: OFFLOAD in every step of (a),
   OFFLOAD_OPT in every step of (b)'s fixed plan, no OFFLOAD run as
   REMAT, the lane's bytes equal to the offloaded inputs (and parked
   moments), ``exposed_s <= copy_s``, K1 = sum k (12 + n_remat +
   n_offload), K2 = K3 = sum 12 k, spans on the step, planner, transfer
   and (when solves ran) solver tracks, ``plan`` and ``train_step``
   events.  Then, with deterministic algorithms on: OFFLOAD against
   REMAT on one batch (bert all 12 OFFLOAD, bert 6 + 6, and mamba2 in
   scan mode at 12 layers in 2 chunks), loss and gradients bitwise (else
   at the reference's tolerances) and the device bytes held after the
   forward down by the offloaded inputs; three OFFLOAD_OPT split steps
   against three fused ones, parameters equal; the bert main path with
   every sink on and off (off, on, on, off), losses bitwise equal, each
   warm step's host time and device time (CUDA events around
   ``Trainer.step``) and their medians;
3d. resilience path (full-width ``bert_base_paper``, the main path's
   budget and batches, deterministic algorithms on): R1, 16 steps
   against 8, a snapshot (``train/resilience.py``), every object
   dropped, fresh ones restored from it and batches 8-15: losses and
   final parameters bitwise equal, no collection or refit after the
   restore, one restored plan per bucket of the first 8 steps; then
   ``launch.train`` in a subprocess with a snapshot every 6 of 12 steps
   and the first 2 executions failing (``--inject-oom 2``), and again
   with ``--resume --save`` (resumes at cursor 12; the saved parameters
   load back bitwise equal to the final snapshot's); R2, the fixed plan
   with the
   last unit's moments parked on the host, 4 steps against 2 + a
   snapshot + 2: losses, parameters and moments bitwise equal; R3, a
   real ``torch.OutOfMemoryError``: the most common bucket's plan and
   every rung of its escalation ladder stepped once each for their
   peak reserved bytes, the allocator capped between the plan's peak
   and the lowest rung's, one step of a trainer restored from a
   pre-step snapshot OOMs, escalates and recovers, equal bitwise to the
   escalated plan run directly from the same snapshot, uncapped;
4. the SSD chunk-scan kernels against their plain version through
   ``ops.ssd_scan`` (the reference's SSD cases and its ragged cases on
   the fp32 FMA kernel, the mamba2 main path's buckets on the
   tensor-core kernel, each case's kernel read from the launch counts),
   the tensor-core kernel against the FMA kernel on one bucket's bf16
   inputs (what its hi/lo split keeps, in bf16 ulps), the bitwise
   padded-versus-unpadded check on each kernel and
   ``SSDScan``'s gradient against autograd through the plain version;
5. the DMA copy kernel against the identity, including a byte count
   that is not a multiple of 16 into a destination off 16-byte
   alignment;
6. mamba2 path: trains full-width ``mamba2_1p3b`` in scan mode under the
   Mimose planner with ``--attn-impl flash`` (every layer's chunk scan
   through the tensor-core kernel, none through the FMA kernel), with
   launch counts read around it; one full-width loss through the kernel
   against ``ssd_chunked``; profile and memory of a warm step; the SSD
   kernels' timings (tensor-core and FMA kernel in turns);
7. DMA path: ``ops.residual_dma_copy`` stages a residual stream and the
   logits, with launch counts read around it; the DMA kernel's timings;
8. hymba path: K1-K3 against their plain versions at each of the
   path's bucket shapes with its true lengths (B = 8, 25 / 5 heads, bf16,
   window 1024 and 0); one loss of ``hymba_1p5b`` at full width, 2
   layers, through the kernels against the plain path, and each layer's
   mixer likewise beside two controls that must fail the same check (the
   wrong kv head; the SSD half skipped); K4 at hymba's SSD shape
   (bf16, P = 50, N = 16: the tensor-core kernel) against its plain
   version and, in bf16 ulps, against the FMA kernel (the hi/lo split),
   timed in turns with the FMA kernel beside its bound; then
   full-width, full-depth ``hymba_1p5b`` (32 layers, bf16, scan mode: 8
   units of 7 local layers and 1 global) trains 8 steps under Mimose
   with ``--attn-impl flash``, launch counts read around it: K1 and K4
   (``ssd_scan``, tensor cores) = sum k (32 + recomputed layers), no
   ``ssd_scan_fma`` launch, K2 = K3 = sum 32 k;
9. granite path: K1-K3 at each bucket shape (16 / 8 heads, bf16); one
   loss of ``granite_moe_1b_a400m`` at full width, 2 layers, and each
   layer's attention against the plain path, beside the wrong-kv-head
   control; full-width,
   full-depth granite (24 layers, 32 experts top-8, bf16, scan mode)
   trains 8 steps the same way, with a finite ``aux > 0`` every step;
   then one batch at 6 layers in 2 chunks under KEEP, REMAT and OFFLOAD
   (deterministic algorithms on): loss, aux and gradients of REMAT and
   OFFLOAD equal to KEEP's, bitwise or within ``OFFLOAD_TOL``;
10. ``qwen3_1p7b`` at full width, 2 layers: one loss and each layer's
   attention through the kernels (qk-norm, hd 128) against the plain
   path, beside the wrong-kv-head control;
11. seamless path (the encoder-decoder family; the launcher builds no
   stub inputs, so the run goes through ``Trainer.run`` with a seeded
   normal ``frames`` (B, S, d) function): K1-K3 at each bucket with its
   true lengths (B = 8, 16 / 16 heads x 64, bf16); one loss of
   ``seamless_m4t_large_v2`` at full width, 2 + 2 layers, and each
   decoder layer's self and cross attention against the plain path,
   beside two controls (the wrong kv head; the cross attention fed a
   zero encoder output); full width and depth (24 encoder and 24
   decoder layers, 48 plan units) trains 8 steps under Mimose, launch
   counts read around it: K1 = sum k (24 + recomputed decoder layers),
   K2 = K3 = sum 24 k (the encoder's and the cross attention run
   plain, as in the reference); profile and memory; then one batch at
   4 + 4 layers under KEEP, every unit OFFLOAD, and encoder REMAT with
   decoder OFFLOAD (deterministic algorithms on): loss and every
   gradient, the encoder's included, equal KEEP's bitwise or within
   ``OFFLOAD_TOL``, the lane's bytes the offloaded inputs;
12. qwen2-vl path (the vision-language family, a seeded normal
   ``vision_embeds`` (B, 1024, d) function): K1-K3 at each bucket behind
   the 1024 vision tokens (S = 1024 + bucket, ``kv_len`` = lengths +
   1024; B = 4, 28 / 4 heads x 128, bf16); the 2-layer loss and mixer
   checks beside two controls (the wrong kv head; plain RoPE over
   ``arange(S)`` for M-RoPE); full-width ``qwen2_vl_7b`` at 8 of its 28
   layers in 2 scan chunks of 4 trains 8 steps under Mimose: K1 = sum k
   (8 + recomputed layers), K2 = K3 = sum 8 k; profile and memory;
13. stablelm and gemma3 paths (head dims 80 and 256; ``run_wide_path``):
   K1-K3 at each bucket in the path's bf16 and in fp32 (stablelm 32 x
   80; gemma3 16 / 8 x 256, window 1024 and 0, and a case at S = 2048
   that the window reaches); a bf16 batch at the path's heads with a
   row of length 0; bitwise padded versus unpadded at the path's heads
   and head dim, fp32 and bf16; the 2-layer checks beside the
   wrong-kv-head control; full-width ``stablelm_3b`` (32 layers,
   through the launcher) and ``gemma3_12b`` (12 of 48 layers, through
   ``Trainer.run``) 8 steps each under Mimose with launch counts read
   around them; profile, memory; the three kernels timed at the most
   common bucket beside their bound, plain versions and
   ``scaled_dot_product_attention``, and dq + dk/dv beside the library's
   backward;
14. serve path (no kernel: every launch count is the same after Q3 as
   before Q1, since decode runs the plain paths, as the reference's
   does): Q1, full-width ``qwen3_1p7b``, ``mamba2_1p3b`` and
   ``hymba_1p5b`` at 2 layers, fp32: a squad prompt prefilled in chunks
   of 32 and a remainder, then 16 tokens decoded teacher-forced, every
   position's logits against the no-cache forward within
   ``SERVE_RTOL``, beside the controls that must miss it (the prefill
   one position late; the SSM state dropped between chunks); Q2, on the
   qwen3 and mamba2 models, ``ServeEngine`` over a 12-request squad
   burst against a one-request ``generate`` per request, token for
   token (a request that differs passes only as a tie, and is counted);
   Q3, full-depth bf16 ``qwen3_1p7b`` and ``mamba2_1p3b`` through
   ``repro_torch.launch.serve.main`` on a squad burst under a budget of
   the parameters plus 6 predicted slots of its largest bucket plus
   what the card already held: every request served (each fits alone),
   deferrals, the predicted, tensor-byte and allocator's peaks within
   the budget (the engine charges the workspace it measured on the
   card), the geometries within the
   reference's bound; tokens/s, TTFT, ITL beside the card line; then one
   decode batch at the run's largest pool: its transient bytes within
   the engine's charge, its wall time and, under ``torch.profiler``,
   its device time (busy share) and kernel launches per layer;
15. phase E, the public surface (each part's wall time logged): E1,
   ``examples/torch_dynamic_training_e2e.py`` through its ``main`` at
   full width (``bert_base_paper``, flash, qqp lengths at quantum 64,
   ``--steps 24 --batch-size 4 --budget-gb 2.5``), first K1-K3 held
   against their plain versions at each of its bucket shapes (B 4, S
   64-384) with its lengths: every loss finite, K1 = sum (12 + REMAT
   units), K2 = K3 = 12 a step, no FMA launch, the checkpoint it writes
   loaded back bitwise, the trained model's loss through the kernels
   against the plain path (rtol 1e-4); tokens/s, warm step time by
   bucket, remat units per bucket, collections and cache hits, and one
   warm step profiled as the bert path's; E2, ``torch_quickstart.py``, 30
   swag batches (plain attention: no attention launch; AdamW's kernels
   once a parameter and step); E3,
   ``torch_serve_decode.py`` in engine mode (12 requests served, none
   rejected, the three peaks within its budget) and ``--sequential``
   (no launch); E4, paper Tables 3-4 at full bert width: the port's
   collector at 14 lengths with B 8, each of ``ESTIMATORS`` fitted on
   the first 10, MAPE on the last 4, fit ms and predict us on the host;
   one ``examples: {...}`` line;
16. phase K6, AdamW's kernels (``kernels/adamw.py``): the update and
   its clip norm over stablelm_3b's and mamba2_1p3b's full parameter
   sets (shapes and dtypes from the model on ``meta``, values drawn on
   the card), first against the plain version on the same inputs at
   every parameter (``AdamW.clip_scale_plain`` within ``K6_SCALE_RTOL``,
   then ``AdamW.update_plain`` with the kernel's clip scale at step 5
   from drawn moments: m and v within ``K6_MOMENT_ULPS`` fp32 ulp, the
   parameter within ``K6_PARAM_ULPS`` ulp of its dtype, the worst gaps
   in the row), then device time a step on CUDA events (the launches queued
   behind a sleep kernel, so the host's issue is not timed), in turns
   with the plain version (``AdamW.update_plain``) and
   ``torch.optim.AdamW(fused=True)`` after
   ``clip_grad_norm_(foreach=True)`` (the yardstick, never called by the
   port; on bf16 parameters it keeps bf16 moments, a lower-precision
   function than the kernel's fp32 ones), beside the bound (bytes: each gradient read twice, parameter,
   m and v read and written once, over 3.35 TB/s); the main paths check
   ``adamw`` = parameters x updates and ``adamw_norm`` = updates;

then prints the card line, one ``{"kernels": [...]}`` JSON line (no new
kernel on the sharding, distributed, offload and resilience paths: they
run K1-K3; K1-K3 launches are the bert, sharding, distributed (D2 and
D3, also ``distributed_launches``), resilience, hymba, granite,
seamless, qwen2-vl, stablelm, gemma3 and E1 (also
``examples_launches``) paths', with each bf16 family's and E1's
``<family>_max_abs_err`` beside the maximum and the stablelm and gemma3
instances' launches, ms, plain, bound and library ms as
``<family>_<key>``; K4's are the mamba2 and hymba paths' launches of
the tensor-core kernel, with the hymba path's part as
``hymba_launches`` and its instance's times as ``hymba_<key>``, the FMA
kernel's in turns as ``hymba_fma_ms``; every row's ``serve_launches``,
0; K6's row, ``adamw``, with stablelm_3b's times and mamba2's as
``mamba2_<key>``), and, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without
a CUDA device, and when the repository's ``src/`` is not beside it.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA's data sheet): HBM 3.35 TB/s;
# fp32 outside the tensor cores 67 TFLOP/s; bf16 tensor cores 989
# TFLOP/s.  The flash kernels and the SSD scan run on the bf16 tensor
# cores, so their operation bounds use the bf16 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12

# the main paths: full-width bert_base_paper and mamba2_1p3b, squad
# lengths, batch 8
BERT_ARGS = dict(arch="bert_base_paper", dataset="squad", batch_size=8,
                 steps=16, quantum=32)
MAMBA_ARGS = dict(arch="mamba2_1p3b", dataset="squad", batch_size=8,
                  steps=16, quantum=32)
# the MoE and hybrid paths: full width and depth, 8 steps (the squad
# buckets 416, 416, 384, 448, 448, 448, 480, 448: three collections, a
# predicted plan and cache hits)
HYMBA_ARGS = dict(arch="hymba_1p5b", dataset="squad", batch_size=8,
                  steps=8, quantum=32)
GRANITE_ARGS = dict(arch="granite_moe_1b_a400m", dataset="squad",
                    batch_size=8, steps=8, quantum=32)
# the encoder-decoder and vision-language paths, driven through
# ``Trainer`` (the launcher builds no stub inputs): seamless at full
# width and depth (24 + 24 layers), B = 8; qwen2-vl at full width, 8 of
# its 28 layers in 2 scan chunks of 4 (all 28 hold 85 GiB of fixed
# bytes), B = 4 (buckets 384, 416, 320, 416, 384, 384, 448, 416 behind
# 1024 vision tokens)
SEAMLESS_ARGS = dict(arch="seamless_m4t_large_v2", dataset="squad",
                     batch_size=8, steps=8, quantum=32)
QWEN2VL_ARGS = dict(arch="qwen2_vl_7b", dataset="squad", batch_size=4,
                    steps=8, quantum=32,
                    over=dict(num_layers=8, scan_chunks=2))
# the head-dim 80 and 256 paths: stablelm at full width and depth (32
# layers, 8 scan units), through the launcher; gemma3 at full width, 12
# of its 48 layers (two cycles of 5 local + 1 global layers, 4 plan
# units; all 48 would hold 141 GB of fixed bytes), through
# ``Trainer.run`` (the launcher has no depth flag)
STABLELM_ARGS = dict(arch="stablelm_3b", dataset="squad", batch_size=8,
                     steps=8, quantum=32)
GEMMA3_ARGS = dict(arch="gemma3_12b", dataset="squad", batch_size=8,
                   steps=8, quantum=32, over=dict(num_layers=12))
# profile groups after each family's own kernels: first match wins
OTHER_GROUPS = [("gemm", ("gemm", "cutlass", "xmma", "sm90_", "nvjet")),
                ("adamw kernels", ("adamw",)),
                ("elementwise", ("elementwise",)), ("reductions", ("reduce",))]
# one full-width bf16 loss through the kernels against the plain path at
# 2 layers (check_model_at_depth), and each layer's mixer likewise
# (check_mixers: relative Frobenius error over the valid rows).  Each
# limit sits between the sound runs and the controls (the wrong kv head;
# hymba's SSD half skipped), which must miss it in every run.  On an
# NVIDIA H100 80GB HBM3 at 700 W: loss gaps 2.0e-6 to 1.22e-4 sound,
# 4.0e-4 to 2.2e-3 under the controls; mixer errors 1.3e-3 to 3.5e-3
# sound, 0.26 to 1.42 under the controls
BF16_MODEL_RTOL = 2.5e-4
MIXER_RTOL = 2e-2
# seamless's loss at 2 + 2 layers moves less under its zero-encoder
# control (8.2e-5) than the other paths' controls do, and its sound gap
# is 3.5e-6 (NVIDIA H100 80GB HBM3, 700 W): the limit sits between them
SEAMLESS_LOSS_RTOL = 2e-5
# share of the first batch's collected activation bytes the budget
# leaves on top of the fixed bytes: the rest must be rematerialised
BUDGET_ACT_SHARE = 0.6
# the planners path: the bert main path's first 8 batches, under each
# planner (launcher arguments after --planner)
PLANNER_STEPS = 8
PLANNER_RUNS = [("none", []), ("sublinear", []), ("dtr", []),
                ("mimose", []),
                ("mimose", ["--max-microbatches", "4", "--solver", "dp"])]
# accumulated against full-batch loss and gradients: the tolerances of
# tests/test_microbatch.py (loss rtol, atol; grads rtol, atol)
ACCUM_TOL = {"loss": (1e-5, 1e-6), "grads": (2e-4, 1e-6)}

CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = [
    # name, source, TPU kernel replaced (file:line of its body)
    ("flash_fwd", CSRC + "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:57"),
    ("flash_bwd_dq", CSRC + "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:163"),
    ("flash_bwd_dkv", CSRC + "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:205"),
    ("ssd_scan", CSRC + "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:34"),
    ("dma_copy", CSRC + "offload_dma.cu",
     "src/repro/kernels/offload_dma.py:30"),
]
FLASH_KERNELS = [k[0] for k in KERNELS[:3]]
# the fp32 FMA kernels the tensor-core flash kernels replaced
FMA_OF = {"flash_fwd": "flash_fwd_fma", "flash_bwd_dq": "flash_bwd_dq_fma",
          "flash_bwd_dkv": "flash_bwd_dkv_fma"}

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
    # hymba's attention (25 query heads over 5 kv heads, an odd GQA group;
    # window 1024 on its local layers, which bites at S = 2048), granite's
    # (16 / 8) and the qwen3 / yi head dim 128, all bf16
    (2, 2048, 25, 5, 64, True, 1024, "bfloat16", True),
    (2, 512, 16, 8, 64, True, 0, "bfloat16", True),
    (2, 512, 16, 8, 128, True, 0, "bfloat16", True),
    # head dims 80 (stablelm) and 256 (gemma3), which no reference test
    # takes: GQA, ragged, windowed and non-causal, in fp32 and bf16
    *[(B, S, H, Hkv, hd, causal, window, dtype, ragged)
      for hd in (80, 256) for dtype in ("float32", "bfloat16")
      for B, S, H, Hkv, causal, window, ragged in (
          (2, 160, 4, 2, True, 0, True), (2, 96, 4, 4, True, 32, True),
          (1, 128, 2, 2, False, 0, False), (2, 200, 4, 1, True, 64, True))],
    # an odd GQA group at 256: the wgmma forward's last pair of query
    # heads has one head
    (2, 160, 6, 2, 256, True, 0, "bfloat16", True),
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


def _one_launch(ops, name, fn):
    """``fn()``, which must launch the kernel ``name`` once and nothing
    else."""
    before = dict(ops.LAUNCHES)
    out = fn()
    ran = _launched(ops, before)
    if ran != [name] or ops.LAUNCHES[name] != before[name] + 1:
        raise AssertionError(f"meant to launch {name} once, ran {ran}")
    return out


def check_case(fa, ops, case, lens=None, seed=0):
    """Run K1-K3 (each on the tensor cores and, at the head dims it
    takes, on its FMA kernel) and their plain versions on one case;
    returns the max abs error against the plain version per kernel.
    Raises on a tolerance miss, against the plain version or between a
    tensor-core kernel and its FMA predecessor."""
    B, S, H, Hkv, hd, causal, window, dtype, ragged = case
    kinds = ("", "_fma") if hd in fa.FMA_HEAD_DIMS else ("",)
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

    def held(name, got, want, what, rows=True):
        """Max abs error of ``got`` against ``want`` at ``what``'s TOL."""
        pick = (lambda x: _valid_rows(x, lens)) if rows else (lambda x: x)
        e = _err(pick(got), pick(want), *tol[what])
        if e[1] > 0:
            raise AssertionError(f"{name} disagrees on {case}: {e}")
        return e[0]

    fwd = {name: _one_launch(ops, name, lambda n=name: getattr(fa, n)(
        q, k, v, kvl, causal, window))
        for name in ("flash_fwd" + x for x in kinds)}
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, kvl, causal, window)
    torch.cuda.synchronize()
    for name, (o, lse) in fwd.items():
        e_l = _err(_valid_rows(lse[..., None], lens),
                   _valid_rows(lse_p[..., None], lens), 2e-5, 2e-5)
        if e_l[1] > 0:
            raise AssertionError(f"{name} lse disagrees on {case}: {e_l}")
        errs[name] = max(held(name, o, o_p, "fwd"), e_l[0])
    if len(kinds) == 2:
        held("flash_fwd against flash_fwd_fma", fwd["flash_fwd"][0],
             fwd["flash_fwd_fma"][0], "fwd")
    o, lse = fwd["flash_fwd"]

    delta = (do.float() * o.float()).sum(-1)
    bwd_args = (q, k, v, do, lse, delta, kvl, causal, window)
    dqs = {name: _one_launch(ops, name, lambda n=name: getattr(fa, n)(
        *bwd_args)) for name in ("flash_bwd_dq" + x for x in kinds)}
    dkv = {name: _one_launch(ops, name, lambda n=name: getattr(fa, n)(
        *bwd_args)) for name in ("flash_bwd_dkv" + x for x in kinds)}
    torch.cuda.synchronize()
    dq_p = fa.flash_bwd_dq_plain(*bwd_args)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(*bwd_args)
    torch.cuda.synchronize()
    for name, dq in dqs.items():
        errs[name] = held(name, dq, dq_p, "bwd")
    if len(kinds) == 2:
        held("flash_bwd_dq against flash_bwd_dq_fma", dqs["flash_bwd_dq"],
             dqs["flash_bwd_dq_fma"], "bwd")
    for name, (dk, dv) in dkv.items():
        errs[name] = max(held(name + " dk", dk, dk_p, "bwd", rows=False),
                         held(name + " dv", dv, dv_p, "bwd", rows=False))
        for b, L in enumerate(lens):
            if bool(dk[b, :, L:].any()) or bool(dv[b, :, L:].any()):
                raise AssertionError(f"{name}: dk/dv not exactly 0 past "
                                     f"length {L}: {case}")
    for i, part in enumerate(("dk", "dv") if len(kinds) == 2 else ()):
        held(f"flash_bwd_dkv {part} against flash_bwd_dkv_fma",
             dkv["flash_bwd_dkv"][i], dkv["flash_bwd_dkv_fma"][i], "bwd",
             rows=False)
    # a row of length 0 (the pad row of a non-divisor split): every
    # kernel writes exactly 0 to its o, dq, dk and dv, and a finite lse
    for b in (b for b, L in enumerate(lens) if L == 0):
        outs = ([t[0][b] for t in fwd.values()]
                + [t[b] for t in dqs.values()]
                + [t[b] for ts in dkv.values() for t in ts])
        if any(bool(t.any()) for t in outs) or not all(
                bool(torch.isfinite(t[1][b]).all()) for t in fwd.values()):
            raise AssertionError(f"a kernel wrote a nonzero or non-finite "
                                 f"value in row {b}, of length 0: {case}")
    # the public wrapper (backward through the same kernels) agrees too
    dq2, dk2, dv2 = fa.flash_bwd(q, k, v, o, lse, do, kvl, causal, window)
    torch.cuda.synchronize()
    dq, (dk, dv) = dqs["flash_bwd_dq"], dkv["flash_bwd_dkv"]
    if not (torch.equal(dq2, dq) and torch.equal(dk2, dk)
            and torch.equal(dv2, dv)):
        raise AssertionError(f"flash_bwd wrapper differs from the direct "
                             f"launches on {case}")
    return errs


def check_flash_bitwise(fa, B, S, H, hd, L, seed=2, dtype="float32",
                        Hkv=None):
    """Padded with ``kv_len = L`` against the unpadded call at length L,
    on the valid rows, bit for bit, for the forward (o, lse), dq and
    dk/dv kernels (tests/test_ragged.py::
    test_flash_ragged_bitwise_matches_unpadded_kernel, there for the
    forward): masking changes nothing but trip counts.  k and v have
    ``Hkv`` heads (default ``H``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, heads, S, hd), generator=gen,
                               device="cuda").to(getattr(torch, dtype))
                   for heads in (H, Hkv or H, Hkv or H, H))
    kvl = torch.full((B,), L, dtype=torch.int32, device="cuda")
    out = {}
    for name, ins, lens in (("padded", (q, k, v, do), kvl),
                            ("exact", [t[:, :, :L].contiguous()
                                       for t in (q, k, v, do)], None)):
        q_, k_, v_, do_ = ins
        o, lse = fa.flash_fwd(q_, k_, v_, lens, True, 0)
        delta = (do_.float() * o.float()).sum(-1)
        args = (q_, k_, v_, do_, lse, delta, lens, True, 0)
        out[name] = (o, lse, fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for part, a, b in zip(("o", "lse", "dq", "dk", "dv"), out["padded"],
                          out["exact"]):
        if not torch.equal(a[:, :, :L], b):
            raise AssertionError(f"flash {part}: padded with kv_len={L} "
                                 f"differs bitwise from the unpadded call "
                                 f"(B={B} S={S} H={H} Hkv={Hkv or H} "
                                 f"hd={hd})")
    log(f"flash bitwise check (B={B} S={S} H={H} Hkv={Hkv or H} hd={hd} "
        f"{dtype} causal, "
        f"L={L}): padded with kv_len == unpadded for o, lse, dq, dk, dv, "
        f"bit for bit")


def check_kernels(fa, ops, cases, lens_of=None):
    """Every case in ``cases``; returns max abs error per kernel over the
    cases flagged as main-path cases in ``lens_of``."""
    main_errs = {name: 0.0 for name in FLASH_KERNELS + list(FMA_OF.values())}
    for case in cases:
        lens = (lens_of or {}).get(case)
        errs = check_case(fa, ops, case, lens)
        log(f"kernel check {case}: "
            + " ".join(f"{n}={e:.3e}" for n, e in errs.items()))
        if lens is not None:
            for n, e in errs.items():
                main_errs[n] = max(main_errs[n], e)
    return main_errs


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def path_config(args, **over):
    """The path's configuration: the registered one with the path's cuts
    (``args["over"]``) and ``over``."""
    import dataclasses
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config(args["arch"]),
                               **{**args.get("over", {}), **over})


def stub_inputs(cfg, seed=0):
    """The stub frontends' batch entries as ``make_batches`` ``extra``
    functions ``fn(B, S)``, from one seeded normal generator: an
    encoder-decoder's ``frames`` (B, S, d), one frame per bucket token
    (the reference's ``launch/steps.py``), and a vision-language model's
    ``vision_embeds`` (B, vt, d); {} for the other families."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    if cfg.family == "encdec":
        return {"frames": lambda B, S: rng.standard_normal(
            (B, S, d), dtype=np.float32)}
    if cfg.family == "vlm":
        return {"vision_embeds": lambda B, S: rng.standard_normal(
            (B, cfg.vision_tokens, d), dtype=np.float32)}
    return {}


def main_path_batches(args):
    from repro_torch.data.pipeline import make_batches
    cfg = path_config(args)
    return list(make_batches(args["dataset"], batch_size=args["batch_size"],
                             vocab_size=cfg.vocab_size,
                             num_batches=args["steps"],
                             quantum=args["quantum"], seed=0,
                             extra=stub_inputs(cfg)))


def lengths_by_bucket(batches):
    """{S: the first batch's true lengths at that bucket length}."""
    out = {}
    for b in batches:
        out.setdefault(b["tokens"].shape[1], [int(x) for x in b["lengths"]])
    return out


def flash_main_cases(args, batches):
    """{case: the bucket's true lengths} for K1-K3 at each bucket of a
    family's main-path ``batches``, at its attention's shape, once for
    each window its layers run (0 on a global layer).  A vision-language
    model's sequence is its vision prefix and the bucket, its lengths
    the text's plus the prefix."""
    cfg = path_config(args)
    W = cfg.sliding_window
    windows = sorted(({W} if W else set())
                     | ({0} if not W or cfg.global_interval else set()))
    vt = cfg.vision_tokens if cfg.family == "vlm" else 0
    return {(args["batch_size"], vt + S, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim(), True, w, cfg.dtype, True):
            [vt + n for n in lens]
            for S, lens in sorted(lengths_by_bucket(batches).items())
            for w in windows}


def most_common_bucket(batches):
    counts = {}
    for b in batches:
        counts[b["tokens"].shape[1]] = counts.get(b["tokens"].shape[1], 0) + 1
    S = max(counts, key=lambda s: (counts[s], s))
    return S, next(b for b in batches if b["tokens"].shape[1] == S)


def derive_budget_mb(args, first_batch) -> float:
    """fixed bytes + BUDGET_ACT_SHARE x the first batch's collected
    activation bytes.  The model is built on ``meta``: the collector and
    the fixed bytes need shapes only."""
    from repro_torch.core.collector import (ShuttlingCollector,
                                           unit_residual_bytes)
    from repro_torch.core.planner import fixed_train_bytes
    from repro_torch.models.lm import LM
    lm = LM(path_config(args), attn_impl="flash", device="meta")
    fixed = fixed_train_bytes(lm.parameters())
    n_params = sum(p.numel() for p in lm.parameters())
    B, S = first_batch["tokens"].shape
    tokens = {"tokens": torch.zeros((B, S), dtype=torch.long)}
    tokens.update({k: torch.empty(np.shape(first_batch[k]), device="meta")
                   for k in ("frames", "vision_embeds") if k in first_batch})
    act = ShuttlingCollector(lm).collect(tokens).total_activation_bytes()
    budget = fixed + BUDGET_ACT_SHARE * act
    units = lm.num_plan_units()
    log(f"budget {args['arch']}: fixed {fixed / 2**20:.1f} MiB ("
        f"{n_params / 1e6:.1f} M params, {fixed / n_params:.0f} B/param: "
        f"params and grads in their dtypes, fp32 m and v) + "
        f"{BUDGET_ACT_SHARE} x {act / 2**20:.1f} MiB activations of the "
        f"first batch (B={B}, S={S}, {units} units) = "
        f"{budget / 2**20:.1f} MiB")
    # what the planner's model leaves out (the measured peak's excess)
    units = lm.plan_units(tokens)
    # the first unit, and an encoder-decoder's first decoder unit
    for unit in {units[0].name: units[0],
                 units[lm.cfg.encoder_layers].name:
                 units[lm.cfg.encoder_layers]}.values():
        shape = lm.unit_input_shape(unit, tokens)
        x_only = unit_residual_bytes(unit, shape,
                                     lm.dtype)["activation_bytes"]
        train = unit_residual_bytes(unit, shape, lm.dtype,
                                    weight_grads=True)["activation_bytes"]
        log(f"residuals per unit ({unit.name}) at {shape}: "
            f"{x_only / 2**20:.2f} MiB counted (input gradient only, as the "
            f"reference) vs {train / 2**20:.2f} MiB held in training "
            f"(weight gradients too)")
    S_out = lm.unit_input_shape(units[-1], tokens)[1]
    log(f"fp32 logits {B * S_out * lm.cfg.vocab_size * 4 / 2**20:.2f} MiB "
        f"per copy, outside every unit")
    return budget / 2**20


def _device_batch(batch, quantum):
    from repro_torch.data.pipeline import pad_batch
    b = pad_batch(batch, quantum)
    out = {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    out["labels"] = out["labels"].long()
    return out


def check_model(lm, batch, quantum, rtol):
    """One full-width loss through the hand-written kernels against the
    plain path (``attn_impl="xla"``) on the same weights and batch."""
    b = _device_batch(batch, quantum)
    impl = lm.attn_impl
    with torch.no_grad():
        lm.attn_impl = "flash"
        kernel, _ = lm.loss(b)
        lm.attn_impl = "xla"
        plain, _ = lm.loss(b)
    lm.attn_impl = impl
    torch.cuda.synchronize()
    kernel, plain = float(kernel), float(plain)
    log(f"model check {lm.cfg.name}: loss kernels {kernel:.6f} plain "
        f"{plain:.6f} (rtol {rtol})")
    if not (math.isfinite(kernel)
            and abs(kernel - plain) <= rtol * abs(plain)):
        raise AssertionError(f"{lm.cfg.name}: full-width loss through the "
                             f"kernels and the plain path disagree")
    return kernel, plain


def run_main_path(args, budget_mb, extra=()):
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    argv = ["--arch", args["arch"], "--dataset", args["dataset"],
            "--planner", "mimose", "--attn-impl", "flash",
            "--budget-mb", f"{budget_mb:.3f}",
            "--steps", str(args["steps"]),
            "--batch-size", str(args["batch_size"]),
            "--quantum", str(args["quantum"]), "--device", "cuda"] + list(
                extra)
    log("main path: python -m repro_torch.launch.train " + " ".join(argv))
    ops.reset_launches()
    trainer = launch_train.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_main_path(trainer, launches)
    return trainer, launches


def check_main_path(trainer, launches):
    """What a main path's run must show; raises otherwise."""
    h = trainer.history
    lm = trainer.lm
    L = lm.cfg.num_layers                 # the decoder's layers
    n_units = lm.num_plan_units()
    losses = [s.loss for s in h]
    # every decoder layer runs its mixers' kernels once in each
    # microbatch's forward, and each layer of a REMAT unit once more in
    # the backward's recompute; the backward kernels run once per layer.
    # An encoder's layers (and a decoder's cross attention) run plain
    fwd = sum(s.microbatches * (L + s.recompute_dec_layers) for s in h)
    bwd = sum(s.microbatches * L for s in h)
    log(f"main path launches: {launches}")
    checks = {
        "losses finite": all(math.isfinite(x) for x in losses),
        "sheltered collections": any(s.collected for s in h),
        "estimator ready": trainer.planner.estimator.ready,
        "predicted plan": any(not s.collected and not s.cache_hit
                              for s in h),
        "plan-cache hit": any(s.cache_hit for s in h),
        "mixed KEEP/REMAT plan": any(0 < s.remat_units < n_units for s in h),
    }
    flash = {
        "every flash kernel launched": all(launches[k] > 0
                                           for k in FLASH_KERNELS),
        f"K1 (tensor cores) = sum k ({L} + recomputed decoder layers)":
            launches["flash_fwd"] == fwd,
        f"K2 = K3 (tensor cores) = sum {L} k": launches["flash_bwd_dq"]
        == launches["flash_bwd_dkv"] == bwd,
        "no FMA flash launches": all(launches[k] == 0
                                     for k in FMA_OF.values()),
    }
    if lm.kind == "ssm":
        checks.update({
            f"ssd_scan (tensor cores) = sum k ({L} + recomputed layers)":
                launches["ssd_scan"] == fwd,
            "no FMA ssd, flash or dma launches": all(
                launches[k] == 0
                for k in FLASH_KERNELS + list(FMA_OF.values())
                + ["ssd_scan_fma", "dma_copy"]),
        })
    elif lm.kind == "hybrid":
        checks.update(flash)
        checks.update({
            f"ssd_scan (tensor cores, P = {lm.cfg.ssm_head_dim}) = sum k "
            f"({L} + recomputed layers)": launches["ssd_scan"] == fwd,
            "no FMA ssd or dma launches": all(
                launches[k] == 0 for k in ("ssd_scan_fma", "dma_copy")),
        })
    else:
        checks.update(flash)
        checks["no ssd or dma launches"] = all(
            launches[k] == 0 for k in ("ssd_scan", "ssd_scan_fma",
                                       "dma_copy"))
    checks["AdamW: adamw = parameters x updates, adamw_norm = updates"] = (
        launches["adamw"] == len(trainer.params) * len(h)
        and launches["adamw_norm"] == len(h))
    if lm.kind == "moe":
        checks["aux finite and > 0 every step"] = all(
            math.isfinite(s.aux) and s.aux > 0 for s in h)
    log("main path checks: " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"main path checks failed: {checks}")
    summ = trainer.summary()
    log(f"main path {lm.cfg.name}: per step loss / ce / aux "
        + ", ".join(f"{s.loss:.4f} / {s.ce:.4f} / {s.aux:.5f}" for s in h)
        + f"; recomputed layers {[s.recompute_layers for s in h]}, of "
        f"them in the decoder {[s.recompute_dec_layers for s in h]}")
    log(f"main path: tokens/s (text tokens, loss weights) over warm steps "
        f"{summ['tokens_per_s']:.1f} "
        f"(padded {summ['padded_tokens_per_s']:.1f}), mean warm step "
        f"{summ['mean_step_s'] * 1e3:.2f} ms, plan time "
        f"{summ['total_plan_s'] * 1e3:.2f} ms total, first step "
        f"{h[0].step_time_s * 1e3:.1f} ms")
    by_bucket = {}
    for st in h:
        by_bucket.setdefault(st.bucket, []).append(st)
    for bucket, sts in sorted(by_bucket.items()):
        log(f"  bucket {bucket}: {len(sts)} steps, n_remat "
            f"{sorted({s.remat_units for s in sts})}, measured peak "
            f"{max(s.max_memory_bytes for s in sts) / 2**20:.1f} MiB vs "
            f"predicted {max(s.predicted_peak_bytes for s in sts) / 2**20:.1f}"
            f" MiB")


def profile_step(trainer, batch, groups):
    """Where one warm training step's time goes: its host wall time
    (synchronised, profiler off), then the same step under
    ``torch.profiler`` for device time by kernel.  The device's busy
    share is device kernel time over the unprofiled wall time.
    ``groups``: (group name, substrings of kernel names), first match
    wins; the rest is "other"."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.calibrate import device_rows
    opt_state = trainer.optimizer.init(trainer.params)
    for _ in range(2):                      # warm, then the timed step
        opt_state, _ = trainer.step(opt_state, batch)
    st = trainer.history[-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt_state, _ = trainer.step(opt_state, batch)
    # the same step's phases on CUDA events, profiler off
    lm, params = trainer.lm, trainer.params
    tb = trainer._prepare(batch)
    actions, _ = trainer.planner.plan(tb)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = lm.loss(tb, actions)
    ev[1].record()
    loss.backward()
    ev[2].record()
    trainer.optimizer.update({n: p.grad for n, p in params.items()},
                             opt_state, params)
    ev[3].record()
    torch.cuda.synchronize()
    for p in params.values():
        p.grad = None
    del opt_state, loss
    phases = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
              enumerate(("forward", "backward", "optimizer"))}
    log(f"phases {trainer.lm.cfg.name} (CUDA events, profiler off, ms): "
        + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    rows = device_rows(prof)
    dev_ms = sum(r[0] for r in rows)
    wall_ms = st.step_time_s * 1e3
    if not dev_ms:
        log("profile: the profiler reported no device time; busy share "
            "not measured")
        return
    log(f"profile {trainer.lm.cfg.name}: one warm step (forward, backward, "
        f"AdamW), S={batch['tokens'].shape[1]}, n_remat={st.remat_units}: "
        f"wall {wall_ms:.2f} ms (profiler off), device kernels "
        f"{dev_ms:.2f} ms (profiler on), busy share {dev_ms / wall_ms:.3f}")
    sums = {g: 0.0 for g, _ in groups}
    sums["other"] = 0.0
    for ms, n, name in rows:
        low = name.lower()
        g = next((g for g, keys in groups if any(k in low for k in keys)),
                 "other")
        sums[g] += ms
    log("profile groups (ms): " + json.dumps(
        {k: round(v, 3) for k, v in sums.items()}))
    # the twelve longest, then every other kernel of the first group
    mixer = [r for r in rows[12:] if any(k in r[2].lower()
                                          for k in groups[0][1])]
    for ms, n, name in rows[:12] + mixer:
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
    log(f"memory {lm.cfg.name}: S={tb['tokens'].shape[1]} n_remat="
        f"{plan.n_remat}: resident before the step {base / mib:.1f} MiB; "
        f"held after the forward {held / mib:.1f} MiB (planner: "
        f"{(plan.est_activation_bytes - plan.covered_bytes) / mib:.1f} MiB "
        f"of unit residuals kept); forward peak {fwd_peak / mib:.1f} MiB; "
        f"backward peak {bwd_peak / mib:.1f} MiB above resident, of which "
        f"grads {grads / mib:.1f} MiB")


# ---------------------------------------------------------------------------
# the planners path: the planner's decision space on the bert main path
# ---------------------------------------------------------------------------

def run_planner(args, budget_mb, planner, extra):
    """One 8-step run of ``launch.train.main`` under ``planner``, launch
    counts read around it; checks what every planner run must show."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    argv = ["--arch", args["arch"], "--dataset", args["dataset"],
            "--planner", planner, "--attn-impl", "flash",
            "--budget-mb", f"{budget_mb:.3f}",
            "--steps", str(PLANNER_STEPS),
            "--batch-size", str(args["batch_size"]),
            "--quantum", str(args["quantum"]), "--device", "cuda"] + extra
    label = " ".join([planner] + extra)
    log(f"planners path [{label}]: python -m repro_torch.launch.train "
        + " ".join(argv))
    ops.reset_launches()
    trainer = launch_train.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    h = trainer.history
    lm = trainer.lm
    layers = [e - s for s, e in lm.unit_bounds()]
    k1 = sum(s.microbatches * (lm.cfg.num_layers + s.remat_units * layers[0])
             for s in h)
    k23 = sum(s.microbatches * lm.cfg.num_layers for s in h)
    checks = {
        "losses finite": all(math.isfinite(s.loss) for s in h),
        "equal units": len(set(layers)) == 1,
        "K1 = sum k (12 + n_remat)": launches["flash_fwd"] == k1,
        "K2 = K3 = sum 12 k": launches["flash_bwd_dq"]
        == launches["flash_bwd_dkv"] == k23,
        "no FMA flash, ssd or dma launches": all(
            launches[k] == 0 for k in list(FMA_OF.values())
            + ["ssd_scan", "ssd_scan_fma", "dma_copy"]),
    }
    summ = trainer.summary()
    pstats = getattr(trainer.planner, "stats", {})
    log(f"planners path [{label}]: launches {launches}; checks "
        + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"planners path [{label}] checks failed: "
                             f"{checks}")
    log(f"planners path [{label}]: tokens/s over warm steps "
        f"{summ['tokens_per_s']:.1f}, mean warm step "
        f"{summ['mean_step_s'] * 1e3:.2f} ms, plan time "
        f"{summ['total_plan_s'] * 1e3:.2f} ms wall"
        + (f" ({pstats['plan_time_s'] * 1e3:.2f} ms with DTR's modelled "
           f"evict search, {pstats['plan_ops']} ops)"
           if "plan_ops" in pstats else "")
        + f", mean k {summ['mean_microbatches']:.3f}, losses "
        f"{[round(s.loss, 4) for s in h]}")
    rows = {}
    for st in h:
        rows.setdefault(st.bucket, []).append(st)
    per_bucket = {}
    for bucket, sts in sorted(rows.items()):
        per_bucket[bucket] = {
            "steps": len(sts),
            "n_remat": sorted({s.remat_units for s in sts}),
            "k": sorted({s.microbatches for s in sts}),
            "measured_peak_mib": max(s.max_memory_bytes for s in sts) / 2**20,
            "predicted_peak_mib": max(s.predicted_peak_bytes
                                      for s in sts) / 2**20}
        log(f"  bucket {bucket}: {len(sts)} steps, n_remat "
            f"{per_bucket[bucket]['n_remat']}, k {per_bucket[bucket]['k']}, "
            f"measured peak {per_bucket[bucket]['measured_peak_mib']:.1f} MiB "
            f"vs predicted {per_bucket[bucket]['predicted_peak_mib']:.1f} "
            f"MiB, budget {budget_mb:.1f} MiB")
    return trainer, {"planner": label, "budget_mb": budget_mb,
                     "tokens_per_s": summ["tokens_per_s"],
                     "mean_step_ms": summ["mean_step_s"] * 1e3,
                     "plan_ms": summ["total_plan_s"] * 1e3,
                     "mean_k": summ["mean_microbatches"],
                     "launches": {k: launches[k] for k in FLASH_KERNELS},
                     "buckets": per_bucket}


def tight_budget_mb(args, batches) -> float:
    """A budget below the simulator's k = 1 remat-all peak of the
    largest bucket and above its k = 2 one (their midpoint), so no k = 1
    plan fits there; from collections on a ``meta`` model."""
    from repro_torch.actions import Action
    from repro_torch.core.collector import ShuttlingCollector
    from repro_torch.core.planner import fixed_train_bytes
    from repro_torch.core.simulator import simulate
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    lm = LM(get_config(args["arch"]), attn_impl="flash", device="meta")
    fixed = fixed_train_bytes(lm.parameters())
    B = args["batch_size"]
    S = max(b["tokens"].shape[1] for b in batches)
    col = ShuttlingCollector(lm)
    peaks = {}
    for k in (1, 2):
        act = col.collect({"tokens": torch.zeros((-(-B // k), S),
                                                 dtype=torch.long)})
        act = act.activation_vector()
        peaks[k] = simulate(act, [Action.REMAT] * len(act), fixed).peak_bytes
    budget = 0.5 * (peaks[1] + peaks[2])
    log(f"tight budget: largest bucket S={S}, simulated remat-all peak "
        f"k=1 {peaks[1] / 2**20:.1f} MiB, k=2 {peaks[2] / 2**20:.1f} MiB; "
        f"budget {budget / 2**20:.1f} MiB")
    return budget / 2**20


def _grad_err(got, want, rtol, atol):
    """(max |got - want|, worst |got - want| - rtol |want| - atol)."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("accumulated or full-batch value not finite")
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d - rtol * want.double().abs()).max()
                                 - atol)


def check_microbatch_equivalence(lm, batch, quantum):
    """The k = 2 and k = 3 accumulated loss and gradients against the
    full-batch step's, on one batch with the same parameters, at
    ACCUM_TOL; k = 3 on B = 8 adds a pad row of length 0."""
    from repro_torch.train.accumulate import accumulated_grads, split_batch
    b = _device_batch(batch, quantum)
    params = dict(lm.named_parameters())
    loss, _ = lm.loss(b)
    full = torch.autograd.grad(loss, list(params.values()))
    want_loss = loss.detach()
    want = dict(zip(params, full))
    del loss, full
    out = {}
    for k in (2, 3):
        lens = split_batch(b, k)["lengths"].reshape(-1).tolist()
        got_loss, _, got = accumulated_grads(lm, b, k)
        e_loss = _grad_err(got_loss, want_loss, *ACCUM_TOL["loss"])
        worst = max((_grad_err(got[n], want[n], *ACCUM_TOL["grads"]) + (n,)
                     for n in params), key=lambda e: e[1])
        log(f"accumulation k={k} (row lengths {lens}): loss "
            f"{float(got_loss):.7f} vs full batch {float(want_loss):.7f} "
            f"(abs err {e_loss[0]:.3e}); grads max abs err "
            f"{max(_grad_err(got[n], want[n], *ACCUM_TOL['grads'])[0] for n in params):.3e}, "
            f"tightest against the tolerance {worst[1]:.3e} at {worst[2]}")
        if e_loss[1] > 0 or worst[1] > 0:
            raise AssertionError(f"k={k} accumulation disagrees with the "
                                 f"full-batch step beyond {ACCUM_TOL}")
        out[k] = {"loss_abs_err": e_loss[0]}
    return out


def check_empty_row(fa, ops, S, H=12, Hkv=12, hd=64, dtype="float32"):
    """K1-K3 (each on the tensor cores and, at the FMA kernels' head
    dims, on its FMA kernel) on a batch with a row of length 0, the pad
    row of a non-divisor split: ``check_case`` holds every kernel against
    its plain version on the valid rows and requires that row's o, dq,
    dk and dv to be exactly 0 and its lse finite."""
    lens = [S, S // 2, 0]
    errs = check_case(fa, ops, (3, S, H, Hkv, hd, True, 0, dtype, True),
                      lens)
    log(f"empty-row check (B=3 S={S} H={H} Hkv={Hkv} hd={hd} {dtype}, "
        f"lens {lens}): the "
        f"row of length 0 has o, dq, dk, dv exactly 0 and a finite lse in "
        f"every kernel; max abs error against the plain versions "
        + " ".join(f"{n}={e:.3e}" for n, e in errs.items()))


def calibrate_on(trainer, batch, S, fa, ops, quantum):
    """On the plain Mimose run's model: the k = 2 and k = 3 accumulation
    checks, K1-K3 on a length-0 row, and the three planning constants
    with the card line and a k = 1 vs k = 2 step profile."""
    from repro_torch.launch import calibrate
    accum = check_microbatch_equivalence(trainer.lm, batch, quantum)
    check_empty_row(fa, ops, S)
    card = card_line()
    mb = calibrate.microbatch_overhead(trainer, batch)
    constants = {"PEAK_FLOPS": calibrate.peak_flops(),
                 "PEAK_FLOPS_BF16": calibrate.peak_flops(
                     *calibrate.BF16_SHAPE, dtype=torch.bfloat16),
                 "PCIE_BW": calibrate.pcie_bandwidth(),
                 "MICROBATCH_OVERHEAD_S": mb["overhead_s"]}
    log(f"planning constants on {card}: PEAK_FLOPS "
        f"{constants['PEAK_FLOPS']:.4e} FLOP/s (fp32 mm 3328x768x3072, TF32 "
        f"off), PEAK_FLOPS_BF16 {constants['PEAK_FLOPS_BF16']:.4e} FLOP/s "
        f"(bf16 mm {'x'.join(map(str, calibrate.BF16_SHAPE))}), PCIE_BW "
        f"{constants['PCIE_BW']:.4e} B/s (pinned 256 MiB "
        f"round trip, per direction), MICROBATCH_OVERHEAD_S "
        f"{constants['MICROBATCH_OVERHEAD_S']:.4e} s (bert S={S} warm "
        f"step k=2 minus k=1, difference of the medians; k=1 steps "
        f"{[round(t * 1e3, 2) for t in mb['k1_s']]} ms, k=2 steps "
        f"{[round(t * 1e3, 2) for t in mb['k2_s']]} ms)")
    log(f"split profile (S={S}, n_remat={mb['n_remat']}, one profiled "
        f"step per k): " + json.dumps(
            {f"k={k}": {n: round(v, 3) for n, v in o.items()}
             for k, o in mb["profiled"].items()}))
    return {"card": card, "accumulation": accum, "constants": constants,
            "split_profile": mb["profiled"]}


def run_planners_path(args, budget_mb, fa, ops):
    """Every planner on the bert main path, the tight-budget Mimose run,
    and on the plain Mimose run's model the accumulation checks and the
    planning constants.  Each run's model is freed before the next run
    starts, so its measured peaks count no other model."""
    batches = main_path_batches(dict(args, steps=PLANNER_STEPS))
    S_main, main_batch = most_common_bucket(batches)
    results, calib = [], None
    runs = PLANNER_RUNS + [("tight", ["--max-microbatches", "4"])]
    for planner, extra in runs:
        if planner == "tight":
            trainer, res = run_planner(args, tight_budget_mb(args, batches),
                                       "mimose", extra)
            if not any(s.microbatches >= 2 for s in trainer.history):
                raise AssertionError("tight budget: no step ran with k >= 2")
        else:
            trainer, res = run_planner(args, budget_mb, planner, extra)
        results.append(res)
        bs = getattr(trainer.planner, "background_solver", None)
        if bs is not None:
            drained = bs.drain(timeout=60.0)
            bs.close()
            st = trainer.planner.stats
            log(f"solver: drained {drained}, solves {st['solves']}, "
                f"wins {st['solver_wins']}, swaps {st['solver_swaps']}, "
                f"timeouts {st['solver_timeouts']}, errors {bs.errors}; by "
                f"bucket {json.dumps(st.get('solver_delta_by_bucket', {}))}")
            res["solver"] = {k: st[k] for k in ("solves", "solver_wins",
                                                "solver_swaps",
                                                "solver_timeouts")}
            if not (drained and st["solves"] > 0 and bs.errors == 0):
                raise AssertionError("background solver: no solve landed")
            del bs
        if planner == "mimose" and not extra:
            calib = calibrate_on(trainer, main_batch, S_main, fa, ops,
                                 args["quantum"])
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    log("planners: " + json.dumps({"card": calib["card"], "runs": results,
                                   **{k: v for k, v in calib.items()
                                      if k != "card"}}))


# ---------------------------------------------------------------------------
# the sharding path: per-device planning on a mesh (bert, gemma3 on meta)
# ---------------------------------------------------------------------------

# the reshape resume's mesh, and gemma3's planning case: bucket 448 at
# B = 8 under 80 GiB a device, with each mesh's fixed bytes per device
# (GB) from the config: 11.77 G parameters x (2 + 2 + 8) bytes on one
# device; every projection and the tied embedding over model 2; the
# moments over data 4 more with ZeRO-1
SHARD_MESH = "4x2"
GEMMA3_PLAN = dict(B=8, S=448, hbm_gib=80)
GEMMA3_FIXED_GB = [((1,), False, 141.2), ((4, 2), False, 70.6),
                   ((4, 2), True, 35.3)]


class _Tee:
    """A stdout that also keeps what it is given."""

    def __init__(self, out):
        self.out, self.kept = out, []

    def write(self, text):
        self.kept.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _cached_plans(planner):
    """``[(plan key, plan)]`` of the planner's cache."""
    return [(k, planner.cache[k]) for k in list(planner.cache.keys())]


def _step_actions(trainer):
    """Each step's action tuple: its bucket's cached plan (no solver and
    no escalation on these runs, so a bucket keeps one plan)."""
    plans = {k[0]: p for k, p in _cached_plans(trainer.planner)}
    return [tuple(int(a) for a in plans[s.bucket].as_actions())
            for s in trainer.history]


def run_sharding_path(args, budget_mb, main_run):
    """(a) the main path under a built one-device mesh (``--mesh-shape
    1x1 --hbm-gb 80``, the main budget), with snapshots at step 8 and at
    the end: every step's actions and loss bitwise the main path's
    (``main_run``), launches by the main path's formula, plan keys
    carrying ((data, 1), (model, 1)); (b) a resume from its step-8
    snapshot under ``--mesh-shape 4x2 --zero1 --hbm-gb`` the main budget
    in GiB, planned per device and executed on this card; (c)
    full-depth gemma3_12b on ``meta`` planned per device.  Returns the
    flash launches of (a) and (b) (``launches``), (a)'s step-8 snapshot
    parameters on the host (``params_half``, the main path's: its losses
    are) and (b)'s per-bucket plans with their per-device peaks
    (``buckets``), which the distributed phases read."""
    import ast
    import contextlib
    import os
    import tempfile
    from repro_torch.core.simulator import simulate_sharded
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    timing, res = {}, {}
    half = args["steps"] // 2
    with tempfile.TemporaryDirectory() as tmp:
        ck, ck_half = os.path.join(tmp, "ck"), os.path.join(tmp, "half")
        # (a) a built (1, 1) mesh
        t0 = time.perf_counter()
        trainer, la = run_main_path(args, budget_mb, [
            "--mesh-shape", "1x1", "--hbm-gb", "80",
            "--checkpoint-dir", ck, "--checkpoint-every-steps", str(half)])
        sig = trainer.planner.mesh_sig()
        acts = _step_actions(trainer)
        losses = [s.loss for s in trainer.history]
        checks = {
            "a mesh (data 1, model 1) built": trainer.mesh is not None
            and tuple(trainer.mesh.mesh_dim_names) == ("data", "model"),
            "plan keys carry ((data, 1), (model, 1))":
                sig[0] == (("data", 1), ("model", 1))
                and all(k[1] == sig for k in trainer.planner.cache.keys()),
            "every step's actions equal the main path's":
                acts == main_run["actions"],
            "losses bitwise equal the main path's":
                losses == main_run["losses"],
        }
        plans_1x1 = {k[0]: p.n_remat
                     for k, p in _cached_plans(trainer.planner)}
        params_half = torch.load(
            os.path.join(ck, f"snap-{half:08d}", "params.ckpt"),
            map_location="cpu", weights_only=True)["leaves"]
        timing["a"] = time.perf_counter() - t0
        log(f"sharding (a) 1x1 mesh: {len(losses)} steps, launches "
            f"{ {k: la[k] for k in FLASH_KERNELS} }, n_remat per bucket "
            f"{plans_1x1}; checks " + json.dumps(checks))
        if not all(checks.values()):
            raise AssertionError(f"sharding (a) checks failed: {checks}")
        del trainer
        _free()
        # (b) resume from the step-8 snapshot under another mesh shape
        t0 = time.perf_counter()
        snap = f"snap-{half:08d}"
        os.makedirs(ck_half)
        os.replace(os.path.join(ck, snap), os.path.join(ck_half, snap))
        with open(os.path.join(ck_half, snap, "planner.json")) as f:
            stored = json.load(f)
        argv = ["--arch", args["arch"], "--dataset", args["dataset"],
                "--planner", "mimose", "--attn-impl", "flash",
                "--steps", str(args["steps"]),
                "--batch-size", str(args["batch_size"]),
                "--quantum", str(args["quantum"]), "--device", "cuda",
                "--mesh-shape", SHARD_MESH, "--zero1",
                "--hbm-gb", f"{budget_mb / 1024:.6f}",
                "--checkpoint-dir", ck_half, "--resume"]
        log("sharding (b): python -m repro_torch.launch.train "
            + " ".join(argv))
        ops.reset_launches()
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            trainer = launch_train.main(argv)
        torch.cuda.synchronize()
        lb = _flash_launches([trainer.history], dict(ops.LAUNCHES),
                             "sharding (b)")
        line = next(ln for ln in "".join(tee.kept).splitlines()
                    if ln.startswith("resumed"))
        summary = ast.literal_eval(line[line.index("planner=")
                                        + len("planner="):-1])
        planner = trainer.planner
        fixed = planner.resolve_fixed_bytes()
        per_bucket = {}
        for key, plan in _cached_plans(planner):
            b = key[0]
            est = planner.estimator.predict(b)
            sim = simulate_sharded(est, plan.as_actions(), fixed,
                                   planner.mesh_budget.n_devices,
                                   planner.est_output.predict(b))
            steps = [s for s in trainer.history if s.bucket == b]
            per_bucket[b] = {
                "actions": [int(a) for a in plan.as_actions()],
                "n_remat": plan.n_remat, "n_remat_1x1": plans_1x1.get(b),
                "sim_peak_per_device_mib": sim.peak_bytes_per_device / 2**20,
                "predicted_peak_mib": max((s.predicted_peak_bytes
                                           for s in steps), default=0.0)
                / 2**20,
                "allocator_peak_mib": max((s.max_memory_bytes
                                           for s in steps), default=0)
                / 2**20}
        got = torch.tensor([s.loss for s in trainer.history],
                           dtype=torch.float64)
        want = torch.tensor(losses[half:], dtype=torch.float64)
        loss_err = _same_or_close("sharding (b) losses", got, want,
                                  OFFLOAD_TOL["loss"])
        st = planner.stats
        checks = {
            "mesh_changed": bool(summary["mesh_changed"]),
            "restored_samples == the sample log's length":
                summary["restored_samples"] == len(stored["sample_log"]),
            "restored_plans == 0": summary["restored_plans"] == 0,
            "dropped_plans == the stored plans (buckets)":
                summary["dropped_plans"] == len(stored["plans"]) > 0,
            "no collection after the restore": st["collections"] == 0,
            "each bucket remats no more units than under 1x1": all(
                v["n_remat_1x1"] is None or v["n_remat"] <= v["n_remat_1x1"]
                for v in per_bucket.values()),
            "simulated per-device peaks within the per-device budget": all(
                v["sim_peak_per_device_mib"] * 2**20 <= planner.budget_bytes
                for v in per_bucket.values()),
            f"{args['steps'] - half} steps from cursor {half}":
                len(trainer.history) == args["steps"] - half,
        }
        timing["b"] = time.perf_counter() - t0
        res["b"] = {"summary": summary, "loss_max_abs_err": loss_err,
                    "fixed_per_device_mib": fixed / 2**20,
                    "budget_per_device_mib": planner.budget_bytes / 2**20,
                    "buckets": per_bucket}
        log(f"sharding (b) resume under {SHARD_MESH} zero1 (planned per "
            f"device, executed on this card): planner {summary}; fixed "
            f"{fixed / 2**20:.1f} MiB per device of "
            f"{planner.budget_bytes / 2**20:.1f}; losses "
            f"{[s.loss for s in trainer.history]} vs "
            f"{losses[half:]} (max abs error {loss_err}); per bucket "
            + json.dumps(per_bucket) + "; checks " + json.dumps(checks))
        if not all(checks.values()):
            raise AssertionError(f"sharding (b) checks failed: {checks}")
        del trainer, planner
        _free()
    # (c) a model one card cannot hold, planned per device on the host
    t0 = time.perf_counter()
    res["c"] = plan_gemma3_on_meshes()
    timing["c"] = time.perf_counter() - t0
    res["s"] = timing
    log("sharding: " + json.dumps({"card": card_line(), **res})
        + f"; wall (a) {timing['a']:.1f} s, (b) {timing['b']:.1f} s, (c) "
        f"{timing['c']:.1f} s, total {sum(timing.values()):.1f} s")
    return {"launches": {k: la[k] + lb[k] for k in FLASH_KERNELS},
            "params_half": params_half, "buckets": res["b"]["buckets"]}


def plan_gemma3_on_meshes():
    """Full-depth gemma3_12b (48 layers) on ``meta``, bucket 448 at B = 8,
    planned under 80 GiB a device on (1,), (4, 2) and (4, 2) with
    ZeRO-1: the fixed bytes per device within 1 % of the config's
    figures, (1,) infeasible (its fixed bytes alone exceed the budget),
    (4, 2) with ZeRO-1 feasible."""
    from repro_torch.core.planner import MimosePlanner
    from repro_torch.core.simulator import simulate_sharded
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    from repro_torch.sharding.budget import MeshBudget
    lm = LM(get_config("gemma3_12b"), device="meta")
    n_params = sum(p.numel() for p in lm.parameters())
    hbm = GEMMA3_PLAN["hbm_gib"] * 2**30
    batch = {"tokens": torch.zeros((GEMMA3_PLAN["B"], GEMMA3_PLAN["S"]),
                                   dtype=torch.long)}
    out, ok = {}, {}
    for shape, zero1, want_gb in GEMMA3_FIXED_GB:
        mb = MeshBudget.from_shape(shape, hbm, zero1=zero1)
        planner = MimosePlanner(lm, mesh_budget=mb, warmup_samples=1,
                                quantum=64)
        fixed = planner.resolve_fixed_bytes()
        acts, info = planner.plan(batch)
        col = planner.collector.collect(batch)
        sim = simulate_sharded(col.device_activation_vector(), acts, fixed,
                               mb.n_devices, col.device_output_vector())
        name = f"{shape}" + (" zero1" if zero1 else "")
        out[name] = {"fixed_gb": fixed / 1e9, "want_gb": want_gb,
                     "activations_gb": float(
                         col.device_activation_vector().sum()) / 1e9,
                     "n_remat": info.plan.n_remat,
                     "units": len(acts),
                     "sim_peak_per_device_gb": sim.peak_bytes_per_device
                     / 1e9, "fits": sim.fits(hbm)}
        ok[f"{name}: fixed within 1 % of {want_gb} GB"] = (
            abs(fixed / 1e9 - want_gb) <= 0.01 * want_gb)
    ok["(1,) infeasible"] = not out["(1,)"]["fits"]
    ok["(4, 2) zero1 feasible"] = out["(4, 2) zero1"]["fits"]
    log(f"sharding (c) gemma3_12b, {lm.cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} G parameters, bucket {GEMMA3_PLAN['S']} at "
        f"B = {GEMMA3_PLAN['B']}, {GEMMA3_PLAN['hbm_gib']} GiB a device: "
        + json.dumps(out) + "; checks " + json.dumps(ok))
    if not all(ok.values()):
        raise AssertionError(f"sharding (c) checks failed: {ok}")
    return out


# ---------------------------------------------------------------------------
# the distributed path (D1-D3): the dry run on meta, and bert's train step
# (launch/steps.build_setup) on DTensor shards of a built mesh
# ---------------------------------------------------------------------------

# D1: two full-scale pairs on the 16x16 production mesh, a fake group of
# 256 ranks, every tensor on meta
DRYRUN_PAIRS = [("qwen3_1p7b", "train_4k"), ("mamba2_1p3b", "decode_32k")]
# D3: bert at (4, 2) with ZeRO-1 under a fake group of 8 ranks, rank 0's
# shards on this card (the mesh of the sharding path's (b))
D3_MESH = (4, 2)


def _prepared(batch, quantum):
    """A main-path batch as ``Trainer._prepare`` hands it to the step:
    bucket-padded, on the card, token ids and labels int64, lengths
    int32, the rest fp32."""
    from repro_torch.data.pipeline import pad_batch
    b = pad_batch(batch, quantum)
    B, S = np.shape(b["tokens"])
    if "lengths" not in b:
        b = dict(b, lengths=np.full((B,), S, np.int32))
    dtypes = {"tokens": torch.long, "labels": torch.long,
              "lengths": torch.int32}
    return {k: torch.as_tensor(np.asarray(v)).to(
        device="cuda", dtype=dtypes.get(k, torch.float32))
        for k, v in b.items()}


def _bert_setup(args, mesh, actions, **kw):
    """``build_setup``'s train step for the bert main path on ``mesh``:
    the launcher's model (seed 0, flash kernels) and optimizer (AdamW on
    its cosine schedule), ``actions`` as the planned mask."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.steps import build_setup
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    shape = ShapeConfig("bert_main", 448, args["batch_size"], "train")
    return build_setup(path_config(args), shape, mesh, remat=actions,
                       attn_impl="flash", device="cuda", seed=0,
                       optimizer=AdamW(lr=cosine_schedule(
                           3e-4, 10, args["steps"])), **kw)


def _expected_flash(actions_per_step):
    """K1 = sum (12 + REMAT units), K2 = K3 = 12 a step (bert, k = 1)."""
    from repro_torch.actions import Action, as_actions
    fwd = sum(12 + sum(a is not Action.KEEP for a in as_actions(acts))
              for acts in actions_per_step)
    return fwd, 12 * len(actions_per_step)


def _check_flash(label, launches, actions_per_step):
    fwd, bwd = _expected_flash(actions_per_step)
    ok = (launches["flash_fwd"] == fwd
          and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == bwd
          and all(launches[k] == 0 for k in FMA_OF.values()))
    log(f"{label} launches: " + json.dumps(
        {k: launches[k] for k in FLASH_KERNELS + list(FMA_OF.values())})
        + f" (K1 = {fwd}, K2 = K3 = {bwd} expected)")
    if not ok:
        raise AssertionError(f"{label}: launches {launches}")
    return {k: launches[k] for k in FLASH_KERNELS}


def run_dryrun_pairs():
    """D1: ``launch.dryrun.run_one`` at full scale on meta, each pair
    ``ok`` with FLOPs per device above 0."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_group, run_one
    if dist.is_initialized():
        raise AssertionError("D1: a process group is still alive")
    recs = []
    with fake_group(256):
        for arch, shape in DRYRUN_PAIRS:
            t0 = time.perf_counter()
            rec = run_one(arch, shape, multi_pod=False, remat="mimose",
                          zero1=False, seq_parallel=False, logits_f32=True)
            rec["wall_s"] = round(time.perf_counter() - t0, 1)
            log(f"D1 dry run {arch} {shape} on 16x16 (fake group of 256, "
                f"meta): " + json.dumps(rec))
            if rec["status"] != "ok" or not rec["flops_per_dev"] > 0:
                raise AssertionError(f"D1 {arch} {shape}: {rec}")
            log(f"D1 {arch} {shape}: useful_flops_ratio "
                f"{rec['useful_flops_ratio']}, bottleneck "
                f"{rec['bottleneck']}, {rec['wall_s']} s")
            recs.append(rec)
    return recs


def run_sharded_main_path(args, main_run, params_half):
    """D2: the bert main path's first half on a built (1, 1) ``nccl``
    mesh through ``build_setup``'s train step: the main path's weights
    (seed 0), plans and batches; every loss and the parameters after the
    last step bitwise the ``Trainer``'s (the sharding path's (a)
    snapshot at that step); K1 = sum (12 + REMAT units), K2 = K3 = 12 a
    step, through ``local_map`` on the heads."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import (ensure_process_group,
                                         make_production_mesh)
    from repro_torch.launch.steps import place
    from repro_torch.sharding import specs as SP
    half = args["steps"] // 2
    batches = main_path_batches(args)[:half]
    actions = main_run["actions"][:half]
    own = ensure_process_group("cuda")
    try:
        mesh = make_production_mesh(shape=(1, 1), device_type="cuda")
        setup = _bert_setup(args, mesh, actions[0])
        params, opt_state = setup.args[0], setup.args[1]
        ops.reset_launches()
        losses = []
        for batch, acts in zip(batches, actions):
            b = _prepared(batch, args["quantum"])
            b = place(b, SP.batch_shardings(b, mesh), mesh)
            params, opt_state, loss = setup.fn(params, opt_state, b,
                                               actions=acts)
            losses.append(float(loss.full_tensor()))
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        launches = _check_flash("D2 (1, 1) nccl mesh", counts, actions)
        got = {n: p.to_local().detach().cpu() for n, p in params.items()}
    finally:
        if own:
            dist.destroy_process_group()
    checks = {
        "losses bitwise the main path's":
            losses == main_run["losses"][:half],
        f"parameters after step {half} bitwise the main path's": (
            set(got) == set(params_half)
            and all(torch.equal(got[n], params_half[n]) for n in got)),
        "every parameter a DTensor on (data 1, model 1)":
            tuple(mesh.mesh_dim_names) == ("data", "model"),
        "AdamW's kernels on the shards: adamw = parameters x steps, "
        "adamw_norm = steps": counts["adamw"] == len(got) * half
            and counts["adamw_norm"] == half,
    }
    log(f"D2 bert's sharded step on a (1, 1) nccl mesh, {half} steps: "
        f"losses {losses} vs {main_run['losses'][:half]}; checks "
        + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"D2 checks failed: {checks}")
    del setup, params, opt_state
    _free()
    return launches


def run_sharded_per_device(args, buckets):
    """D3: bert's train step at (4, 2) with ZeRO-1 under a fake group of
    8 ranks: rank 0 runs its own shards on this card (2 of 8 rows, 6 of
    12 heads through K1-K3, half of d_ff, a quarter of each moment).  One
    step at each bucket under the sharding path's (b) plan; its
    allocator peak beside the per-device simulated peak and prediction.
    The fake collectives leave the values meaningless: only the launches
    and the memory are checked."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import place
    from repro_torch.sharding import specs as SP
    if dist.is_initialized():
        raise AssertionError("D3: a process group is still alive")
    first = {}                  # the planner's bucket key: B x S tokens
    for batch in main_path_batches(args):
        first.setdefault(int(np.prod(np.shape(batch["tokens"]))), batch)
    out, acts_run = {}, []
    _free()
    with fake_group(math.prod(D3_MESH)):
        mesh = make_production_mesh(shape=D3_MESH, device_type="cuda")
        some = next(iter(buckets.values()))["actions"]
        setup = _bert_setup(args, mesh, some, zero1=True)
        params, opt_state = setup.args[0], setup.args[1]
        local = {n: tuple(params[n].to_local().shape) for n in (
            "blocks.0.attn.wq", "blocks.0.mlp.wi", "embed")}
        moment = tuple(opt_state.m["blocks.0.mlp.wi"].to_local().shape)
        ops.reset_launches()
        for key, plan in sorted(buckets.items()):
            b = _prepared(first[int(key)], args["quantum"])
            b = place(b, SP.batch_shardings(b, mesh), mesh)
            rows = tuple(b["tokens"].to_local().shape)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            params, opt_state, _ = setup.fn(params, opt_state, b,
                                            actions=plan["actions"])
            torch.cuda.synchronize()
            acts_run.append(plan["actions"])
            out[key] = {"local_batch": rows,
                        "resident_before_mib": resident / 2**20,
                        "allocator_peak_mib":
                            torch.cuda.max_memory_allocated() / 2**20,
                        "sim_peak_per_device_mib":
                            plan["sim_peak_per_device_mib"],
                        "predicted_peak_mib": plan["predicted_peak_mib"],
                        "n_remat": plan["n_remat"]}
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        launches = _check_flash(f"D3 {D3_MESH} zero1 (fake group of 8)",
                                counts, acts_run)
        adamw_ok = (counts["adamw"] == len(params) * len(acts_run)
                    and counts["adamw_norm"] == len(acts_run))
        del setup, params, opt_state
    _free()
    log(f"D3 bert at {D3_MESH} ZeRO-1, rank 0's shards on this card "
        f"({card_line()}): local shapes {local}, moment of "
        f"blocks.0.mlp.wi {moment}; per bucket " + json.dumps(out))
    checks = {
        "2 of 8 rows": all(v["local_batch"][0] == args["batch_size"] // 4
                           for v in out.values()),
        "6 of 12 heads (wq 768 x 384)":
            local["blocks.0.attn.wq"] == (768, 384),
        "half of d_ff (wi 768 x 1536)": local["blocks.0.mlp.wi"] == (768,
                                                                     1536),
        "AdamW's kernels on the shards: adamw = parameters x steps, "
        "adamw_norm = steps": adamw_ok,
    }
    if not all(checks.values()):
        raise AssertionError(f"D3 checks failed: {checks}")
    return launches, out


def run_distributed_path(args, main_run, sharding):
    """D1, D2 and D3, each's wall time logged; returns D2's and D3's
    flash launches."""
    timing = {}
    t0 = time.perf_counter()
    run_dryrun_pairs()
    timing["D1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    l2 = run_sharded_main_path(args, main_run, sharding["params_half"])
    timing["D2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    l3, per_bucket = run_sharded_per_device(args, sharding["buckets"])
    timing["D3"] = time.perf_counter() - t0
    log("distributed: " + json.dumps({
        "card": card_line(), "D3": per_bucket,
        "wall_s": {k: round(v, 1) for k, v in timing.items()}}))
    return {k: l2[k] + l3[k] for k in FLASH_KERNELS}


# ---------------------------------------------------------------------------
# the offload path: OFFLOAD and OFFLOAD_OPT executed on the bert main path
# ---------------------------------------------------------------------------

OFFLOAD_STEPS = 8
# OFFLOAD against REMAT, and OFFLOAD_OPT split steps against fused ones,
# are expected bitwise equal (the same kernels on the same values); when
# they are not, they are held at the reference's tolerances
# (tests/test_hybrid.py: loss rtol 1e-6; grads rtol 2e-4, atol 1e-5)
OFFLOAD_TOL = {"loss": (1e-6, 0.0), "grads": (2e-4, 1e-5)}
# the device bytes held after the forward fall by the offloaded inputs'
# bytes, to this share of them: on an NVIDIA H100 80GB HBM3 the OFFLOAD
# side held exact multiples of the inputs and the REMAT side up to
# 0.66-0.75 MiB more than the inputs it keeps (0.5-1.2 %; small tensors
# of the checkpoint, not identified)
DROP_RTOL = 0.02


def offload_budgets_mb(args, batches):
    """Budgets for the offload runs, from the simulator on collections
    of a ``meta`` model at every bucket of the batches: (a) between the
    largest bucket's all-OFFLOAD peak and the smallest bucket's
    remat-all peak, so no bucket fits a k = 1 KEEP/REMAT plan and a
    hybrid one fits; (b) between the largest bucket's peak with the
    last unit OFFLOAD_OPT and the rest OFFLOAD and the smallest
    bucket's all-OFFLOAD peak, so only parked moments fit.  Returns
    (a, b, {S: {plan: peak MiB}})."""
    from repro_torch.actions import Action
    from repro_torch.core.collector import ShuttlingCollector
    from repro_torch.core.planner import fixed_train_bytes
    from repro_torch.core.simulator import simulate
    from repro_torch.launch.roofline import PCIE_BW
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    lm = LM(get_config(args["arch"]), attn_impl="flash", device="meta")
    fixed = fixed_train_bytes(lm.parameters())
    n = lm.num_plan_units()
    col = ShuttlingCollector(lm)
    plans = {"remat-all": [Action.REMAT] * n,
             "all-OFFLOAD": [Action.OFFLOAD] * n,
             "last-OFFLOAD_OPT": [Action.OFFLOAD] * (n - 1)
             + [Action.OFFLOAD_OPT]}
    peaks = {}
    for S in sorted({b["tokens"].shape[1] for b in batches}):
        r = col.collect({"tokens": torch.zeros((args["batch_size"], S),
                                               dtype=torch.long)})
        peaks[S] = {name: simulate(
            r.activation_vector(), acts, fixed, r.output_vector(),
            r.flops_vector(), offload_bytes=r.offloadable_vector(),
            opt_bytes=r.opt_vector(), pcie_bytes_per_s=PCIE_BW).peak_bytes
            / 2**20 for name, acts in plans.items()}
        log(f"offload budgets: S={S} simulated peaks (MiB) " + json.dumps(
            {k: round(v, 1) for k, v in peaks[S].items()}))
    hi = {k: max(p[k] for p in peaks.values()) for k in plans}
    lo = {k: min(p[k] for p in peaks.values()) for k in plans}
    if not (hi["all-OFFLOAD"] < lo["remat-all"]
            and hi["last-OFFLOAD_OPT"] < lo["all-OFFLOAD"]):
        raise AssertionError(f"offload budgets: no gap between the "
                             f"simulated peaks {peaks}")
    a = 0.5 * (hi["all-OFFLOAD"] + lo["remat-all"])
    b = 0.5 * (hi["last-OFFLOAD_OPT"] + lo["all-OFFLOAD"])
    log(f"offload budgets: (a) {a:.1f} MiB, (b) {b:.1f} MiB")
    return a, b, peaks


def fixed_planner(lm, actions, quantum, microbatch=1):
    """A planner serving one action plan (split ``microbatch`` ways) for
    every batch (the OFFLOAD_OPT runs: the planner never picks
    OFFLOAD_OPT for bert at squad lengths, PERF.md §6; the OOM phase's
    direct run of the escalated plan)."""
    from repro_torch.core.planner import PlanInfo, PlannerBase
    from repro_torch.core.scheduler import Plan

    class FixedPlanner(PlannerBase):
        def __init__(self):
            self.lm, self.quantum = lm, quantum

        def plan(self, batch):
            p = Plan([], 0.0, 0.0, 0.0, actions=actions,
                     microbatch=microbatch)
            return p.as_actions(), PlanInfo(0, self.bucket_key(batch), True,
                                            False, p)
    return FixedPlanner()


def _sinks(tmp):
    return {"metrics": str(Path(tmp) / "metrics.json"),
            "events": str(Path(tmp) / "events.jsonl"),
            "trace": str(Path(tmp) / "trace.json")}


def _read_sinks(paths):
    from repro_torch.obs import read_events
    return (json.load(open(paths["metrics"])),
            list(read_events(paths["events"])),
            json.load(open(paths["trace"]))["traceEvents"])


def check_offload_run(trainer, launches, sinks, label, budget_mb,
                      want="offload", parked_bytes=0.0, sim_peaks=None,
                      batch_size=8):
    """What an offload-path run must show; logs its numbers and returns
    its record.  ``want``: "offload" (every step holds an OFFLOAD unit;
    the lane moves exactly the OFFLOAD layers' inputs out and back),
    "opt" (every step parks moments; the lane moves the inputs and
    ``parked_bytes`` per step), or "any" (the planner's choice, logged).
    ``sim_peaks``: {S: simulated peak MiB} to log against the measured
    peak when the planner gives no prediction."""
    from repro_torch.obs import TRACK_PLANNER, TRACK_SOLVER, TRACK_STEP, \
        TRACK_TRANSFER
    metrics, events, trace = _read_sinks(sinks)
    h = trainer.history
    lm = trainer.lm
    d = lm.cfg.d_model
    per = [e - s for s, e in lm.unit_bounds()][0]
    k1 = sum(s.microbatches * (lm.cfg.num_layers + (s.remat_units
                                                    + s.offload_units) * per)
             for s in h)
    k23 = sum(s.microbatches * lm.cfg.num_layers for s in h)

    def total(name):
        return float(metrics.get(name, {}).get("total", 0.0))
    lane = {k: total("transfer_" + k) for k in ("bytes_out", "bytes_in",
                                                "copy_s", "exposed_s",
                                                "stall_s")}
    lane["pinned_mib"] = (trainer.transfer_lane.pinned_bytes / 2**20
                          if trainer.transfer_lane is not None else 0.0)
    inputs = sum(s.offload_units * per * s.padded_tokens * d * 4 for s in h)
    steps = [e for e in events if e["kind"] == "train_step"]
    priced = sum(2.0 * e["offload_bytes"] for e in steps)
    tracks = {e["tid"] for e in trace if e["ph"] in ("X", "i")}
    summ = trainer.summary()
    checks = {
        "losses finite": all(math.isfinite(s.loss) for s in h),
        "K1 = sum k (12 + n_remat + n_offload)": launches["flash_fwd"] == k1,
        "K2 = K3 = sum 12 k": launches["flash_bwd_dq"]
        == launches["flash_bwd_dkv"] == k23,
        "no OFFLOAD step ran as REMAT": summ["offload_degraded_steps"] == 0,
        "exposed_s <= copy_s": lane["exposed_s"] <= lane["copy_s"],
        "plan and train_step events": {"plan", "train_step"}
        <= {e["kind"] for e in events} or want == "opt",
        "a train_step event per step": len(steps) == len(h),
        "spans on the step and planner tracks": {TRACK_STEP}
        <= tracks and (TRACK_PLANNER in tracks or want == "opt"),
        "solver spans when solves ran": (TRACK_SOLVER in tracks)
        == (total("solver_solves") + total("solver_timeouts") > 0),
    }
    if want == "offload":
        checks["every step holds an OFFLOAD unit"] = all(
            s.offload_units >= 1 for s in h)
        checks["lane out = in = the OFFLOAD inputs"] = (
            lane["bytes_out"] == lane["bytes_in"] == inputs)
        checks["spans on the transfer track"] = TRACK_TRANSFER in tracks
    elif want == "opt":
        checks["every step holds an OFFLOAD_OPT unit"] = all(
            s.opt_offload_units >= 1 for s in h)
        checks["lane out = inputs + parked moments per step"] = (
            lane["bytes_out"] == inputs + len(h) * parked_bytes)
        checks["lane in = inputs + parked moments after step 1"] = (
            lane["bytes_in"] == inputs + (len(h) - 1) * parked_bytes)
        checks["spans on the transfer track"] = TRACK_TRANSFER in tracks
    log(f"offload path [{label}]: launches "
        + json.dumps({k: launches[k] for k in FLASH_KERNELS})
        + "; lane " + json.dumps({k: round(v, 6) for k, v in lane.items()})
        + f"; OFFLOAD inputs moved each way {inputs / 2**20:.1f} MiB, "
        f"priced by the plans (2 x offloadable bytes) {priced / 2**20:.1f} "
        f"MiB; tracks {sorted(tracks)}; checks " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"offload path [{label}] checks failed: "
                             f"{checks}")
    log(f"offload path [{label}]: tokens/s over warm steps "
        f"{summ['tokens_per_s']:.1f}, mean warm step "
        f"{summ['mean_step_s'] * 1e3:.2f} ms, plan time "
        f"{summ['total_plan_s'] * 1e3:.2f} ms, exposed transfer "
        f"{summ['exposed_transfer_s']:.6f} s vs simulated "
        f"{summ['sim_transfer_s']:.6f} s, mean k "
        f"{summ['mean_microbatches']:.3f}, losses "
        f"{[round(s.loss, 4) for s in h]}")
    rows = {}
    for st in h:
        rows.setdefault(st.bucket, []).append(st)
    per_bucket = {}
    for bucket, sts in sorted(rows.items()):
        S = bucket // batch_size
        per_bucket[bucket] = {
            "steps": len(sts),
            "n_remat": sorted({s.remat_units for s in sts}),
            "n_offload": sorted({s.offload_units for s in sts}),
            "n_opt": sorted({s.opt_offload_units for s in sts}),
            "k": sorted({s.microbatches for s in sts}),
            "measured_peak_mib": round(max(s.max_memory_bytes
                                           for s in sts) / 2**20, 1),
            "predicted_peak_mib": round(
                (max(s.predicted_peak_bytes for s in sts) / 2**20)
                if sim_peaks is None else sim_peaks.get(S, 0.0), 1)}
        log(f"  bucket {bucket}: " + json.dumps(per_bucket[bucket])
            + f", budget {budget_mb:.1f} MiB")
    return {"run": label, "budget_mb": budget_mb,
            "tokens_per_s": summ["tokens_per_s"],
            "mean_step_ms": summ["mean_step_s"] * 1e3,
            "plan_ms": summ["total_plan_s"] * 1e3,
            "exposed_transfer_s": summ["exposed_transfer_s"],
            "sim_transfer_s": summ["sim_transfer_s"], "lane": lane,
            "inputs_mib": inputs / 2**20, "priced_mib": priced / 2**20,
            "buckets": per_bucket}


def run_offload(args, budget_mb, extra, label, want="offload"):
    """One 8-step run of ``launch.train.main`` with every sink on, into
    a temporary directory; launch counts read around it."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    with tempfile.TemporaryDirectory() as tmp:
        sinks = _sinks(tmp)
        argv = ["--arch", args["arch"], "--dataset", args["dataset"],
                "--planner", "mimose", "--attn-impl", "flash",
                "--budget-mb", f"{budget_mb:.3f}",
                "--steps", str(OFFLOAD_STEPS),
                "--batch-size", str(args["batch_size"]),
                "--quantum", str(args["quantum"]), "--device", "cuda",
                "--metrics", sinks["metrics"], "--events-out",
                sinks["events"], "--trace-out", sinks["trace"]] + extra
        log(f"offload path [{label}]: python -m repro_torch.launch.train "
            + " ".join(argv))
        ops.reset_launches()
        trainer = launch_train.main(argv)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        res = check_offload_run(trainer, launches, sinks, label, budget_mb,
                                want, batch_size=args["batch_size"])
    return trainer, res


def run_fixed_opt(args, budget_mb, batches, sim_peaks):
    """(b) with the plan the planner does not find: every unit OFFLOAD
    but the last, whose fp32 moments are parked; 8 steps through the
    trainer with every sink on."""
    import tempfile

    from repro_torch.actions import Action
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    from repro_torch.obs import build_telemetry, flush_telemetry
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import Trainer
    lm = LM(get_config(args["arch"]), attn_impl="flash", device="cuda")
    n = lm.num_plan_units()
    acts = (Action.OFFLOAD,) * (n - 1) + (Action.OFFLOAD_OPT,)
    with tempfile.TemporaryDirectory() as tmp:
        sinks = _sinks(tmp)
        tel = build_telemetry(metrics_path=sinks["metrics"],
                              events_path=sinks["events"],
                              trace_path=sinks["trace"])
        tr = Trainer(lm, fixed_planner(lm, acts, args["quantum"]),
                     AdamW(lr=cosine_schedule(3e-4, 10, OFFLOAD_STEPS)),
                     telemetry=tel)
        parked = float(sum(8 * tr.params[name].numel()
                           for name in tr._unit_names[n - 1]))
        ops.reset_launches()
        tr.run(batches[:OFFLOAD_STEPS])
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        flush_telemetry(tel)
        res = check_offload_run(tr, launches, sinks, "b: fixed plan, "
                                "11 OFFLOAD + last unit OFFLOAD_OPT",
                                budget_mb, "opt", parked,
                                {S: p["last-OFFLOAD_OPT"]
                                 for S, p in sim_peaks.items()},
                                batch_size=args["batch_size"])
    res["parked_mib_per_step"] = parked / 2**20
    del tr, lm
    return res


def _same_or_close(name, got, want, tol):
    """True when bitwise equal; else the max abs error, which must be
    within ``tol`` (rtol, atol)."""
    if torch.equal(got, want):
        return 0.0
    err = _err(got, want, *tol)
    if err[1] > 0:
        raise AssertionError(f"{name}: {err} beyond {tol}")
    return err[0]


def check_offload_equals_remat(arch_cfg, batch, quantum, acts, label):
    """One batch under ``acts`` run with OFFLOAD for real and as REMAT
    (``offload_exec`` off), deterministic algorithms on: loss and
    gradients, and the device bytes held after the forward (synchronised,
    freed blocks returned), which must fall by the offloaded layers'
    inputs."""
    from repro_torch.actions import Action
    from repro_torch.models.lm import LM
    lm = LM(arch_cfg, attn_impl="flash", device="cuda")
    b = _device_batch(batch, quantum)
    B, S = b["tokens"].shape
    # one unmeasured step first, so allocations made on first use
    # (library workspaces) land outside both measurements
    loss, _ = lm.loss(b, acts)
    loss.backward()
    lm.zero_grad(set_to_none=True)
    del loss
    out = {}
    for exe in (True, False):
        lm.offload_exec = exe
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        loss, _ = lm.loss(b, acts)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() - base
        loss.backward()
        torch.cuda.synchronize()
        out[exe] = (loss.detach().clone(), held,
                    {n: p.grad.clone() for n, p in lm.named_parameters()})
        for p in lm.parameters():
            p.grad = None
    per = [e - s for s, e in lm.unit_bounds()][0]
    n_layers = sum(per for a in acts if a is Action.OFFLOAD)
    elem = torch.empty((), dtype=lm.dtype).element_size()
    want_drop = n_layers * B * S * lm.cfg.d_model * elem
    drop = out[False][1] - out[True][1]
    e_loss = _same_or_close("loss", out[True][0], out[False][0],
                            OFFLOAD_TOL["loss"])
    e_grad = max(_same_or_close(n, out[True][2][n], out[False][2][n],
                                OFFLOAD_TOL["grads"]) for n in out[True][2])
    bitwise = e_loss == 0.0 and e_grad == 0.0
    log(f"offload check [{label}] (B={B} S={S}, {n_layers} layers' inputs "
        f"to host): loss {float(out[True][0]):.7f} OFFLOAD vs "
        f"{float(out[False][0]):.7f} REMAT; "
        + ("loss and every gradient bitwise equal"
           if bitwise else f"not bitwise: loss err {e_loss:.3e}, grads "
           f"max abs err {e_grad:.3e} (within {OFFLOAD_TOL})")
        + f"; held after the forward {out[True][1] / 2**20:.2f} MiB OFFLOAD "
        f"vs {out[False][1] / 2**20:.2f} MiB REMAT: drop "
        f"{drop / 2**20:.2f} MiB, the inputs {want_drop / 2**20:.2f} MiB")
    if abs(drop - want_drop) > max(512 * n_layers, DROP_RTOL * want_drop):
        raise AssertionError(f"offload check [{label}]: the device bytes "
                             f"fell by {drop}, not by the offloaded inputs' "
                             f"{want_drop}")
    st = lm.transfer_lane.reset_stats()
    del lm
    return {"bitwise": bitwise, "drop_mib": drop / 2**20,
            "inputs_mib": want_drop / 2**20, "lane": st}


def check_split_equals_fused(args, batches):
    """Three OFFLOAD_OPT split steps against three fused steps (the same
    plan with KEEP for OFFLOAD_OPT) from the same state: parameters
    equal; each step's peak logged beside the parked bytes."""
    from repro_torch.actions import Action
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import Trainer
    n = get_config(args["arch"]).num_layers
    split = ((Action.OFFLOAD_OPT,) + (Action.OFFLOAD,) * (n - 2)
             + (Action.OFFLOAD_OPT,))
    fused = tuple(Action.KEEP if a is Action.OFFLOAD_OPT else a
                  for a in split)
    res = {}
    for name, acts in (("split", split), ("fused", fused)):
        lm = LM(get_config(args["arch"]), attn_impl="flash", device="cuda")
        tr = Trainer(lm, fixed_planner(lm, acts, args["quantum"]),
                     AdamW(lr=1e-3))
        tr.run(batches[:3])
        torch.cuda.synchronize()
        parked = sum(8 * tr.params[p].numel() for u in (0, n - 1)
                     for p in tr._unit_names[u])
        res[name] = ({k: p.detach().clone() for k, p in tr.params.items()},
                     [s.max_memory_bytes for s in tr.history], parked,
                     [s.loss for s in tr.history])
        del tr, lm
        gc.collect()
        torch.cuda.empty_cache()
    errs = [_same_or_close(k, res["split"][0][k], res["fused"][0][k],
                           OFFLOAD_TOL["grads"]) for k in res["fused"][0]]
    mib = 2 ** 20
    log(f"OFFLOAD_OPT split vs fused, 3 steps (units 0 and {n - 1} parked, "
        f"{res['split'][2] / mib:.1f} MiB of moments): parameters "
        + ("bitwise equal" if max(errs) == 0.0 else
           f"max abs err {max(errs):.3e}")
        + f"; losses split {res['split'][3]} fused {res['fused'][3]}; step "
        f"peaks split {[round(x / mib, 1) for x in res['split'][1]]} MiB "
        f"vs fused {[round(x / mib, 1) for x in res['fused'][1]]} MiB "
        f"(fused minus parked: "
        f"{[round((x - res['split'][2]) / mib, 1) for x in res['fused'][1]]})")
    return {"bitwise": max(errs) == 0.0,
            "split_peaks_mib": [x / mib for x in res["split"][1]],
            "fused_peaks_mib": [x / mib for x in res["fused"][1]],
            "parked_mib": res["split"][2] / mib}


def _timed_steps(times):
    """A context in which every ``Trainer.step`` appends (host seconds,
    device seconds) to ``times``: the host clock around the call, which
    ends in a synchronise, and CUDA events recorded on the stream just
    before and after it."""
    import contextlib
    from repro_torch.train.trainer import Trainer
    step = Trainer.step

    def timed(self, opt_state, batch):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        out = step(self, opt_state, batch)
        e1.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0, e0.elapsed_time(e1) / 1e3))
        return out

    @contextlib.contextmanager
    def ctx():
        Trainer.step = timed
        try:
            yield
        finally:
            Trainer.step = step
    return ctx()


def _sink_seconds(acc):
    """A context in which the event log's ``emit`` and the tracer's
    ``complete`` and ``instant`` (what a run with the sinks on does
    beyond one with them off, bar the files written at exit) add their
    host seconds to ``acc[0]``."""
    import contextlib
    from repro_torch.obs.events import EventLog
    from repro_torch.obs.tracing import SpanTracer
    methods = [(EventLog, "emit"), (SpanTracer, "complete"),
               (SpanTracer, "instant")]
    originals = [getattr(cls, name) for cls, name in methods]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[0] += time.perf_counter() - t0
        return call

    @contextlib.contextmanager
    def ctx():
        for (cls, name), fn in zip(methods, originals):
            setattr(cls, name, timed(fn))
        try:
            yield
        finally:
            for (cls, name), fn in zip(methods, originals):
                setattr(cls, name, fn)
    return ctx()


def check_telemetry_is_free(args, budget_mb):
    """The bert main path with every sink on and with them off, in the
    order off, on, on, off: losses bitwise equal; each warm step's host
    time (synchronised clock around ``Trainer.step``) and device time
    (CUDA events around it), and their medians side by side; and with
    the sinks on, the host seconds spent inside them per step.  Then,
    on the last run's trainer, the sinks switched step by step
    (``alternate_sinks``), which is what decides whether they cost."""
    import tempfile
    out = {}
    alt = None
    for i, name in enumerate(("off", "on", "on", "off")):
        with tempfile.TemporaryDirectory() as tmp:
            sinks = _sinks(tmp)
            extra = ([] if name == "off" else
                     ["--metrics", sinks["metrics"], "--events-out",
                      sinks["events"], "--trace-out", sinks["trace"]])
            times, in_sinks = [], [0.0]
            with _timed_steps(times), _sink_seconds(in_sinks):
                trainer, _ = run_main_path(args, budget_mb, extra)
            summ = trainer.summary()
            warm = [t for t, st in zip(times, trainer.history)
                    if not (st.compile or st.collected)]
            out.setdefault(name, []).append({
                "losses": [s.loss for s in trainer.history],
                "mean_step_ms": summ["mean_step_s"] * 1e3,
                "tokens_per_s": summ["tokens_per_s"],
                "host_ms": [round(h * 1e3, 3) for h, _ in warm],
                "device_ms": [round(d * 1e3, 3) for _, d in warm],
                "sink_ms_per_step": in_sinks[0] * 1e3 / len(times)})
            if i == 3:
                alt = alternate_sinks(trainer, main_path_batches(args), tmp)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    losses = [r["losses"] for runs in out.values() for r in runs]
    same = all(x == losses[0] for x in losses)
    res = {}
    for name, runs in out.items():
        host = [t for r in runs for t in r["host_ms"]]
        dev = [t for r in runs for t in r["device_ms"]]
        res[name] = {"median_host_ms": float(np.median(host)),
                     "median_device_ms": float(np.median(dev)),
                     "median_host_minus_device_ms": float(np.median(
                         [h - d for h, d in zip(host, dev)])),
                     "warm_steps": len(host),
                     "sink_ms_per_step": [r["sink_ms_per_step"]
                                          for r in runs],
                     "mean_step_ms": [round(r["mean_step_ms"], 2)
                                      for r in runs],
                     "tokens_per_s": [round(r["tokens_per_s"], 1)
                                      for r in runs]}
    for k in ("median_host_ms", "median_device_ms"):
        res[f"{k}_on_over_off"] = res["on"][k] / res["off"][k]
    log(f"telemetry on vs off (bert main path, {args['steps']} steps, runs "
        f"off/on/on/off, {card_line()}): " + json.dumps(res)
        + "; per warm step (host ms, device ms): "
        + json.dumps({n: [list(zip(r["host_ms"], r["device_ms"]))
                          for r in runs] for n, runs in out.items()})
        + "; losses " + ("bitwise equal in all four" if same
                         else f"DIFFER: {losses}"))
    if not same:
        raise AssertionError("telemetry changed the losses")
    return {"step_ms_on": res["on"]["mean_step_ms"],
            "step_ms_off": res["off"]["mean_step_ms"], **{
                k: v for k, v in res.items() if k.endswith("on_over_off")},
            "alternating": alt}


# the sink settings ``alternate_sinks`` switches between, in the order
# of each batch's first half (the second half runs them backwards)
SINK_ORDER = ("off", "events", "trace", "all")


def alternate_sinks(trainer, batches, tmp, rounds=11, n_batches=4, seed=0):
    """The sinks' cost, told apart from run-to-run noise: one warm
    trainer, its telemetry's event log and span tracer switched between
    steps.  Each round runs every chosen batch (the first of each of
    ``n_batches`` buckets) eight times in the order off, events, trace,
    all, all, trace, events, off -- one batch, so its shape and plan
    are the same, and mirrored, so a linear drift cancels.  A setting's
    difference in one such group is the mean of its two steps less the
    mean of the two off steps; the first round is warm-up and dropped.
    Per setting: the median difference in ms and as a share of the off
    step, and its 95 % bootstrap interval (``seed``'s 2000 resamples);
    and, since the host's interference only ever adds time, the
    difference of the fastest steps: per batch, the setting's fastest
    step less the fastest off step, averaged over the batches.
    ``free`` holds when that interval of "all" contains 0, and
    ``within_2pct`` when it lies below 2 % of the off step (the
    reference's gate on full sinks)."""
    from repro_torch.obs import EventLog, NullEventLog, NullTracer, SpanTracer
    tel = trainer.telemetry
    saved = (tel.events, tel.tracer, tel.events_on, tel.trace_on)
    ev = EventLog(path=str(Path(tmp) / "alternate_events.jsonl"))
    tr = SpanTracer()
    settings = {"off": (NullEventLog(), NullTracer()),
                "events": (ev, NullTracer()), "trace": (NullEventLog(), tr),
                "all": (ev, tr)}
    chosen = {}
    for b in batches:
        chosen.setdefault(b["tokens"].shape[1], b)
    chosen = list(chosen.values())[:n_batches]
    opt_state = trainer.optimizer.init(trainer.params)
    n_hist = len(trainer.history)
    order = SINK_ORDER + SINK_ORDER[::-1]
    diffs = {k: [] for k in SINK_ORDER[1:]}
    fastest = [{k: math.inf for k in SINK_ORDER} for _ in chosen]
    off_ms, in_sinks = [], [0.0]
    try:
        with _sink_seconds(in_sinks):
            for r in range(rounds):
                for b, low in zip(chosen, fastest):
                    ms = {k: [] for k in SINK_ORDER}
                    for name in order:
                        tel.events, tel.tracer = settings[name]
                        tel.events_on = tel.events is ev
                        tel.trace_on = tel.tracer is tr
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        opt_state, _ = trainer.step(opt_state, b)
                        torch.cuda.synchronize()
                        ms[name].append((time.perf_counter() - t0) * 1e3)
                    if r == 0:
                        continue
                    for k, v in ms.items():
                        low[k] = min(low[k], *v)
                    off = float(np.mean(ms["off"]))
                    off_ms.append(off)
                    for k in diffs:
                        diffs[k].append(float(np.mean(ms[k])) - off)
    finally:
        tel.events, tel.tracer, tel.events_on, tel.trace_on = saved
        ev.close()
    compiled = sum(s.compile for s in trainer.history[n_hist:])
    rng = np.random.default_rng(seed)
    base = float(np.median(off_ms))
    res = {"groups": len(off_ms), "steps": len(trainer.history) - n_hist,
           "compiles": int(compiled), "median_off_ms": base,
           "sink_ms_all_settings": in_sinks[0] * 1e3}
    for k, d in diffs.items():
        d = np.asarray(d)
        boot = np.median(rng.choice(d, (2000, len(d))), axis=1)
        lo, hi = (float(x) for x in np.percentile(boot, [2.5, 97.5]))
        res[k] = {"median_ms": float(np.median(d)),
                  "share": float(np.median(d)) / base,
                  "ci95_ms": [lo, hi],
                  "fastest_ms": float(np.mean([f[k] - f["off"]
                                               for f in fastest]))}
    lo, hi = res["all"]["ci95_ms"]
    res["free"] = bool(lo <= 0.0 <= hi)
    res["within_2pct"] = bool(hi < 0.02 * base)
    log(f"telemetry alternating step by step ({card_line()}; "
        f"{len(chosen)} batches x {rounds} rounds x 8 steps, first round "
        f"dropped): " + json.dumps(res))
    return res


def run_offload_path(args, budget_main_mb):
    """(a) hybrid remat + offload, (b) with parked moments, (c) the
    split plan at (a)'s budget; then the equality and memory checks on
    the card and the telemetry check.  Every run's model is freed before
    the next starts."""
    import dataclasses
    batches = main_path_batches(dict(args, steps=OFFLOAD_STEPS))
    a_mb, b_mb, sim_peaks = offload_budgets_mb(args, batches)
    results = []

    def free(trainer=None):
        bs = getattr(getattr(trainer, "planner", None), "background_solver",
                     None)
        if bs is not None:
            drained = bs.drain(timeout=60.0)
            bs.close()
            st = trainer.planner.stats
            log(f"offload path solver: drained {drained}, solves "
                f"{st['solves']}, wins {st['solver_wins']}, swaps "
                f"{st['solver_swaps']}, errors {bs.errors}")
        gc.collect()
        torch.cuda.empty_cache()

    _, main_batch = most_common_bucket(batches)
    tr, res = run_offload(args, a_mb, ["--offload", "--max-microbatches",
                                       "1", "--solver", "dp"],
                          "a: mimose --offload")
    results.append(res)
    # where an OFFLOAD step's device time goes; the host copies run on
    # the copy stream beside the kernels
    profile_step(tr, main_batch, [("flash kernels", ("flash_",)),
                                  ("host copies", ("memcpy",)),
                                  ("gemm", ("gemm", "cutlass", "xmma"))])
    free(tr)
    del tr
    free()
    tr, res = run_offload(args, b_mb, ["--offload", "--opt-offload",
                                       "--max-microbatches", "1"],
                          "b: mimose --offload --opt-offload", want="any")
    res["planner_picked_offload_opt"] = any(s.opt_offload_units
                                            for s in tr.history)
    results.append(res)
    del tr
    free()
    results.append(run_fixed_opt(args, b_mb, batches, sim_peaks))
    free()
    tr, res = run_offload(args, a_mb, ["--max-microbatches", "4"],
                          "c: mimose --max-microbatches 4", want="any")
    results.append(res)
    del tr
    free()
    # equality, memory and telemetry checks, deterministic algorithms on
    from repro_torch.actions import Action
    from repro_torch.models.registry import get_config
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = get_config(args["arch"])
        n = cfg.num_layers
        eq = {"bert all OFFLOAD vs all REMAT": check_offload_equals_remat(
            cfg, main_batch, args["quantum"], (Action.OFFLOAD,) * n,
            "bert, 12 OFFLOAD")}
        free()
        eq["bert 6 OFFLOAD + 6 REMAT"] = check_offload_equals_remat(
            cfg, main_batch, args["quantum"],
            (Action.OFFLOAD, Action.REMAT) * (n // 2),
            "bert, 6 OFFLOAD + 6 REMAT")
        free()
        mcfg = get_config(MAMBA_ARGS["arch"])
        mcfg = dataclasses.replace(mcfg, num_layers=2 * mcfg.num_layers
                                   // mcfg.scan_chunks, scan_chunks=2)
        m_batch = main_path_batches(MAMBA_ARGS)[0]
        eq["mamba2 scan, OFFLOAD chunk"] = check_offload_equals_remat(
            mcfg, m_batch, MAMBA_ARGS["quantum"],
            (Action.OFFLOAD, Action.REMAT), f"mamba2 scan mode, "
            f"{mcfg.num_layers} layers in 2 chunks, first chunk OFFLOAD")
        free()
        split = check_split_equals_fused(args, batches)
        free()
        tele = check_telemetry_is_free(args, budget_main_mb)
    finally:
        torch.use_deterministic_algorithms(False)
    log("offload: " + json.dumps({"card": card_line(), "runs": results,
                                  "equality": eq, "split": split,
                                  "telemetry": tele}))


# ---------------------------------------------------------------------------
# the resilience phases (R1-R3): snapshots, kill-and-resume and a real
# CUDA OOM on full-width bert, deterministic algorithms on
# ---------------------------------------------------------------------------

# R1: 16 uninterrupted steps against 8, a snapshot, fresh objects, and
# batches 8-15; the launcher drill: 12 steps with a snapshot every 6 and
# the first 2 executions failing, then the same command with --resume
RESUME_STEPS = 16
DRILL_STEPS = 12
# R2: the fixed OFFLOAD_OPT plan, 4 uninterrupted steps against 2 + 2
PARKED_STEPS = 4


def _bert_trainer(args, budget_mb, seed=0, actions=None, k=1, **kw):
    """Full-width bert through the flash kernels under Mimose at the main
    budget (or a fixed plan), AdamW on the launcher's schedule; ``seed``
    draws the weights (a restore overwrites them)."""
    from repro_torch.core.planner import MimosePlanner
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import Trainer
    lm = LM(path_config(args), attn_impl="flash", device="cuda", seed=seed)
    planner = (fixed_planner(lm, actions, args["quantum"], k)
               if actions is not None else
               MimosePlanner(lm, budget_mb * 2**20, quantum=args["quantum"],
                             warmup_samples=3))
    return Trainer(lm, planner, AdamW(lr=cosine_schedule(
        3e-4, 10, RESUME_STEPS)), **kw)


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _host_copy(tree):
    return {n: t.detach().to("cpu", copy=True) for n, t in tree.items()}


def _bitwise(label, got: dict, want: dict):
    bad = [n for n in want if not torch.equal(got[n], want[n])]
    if set(got) != set(want) or bad:
        raise AssertionError(f"{label}: not bitwise equal at {bad[:4]} "
                             f"({len(bad)} of {len(want)})")


def _snapshot_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir())


def _flash_launches(histories, launches, label, exact=True):
    """K1 = sum k (12 + recomputed layers), K2 = K3 = sum 12 k over the
    runs' steps (``exact``), else each > 0; never an FMA launch."""
    fwd = sum(s.microbatches * (12 + s.recompute_dec_layers)
              for h in histories for s in h)
    bwd = sum(12 * s.microbatches for h in histories for s in h)
    ok = (all(launches[k] > 0 for k in FLASH_KERNELS)
          and all(launches[k] == 0 for k in FMA_OF.values()))
    if exact:
        ok = ok and (launches["flash_fwd"] == fwd
                     and launches["flash_bwd_dq"]
                     == launches["flash_bwd_dkv"] == bwd)
    log(f"{label} launches: " + json.dumps(
        {k: launches[k] for k in FLASH_KERNELS + list(FMA_OF.values())})
        + (f" (K1 = {fwd}, K2 = K3 = {bwd} expected)" if exact else ""))
    if not ok:
        raise AssertionError(f"{label}: launches {launches}")
    return {k: launches[k] for k in FLASH_KERNELS}


def run_kill_and_resume(args, budget_mb, batches):
    """R1: 16 uninterrupted steps (run A) against 8 steps, a snapshot,
    every object dropped, fresh ones restored from it, and batches 8-15
    (run B): losses and final parameters bitwise equal, no collection
    or refit after the restore, one restored plan per bucket A planned
    in its first 8 steps.  Then the launcher drill in two subprocesses."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.train.resilience import SnapshotManager
    half = RESUME_STEPS // 2
    ops.reset_launches()
    tr = _bert_trainer(args, budget_mb)
    tr.run(batches)
    hist = [tr.history]
    losses_a = [s.loss for s in tr.history]
    params_a = _host_copy(tr.params)
    buckets = len({s.bucket for s in tr.history[:half]})
    del tr
    _free()
    tr = _bert_trainer(args, budget_mb)
    st = tr.run(batches[:half])
    hist.append(tr.history)
    losses_b = [s.loss for s in tr.history]
    with tempfile.TemporaryDirectory() as tmp:
        sm = SnapshotManager(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = tr.save_snapshot(st, sm)
        save_s = time.perf_counter() - t0
        nbytes = _snapshot_bytes(path)
        del tr, st
        _free()
        tr = _bert_trainer(args, budget_mb, seed=1)
        t0 = time.perf_counter()
        st, r = tr.restore(tr.optimizer.init(tr.params), sm)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    st = tr.run(batches[r.data_cursor:], st)
    hist.append(tr.history)
    torch.cuda.synchronize()
    launches = _flash_launches(hist, dict(ops.LAUNCHES), "R1")
    losses_b += [s.loss for s in tr.history]
    stats = tr.planner.stats
    checks = {
        "losses bitwise equal": losses_b == losses_a,
        "restored at step and cursor 8": r.step == r.data_cursor == half,
        "collections == 0 after the restore": stats["collections"] == 0,
        "refits == 0 after the restore": stats["refits"] == 0,
        f"restored_plans == {buckets} buckets of A's first {half} steps":
            stats["restored_plans"] == buckets,
        "summary restores == 1": tr.summary()["restores"] == 1,
    }
    res = {"snapshot_bytes": nbytes, "save_s": save_s,
           "restore_s": restore_s, "buckets": buckets,
           "planner_summary": r.planner_summary, "launches": launches}
    log(f"R1 kill and resume (bert, {RESUME_STEPS} steps vs {half} + "
        f"snapshot + {half}): snapshot {nbytes} bytes, save "
        f"{save_s:.3f} s, restore {restore_s:.3f} s, planner "
        f"{r.planner_summary}; losses A {losses_a} B {losses_b}; checks "
        + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"R1 checks failed: {checks}")
    _bitwise("R1 final parameters", _host_copy(tr.params), params_a)
    del tr, st
    _free()
    res["drill"] = run_launcher_drill(args, budget_mb)
    return res


def run_launcher_drill(args, budget_mb):
    """``launch.train`` with a snapshot every 6 steps and the first 2
    executions failing (injected), then the same command with
    ``--resume`` and ``--save``: two subprocesses, each with one card;
    the saved parameters load back (``checkpoint.load``, strict) equal,
    bit for bit, to the resumed run's final snapshot's."""
    import ast
    import os
    import tempfile
    from repro_torch.train import checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        saved = os.path.join(tmp, "final.pt")
        argv = [sys.executable, "-m", "repro_torch.launch.train",
                "--arch", args["arch"], "--dataset", args["dataset"],
                "--planner", "mimose", "--attn-impl", "flash",
                "--budget-mb", f"{budget_mb:.3f}",
                "--steps", str(DRILL_STEPS),
                "--batch-size", str(args["batch_size"]),
                "--quantum", str(args["quantum"]),
                "--checkpoint-dir", tmp, "--checkpoint-every-steps",
                str(DRILL_STEPS // 2)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = {}
        for name, extra in (("first", ["--inject-oom", "2"]),
                            ("resumed", ["--resume", "--save", saved])):
            log("R1 drill: python -m repro_torch.launch.train "
                + " ".join(argv[3:] + extra))
            t0 = time.perf_counter()
            proc = subprocess.run(argv + extra, cwd=ROOT, env=env,
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"R1 drill ({name}) exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            lines = proc.stdout.splitlines()
            summ = next(ln for ln in lines if ln.startswith("summary:"))
            out[name] = {"s": time.perf_counter() - t0,
                         "summary": ast.literal_eval(summ[len("summary:"):]
                                                     .strip()),
                         "lines": [ln for ln in lines
                                   if ln.startswith(("resumed", "resilience",
                                                     "snapshot"))]}
            log(f"R1 drill ({name}, {out[name]['s']:.1f} s): "
                + " | ".join(out[name]["lines"]))
        final = sorted(d for d in os.listdir(tmp) if d.startswith("snap-"))[-1]
        want = torch.load(os.path.join(tmp, final, "params.ckpt"),
                          map_location="cpu", weights_only=True)["leaves"]
        got = checkpoint.load(saved, want)
        same_save = all(torch.equal(got[n], t) for n, t in want.items())
        log(f"R1 drill --save: {len(got)} tensors, "
            f"{os.path.getsize(saved)} bytes, loaded back bitwise equal to "
            f"{final}'s parameters: {same_save}")
    first = out["first"]["summary"]
    checks = {
        "first run: oom_events == 2": first.get("oom_events") == 2,
        "first run: escalations == 2, one retry success":
            first.get("escalations") == 2
            and first.get("retry_successes") == 1,
        f"resumed at cursor {DRILL_STEPS}": any(
            f"at step {DRILL_STEPS} (cursor={DRILL_STEPS}," in ln
            for ln in out["resumed"]["lines"]),
        "--save loads back equal to the final snapshot": same_save,
    }
    log("R1 drill checks: " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"R1 drill checks failed: {checks}")
    return {k: {"s": v["s"], "oom_events": v["summary"].get("oom_events"),
                "snapshots_written": v["summary"].get("snapshots_written")}
            for k, v in out.items()}


def run_parked_resume(args, batches):
    """R2: the fixed plan with every unit OFFLOAD but the last, whose
    moments are parked on the host: 4 uninterrupted steps against 2, a
    snapshot taken with the moments parked, fresh objects restored from
    it, and 2 more: losses, parameters and moments bitwise equal."""
    import tempfile

    from repro_torch.actions import Action
    from repro_torch.kernels import ops
    from repro_torch.train.resilience import SnapshotManager
    n = path_config(args).num_layers
    acts = (Action.OFFLOAD,) * (n - 1) + (Action.OFFLOAD_OPT,)
    half = PARKED_STEPS // 2
    ops.reset_launches()
    tr = _bert_trainer(args, 0.0, actions=acts)
    st = tr.run(batches[:PARKED_STEPS])
    hist = [tr.history]
    want = ([s.loss for s in tr.history], _host_copy(tr.params),
            _host_copy(st.m), _host_copy(st.v))
    del tr, st
    _free()
    tr = _bert_trainer(args, 0.0, actions=acts)
    st = tr.run(batches[:half])
    hist.append(tr.history)
    losses = [s.loss for s in tr.history]
    parked = sorted(tr._parked)
    on_host = sum(t.device.type == "cpu" for t in st.m.values())
    with tempfile.TemporaryDirectory() as tmp:
        sm = SnapshotManager(tmp)
        path = tr.save_snapshot(st, sm)
        nbytes = _snapshot_bytes(path)
        del tr, st
        _free()
        tr = _bert_trainer(args, 0.0, seed=1, actions=acts)
        st, r = tr.restore(tr.optimizer.init(tr.params), sm)
    reparked = sorted(tr._parked)
    st = tr.run(batches[r.data_cursor:PARKED_STEPS], st)
    hist.append(tr.history)
    torch.cuda.synchronize()
    launches = _flash_launches(hist, dict(ops.LAUNCHES), "R2")
    losses += [s.loss for s in tr.history]
    log(f"R2 parked moments (bert, 11 OFFLOAD + unit {n - 1} OFFLOAD_OPT, "
        f"{PARKED_STEPS} steps vs {half} + snapshot + {half}): parked "
        f"units at the snapshot {parked} ({on_host} moment tensors on the "
        f"host), after the restore {reparked}; snapshot {nbytes} bytes; "
        f"losses {losses} vs {want[0]}")
    if not (parked == reparked == [n - 1] and on_host > 0
            and losses == want[0]):
        raise AssertionError("R2: parked units or losses differ")
    _bitwise("R2 parameters", _host_copy(tr.params), want[1])
    _bitwise("R2 m", _host_copy(st.m), want[2])
    _bitwise("R2 v", _host_copy(st.v), want[3])
    del tr, st
    _free()
    return {"snapshot_bytes": nbytes, "parked_units": parked,
            "launches": launches}


def _peak_step(args, budget_mb, batch, actions, k):
    """One step of a fixed plan on fresh full-width bert: the allocator's
    peak reserved and allocated bytes over it, from an emptied cache."""
    tr = _bert_trainer(args, budget_mb, actions=actions, k=k)
    st = tr.optimizer.init(tr.params)
    _free()
    st, _ = tr.step(st, batch)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_reserved(),
            torch.cuda.max_memory_allocated())
    del tr, st
    _free()
    return peak


def run_real_oom(args, budget_mb, batches):
    """R3: a real ``torch.OutOfMemoryError`` (no injector).  The most
    common bucket's plan and every rung of its ladder are made on a
    planner of their own; one step of the plan and of each rung measures
    its peak reserved bytes; the allocator is capped between the plan's
    peak and the lowest rung's; one step of a trainer restored from a
    pre-step snapshot must OOM, escalate and recover, and equal, bitwise,
    a fresh trainer restored from the same snapshot running the
    escalated plan directly, uncapped."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.obs import Telemetry
    from repro_torch.train.resilience import OOMWatchdog, SnapshotManager
    S, batch = most_common_bucket(batches)
    tr = _bert_trainer(args, budget_mb)
    tb = tr._prepare(batch)
    planner = tr.planner
    planner.plan(tb)
    key = planner.plan_key(tb)
    rungs = [planner.cache[key]]
    while planner.escalate(tb):
        rungs.append(planner.cache[key])
    del tr, planner
    _free()
    peaks = [_peak_step(args, budget_mb, batch, p.actions, p.microbatch)
             for p in rungs]
    mib = 2 ** 20
    desc = [{"rung": i, "k": int(p.microbatch), "n_remat": int(p.n_remat),
             "n_offload": int(p.n_offload),
             "peak_reserved_mib": r / mib, "peak_allocated_mib": a / mib}
            for i, (p, (r, a)) in enumerate(zip(rungs, peaks))]
    log(f"R3 bucket {S}: the planner's plan (rung 0) and its ladder, one "
        f"step each: " + json.dumps(desc))
    plan_peak = peaks[0][0]
    low = min(r for r, _ in peaks[1:])
    if not low < plan_peak:
        raise AssertionError(f"R3: no rung peaks below the plan's "
                             f"{plan_peak / mib:.1f} MiB")
    cap = 0.5 * (plan_peak + low)
    total = torch.cuda.get_device_properties(0).total_memory
    expected = next(i for i, (r, _) in enumerate(peaks) if r < cap)
    with tempfile.TemporaryDirectory() as tmp:
        sm = SnapshotManager(tmp)
        tr = _bert_trainer(args, budget_mb)
        sm.save(step=0, params=tr.params,
                opt_state=tr.optimizer.init(tr.params))
        del tr
        _free()
        tel = Telemetry.enabled()
        tr = _bert_trainer(args, budget_mb, seed=1, telemetry=tel,
                           watchdog=OOMWatchdog(max_retries=len(rungs)))
        if tr.watchdog.injector is not None:
            raise AssertionError("R3 runs with no injector")
        st, _ = tr.restore(tr.optimizer.init(tr.params), sm)
        _free()
        ops.reset_launches()
        log(f"R3 cap: {cap / mib:.1f} MiB ({cap / total:.5f} of "
            f"{total / mib:.0f} MiB) between the plan's peak "
            f"{plan_peak / mib:.1f} MiB and the lowest rung's "
            f"{low / mib:.1f} MiB; rung {expected} is the first under it")
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            st, loss = tr.step(st, batch)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        launches = _flash_launches([], dict(ops.LAUNCHES), "R3", exact=False)
        ev = tel.events.tail()
        wd = tr.watchdog.stats
        level = tr.planner._escalation.get(key, 0)
        plan = tr.planner.cache[key]
        got = (loss, _host_copy(tr.params))
        errors = [e["error"] for e in ev if e["kind"] == "oom"]
        reached = {"rung": level, "k": int(plan.microbatch),
                   "n_remat": int(plan.n_remat),
                   "n_offload": int(plan.n_offload),
                   "peak_allocated_mib": tr.history[-1].max_memory_bytes
                   / mib}
        log(f"R3 capped step: loss {loss}; watchdog {dict(wd)}; oom "
            f"errors {errors}; rung reached " + json.dumps(reached)
            + f"; events " + json.dumps(
                [e["kind"] for e in ev
                 if e["kind"] in ("oom", "plan_poisoned", "escalation")]))
        del tr, st
        _free()
        tr = _bert_trainer(args, budget_mb, seed=2, actions=plan.actions,
                           k=plan.microbatch)
        st, _ = tr.restore(tr.optimizer.init(tr.params), sm)
        st, loss_direct = tr.step(st, batch)
        torch.cuda.synchronize()
        direct = _host_copy(tr.params)
        del tr, st
        _free()
    checks = {
        "oom_events >= 1": wd["oom_events"] >= 1,
        "every OOM a torch.OutOfMemoryError": bool(errors) and all(
            e == "OutOfMemoryError" for e in errors)
        and len(errors) == wd["oom_events"],
        "escalations == oom_events": wd["escalations"] == wd["oom_events"],
        "retry_successes == 1, retry_failures == 0":
            wd["retry_successes"] == 1 and wd["retry_failures"] == 0,
        "rung reached == escalations": level == wd["escalations"],
        "loss bitwise equal to the direct run": got[0] == loss_direct,
    }
    log("R3 checks: " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"R3 checks failed: {checks}")
    _bitwise("R3 parameters against the direct run", got[1], direct)
    return {"bucket": S, "plan_peak_mib": plan_peak / mib,
            "lowest_rung_peak_mib": low / mib, "cap_mib": cap / mib,
            "expected_rung": expected, "reached": reached,
            "oom_events": int(wd["oom_events"]), "ladder": desc,
            "launches": launches}


def run_resilience_path(args, budget_mb):
    """R1-R3 on the bert main path's batches, deterministic algorithms
    on; returns each phase's flash launches."""
    batches = main_path_batches(dict(args, steps=RESUME_STEPS))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        r1 = run_kill_and_resume(args, budget_mb, batches)
        r1["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r2 = run_parked_resume(args, batches)
        r2["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r3 = run_real_oom(args, budget_mb, batches)
        r3["s"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    log("resilience: " + json.dumps({"card": card_line(), "R1": r1,
                                     "R2": r2, "R3": r3}))
    return {k: sum(r["launches"][k] for r in (r1, r2, r3))
            for k in FLASH_KERNELS}


# ---------------------------------------------------------------------------
# the SSD chunk scan and the DMA copy against their plain versions
# ---------------------------------------------------------------------------

# (B, S, H, P, N, chunk, dtype): the reference's SSD_CASES
# (tests/test_kernels.py), plus the reduced mamba2's shape; dt has x's
# dtype, as there.  The main path's buckets are added at run time.
SSD_CASES = [
    (1, 64, 2, 16, 8, 16, "float32"),
    (2, 128, 4, 32, 16, 32, "float32"),
    (1, 100, 2, 16, 8, 32, "float32"),          # padding path
    (1, 128, 1, 64, 32, 64, "float32"),
    (1, 64, 2, 16, 8, 16, "bfloat16"),
    (2, 96, 32, 16, 16, 16, "float32"),         # reduced mamba2
]
# |kernel - plain| <= atol + rtol |plain| on valid rows, the reference's
# tolerances (tests/test_kernels.py): fp32 sums in another order; one
# bf16 rounding of y
SSD_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, 2e-1)}


def _ssd_inputs(B, S, H, P, N, dtype, dt_dtype=None, seed=0):
    """The reference test's distributions: x, B, C ~ N(0, 1); dt =
    softplus(N(0, 1)); A = -exp(0.3 N(0, 1))."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = rnd(B, S, H, P).to(dt_)
    dt = torch.nn.functional.softplus(rnd(B, S, H)).to(
        getattr(torch, dt_dtype or dtype))
    A = -torch.exp(rnd(H) * 0.3)
    return x, dt, A, rnd(B, S, N).to(dt_), rnd(B, S, N).to(dt_)


def _ssd_valid(y, lens):
    return torch.cat([y[b, :L].reshape(-1) for b, L in enumerate(lens)])


def _launched(ops, before):
    """The kernels launched since ``before`` (a copy of ``ops.LAUNCHES``)."""
    return sorted(k for k in ops.LAUNCHES if ops.LAUNCHES[k] != before[k])


# The hi/lo split, on the card: the tensor-core kernel against the FMA
# kernel (fp32 throughout) on the same bf16 inputs of a main-path bucket,
# each y rounded once to bf16.  With ~16 mantissa bits kept, a few
# outputs differ by one bf16 ulp (more only where |y| is near 0); with
# the lo halves dropped (one bf16 rounding of w, the carried state and
# the decayed x) many differ, by many ulps.  At one main-width head
# group (L = 390 of 448), against the fp32 recurrence, the CPU
# emulation of the kernel's arithmetic (tests/test_torch_kernels.py::
# test_chip_smoke_split_check_tells_split_from_no_split) gives 0.12 %
# differing and 0.010 % by more than one ulp with the split; 34 % and
# 5.5 % without.
SPLIT_MAX_SHARE = {"differ": 1e-2, "over_one_ulp": 1e-3}


def bf16_ulp_gap(a, b):
    """|a - b| in bf16 units in the last place, for tensors of bf16
    values (their order as integers; +0 and -0 are one value)."""
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def split_shares(y, y_ref):
    """The shares of outputs of ``y`` that differ from ``y_ref`` and that
    differ by more than one bf16 ulp, and the largest gap in ulps."""
    gap = bf16_ulp_gap(y, y_ref)
    return {"differ": float((gap > 0).float().mean()),
            "over_one_ulp": float((gap > 1).float().mean()),
            "max_ulp": int(gap.max())}


def _ssd_split_check(ssd, case, lens):
    B, S, H, P, N, chunk, dtype = case
    Sp = -(-S // chunk) * chunk              # the kernels take whole chunks
    x, dt, A, Bm, Cm = _ssd_inputs(B, Sp, H, P, N, dtype, "float32", seed=6)
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    y_tc = ssd.ssd_scan_tc(x, dt, A, Bm, Cm, kvl, chunk)
    y_fma = ssd.ssd_scan_fma(x, dt, A, Bm, Cm, kvl, chunk)
    share = split_shares(_ssd_valid(y_tc, lens), _ssd_valid(y_fma, lens))
    log(f"ssd check hi/lo split {case} lens={lens}: ssd_scan against "
        f"ssd_scan_fma, outputs differing {share['differ']:.3e}, by more "
        f"than one bf16 ulp {share['over_one_ulp']:.3e} (at most "
        f"{SPLIT_MAX_SHARE}), largest gap {share['max_ulp']} ulp")
    if any(share[k] > limit for k, limit in SPLIT_MAX_SHARE.items()):
        raise AssertionError("the tensor-core kernel departs from the FMA "
                             "kernel more than its hi/lo split allows")


def _ssd_bitwise(ops, B, S, H, P, N, chunk, dtype, L, kernel):
    """Padded with kv_len against the unpadded call, on ``kernel``
    (tests/test_ragged.py::test_ssd_ragged_bitwise_matches_unpadded_kernel)."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, dtype, seed=1)
    before = dict(ops.LAUNCHES)
    padded = ops.ssd_scan(x, dt, A, Bm, Cm,
                          torch.full((B,), L, dtype=torch.int32,
                                     device="cuda"), chunk=chunk)
    exact = ops.ssd_scan(x[:, :L], dt[:, :L], A, Bm[:, :L], Cm[:, :L],
                         chunk=chunk)
    torch.cuda.synchronize()
    ran = _launched(ops, before)
    if ran != [kernel]:
        raise AssertionError(f"bitwise check meant for {kernel} ran {ran}")
    if not torch.equal(padded[:, :L], exact):
        raise AssertionError(f"{kernel} padded with kv_len differs bitwise "
                             f"from the unpadded call")
    first_skipped = -(-L // chunk) * chunk
    if bool(padded[:, first_skipped:].any()):
        raise AssertionError(f"{kernel} rows of skipped chunks are not 0")
    log(f"ssd check {kernel} (B={B} S={S} H={H} P={P} N={N} Q={chunk} "
        f"{dtype}, L={L}): padded with kv_len == unpadded, bit for bit; "
        f"skipped chunks zero")


def check_ssd(ops, ssd, cases):
    """K4 through ``ops.ssd_scan`` against its plain version on every
    case ((case, lens or None, chunks_per_block, dt dtype or None = x's,
    main path?)); each case must run the kernel ``ssd.uses_tensor_cores``
    names, the main path's the tensor-core kernel; then the hi/lo split
    on the last main case.  Returns the max abs error over the main
    path's cases."""
    main_err, split_case = 0.0, None
    for case, lens, cpb, dt_dtype, main in cases:
        B, S, H, P, N, chunk, dtype = case
        x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, dtype, dt_dtype)
        kvl = (None if lens is None else
               torch.tensor(lens, dtype=torch.int32, device="cuda"))
        before = dict(ops.LAUNCHES)
        y = ops.ssd_scan(x, dt, A, Bm, Cm, kvl, chunk=chunk,
                         chunks_per_block=cpb)
        ran = _launched(ops, before)
        y_p = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, kvl)
        torch.cuda.synchronize()
        valid = lens or [S] * B
        err, over = _err(_ssd_valid(y, valid), _ssd_valid(y_p, valid),
                         *SSD_TOL[dtype])
        log(f"ssd check {case} lens={lens} chunks_per_block={cpb} "
            f"dt={dt_dtype or dtype}: {ran}, max abs err {err:.3e}")
        want = ("ssd_scan" if ssd.uses_tensor_cores(x, Bm, chunk)
                else "ssd_scan_fma")
        if ran != [want] or (main and want != "ssd_scan"):
            raise AssertionError(f"{case} ran {ran}, expected {want}")
        if over > 0:
            raise AssertionError(f"{ran[0]} disagrees with plain on {case}")
        if main:
            main_err = max(main_err, err)
            split_case = (case, lens)
    _ssd_split_check(ssd, *split_case)
    _ssd_bitwise(ops, 1, 96, 2, 16, 8, 16, "float32", 32, "ssd_scan_fma")
    _ssd_bitwise(ops, 2, 448, 8, 64, 128, 64, "bfloat16", 300, "ssd_scan")
    _ssd_bitwise(ops, 2, 448, 8, 50, 16, 64, "bfloat16", 300, "ssd_scan")
    # SSDScan's gradient against autograd through the plain version
    x, dt, A, Bm, Cm = _ssd_inputs(2, 96, 4, 16, 8, "float32", seed=2)
    lens = torch.tensor([50, 96], dtype=torch.int32, device="cuda")
    w = (torch.arange(96, device="cuda")[None, :] < lens[:, None]).float()
    dy = torch.randn(x.shape, device="cuda") * w[:, :, None, None]
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    ref_ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y = ops.ssd_scan(*ins, lens, chunk=16)
    got = torch.autograd.grad(y, ins, dy)
    y_ref = ssd.ssd_scan_plain(*ref_ins, lens)
    want = torch.autograd.grad(y_ref, ref_ins, dy)
    for name, g, r in zip(("x", "dt", "A", "B", "C"), got, want):
        err, over = _err(g, r, 1e-3, 1e-3)
        log(f"ssd gradient d{name}: max abs err {err:.3e}")
        if over > 0:
            raise AssertionError(f"SSDScan d{name} disagrees with autograd "
                                 f"through the plain version")
    return main_err


# (shape, dtype, chunk_elems): tests/test_offload_exec.py's cases
DMA_CASES = [((128,), "float32", 16), ((33,), "float32", 16),
             ((7, 5), "bfloat16", 16), ((1,), "int32", 16)]


def _check_dma_raw(dma):
    """The C entry point on byte counts that are not a multiple of 16,
    into destinations off 16-byte alignment: src and dst 5 bytes off
    (bulk middles, byte-wise ends) and dst alone 3 bytes off (byte by
    byte).  The bytes around the destination must stay untouched."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    for n, src_off, dst_off, chunk in ((100_003, 5, 5, 4096),
                                       (100_003, 0, 3, 4096),
                                       (1_000_001, 13, 13, 65536)):
        src = torch.randint(0, 256, (n + 32,), generator=gen,
                            device="cuda", dtype=torch.int32).to(torch.uint8)
        dst = torch.zeros(n + 32, device="cuda", dtype=torch.uint8)
        dma.build.raise_on(dma.library().dma_copy(
            src.data_ptr() + src_off, dst.data_ptr() + dst_off, n, chunk,
            stream), "dma_copy")
        torch.cuda.synchronize()
        ok = (torch.equal(dst[dst_off:dst_off + n], src[src_off:src_off + n])
              and not bool(dst[:dst_off].any())
              and not bool(dst[dst_off + n:].any()))
        log(f"dma check {n} bytes, src +{src_off}, dst +{dst_off} bytes off "
            f"16-byte alignment, chunk {chunk} bytes: "
            f"{'identical' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError(f"dma_copy wrong on {n} bytes, src "
                                 f"+{src_off}, dst +{dst_off}")


def check_dma(ops, dma, logits_shape):
    """K5 against the identity and its plain version: the reference's
    cases, a source that is not 16-byte aligned, and one logits-sized
    fp32 array at the default chunk; returns the max abs error."""
    cases = []
    for shape, dtype, chunk in DMA_CASES:
        n = math.prod(shape)
        x = torch.arange(n, device="cuda", dtype=torch.float32).to(
            getattr(torch, dtype)).reshape(shape)
        cases.append((f"{shape} {dtype} chunk {chunk}", x, chunk))
    odd = torch.arange(4097, device="cuda", dtype=torch.float32).to(
        torch.bfloat16)[1:]                     # data_ptr 2 bytes off
    cases.append(("(4096,) bfloat16 offset by one element", odd, 100))
    gen = torch.Generator(device="cuda").manual_seed(3)
    big = torch.randn(logits_shape, generator=gen, device="cuda")
    cases.append((f"{tuple(logits_shape)} float32 (logits)", big, 1 << 15))
    _check_dma_raw(dma)
    for name, x, chunk in cases:
        y = ops.residual_dma_copy(x, chunk_elems=chunk)
        y_p = dma.dma_copy_plain(x, chunk)
        torch.cuda.synchronize()
        ok = (y.shape == x.shape and y.dtype == x.dtype
              and torch.equal(y, x) and torch.equal(y, y_p))
        log(f"dma check {name}: {'identical' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError(f"dma_copy is not the identity on {name}")
    return 0.0


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------

# flash kernel instances whose resources are logged: (dtype, head dim)
# -> kernels; bert's fp32 HD 64 and the bf16 HD 80 (stablelm) and HD 256
# (gemma3) instances of the paths, which must use no local memory (bf16
# at 256 runs the wgmma kernels)
RESOURCE_INSTANCES = {
    ("float", 64): ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                    "flash_bwd_dkv_tc_kernel", "flash_fwd_fma_kernel",
                    "flash_bwd_dq_fma_kernel", "flash_bwd_dkv_fma_kernel"),
    **{(dt, hd): ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                  "flash_bwd_dkv_tc_kernel")
       for dt, hd in (("float", 80), ("__nv_bfloat16", 80), ("float", 256))},
    ("__nv_bfloat16", 256): ("flash_fwd_wgmma_kernel",
                             "flash_bwd_dq_wgmma_kernel",
                             "flash_bwd_dkv_wgmma_kernel")}
NO_LOCAL_MEMORY = [("__nv_bfloat16", 80), ("__nv_bfloat16", 256)]
# the SSD tensor-core kernel's instances, (P, N): mamba2's and hymba's
SSD_TC_INSTANCES = [(64, 128), (50, 16)]


def log_flash_resources(kb, fa, lib):
    """Registers, stack and local (spilled) memory per thread of the flash
    kernel instances of ``RESOURCE_INSTANCES`` in the built library, as
    ``cuobjdump -res-usage`` reads them (their shared memory is dynamic,
    so it shows as 0 there), then each instance's launch configuration
    (threads per CTA, dynamic shared memory, registers and local memory
    as the runtime reports them).  Raises if an instance of
    ``NO_LOCAL_MEMORY`` is missing or has a nonzero stack or local
    size."""
    import re
    exe = Path(kb.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(exe), "-res-usage", str(lib)],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    mangled = {"float": "f", "__nv_bfloat16": "13__nv_bfloat16"}
    found = {}
    for name, usage in zip(out, out[1:]):
        for (dt, hd), kernels in RESOURCE_INSTANCES.items():
            for kernel in kernels:
                if f"{kernel}I{mangled[dt]}Li{hd}E" in name:
                    found[(kernel, dt, hd)] = usage.strip()
                    log(f"resources {kernel}<{dt}, {hd}>: {usage.strip()}")
    for dt, hd in NO_LOCAL_MEMORY:
        for kernel in RESOURCE_INSTANCES[(dt, hd)]:
            usage = found.get((kernel, dt, hd))
            sizes = usage and {k: int(v) for k, v in re.findall(
                r"(STACK|LOCAL):(\d+)", usage)}
            if not sizes or any(sizes.values()):
                raise AssertionError(f"{kernel}<{dt}, {hd}>: local memory "
                                     f"in use or not reported ({usage})")
    dtypes = {"float": torch.float32, "__nv_bfloat16": torch.bfloat16}
    for dt, hd in RESOURCE_INSTANCES:
        for entry in FLASH_KERNELS:
            # kernel_config raises where the threads are not the kernel's
            log(f"launch config {entry} <{dt}, {hd}>: "
                f"{fa.kernel_config(entry, hd, dtypes[dt])}")


def log_ssd_resources(kb, lib):
    """Registers and stack per thread of the SSD tensor-core kernel's
    instances (``SSD_TC_INSTANCES``, each with fp32 and bf16 dt) in the
    built library, as ``cuobjdump -res-usage`` reads them; raises if an
    instance is missing or has a nonzero stack or local size."""
    import re
    exe = Path(kb.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(exe), "-res-usage", str(lib)],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    for P, N in SSD_TC_INSTANCES:
        for dt, mangled in (("float", "f"), ("__nv_bfloat16", "13__nv_bfloat16")):
            tag = f"ssd_scan_tc_kernelILi{P}ELi{N}E{mangled}E"
            found = [u.strip() for name, u in zip(out, out[1:]) if tag in name]
            if not found:
                raise AssertionError(f"ssd_scan_tc_kernel<{P}, {N}, {dt}> is "
                                     f"not in {lib.name}")
            log(f"resources ssd_scan_tc_kernel<{P}, {N}, {dt}>: {found[0]}")
            sizes = {k: int(v) for k, v in re.findall(r"(STACK|LOCAL):(\d+)",
                                                      found[0])}
            if not sizes or any(sizes.values()):
                raise AssertionError(f"ssd_scan_tc_kernel<{P}, {N}, {dt}>: "
                                     f"local memory in use or not reported "
                                     f"({found[0]})")


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


def time_flash_kernels(fa, kb, S, lens, H=12, hd=64, Hkv=None,
                       dtype="float32"):
    """Each kernel at a main path's shape (B = len(lens), S, H query and
    Hkv kv heads, hd, ``dtype``, causal, these lengths), with its plain
    version, the library call (``scaled_dot_product_attention``, timed
    here only) and its bound; at the FMA kernels' head dims in fp32 each
    tensor-core kernel in turns with its FMA predecessor (tc, fma, fma,
    tc; each time the mean of its two), else in two turns of its own."""
    import torch.nn.functional as F
    B, Hkv = len(lens), Hkv or H
    dt = getattr(torch, dtype)
    es = torch.finfo(dt).bits // 8
    fma = dtype == "float32" and hd in fa.FMA_HEAD_DIMS
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(heads):
        return torch.randn((B, heads, S, hd), generator=gen,
                           device="cuda").to(dt)
    q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_fwd(q, k, v, kvl, True, 0)
    delta = (do.float() * o.float()).sum(-1)
    lib = fa.library()
    stream = torch.cuda.current_stream().cuda_stream
    dims = (B, H, Hkv, S, hd, 1, 0, 1.0 / math.sqrt(hd),
            fa._DTYPE_CODE[dt], stream)
    o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fwd_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
                o2.data_ptr(), lse2.data_ptr())
    bwd_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), kvl.data_ptr())
    launch = {
        "flash_fwd": lambda: lib.flash_fwd(*fwd_ptrs, *dims),
        "flash_bwd_dq": lambda: lib.flash_bwd_dq(*bwd_ptrs, dq.data_ptr(),
                                                 *dims),
        "flash_bwd_dkv": lambda: lib.flash_bwd_dkv(
            *bwd_ptrs, dk.data_ptr(), dv.data_ptr(), *dims),
    }
    if fma:
        launch.update({
            "flash_fwd_fma": lambda: lib.flash_fwd_fma(*fwd_ptrs, *dims),
            "flash_bwd_dq_fma": lambda: lib.flash_bwd_dq_fma(
                *bwd_ptrs, dq.data_ptr(), *dims),
            "flash_bwd_dkv_fma": lambda: lib.flash_bwd_dkv_fma(
                *bwd_ptrs, dk.data_ptr(), dv.data_ptr(), *dims)})

    # the library yardstick: the same masked attention, forward, and its
    # backward (one autograd call computing dq, dk and dv together), on
    # k and v expanded to the H query heads (made outside the timing)
    pos = torch.arange(S, device="cuda")
    mask = ((pos[:, None] >= pos[None, :])[None]
            & (pos[None, None, :] < kvl[:, None, None]))[:, None]
    ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, ke, ve))

    def lib_fwd():
        return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
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
    # forward, 6 hd for dq (q.k, do.v, ds.k), 8 hd for dk/dv; at the
    # bf16 tensor-core rate, where the kernels run.  Bytes: the
    # inputs (q, do over H heads, k, v over Hkv, lse, delta) over the
    # 64-row tiles that hold valid rows (min(ceil(L / 64) 64, S) rows of
    # each sequence; no tile past kv_len is needed), the lengths once,
    # the outputs (o, lse, dq over H heads, dk, dv over Hkv) in full
    # (rows past the valid tiles are written as zeros), each once
    pairs = H * sum(L * (L + 1) // 2 for L in lens)
    run = sum(min(-(-L // 64) * 64, S) for L in lens)
    q_in, kv_in, rows_in = run * H * hd * es, run * Hkv * hd * es, run * H * 4
    q_out, kv_out, rows_out = (B * S * H * hd * es, B * S * Hkv * hd * es,
                               B * S * H * 4)
    work = {
        "flash_fwd": (4 * hd * pairs, q_in + 2 * kv_in + 4 * B + q_out
                      + rows_out),
        "flash_bwd_dq": (6 * hd * pairs, 2 * q_in + 2 * kv_in + 2 * rows_in
                         + 4 * B + q_out),
        "flash_bwd_dkv": (8 * hd * pairs, 2 * q_in + 2 * kv_in + 2 * rows_in
                          + 4 * B + 2 * kv_out),
    }
    for name, fn in launch.items():
        kb.raise_on(fn(), name)
    out = {}
    shape = (f"B={B} S={S} H={H} Hkv={Hkv} hd={hd} {dtype} "
             f"lens={lens}")
    for name in FLASH_KERNELS:
        turns = {}
        for n in ((name, FMA_OF[name], FMA_OF[name], name) if fma
                  else (name, name)):
            turns.setdefault(n, []).append(_time_ms(launch[n], 20))
        ms = sum(turns[name]) / len(turns[name])
        plain_ms = _time_ms(plain[name], 5)
        flops, nbytes = work[name]
        t_ops = flops / BF16_TC_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms[name],
                         bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes", flops=flops, bytes=nbytes)
        extra = ""
        if fma:
            f = turns[FMA_OF[name]]
            out[name]["fma_ms"] = sum(f) / len(f)
            extra = (f"; FMA kernel {FMA_OF[name]} "
                     f"{out[name]['fma_ms']:.4f} ms (turns {f[0]:.4f}, "
                     f"{f[1]:.4f}), bound at the 67 TFLOP/s fp32 rate "
                     f"{max(flops / FP32_FLOPS * 1e3, t_bytes):.4f} ms")
        log(f"timing {name} {shape}: kernel {ms:.4f} ms (turns "
            f"{turns[name][0]:.4f}, {turns[name][1]:.4f}){extra}, plain "
            f"{plain_ms:.4f} ms, library {lib_ms[name]:.4f} ms, bound "
            f"{max(t_ops, t_bytes):.4f} ms ({out[name]['bound_by']}; "
            f"{flops / 1e9:.3f} GFLOP at 989 TFLOP/s = {t_ops:.4f} ms, "
            f"{nbytes / 1e6:.2f} MB at 3.35 TB/s = {t_bytes:.4f} ms), "
            f"{flops / ms / 1e9:.2f} TFLOP/s achieved")
    bwd = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    log(f"timing backward {shape}: K2 + K3 {bwd:.4f} ms against the "
        f"library backward (dq, dk, dv) {lib_ms['flash_bwd_dq']:.4f} ms, "
        f"{bwd / lib_ms['flash_bwd_dq']:.3f}x")
    return out


def _ssd_work(cfg, lens, x, dt, A, Bm, kvl, y):
    """K4's work on these inputs: (FLOPs, bytes, rows run, ms at the bf16
    tensor-core rate, ms at the memory rate).  FLOPs on the valid
    positions (``_ssm_flops``' scan term); x, dt, B and C over the chunks
    the kernel runs (ceil(len / Q) Q rows of each sequence; skipped
    chunks are never read), A and the lengths once, y in full (skipped
    rows are written as zeros)."""
    from repro_torch.launch.roofline import ssd_scan_flops_per_position
    Q, (H, P), N = cfg.ssm_chunk, x.shape[2:], Bm.shape[-1]
    flops = sum(lens) * ssd_scan_flops_per_position(cfg)
    rows = sum(-(-L // Q) * Q for L in lens)
    nbytes = (rows * (H * P * x.element_size() + H * dt.element_size()
                      + 2 * N * Bm.element_size())
              + A.numel() * A.element_size() + kvl.numel() * kvl.element_size()
              + y.numel() * y.element_size())
    return (flops, nbytes, rows, flops / BF16_TC_FLOPS * 1e3,
            nbytes / HBM_BYTES_PER_S * 1e3)


def time_ssd(ssd, kb, cfg, S, lens):
    """K4 at the mamba2 main path's shape (B = len(lens), S padded to the
    chunk, H, P, N, Q of the config, bf16 x/B/C, fp32 dt, these
    lengths): the tensor-core kernel and the FMA kernel in turns (tc,
    fma, fma, tc; each time the mean of its two), beside the plain
    version and the plain ``ssd_chunked`` forward; no single PyTorch call
    computes the scan, so no library time.  The bound counts the
    function's work on the valid positions (``_ssm_flops``' scan term) at
    the bf16 tensor-core rate, and its inputs over the chunks it runs and
    its output in full, each once; the bound at the fp32 CUDA-core rate
    of earlier runs is logged beside it."""
    from repro_torch.models.mamba2 import mamba2_dims, mask_dt, ssd_chunked
    B, Q, P = len(lens), cfg.ssm_chunk, cfg.ssm_head_dim
    _, H, N, _ = mamba2_dims(cfg)
    Sp = -(-S // Q) * Q
    x, dt, A, Bm, Cm = _ssd_inputs(B, Sp, H, P, N, "bfloat16", "float32",
                                   seed=4)
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    lib = ssd.library()
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), kvl.data_ptr(), y.data_ptr(), B, Sp, H, P, N, Q,
            1, 0, torch.cuda.current_stream().cuda_stream)
    kernels = {"ssd_scan": lambda: lib.ssd_scan(*args),
               "ssd_scan_fma": lambda: lib.ssd_scan_fma(*args)}
    for name, fn in kernels.items():
        kb.raise_on(fn(), name)
    turns = {name: [] for name in kernels}
    for name in ("ssd_scan", "ssd_scan_fma", "ssd_scan_fma", "ssd_scan"):
        turns[name].append(_time_ms(kernels[name], 20))
    ms, fma_ms = (sum(turns[n]) / 2 for n in ("ssd_scan", "ssd_scan_fma"))
    plain_ms = _time_ms(lambda: ssd.ssd_scan_plain(x, dt, A, Bm, Cm, kvl), 3)
    chunked_ms = _time_ms(lambda: ssd_chunked(x, mask_dt(dt, kvl), A, Bm,
                                              Cm, Q), 5)
    # SSDScan's backward: ssd_chunked recomputed under autograd and its
    # vector-Jacobian product, once per layer per step
    dy = torch.randn_like(x)
    ctx = SimpleNamespace(saved_tensors=(x, dt, A, Bm, Cm, kvl), chunk=Q)
    backward_ms = _time_ms(lambda: ssd.SSDScan.backward(ctx, dy), 5)
    flops, nbytes, rows, t_ops, t_bytes = _ssd_work(cfg, lens, x, dt, A, Bm,
                                                    kvl, y)
    fp32_bound_ms = max(flops / FP32_FLOPS * 1e3, t_bytes)
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=None, fma_ms=fma_ms,
               chunked_ms=chunked_ms, backward_ms=backward_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"timing ssd_scan B={B} S={Sp} H={H} P={P} N={N} Q={Q} bf16 (dt "
        f"fp32) lens={lens}: tensor-core kernel {ms:.4f} ms "
        f"({turns['ssd_scan'][0]:.4f}, {turns['ssd_scan'][1]:.4f}), FMA "
        f"kernel {fma_ms:.4f} ms ({turns['ssd_scan_fma'][0]:.4f}, "
        f"{turns['ssd_scan_fma'][1]:.4f}), plain {plain_ms:.4f} ms, "
        f"ssd_chunked {chunked_ms:.4f} ms, SSDScan backward (ssd_chunked "
        f"recompute and its vjp) {backward_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}; {flops / 1e9:.3f} "
        f"GFLOP at 989 TFLOP/s bf16 = {t_ops:.4f} ms, {nbytes / 1e6:.2f} "
        f"MB ({rows} of {B * Sp} rows run) at 3.35 TB/s = {t_bytes:.4f} "
        f"ms; at the 67 TFLOP/s fp32 rate "
        f"of earlier runs {fp32_bound_ms:.4f} ms), {flops / ms / 1e9:.2f} "
        f"TFLOP/s achieved (FMA kernel {flops / fma_ms / 1e9:.2f})")
    return out


def check_ssd_hymba(ops, ssd, kb, cfg, S, lens):
    """K4 at hymba's SSD shape (B = len(lens), S padded to the chunk, H =
    64, P = 50, N = 16, Q = 64, bf16 x/B/C, fp32 dt, these lengths)
    through ``ops.ssd_scan``: it must launch the tensor-core kernel once
    and agree with the plain version within ``SSD_TOL``, and with the
    FMA kernel in bf16 ulps (``_ssd_split_check``); then the tensor-core
    and FMA kernels timed in turns (tc, fma, fma, tc; each time the mean
    of its two) beside the plain version, ``ssd_chunked`` and the bound
    (no library call)."""
    from repro_torch.models.mamba2 import mamba2_dims, mask_dt, ssd_chunked
    B, Q, P = len(lens), cfg.ssm_chunk, cfg.ssm_head_dim
    _, H, N, _ = mamba2_dims(cfg)
    Sp = -(-S // Q) * Q
    x, dt, A, Bm, Cm = _ssd_inputs(B, Sp, H, P, N, "bfloat16", "float32",
                                   seed=7)
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = dict(ops.LAUNCHES)
    y = ops.ssd_scan(x, dt, A, Bm, Cm, kvl, chunk=Q)
    ran = _launched(ops, before)
    n_launch = ops.LAUNCHES["ssd_scan"] - before["ssd_scan"]
    y_p = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, kvl)
    torch.cuda.synchronize()
    err, over = _err(_ssd_valid(y, lens), _ssd_valid(y_p, lens),
                     *SSD_TOL["bfloat16"])
    log(f"ssd check hymba (B={B} S={Sp} H={H} P={P} N={N} Q={Q} bf16, dt "
        f"fp32) lens={lens}: {ran} x{n_launch}, max abs err {err:.3e} "
        f"(rtol, atol {SSD_TOL['bfloat16']})")
    if ran != ["ssd_scan"] or n_launch != 1 or over > 0:
        raise AssertionError(f"K4 at hymba's shape: ran {ran} x{n_launch}, "
                             f"tolerance miss {over:.3e}")
    _ssd_split_check(ssd, (B, Sp, H, P, N, Q, "bfloat16"), lens)
    lib = ssd.library()
    out = torch.empty_like(x)
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), kvl.data_ptr(), out.data_ptr(), B, Sp, H, P, N, Q,
            1, 0, torch.cuda.current_stream().cuda_stream)
    kernels = {"ssd_scan": lambda: lib.ssd_scan(*args),
               "ssd_scan_fma": lambda: lib.ssd_scan_fma(*args)}
    for name, fn in kernels.items():
        kb.raise_on(fn(), name)
    turns = {name: [] for name in kernels}
    for name in ("ssd_scan", "ssd_scan_fma", "ssd_scan_fma", "ssd_scan"):
        turns[name].append(_time_ms(kernels[name], 20))
    ms, fma_ms = (sum(turns[n]) / 2 for n in ("ssd_scan", "ssd_scan_fma"))
    plain_ms = _time_ms(lambda: ssd.ssd_scan_plain(x, dt, A, Bm, Cm, kvl), 3)
    chunked_ms = _time_ms(lambda: ssd_chunked(x, mask_dt(dt, kvl), A, Bm,
                                              Cm, Q), 5)
    flops, nbytes, rows, t_ops, t_bytes = _ssd_work(cfg, lens, x, dt, A, Bm,
                                                    kvl, out)
    fp32_ops = flops / FP32_FLOPS * 1e3
    res = dict(ms=ms, fma_ms=fma_ms, plain_ms=plain_ms,
               chunked_ms=chunked_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               max_abs_err=err)
    log(f"timing ssd_scan hymba B={B} S={Sp} H={H} P={P} N={N} Q={Q} bf16 "
        f"(dt fp32): tensor-core kernel {ms:.4f} ms ({turns['ssd_scan'][0]:.4f}"
        f", {turns['ssd_scan'][1]:.4f}), FMA kernel {fma_ms:.4f} ms "
        f"({turns['ssd_scan_fma'][0]:.4f}, {turns['ssd_scan_fma'][1]:.4f}), "
        f"plain {plain_ms:.4f} ms, ssd_chunked {chunked_ms:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}; {flops / 1e9:.3f} "
        f"GFLOP at 989 TFLOP/s bf16 = {t_ops:.4f} ms, {nbytes / 1e6:.2f} MB "
        f"({rows} of {B * Sp} rows run) at 3.35 TB/s = {t_bytes:.4f} ms; the "
        f"FMA kernel's own ceiling, 67 TFLOP/s fp32: "
        f"{max(fp32_ops, t_bytes):.4f} ms), {flops / ms / 1e9:.2f} TFLOP/s "
        f"achieved (FMA kernel {flops / fma_ms / 1e9:.2f})")
    return res


def check_model_at_depth(args, batch, rtol, layers=2):
    """``check_model`` and ``check_mixers`` on a full-width
    ``args["arch"]`` cut to ``layers`` layers (an encoder-decoder:
    ``layers`` encoder and ``layers`` decoder layers; its own seeded
    weights), freed after; the loss under each control of ``_controls``
    must miss ``rtol`` too, so the loss check is shown able to fail."""
    from repro_torch.models.lm import LM
    base = path_config(args)
    cfg = path_config(args, num_layers=layers, **(
        {"encoder_layers": layers} if base.encoder_layers else {}))
    lm = LM(cfg, attn_impl="flash", device="cuda")
    kernel, plain = check_model(lm, batch, args["quantum"], rtol)
    gaps = {n: abs(v - plain) / abs(plain) for n, v in check_mixers(
        lm, batch, args["quantum"], MIXER_RTOL).items()}
    log(f"loss check {cfg.name}: |kernels - plain| / |plain| "
        f"{abs(kernel - plain) / abs(plain):.3e}; under the controls "
        + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items())
        + f" (limit {rtol})")
    blind = [n for n, g in gaps.items() if g <= rtol]
    if blind:
        raise AssertionError(f"{cfg.name}: the loss check does not tell "
                             f"the controls {blind} from the kernels")
    del lm
    gc.collect()
    torch.cuda.empty_cache()


def check_plans_equal_keep(args, batch, plans, layers=6, chunks=2):
    """Checkpointing and the transfer lane change no value: full-width
    ``args["arch"]`` at ``layers`` layers (an encoder-decoder: ``layers``
    encoder and ``layers`` decoder layers) in ``chunks`` scan chunks, one
    batch under all-KEEP and under each plan of ``plans`` ({name:
    fn(n_encoder_units, n_decoder_units) -> actions}; deterministic
    algorithms on): loss, aux and every gradient (the encoder's
    included) equal KEEP's, bitwise or within ``OFFLOAD_TOL``, the lane
    moved exactly each OFFLOAD layer's input out and back, and each
    plan's launches meet K1 = L + recomputed decoder layers, K2 = K3 =
    L."""
    from repro_torch.actions import Action
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM
    base = path_config(args)
    cfg = path_config(args, num_layers=layers, scan_chunks=chunks, **(
        {"encoder_layers": layers} if base.encoder_layers else {}))
    lm = LM(cfg, attn_impl="flash", device="cuda")
    b = _device_batch(batch, args["quantum"])
    B, S = b["tokens"].shape
    stream = {"encoder.blocks": b["frames"].shape[1] if "frames" in b
              else 0, "blocks": lm.unit_input_shape(
                  lm.plan_units(b)[-1], b)[1]}
    ne, nd = cfg.encoder_layers, len(lm.unit_bounds())
    el = torch.empty((), dtype=lm.dtype).element_size()
    out, moved, want, k1 = {}, {}, {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, fn in {"KEEP": lambda e, d: (Action.KEEP,) * (e + d),
                         **plans}.items():
            acts = fn(ne, nd)
            lm.lane().reset_stats()
            ops.reset_launches()
            loss, m = lm.loss(b, acts)
            loss.backward()
            torch.cuda.synchronize()
            rec = sum(e - s_ for a, (stack, s_, e)
                      in zip(acts, lm.plan_unit_layers())
                      if stack == "blocks"
                      and a in (Action.REMAT, Action.OFFLOAD))
            k1[name] = (ops.LAUNCHES["flash_fwd"], layers + rec)
            if not (ops.LAUNCHES["flash_fwd"] == layers + rec
                    and ops.LAUNCHES["flash_bwd_dq"]
                    == ops.LAUNCHES["flash_bwd_dkv"] == layers):
                raise AssertionError(f"{name}: launches {ops.LAUNCHES}, "
                                     f"not K1 = {layers} + {rec}, K2 = "
                                     f"K3 = {layers}")
            out[name] = (loss.detach().clone(), m["aux"].detach().clone(),
                         {n: p.grad.clone()
                          for n, p in lm.named_parameters()})
            lm.zero_grad(set_to_none=True)
            moved[name] = lm.lane().reset_stats()
            want[name] = sum(
                (e - s_) * B * stream[stack] * cfg.d_model * el
                for a, (stack, s_, e) in zip(acts, lm.plan_unit_layers())
                if a is Action.OFFLOAD)
    finally:
        torch.use_deterministic_algorithms(False)
    keep = out["KEEP"]
    res = {"aux": float(keep[1])}
    for name in plans:
        got = out[name]
        e_loss = max(_same_or_close(f"{name} loss", got[0], keep[0],
                                    OFFLOAD_TOL["loss"]),
                     _same_or_close(f"{name} aux", got[1], keep[1],
                                    OFFLOAD_TOL["loss"]))
        e_grad = max(_same_or_close(f"{name} grad {n}", g, keep[2][n],
                                    OFFLOAD_TOL["grads"])
                     for n, g in got[2].items())
        res[name] = {"bitwise": e_loss == 0.0 and e_grad == 0.0,
                     "loss_err": e_loss, "grad_err": e_grad,
                     "lane_bytes_out": int(moved[name]["bytes_out"]),
                     "offloaded_inputs": int(want[name]),
                     "K1": k1[name][0]}
        if not (moved[name]["bytes_out"] == moved[name]["bytes_in"]
                == want[name]):
            raise AssertionError(f"{name}: the lane moved {moved[name]}, "
                                 f"not the offloaded inputs' {want[name]} "
                                 f"bytes")
    log(f"plan equality {cfg.name} ({ne} + {layers} layers, {nd} decoder "
        f"units, B={B} S={S}): loss {float(keep[0]):.7f}, aux "
        f"{float(keep[1]):.7f} under KEEP; against KEEP (tolerances "
        f"{OFFLOAD_TOL}): " + json.dumps({n: res[n] for n in plans}))
    if lm.kind == "moe" and not (keep[1] > 0 and torch.isfinite(keep[1])):
        raise AssertionError(f"aux is not finite and > 0: {float(keep[1])}")
    del lm, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _rel(a, b, lens):
    """|a - b|_F / |b|_F over the valid rows of (B, S, d) outputs."""
    a = torch.cat([a[i, :L] for i, L in enumerate(lens)]).float()
    b = torch.cat([b[i, :L] for i, L in enumerate(lens)]).float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("mixer output is not finite")
    return float((a - b).norm() / b.norm())


class _swapped:
    """Context: each tensor of ``pairs`` holds its control value."""

    def __init__(self, pairs):
        self.pairs = pairs

    def __enter__(self):
        self.saved = [t.detach().clone() for t, _ in self.pairs]
        with torch.no_grad():
            for t, v in self.pairs:
                t.copy_(v)

    def __exit__(self, *exc):
        with torch.no_grad():
            for (t, _), v in zip(self.pairs, self.saved):
                t.copy_(v)


class _config_swapped:
    """Context: ``lm.cfg`` with the fields ``over`` changed."""

    def __init__(self, lm, **over):
        self.lm, self.over = lm, over

    def __enter__(self):
        import dataclasses
        self.saved = self.lm.cfg
        self.lm.cfg = dataclasses.replace(self.saved, **self.over)

    def __exit__(self, *exc):
        self.lm.cfg = self.saved


def _controls(lm, layers):
    """{name: context manager} of the controls over the decoder layers
    ``layers``: the kv heads rolled by one (each query head reads the
    wrong kv head; the self attention's); for the hybrid mixer its SSD
    half skipped (``ssm_scale`` 0); for an encoder-decoder the cross
    attention fed a zero encoder output (the encoder's final norm scale
    0); for M-RoPE plain RoPE over ``arange(S)`` instead."""
    hd = lm.cfg.resolved_head_dim()
    attn = [lm.blocks[i]["mixer"]["attn"] if lm.kind == "hybrid"
            else lm.blocks[i]["attn"] for i in layers]
    out = {"kv heads rolled": _swapped([(a[w], torch.roll(a[w], hd, dims=1))
                                        for a in attn for w in ("wk", "wv")])}
    if lm.kind == "hybrid":
        out["SSD half skipped"] = _swapped(
            [(lm.blocks[i]["mixer"]["ssm_scale"],
              torch.zeros_like(lm.blocks[i]["mixer"]["ssm_scale"]))
             for i in layers])
    if lm.kind == "dec":
        scale = lm.encoder.final_norm["scale"]
        out["encoder output zeroed"] = _swapped(
            [(scale, torch.zeros_like(scale))])
    if lm.cfg.mrope:
        out["1-D RoPE for M-RoPE"] = _config_swapped(lm, mrope=False)
    return out


def check_mixers(lm, batch, quantum, rtol):
    """Each decoder layer's mixer (attention; hymba's attention and SSD
    halves; an encoder-decoder's self and cross attention) through the
    kernels against the plain path, on the plain path's residual stream,
    at ``_rel`` <= ``rtol``; and each control of ``_controls`` through
    the kernels, which must land above ``rtol`` in every layer, so the
    check is shown able to fail.  Returns the loss through the kernels
    under each control (all layers)."""
    from repro_torch.actions import Action
    from repro_torch.models import hymba as HY
    from repro_torch.models import layers as L
    from repro_torch.models.lm import block_apply
    b = _device_batch(batch, quantum)
    n_layers = lm.cfg.num_layers
    B, _ = b["tokens"].shape
    enc_keep = (Action.KEEP,) * lm.cfg.encoder_layers

    def mixer(i, x, positions, mpos, seq_lens, impl):
        cfg, blk, g = lm.cfg, lm.blocks[i], lm._is_global(i)
        h = L.rmsnorm_apply(blk["norm1"], x, cfg.norm_eps)
        if lm.kind == "hybrid":
            return HY.hymba_apply(blk["mixer"], cfg, h, positions=positions,
                                  layer_is_global=g, impl=impl,
                                  seq_lens=seq_lens)
        a = L.attention_apply(blk["attn"], cfg, h, positions=positions,
                              layer_is_global=g, impl=impl,
                              kv_len=seq_lens, mrope_positions=mpos)
        if lm.kind != "dec":
            return a
        # the cross attention over the encoder's output, as block_apply
        enc = lm.encode(b, enc_keep)
        hd = cfg.resolved_head_dim()
        ck, cv = ((enc @ blk["cross"][w]).reshape(
            B, enc.shape[1], cfg.num_kv_heads, hd) for w in ("wk", "wv"))
        hx = L.rmsnorm_apply(blk["norm_cross"], x + a, cfg.norm_eps)
        return a + L.attention_apply(blk["cross"], cfg, hx,
                                     positions=positions, impl=impl,
                                     cross_kv=(ck, cv))
    sound, ctrl = [], {}
    with torch.no_grad():
        x, positions, mpos = lm._embed_inputs(b)
        seq_lens = b["lengths"].to(torch.int32) + (x.shape[1]
                                                   - b["tokens"].shape[1])
        lens = [int(n) for n in seq_lens]
        enc = lm.encode(b, enc_keep) if lm.kind == "dec" else None
        for i in range(n_layers):
            plain = mixer(i, x, positions, mpos, seq_lens, "xla")
            sound.append(_rel(mixer(i, x, positions, mpos, seq_lens,
                                    "flash"), plain, lens))
            for name, ctl in _controls(lm, [i]).items():
                with ctl:
                    ctrl.setdefault(name, []).append(_rel(
                        mixer(i, x, positions, mpos, seq_lens, "flash"),
                        plain, lens))
            x, _ = block_apply(lm.blocks[i], lm.cfg, x, lm.kind,
                               positions=positions,
                               layer_is_global=lm._is_global(i),
                               impl="xla", seq_lens=seq_lens, enc_out=enc,
                               mrope_positions=mpos)
        impl, lm.attn_impl = lm.attn_impl, "flash"
        losses = {}
        for name, ctl in _controls(lm, range(n_layers)).items():
            with ctl:
                losses[name] = float(lm.loss(b)[0])
        lm.attn_impl = impl
    torch.cuda.synchronize()
    log(f"mixer check {lm.cfg.name} (B={B} S={x.shape[1]}, {n_layers} "
        f"decoder layers): |kernel - plain| / |plain| per layer "
        f"{[f'{e:.3e}' for e in sound]} (limit {rtol}); controls through "
        f"the kernels: " + "; ".join(
            f"{n} {[f'{e:.3e}' for e in v]}, loss {losses[n]:.6f}"
            for n, v in ctrl.items()))
    if max(sound) > rtol:
        raise AssertionError(f"{lm.cfg.name}: a mixer through the kernels "
                             f"disagrees with the plain path")
    blind = [n for n, v in ctrl.items() if min(v) <= rtol]
    if blind:
        raise AssertionError(f"{lm.cfg.name}: the mixer check does not "
                             f"tell the controls {blind} from the kernels")
    return losses


def run_trainer_path(args, budget_mb, batches):
    """A main path through ``Trainer.run``, as the launcher would drive
    it (Mimose, the launcher's settings) on ``batches``, which carry the
    stub frontends' entries the launcher does not build; launch counts
    read around the run and checked."""
    from repro_torch.core.planner import MimosePlanner
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import Trainer
    cfg = path_config(args)
    lm = LM(cfg, attn_impl="flash", device="cuda")
    planner = MimosePlanner(lm, budget_mb * 2**20, quantum=args["quantum"],
                            warmup_samples=3)
    trainer = Trainer(lm, planner, AdamW(lr=cosine_schedule(
        3e-4, 10, args["steps"])))
    log(f"main path: Trainer.run, {cfg.name} ({cfg.encoder_layers} + "
        f"{cfg.num_layers} layers, {lm.num_plan_units()} units), Mimose at "
        f"{budget_mb:.3f} MiB, {len(batches)} batches of "
        f"{sorted(k for k in batches[0] if k not in ('labels', 'weights'))}")
    ops.reset_launches()
    trainer.run(batches)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_main_path(trainer, launches)
    return trainer, launches


def run_family_path(args, batches, profile_groups, rtol):
    """One family's path on its main-path ``batches``: ``check_model`` at
    2 layers, then the main path's run (the launcher; ``Trainer.run``
    for the stub-input families and for a path cut in depth, which the
    launcher has no flag for) with launch counts read around it, one
    profiled warm step and the memory phase; returns the launches."""
    check_model_at_depth(args, batches[0], rtol)
    budget_mb = derive_budget_mb(args, batches[0])
    if stub_inputs(path_config(args)) or args.get("over"):
        trainer, launches = run_trainer_path(args, budget_mb, batches)
    else:
        trainer, launches = run_main_path(args, budget_mb)
    _, batch = most_common_bucket(batches)
    profile_step(trainer, batch, profile_groups)
    memory_phase(trainer, batch)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_wide_path(fa, ops, kb, args, batches, extra_cases):
    """A head-dim 80 or 256 family's path: K1-K3 at each bucket's shape
    with its true lengths (``flash_main_cases``) in the path's bf16 and
    in fp32, and ``extra_cases``; a bf16 batch at the path's heads with a
    row of length 0 (``check_empty_row``); the bitwise
    padded-versus-unpadded check at the path's heads and head dim in both
    dtypes; the family path
    (``run_family_path``: 2-layer checks with their controls, the main
    run with launch counts, profile, memory); the kernels timed at the
    most common bucket.  Returns the max abs errors at the path's
    shapes, the launches and the timings."""
    cfg = path_config(args)
    hd, H, Hkv = cfg.resolved_head_dim(), cfg.num_heads, cfg.num_kv_heads
    cases = flash_main_cases(args, batches)
    lens_of = dict(cases)
    lens_of.update({c[:7] + ("float32",) + c[8:]: lens
                    for c, lens in cases.items()})
    errs = check_kernels(fa, ops, list(lens_of) + extra_cases, lens_of)
    log(f"flash kernel checks at the {cfg.name} path's shapes (hd {hd}; "
        f"bf16 and fp32) passed; max abs error {errs}")
    check_empty_row(fa, ops, 448, H, Hkv, hd, "bfloat16")
    for dt in ("float32", "bfloat16"):
        check_flash_bitwise(fa, 2, 448, H, hd, 338, dtype=dt, Hkv=Hkv)
    launches = run_family_path(args, batches, [("flash kernels",
                                                ("flash_",))]
                               + OTHER_GROUPS, BF16_MODEL_RTOL)
    S, _ = most_common_bucket(batches)
    timing = time_flash_kernels(fa, kb, S, lengths_by_bucket(batches)[S],
                                H=H, hd=hd, Hkv=Hkv, dtype=cfg.dtype)
    return {"errs": errs, "launches": launches, "timing": timing}


def time_dma(dma, kb, shape, chunk_elems=1 << 15):
    """K5 on a logits-sized fp32 array at the default chunk, beside its
    plain version and ``Tensor.copy_`` (timed here only), kernel and
    ``copy_`` in turns (kernel, copy_, copy_, kernel; each the mean of
    its two); the bound is 2 x bytes over the memory rate."""
    src = torch.randn(shape, device="cuda")
    dst = torch.empty_like(src)
    nbytes = src.numel() * src.element_size()
    lib = dma.library()
    stream = torch.cuda.current_stream().cuda_stream

    def kernel():
        return lib.dma_copy(src.data_ptr(), dst.data_ptr(), nbytes,
                            chunk_elems * src.element_size(), stream)
    kb.raise_on(kernel(), "dma_copy")
    fns = {"kernel": kernel, "copy_": lambda: dst.copy_(src)}
    turns = {k: [] for k in fns}
    for k in ("kernel", "copy_", "copy_", "kernel"):
        turns[k].append(_time_ms(fns[k], 20))
    ms, library_ms = (sum(turns[k]) / 2 for k in ("kernel", "copy_"))
    plain_ms = _time_ms(lambda: dma.dma_copy_plain(src, chunk_elems), 5)
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    log(f"timing dma_copy {tuple(shape)} fp32 chunk {chunk_elems}: kernel "
        f"{ms:.4f} ms ({turns['kernel'][0]:.4f}, {turns['kernel'][1]:.4f}), "
        f"copy_ {library_ms:.4f} ms ({turns['copy_'][0]:.4f}, "
        f"{turns['copy_'][1]:.4f}), plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms (bytes; {2 * nbytes / 1e6:.1f} MB moved), "
        f"{2 * nbytes / ms / 1e6:.1f} GB/s achieved")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by="bytes")


def run_dma_path(ops, trainer, batch):
    """K5's path, its public entry point: ``ops.residual_dma_copy``
    stages one batch's embedded residual stream and its fp32 logits, the
    two largest arrays a residual offload would move; launch counts are
    read around it."""
    b = _device_batch(batch, trainer.planner.quantum)
    with torch.no_grad():
        stream = trainer.lm.embed[b["tokens"]]
        logits = trainer.lm(b)
    torch.cuda.synchronize()
    ops.reset_launches()
    staged = [ops.residual_dma_copy(t) for t in (stream, logits)]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    ok = (launches["dma_copy"] == 2
          and all(torch.equal(a, t) for a, t in zip(staged, (stream, logits))))
    log(f"dma path: staged {tuple(stream.shape)} {stream.dtype} and "
        f"{tuple(logits.shape)} {logits.dtype}; launches {launches}; "
        f"{'identical' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("dma path: launches or values wrong")
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# serving: decode on the LM and the continuous-batching engine (Q1-Q3)
# ---------------------------------------------------------------------------

# Q1 and Q2: full width, 2 layers, fp32; a squad-length prompt prefilled
# in chunks of 32 and a remainder, then 16 tokens decoded
SERVE_CHECK_ARCHES = ("qwen3_1p7b", "mamba2_1p3b", "hymba_1p5b")
SERVE_CHUNK = 32
SERVE_DECODE = 16
# |cached - forward| / |forward| (Frobenius, every position's logits)
# below which the cached path counts as the forward; it must sit between
# the sound runs and the controls (the prefill one position late; the
# SSM state dropped between chunks), which must miss it.  On an NVIDIA
# H100 80GB HBM3 at 700 W: 1.7e-6 to 2.4e-6 sound, 4.6e-2 to 0.42 under
# the controls
SERVE_RTOL = 1e-4
# Q2: a burst of 12 squad requests, 16 new tokens each
ENGINE_CHECK = dict(num_requests=12, max_new_tokens=16, quantum=64,
                    max_slots=4)
# Q3: full depth, bf16, through the serve launcher; the budget is what
# the card already holds, the parameters and SERVE_BUDGET_SLOTS
# predicted slots of the largest bucket, so the burst must defer.  32 requests took 108-121 s for each
# model on an NVIDIA H100 80GB HBM3 at 700 W; 12 keep Q1-Q3 near two
# minutes
SERVE_ARGS = dict(dataset="squad", num_requests=12, max_new_tokens=64,
                  seed=0, quantum=64, max_slots=8, prefill_chunk=32,
                  decode_steps=4)
SERVE_BUDGET_SLOTS = 6
# decode batches timed after Q3's run (median), after 2 untimed ones
SERVE_PROFILE_BATCHES = 10


def _serve_model(arch):
    """``arch`` at full width, 2 layers, fp32, its own seeded weights."""
    from repro_torch.models.lm import LM
    cfg = path_config(dict(arch=arch), num_layers=2, dtype="float32")
    return LM(cfg, device="cuda", seed=0)


def _squad_prompt(vocab):
    from repro_torch.data.trace import gen_trace
    return gen_trace(num_requests=1, vocab_size=vocab, dataset="squad",
                     rate_rps=0.0, seed=0)[0].prompt


def _cached_logits(lm, seq, P, late=0, drop_state=False):
    """Every position's logits of ``seq`` (1, P + SERVE_DECODE) through
    the cache: the prompt's P tokens in chunks of SERVE_CHUNK (the full
    chunks, then the remainder, as ``prefill_into_cache``), then the
    rest one token at a time, teacher-forced.  Controls: ``late`` shifts
    every cache index; ``drop_state`` zeroes the SSM and convolution
    states before each chunk."""
    from repro_torch.train.serve import cached_serve_step
    step = cached_serve_step(lm)
    cache = lm.init_cache(1, seq.shape[1] + late)
    starts = list(range(0, P, SERVE_CHUNK)) + list(range(P, seq.shape[1]))
    ends = starts[1:] + [seq.shape[1]]
    out = []
    for s, e in zip(starts, ends):
        if drop_state:
            for layer in cache:
                for key in ("ssm", "conv"):
                    if key in layer:
                        layer[key] = torch.zeros_like(layer[key])
        logits, cache = step(seq[:, s:e], cache, s + late)
        out.append(logits)
    return torch.cat(out, dim=1)


def _rel_err(a, b):
    return float((a - b).norm() / b.norm())


def check_cached_decode(arch):
    """Q1: the cached path's logits at every position against the
    no-cache forward of the whole sequence (plain path), beside the
    controls that must miss SERVE_RTOL; ``prefill_into_cache``'s last
    chunk is the sound run's, bitwise."""
    from repro_torch.train.serve import prefill_into_cache
    lm = _serve_model(arch)
    prompt = _squad_prompt(lm.cfg.vocab_size)
    P = len(prompt)
    rng = np.random.default_rng(1)
    seq = torch.as_tensor(np.concatenate(
        [prompt, rng.integers(1, lm.cfg.vocab_size, SERVE_DECODE)])[None],
        dtype=torch.long, device="cuda")
    with torch.inference_mode():
        want = lm({"tokens": seq})
    got = _cached_logits(lm, seq, P)
    last, _ = prefill_into_cache(lm, seq[:, :P], lm.init_cache(1, P),
                                 chunk=SERVE_CHUNK)
    if not torch.equal(last, got[:, P - last.shape[1]:P]):
        raise AssertionError(f"{arch}: prefill_into_cache's last chunk is "
                             f"not the chunked prefill's")
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise AssertionError(f"{arch}: cached logits {tuple(got.shape)} "
                             f"not finite or not the forward's shape")
    err = _rel_err(got, want)
    controls = {}
    if lm.kind in ("dense", "hybrid"):
        controls["index one late"] = _rel_err(
            _cached_logits(lm, seq, P, late=1), want)
    if lm.kind in ("ssm", "hybrid"):
        controls["state dropped between chunks"] = _rel_err(
            _cached_logits(lm, seq, P, drop_state=True), want)
    log(f"serve Q1 {arch}: P {P} + {SERVE_DECODE} decoded, chunk "
        f"{SERVE_CHUNK}; |cached - forward| / |forward| {err:.3e}; under "
        f"the controls " + ", ".join(f"{n} {e:.3e}"
                                    for n, e in controls.items())
        + f" (limit {SERVE_RTOL})")
    if err > SERVE_RTOL:
        raise AssertionError(f"{arch}: cached decode disagrees with the "
                             f"forward ({err:.3e} > {SERVE_RTOL})")
    blind = [n for n, e in controls.items() if e <= SERVE_RTOL]
    if blind:
        raise AssertionError(f"{arch}: the decode check does not tell the "
                             f"controls {blind} from the cached path")
    return lm


def _tie(lm, prompt, got, want, cache_len):
    """At the first token where ``got`` and ``want`` differ: whether the
    two candidates' logits (prefill in chunks of 32 and teacher-forced
    decode of the common prefix) lie within SERVE_RTOL x max |logit|."""
    from repro_torch.train.serve import prefill_into_cache
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = torch.as_tensor(np.concatenate([prompt, want[:j]])[None],
                          dtype=torch.long, device="cuda")
    P = len(prompt)
    lg, cache = prefill_into_cache(lm, seq[:, :P],
                                   lm.init_cache(1, cache_len), SERVE_CHUNK)
    for i in range(P, seq.shape[1]):
        lg, cache = lm.decode_step(seq[:, i:i + 1], cache, i)
    lg = lg[0, -1]
    gap = abs(float(lg[got[j]] - lg[want[j]]))
    return gap <= SERVE_RTOL * float(lg.abs().max()), j, gap


def check_engine_tokens(lm):
    """Q2: a squad burst through ``ServeEngine`` against a one-request
    ``generate`` per request at the engine's bucketed cache length,
    token for token; a request that differs passes only as a tie at its
    first differing token.  Returns the number of such requests."""
    from repro_torch.data.trace import gen_trace
    from repro_torch.train.engine import ServeEngine
    from repro_torch.train.serve import generate
    kw = ENGINE_CHECK
    trace = gen_trace(num_requests=kw["num_requests"],
                      vocab_size=lm.cfg.vocab_size, dataset="squad",
                      rate_rps=0.0, max_new_tokens=kw["max_new_tokens"],
                      seed=0)
    eng = ServeEngine(lm, hbm_bytes=70e9, quantum=kw["quantum"],
                      max_slots=kw["max_slots"])
    res = eng.run(trace)
    if res.completed != len(trace):
        raise AssertionError(f"{lm.cfg.name}: engine completed "
                             f"{res.completed} of {len(trace)}")
    ties = []
    for r in trace:
        prompt = torch.as_tensor(r.prompt[None], dtype=torch.long,
                                 device="cuda")
        want = generate(lm, prompt, r.max_new_tokens,
                        cache_len=eng.bucket_of(r))[0].tolist()
        got = res.outputs[r.rid]
        if got == want:
            continue
        tie, j, gap = _tie(lm, r.prompt, got, want, eng.bucket_of(r))
        log(f"serve Q2 {lm.cfg.name}: rid {r.rid} differs at token {j} "
            f"({got[j]} vs {want[j]}), logit gap {gap:.3e}"
            + (" (a tie)" if tie else ""))
        if not tie:
            raise AssertionError(f"{lm.cfg.name}: rid {r.rid} differs from "
                                 f"sequential generate, not at a tie")
        ties.append(r.rid)
    log(f"serve Q2 {lm.cfg.name}: {len(trace)} requests, "
        f"{res.total_tokens} tokens equal to sequential generate, "
        f"{len(ties)} tie-divergent request(s) {ties}; geometries "
        f"{res.compile_counts}")
    return len(ties)


def run_serve_launcher(arch):
    """Q3: full depth, bf16, through ``python -m repro_torch.launch.serve``
    (its ``main``) with the launcher's own seeded parameters, a squad
    burst under a budget of what the card already holds, the parameters
    and SERVE_BUDGET_SLOTS predicted slots of the trace's largest
    bucket."""
    from repro_torch.data.trace import gen_trace
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    from repro_torch.train.engine import ServeEngine
    a = SERVE_ARGS
    cfg = get_config(arch)
    trace = gen_trace(num_requests=a["num_requests"],
                      vocab_size=cfg.vocab_size, dataset=a["dataset"],
                      rate_rps=0.0, max_new_tokens=a["max_new_tokens"],
                      seed=a["seed"])
    # the engine's own prediction, on a model that allocates nothing
    probe = ServeEngine(LM(cfg, device="meta"), hbm_bytes=float("inf"),
                        quantum=a["quantum"], max_slots=a["max_slots"],
                        prefill_chunk=a["prefill_chunk"])
    buckets = {probe.bucket_of(r) for r in trace}
    # what the card already holds (cuBLAS's workspace, this script's
    # earlier tensors) is not the server's: the engine measures and
    # charges it, so it is added to keep the caches' share the same
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    budget = (held + probe.param_bytes
              + SERVE_BUDGET_SLOTS * probe.slot_bytes(max(buckets)))
    argv = ["--arch", arch, "--hbm-gb", repr(budget / 1e9),
            "--rate-rps", "0"]
    for key in ("dataset", "num_requests", "max_new_tokens", "seed",
                "quantum", "max_slots", "prefill_chunk", "decode_steps"):
        argv += ["--" + key.replace("_", "-"), str(a[key])]
    t0 = time.perf_counter()
    eng, res = launch_serve.main(argv)
    secs = time.perf_counter() - t0
    st = res.stats
    widths = sorted({k[2] for k in eng.compile_keys if k[0] == "prefill"})
    decode_geoms = res.compile_counts.get("decode", 0)
    log(f"serve Q3 {arch}: {cfg.num_layers} layers bf16, "
        f"{res.completed} completed, {res.rejected} rejected, "
        f"{st['deferrals']} deferral(s), {st['admitted']} admitted; "
        f"{res.tokens_per_s:.1f} tokens/s ({res.total_tokens} tokens in "
        f"{res.wall_s:.2f} s; launcher {secs:.1f} s with the model's "
        f"build); TTFT p50 / p99 {res.ttft_p50_s * 1e3:.1f} / "
        f"{res.ttft_p99_s * 1e3:.1f} ms; ITL p50 / p99 "
        f"{res.itl_p50_s * 1e3:.2f} / {res.itl_p99_s * 1e3:.2f} ms; peak "
        f"predicted {st['peak_predicted_bytes'] / 1e6:.2f} MB, tensor "
        f"bytes {st['peak_actual_bytes'] / 1e6:.2f} MB, allocated "
        f"{res.peak_allocated_bytes / 1e6:.2f} MB, budget "
        f"{budget / 1e6:.2f} MB (params {probe.param_bytes / 1e6:.2f} MB, "
        f"held before {held / 1e6:.2f} MB); {card_line()}")
    log(f"serve Q3 {arch} workspace measured at bucket {max(buckets)}: a "
        f"prefill chunk of {a['prefill_chunk']} "
        f"{eng.prefill_ws * a['prefill_chunk'] / 1e6:.2f} MB "
        f"({eng.prefill_ws / 1e6:.4f} MB a token against the formula's "
        f"{eng._token_ws / 1e6:.4f}), a decode row "
        f"{eng.slot_ws / 1e6:.4f} MB, allocated beside the parameters "
        f"{eng.fixed_bytes / 1e6:.2f} MB")
    log(f"serve Q3 {arch} geometries: {sorted(eng.compile_keys)}")
    checks = {
        "every request completed or rejected":
            res.completed + res.rejected == a["num_requests"],
        "none rejected (each fits on an empty card)": res.rejected == 0,
        "the burst deferred": st["deferrals"] >= 1,
        "predicted peak within the budget":
            st["peak_predicted_bytes"] <= eng.hbm_bytes,
        "tensor-byte peak within the budget":
            st["peak_actual_bytes"] <= eng.hbm_bytes,
        "allocator's peak within the budget":
            res.peak_allocated_bytes <= eng.hbm_bytes,
        "decode geometries <= buckets x slot tiers":
            decode_geoms <= len(buckets) * len(eng.tiers),
        "prefill chunks powers of two <= 32":
            all(w & (w - 1) == 0 and w <= a["prefill_chunk"]
                for w in widths),
    }
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{arch} serve run: {failed}")
    summary = dict(res.summary(), budget_mb=round(budget / 1e6, 3),
                   buckets=len(buckets), tiers=len(eng.tiers),
                   decode_batch=profile_decode(eng))
    del eng, res
    return summary


def profile_decode(eng):
    """One full-depth decode batch at the largest pool ``eng``'s run
    decoded (most slots, then the longest bucket), every row at half
    the bucket: its transient bytes against the engine's charge (slots
    x the measured decode row); its wall time as the engine's
    ``decode_batch`` span takes it (the call and the (slots,) tokens'
    copy to the host, synchronised by that copy), the median of
    SERVE_PROFILE_BATCHES; then one batch under ``torch.profiler`` for
    its device kernel time and launches.  The busy share is device time
    over the unprofiled median."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.calibrate import device_rows
    from repro_torch.train.engine import _transient_bytes
    lm = eng.lm
    _, L, S = max((k for k in eng.compile_keys if k[0] == "decode"),
                  key=lambda k: (k[2], k[1]))
    cache = lm.init_cache(S, L)
    tok = torch.ones((S, 1), dtype=torch.long, device="cuda")
    idx = torch.full((S,), L // 2, dtype=torch.long, device="cuda")

    def batch():
        return eng._decode_fn(tok, cache, idx)[0].cpu()
    transient = _transient_bytes(lambda: eng._decode_fn(tok, cache, idx),
                                 lm.device)
    for _ in range(2):
        batch()
    walls = []
    for _ in range(SERVE_PROFILE_BATCHES):
        t0 = time.perf_counter()
        batch()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batch()
    rows = device_rows(prof)
    del cache
    wall_ms = float(np.median(walls)) * 1e3
    dev_ms = sum(r[0] for r in rows)
    kernels = sum(r[1] for r in rows)
    layers = lm.cfg.num_layers
    out = {"slots": S, "bucket": L, "wall_ms": wall_ms,
           "walls_ms": [w * 1e3 for w in walls],
           "device_ms": dev_ms if dev_ms else None,
           "busy_share": dev_ms / wall_ms if dev_ms else None,
           "launches": kernels, "launches_per_layer": kernels / layers,
           "transient_mb": transient / 1e6,
           "charge_mb": S * eng.slot_ws / 1e6}
    log(f"serve Q3 {lm.cfg.name} decode batch ({S} slots, bucket {L}, "
        f"{layers} layers): wall {wall_ms:.3f} ms (median of "
        f"{SERVE_PROFILE_BATCHES}, profiler off); "
        + (f"device kernels {dev_ms:.3f} ms (profiler on), busy share "
           f"{dev_ms / wall_ms:.3f}, " if dev_ms else
           "the profiler reported no device time: busy share not "
           "measured, ")
        + f"{kernels} device launches ({kernels / layers:.1f} a layer); "
        f"transient {transient / 1e6:.2f} MB against the charge "
        f"{S} x {eng.slot_ws / 1e6:.4f} MB; {card_line()}")
    for ms, n, name in rows[:8]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name[:110]}")
    if transient > S * eng.slot_ws:
        raise AssertionError(f"{lm.cfg.name}: a decode batch of {S} slots "
                             f"needs {transient} bytes beyond the charge "
                             f"{S * eng.slot_ws:.0f}")
    return out


def run_serve_path(ops):
    """Q1-Q3, with every kernel's launch count unchanged across them
    (decode runs the plain paths, as the reference's does)."""
    before = dict(ops.LAUNCHES)
    ties = {}
    for arch in SERVE_CHECK_ARCHES:
        t0 = time.perf_counter()
        lm = check_cached_decode(arch)
        if arch != "hymba_1p5b":
            ties[arch] = check_engine_tokens(lm)
        del lm
        _free()
        log(f"serve Q1-Q2 {arch}: {time.perf_counter() - t0:.1f} s")
    runs = {}
    for arch in ("qwen3_1p7b", "mamba2_1p3b"):
        t0 = time.perf_counter()
        runs[arch] = run_serve_launcher(arch)
        _free()
        log(f"serve Q3 {arch}: {time.perf_counter() - t0:.1f} s")
    ran = _launched(ops, before)
    if ran:
        raise AssertionError(f"the serve path launched kernels: {ran}")
    log("serve: " + json.dumps({"tie_divergent": ties, "runs": runs}))
    return {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}


# ---------------------------------------------------------------------------
# phase E: the public surface -- the three examples, Tables 3-4
# ---------------------------------------------------------------------------

# E1: the end-to-end example at full width (bert_base_paper, 110M, fp32,
# its qqp lengths at quantum 64 from seed 0 and its flash kernels), cut
# to 24 steps; E1_ARGS gives main_path_batches the example's batches
E1_ARGS = dict(arch="bert_base_paper", dataset="qqp", batch_size=4,
               steps=24, quantum=64)
E1_ARGV = ["--steps", str(E1_ARGS["steps"]),
           "--batch-size", str(E1_ARGS["batch_size"]), "--budget-gb", "2.5"]
# E2: the quickstart's own count of swag batches
E2_ARGV = ["--num-batches", "30"]
# E4: benchmarks/table34_estimator.py's sizes at bert's B 8, the first
# 10 fitted, the last 4 held out; predict time over 50 calls
E4_SIZES = np.linspace(32, 352, 14).astype(int)
E4_BATCH = 8
E4_TRAIN = 10
E4_PREDICTS = 50


def _example(name):
    """``examples/<name>.py`` as a module (its ``main(argv)``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_e2e_example(fa, ops):
    """E1: K1-K3 held against their plain versions at each of the
    example's bucket shapes and lengths; then
    ``torch_dynamic_training_e2e.main`` on the card: every loss finite,
    each step's bucket the checked batches', K1 = sum (12 + REMAT
    units), K2 = K3 = 12 a step, no FMA launch; the checkpoint it writes
    loads back bitwise equal; the trained model's loss through the
    kernels against the plain path on the first batch; one warm step at
    the most common bucket profiled.  Returns the launches, the max abs
    error per kernel and the warm tokens/s."""
    import tempfile
    from repro_torch.train import checkpoint
    batches = main_path_batches(E1_ARGS)
    cases = flash_main_cases(E1_ARGS, batches)
    errs = check_kernels(fa, ops, list(cases), cases)
    log(f"E1 kernel checks passed at its {len(cases)} bucket shapes; max "
        f"abs error {errs}")
    e2e = _example("torch_dynamic_training_e2e")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "bert_base_mimose.pt")
        argv = E1_ARGV + ["--save", path]
        log("E1: examples/torch_dynamic_training_e2e.py " + " ".join(argv))
        ops.reset_launches()
        trainer = e2e.main(argv)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        _bitwise("E1 checkpoint", checkpoint.load(path, trainer.params),
                 trainer.params)
    h = trainer.history
    losses = [s.loss for s in h]
    if len(h) != E1_ARGS["steps"] or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"E1: {len(h)} steps, losses {losses}")
    shapes = [int(np.prod(b["tokens"].shape)) for b in batches]
    if [s.bucket for s in h] != shapes:
        raise AssertionError(f"E1: buckets {[s.bucket for s in h]}, the "
                             f"checked batches' {shapes}")
    got = _check_flash("E1", launches, _step_actions(trainer))
    summ, stats = trainer.summary(), trainer.planner.stats
    remat = {}
    for st in h:
        remat.setdefault(st.bucket, set()).add(st.remat_units)
    remat = {b: sorted(r) for b, r in sorted(remat.items())}
    warm = [s for s in h if not s.compile]
    log("E1 losses: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"E1: tokens/s {summ['tokens_per_s']:.1f} over {len(warm)} warm "
        f"steps, mean warm step {summ['mean_step_s'] * 1e3:.2f} ms (plan "
        f"{np.mean([s.plan_time_s for s in warm]) * 1e3:.2f} ms of it), "
        f"warm step ms by bucket " + json.dumps(
            {b: round(1e3 * float(np.mean([s.step_time_s for s in warm
                                           if s.bucket == b])), 2)
             for b in sorted({s.bucket for s in warm})})
        + f"; remat units per bucket (B x S) {json.dumps(remat)}"
        f"; collections {stats['collections']}, cache_hits "
        f"{stats['cache_hits']}; checkpoint loads back bitwise")
    check_model(trainer.lm, batches[0], E1_ARGS["quantum"], 1e-4)
    _, batch = most_common_bucket(batches)
    profile_step(trainer, batch,
                 [("flash kernels", ("flash_",)),
                  ("gemm", ("gemm", "cutlass", "xmma"))])
    del trainer
    _free()
    return got, errs, summ["tokens_per_s"]


def run_quickstart_example(ops):
    """E2: ``torch_quickstart.main`` on the card (plain attention, the
    reference's default: no attention kernel launch; AdamW's kernels
    update every parameter each step)."""
    before = dict(ops.LAUNCHES)
    trainer = _example("torch_quickstart").main(E2_ARGV + ["--device",
                                                           "cuda"])
    losses = [s.loss for s in trainer.history]
    ran = _launched(ops, before)
    steps = len(trainer.history)
    adamw = {"adamw": ops.LAUNCHES["adamw"] - before["adamw"],
             "adamw_norm": ops.LAUNCHES["adamw_norm"] - before["adamw_norm"]}
    if (len(losses) != 30 or not all(math.isfinite(x) for x in losses)
            or set(ran) - set(adamw)
            or adamw != {"adamw": len(trainer.params) * steps,
                         "adamw_norm": steps}):
        raise AssertionError(f"E2: losses {losses}, launched {ran}, "
                             f"AdamW {adamw}")
    tps = trainer.summary()["tokens_per_s"]
    log(f"E2: 30 swag batches, final loss {losses[-1]:.4f}, tokens/s "
        f"{tps:.1f}")
    del trainer
    _free()
    return tps


def run_serve_example(ops):
    """E3: ``torch_serve_decode.main`` in engine mode and with
    ``--sequential`` at its reduced sizes (decode runs the plain paths:
    no kernel launch); every request served, the engine's peaks within
    its budget."""
    serve = _example("torch_serve_decode")
    before = dict(ops.LAUNCHES)
    engine, result = serve.main([])
    summ = result.summary()
    budget_mb = engine.hbm_bytes / 1e6
    peaks = {k: summ[k] for k in ("peak_predicted_mb", "peak_actual_mb",
                                  "peak_allocated_mb")}
    log(f"E3 engine: {result.completed} served, {result.rejected} "
        f"rejected, tokens/s {result.tokens_per_s:.1f}, peaks "
        f"{json.dumps(peaks)} MB against the budget {budget_mb:.1f} MB")
    if result.rejected or result.completed != 12 or any(
            v > budget_mb for v in peaks.values()):
        raise AssertionError(f"E3 engine: {summ}")
    del engine, result
    _free()
    out = serve.main(["--sequential"])
    if tuple(out.shape) != (4, 32):
        raise AssertionError(f"E3 sequential: tokens {tuple(out.shape)}")
    ran = _launched(ops, before)
    if ran:
        raise AssertionError(f"E3 launched kernels: {ran}")
    _free()
    return summ["tokens_per_s"], peaks, budget_mb


def run_estimator_table():
    """E4: paper Tables 3-4 at full bert width: the port's collector at
    ``E4_SIZES`` with B 8, each of ``ESTIMATORS`` fitted on the first
    ``E4_TRAIN`` sizes; MAPE on the rest, fit ms and predict us on this
    host."""
    from repro_torch.core import ESTIMATORS, ShuttlingCollector
    from repro_torch.models.lm import LM
    lm = LM(path_config(BERT_ARGS), device="meta")
    col = ShuttlingCollector(lm)
    data = {}
    for S in E4_SIZES:
        res = col.collect({"tokens": torch.ones((E4_BATCH, int(S)),
                                                 dtype=torch.long)})
        data[res.input_size] = res.activation_vector()
    sizes = list(data)
    train, test = sizes[:E4_TRAIN], sizes[E4_TRAIN:]
    truth = np.stack([data[s] for s in test])
    rows = {}
    for name, make in ESTIMATORS.items():
        est = make()
        for s in train:
            est.add_sample(s, data[s])
        t0 = time.perf_counter()
        est.fit()
        fit_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(E4_PREDICTS):
            est.predict_total(test[0])
        pred_us = (time.perf_counter() - t0) / E4_PREDICTS * 1e6
        rows[name] = {"mape": est.mape(test, truth), "fit_ms": fit_ms,
                      "predict_us": pred_us}
        log(f"E4 {name}: MAPE {100 * rows[name]['mape']:.4f} % on sizes "
            f"{test}, fit {fit_ms:.3f} ms, predict {pred_us:.2f} us")
    if len(rows) != 4 or not all(math.isfinite(r["mape"])
                                 for r in rows.values()):
        raise AssertionError(f"E4: {rows}")
    return rows


def run_examples_phase(fa, ops):
    """E1-E4, each one's wall time logged; returns E1's K1-K3 launches
    and its kernels' max abs errors at its shapes."""
    walls, out = {}, {}
    t0 = time.perf_counter()
    e_launches, e_errs, out["e1_tokens_per_s"] = run_e2e_example(fa, ops)
    walls["E1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["e2_tokens_per_s"] = run_quickstart_example(ops)
    walls["E2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (out["e3_tokens_per_s"], out["e3_peaks_mb"],
     out["e3_budget_mb"]) = run_serve_example(ops)
    walls["E3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["e4"] = run_estimator_table()
    walls["E4"] = time.perf_counter() - t0
    out["wall_s"] = walls
    log("examples: " + json.dumps(out))
    return e_launches, e_errs


# --------------------------------------------------------------------------
# phase K6: AdamW's update and clip norm over a model's parameter set
# --------------------------------------------------------------------------

K6_ARCHS = ("stablelm_3b", "mamba2_1p3b")
# the kernels against the plain version: the card tests' tolerances
# (tests/test_torch_adamw.py)
K6_SCALE_RTOL, K6_MOMENT_ULPS, K6_PARAM_ULPS = 1e-6, 2, 1


def _ulps(got, want, mant_bits):
    """The largest gap between ``got`` and ``want`` in units of the last
    place of ``want`` in a format of ``mant_bits`` significand bits."""
    got, want = got.double(), want.double()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), (e - mant_bits).to(torch.int32))
    ulp = torch.where(want == 0, torch.full_like(want, 2.0 ** -149), ulp)
    return float(((got - want).abs() / ulp).max())


def check_adamw(ka, opt, params, grads, state, gen, step=5):
    """K6's comparison at every parameter: the kernels' clip scale
    against the plain version's, then one update by the kernel and one
    by the plain version from the same parameter, gradient and drawn
    moments, both with the kernel's scale; the worst gaps.  Leaves the
    plain version's update in ``params`` and ``state``."""
    from repro_torch.optim.adamw import UpdateCursor
    gs = list(grads.values())
    before = dict(ka.LAUNCHES)
    scale = ka.clip_scale(gs, opt.clip_norm)
    scale_rel = abs(float(scale) / float(opt.clip_scale_plain(gs)) - 1)
    cur = UpdateCursor(step, scale, opt._lr(step), 1 - opt.b1 ** step,
                       1 - opt.b2 ** step)
    worst = {"m": 0.0, "v": 0.0, "p": 0.0}
    max_abs_err, differ = 0.0, 0
    for n, p in params.items():
        m, v = state.m[n], state.v[n]
        m.normal_(0.0, 1e-4, generator=gen)
        v.normal_(0.0, 1e-7, generator=gen).abs_()
        kp, km, kv = p.clone(), m.clone(), v.clone()
        ka.update(kp, grads[n], km, kv, scale, lr=cur.lr, b1=opt.b1,
                  b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay,
                  bc1=cur.bc1, bc2=cur.bc2)
        opt.update_plain(cur, p, grads[n], m, v)
        worst["m"] = max(worst["m"], _ulps(km, m, 24))
        worst["v"] = max(worst["v"], _ulps(kv, v, 24))
        worst["p"] = max(worst["p"], _ulps(
            kp, p, 8 if p.dtype == torch.bfloat16 else 24))
        max_abs_err = max(max_abs_err,
                          float((kp.float() - p.float()).abs().max()))
        differ += int((kp != p).sum())
        del kp, km, kv
    gaps = {"scale_rel_err": scale_rel, "m_ulps": worst["m"],
            "v_ulps": worst["v"], "p_ulps": worst["p"],
            "max_abs_err": max_abs_err, "p_elements_differ": differ,
            "compared_launches": ka.LAUNCHES["adamw"] - before["adamw"]}
    checks = {f"clip scale within {K6_SCALE_RTOL}":
                  scale_rel <= K6_SCALE_RTOL,
              f"m and v within {K6_MOMENT_ULPS} fp32 ulp":
                  max(worst["m"], worst["v"]) <= K6_MOMENT_ULPS,
              f"parameters within {K6_PARAM_ULPS} ulp of their dtype":
                  worst["p"] <= K6_PARAM_ULPS,
              "every parameter compared":
                  gaps["compared_launches"] == len(params)}
    log("K6 kernels against the plain version: " + json.dumps(gaps)
        + "; checks " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"K6 comparison failed: {checks} {gaps}")
    return gaps


def _queued_ms(fn, reps, sleep_cycles=200_000_000):
    """Device time of one ``fn()``: ``reps`` calls queued behind a sleep
    kernel (about 0.1 s), so the events time the kernels and not the
    host's issue."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_adamw(ka, arch, reps=5, rounds=3):
    """K6 at ``arch``'s parameter set: the kernels against the plain
    version (``check_adamw``), then kernel, plain and library ms a step
    (median of ``rounds`` turns), bound ms and bytes."""
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamW, UpdateCursor
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in
              LM(get_config(arch), device="meta").named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(shape, dtype, std):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dtype)
    params = {n: draw(s, dt, 0.02) for n, (s, dt) in shapes.items()}
    grads = {n: draw(s, dt, 1e-3) for n, (s, dt) in shapes.items()}
    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    n_elems = sum(p.numel() for p in params.values())
    nbytes = sum(p.numel() * (2 * p.element_size() + 2 * grads[n].element_size()
                              + 16) for n, p in params.items())

    gaps = check_adamw(ka, opt, params, grads, state, gen)

    def kernel():
        opt.update(grads, state, params)

    def plain():
        gs = list(grads.values())
        cur = UpdateCursor(1, opt.clip_scale_plain(gs), 3e-4, 0.1, 0.001)
        for n, p in params.items():
            opt.update_plain(cur, p, grads[n], state.m[n], state.v[n])

    plist = list(params.values())
    for n, p in params.items():
        p.grad = grads[n]
    lib_opt = torch.optim.AdamW(plist, lr=3e-4, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.01, fused=True)

    def library():
        torch.nn.utils.clip_grad_norm_(plist, 1.0, foreach=True)
        lib_opt.step()

    before = dict(ka.LAUNCHES)
    times = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(rounds):
        for key, fn in (("ms", kernel), ("plain_ms", plain),
                        ("library_ms", library)):
            times[key].append(_queued_ms(fn, reps))
    launches = {k: ka.LAUNCHES[k] - before[k] for k in ("adamw",
                                                         "adamw_norm")}
    calls = rounds * (reps + 1)
    checks = {"adamw = parameters x calls": launches["adamw"]
              == len(params) * calls,
              "adamw_norm = calls": launches["adamw_norm"] == calls}
    row = {k: float(np.median(v)) for k, v in times.items()}
    row.update(gaps)
    row.update({"library": "torch.optim.AdamW(fused=True) after "
                           "clip_grad_norm_: bf16 moments on bf16 "
                           "parameters, a lower-precision function "
                           "(yardstick only)",
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": nbytes, "elements": n_elems,
                "parameters": len(params), "launches": launches["adamw"],
                "norm_launches": launches["adamw_norm"],
                "rounds": {k: [round(x, 4) for x in v]
                           for k, v in times.items()}})
    log(f"K6 adamw at {arch}'s {len(params)} parameters ({n_elems:,} "
        f"elements, {nbytes / 1e9:.2f} GB to move): " + json.dumps(row)
        + "; checks " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"K6 checks failed: {checks}")
    for p in plist:
        p.grad = None
    del params, grads, state, lib_opt, plist
    _free()
    return row


def run_adamw_path(ka):
    """Phase K6: the AdamW row of the kernel table, stablelm_3b's
    parameter set first, mamba2_1p3b's as ``mamba2_<key>``."""
    rows = {arch: time_adamw(ka, arch) for arch in K6_ARCHS}
    row = {"name": "adamw", "route": "cuda", "source": CSRC + "adamw.cu",
           "replaces": "none (src/repro/optim/adamw.py: XLA fuses it)"}
    row.update(rows["stablelm_3b"])
    row.update({f"mamba2_{k}": v for k, v in rows["mamba2_1p3b"].items()
                if k not in ("rounds", "library")})
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.actions import Action
    from repro_torch.kernels import adamw as ka
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import offload_dma as dma
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.registry import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    paths = kb.build(fa._SRC, ssd._SRC, dma._SRC, ka._SRC)  # nvcc x 4
    fa.library(), ssd.library(), dma.library(), ka.library()
    log(f"build: {[str(p.relative_to(ROOT)) for p in paths]} in "
        f"{time.perf_counter() - t0:.1f} s")
    log_flash_resources(kb, fa, paths[0])
    log_ssd_resources(kb, paths[1])
    launches, errs, timings = {}, {}, {}

    # -- bert path: the flash kernels -------------------------------------
    t0 = time.perf_counter()
    batches = main_path_batches(BERT_ARGS)
    by_bucket = lengths_by_bucket(batches)
    main_cases = flash_main_cases(BERT_ARGS, batches)
    errs.update(check_kernels(fa, ops, REFERENCE_CASES + list(main_cases),
                              main_cases))
    log(f"flash kernel checks passed; max abs error at the main path's "
        f"shapes: {errs}")
    check_flash_bitwise(fa, 2, 128, 2, 32, 64)        # tests/test_ragged.py's
    check_flash_bitwise(fa, 2, 416, 12, 64, 338)      # the main width
    budget_mb = derive_budget_mb(BERT_ARGS, batches[0])
    trainer, path_launches = run_main_path(BERT_ARGS, budget_mb)
    launches.update({k: path_launches[k] for k in FLASH_KERNELS})
    main_run = {"actions": _step_actions(trainer),
                "losses": [s.loss for s in trainer.history]}
    check_model(trainer.lm, batches[0], BERT_ARGS["quantum"], 1e-4)
    S_main, main_batch = most_common_bucket(batches)
    profile_step(trainer, main_batch,
                 [("flash kernels", ("flash_",)),
                  ("gemm", ("gemm", "cutlass", "xmma"))])
    memory_phase(trainer, main_batch)
    timings.update(time_flash_kernels(fa, kb, S_main, by_bucket[S_main]))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"bert path: {time.perf_counter() - t0:.1f} s")

    # -- planners path: the planner's decision space on bert --------------
    t0 = time.perf_counter()
    run_planners_path(BERT_ARGS, budget_mb, fa, ops)
    log(f"planners path: {time.perf_counter() - t0:.1f} s")

    # -- sharding path: per-device planning on a mesh -----------------------
    t0 = time.perf_counter()
    sharding = run_sharding_path(BERT_ARGS, budget_mb, main_run)
    sh_launches = sharding["launches"]
    log(f"sharding path: {time.perf_counter() - t0:.1f} s")

    # -- distributed path: the dry run, bert's sharded step (D1-D3) ------
    t0 = time.perf_counter()
    d_launches = run_distributed_path(BERT_ARGS, main_run, sharding)
    log(f"distributed path: {time.perf_counter() - t0:.1f} s")

    # -- offload path: OFFLOAD / OFFLOAD_OPT and telemetry on bert --------
    t0 = time.perf_counter()
    run_offload_path(BERT_ARGS, budget_mb)
    log(f"offload path: {time.perf_counter() - t0:.1f} s")

    # -- resilience path: snapshots, resume and a real OOM on bert --------
    t0 = time.perf_counter()
    r_launches = run_resilience_path(BERT_ARGS, budget_mb)
    log(f"resilience path: {time.perf_counter() - t0:.1f} s")

    # -- the SSD scan and DMA copy against their plain versions -----------
    t0 = time.perf_counter()
    mcfg = get_config(MAMBA_ARGS["arch"])
    m_batches = main_path_batches(MAMBA_ARGS)
    m_by_bucket = lengths_by_bucket(m_batches)
    H = mcfg.ssm_expand * mcfg.d_model // mcfg.ssm_head_dim
    ssd_cases = ([(c, None, 1, None, False) for c in SSD_CASES]
                 # tests/test_ragged.py's ragged case, 1 and 2 chunks per
                 # block
                 + [((2, 96, 2, 16, 8, 16, "float32"), [40, 77], cpb, None,
                     False) for cpb in (1, 2)]
                 + [((MAMBA_ARGS["batch_size"], S, H, mcfg.ssm_head_dim,
                      mcfg.ssm_state, mcfg.ssm_chunk, "bfloat16"), lens, 1,
                     "float32", True)
                    for S, lens in sorted(m_by_bucket.items())])
    errs["ssd_scan"] = check_ssd(ops, ssd, ssd_cases)
    S_m, m_batch = most_common_bucket(m_batches)
    logits_shape = (MAMBA_ARGS["batch_size"], S_m, mcfg.vocab_size)
    errs["dma_copy"] = check_dma(ops, dma, logits_shape)
    log(f"ssd and dma checks passed in {time.perf_counter() - t0:.1f} s; "
        f"ssd max abs error at the main path's shapes "
        f"{errs['ssd_scan']:.3e}")

    # -- mamba2 path: the SSD scan ------------------------------------------
    t0 = time.perf_counter()
    budget_mb = derive_budget_mb(MAMBA_ARGS, m_batches[0])
    trainer, path_launches = run_main_path(MAMBA_ARGS, budget_mb)
    launches["ssd_scan"] = path_launches["ssd_scan"]
    # rtol: both paths take every product in fp32 and round the scan's y
    # to bf16 once per layer; 48 bf16 layers, mean over ~3k tokens
    check_model(trainer.lm, m_batches[0], MAMBA_ARGS["quantum"], 5e-3)
    profile_step(trainer, m_batch,
                 [("ssd_scan kernel", ("ssd_scan",)),
                  ("gemm", ("gemm", "cutlass", "xmma", "sm90_"))])
    memory_phase(trainer, m_batch)
    timings["ssd_scan"] = time_ssd(ssd, kb, mcfg, S_m, m_by_bucket[S_m])
    log(f"mamba2 path: {time.perf_counter() - t0:.1f} s")

    # -- DMA path -----------------------------------------------------------
    launches["dma_copy"] = run_dma_path(ops, trainer, m_batch)["dma_copy"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    timings["dma_copy"] = time_dma(dma, kb, logits_shape)

    # -- hymba path: the hybrid family, K1-K4 ---------------------------
    t0 = time.perf_counter()
    hcfg = get_config(HYMBA_ARGS["arch"])
    h_batches = main_path_batches(HYMBA_ARGS)
    h_cases = flash_main_cases(HYMBA_ARGS, h_batches)
    family_errs = {"hymba": check_kernels(fa, ops, list(h_cases), h_cases)}
    log(f"flash kernel checks at the hymba path's shapes passed; max abs "
        f"error {family_errs['hymba']}")
    S_h = most_common_bucket(h_batches)[0]
    hymba_k4 = check_ssd_hymba(ops, ssd, kb, hcfg, S_h,
                               lengths_by_bucket(h_batches)[S_h])
    h_launches = run_family_path(
        HYMBA_ARGS, h_batches, [("flash kernels", ("flash_",)),
                     ("ssd_scan kernel", ("ssd_scan",))] + OTHER_GROUPS,
        BF16_MODEL_RTOL)
    log(f"hymba path: {time.perf_counter() - t0:.1f} s")

    # -- granite path: the MoE family, K1-K3 ----------------------------
    t0 = time.perf_counter()
    g_batches = main_path_batches(GRANITE_ARGS)
    g_cases = flash_main_cases(GRANITE_ARGS, g_batches)
    family_errs["granite"] = check_kernels(fa, ops, list(g_cases), g_cases)
    log(f"flash kernel checks at the granite path's shapes passed; max abs "
        f"error {family_errs['granite']}")
    g_launches = run_family_path(
        GRANITE_ARGS, g_batches, [("flash kernels", ("flash_",)),
                       ("cumsum (MoE slots)", ("scan_outer_dim",))]
        + OTHER_GROUPS, BF16_MODEL_RTOL)
    check_plans_equal_keep(GRANITE_ARGS, g_batches[0], {
        "REMAT": lambda e, d: (Action.REMAT,) * (e + d),
        "OFFLOAD": lambda e, d: (Action.OFFLOAD,) * (e + d)})
    log(f"granite path: {time.perf_counter() - t0:.1f} s")

    # -- qwen3: qk-norm and head dim 128 through the kernels -------------
    t0 = time.perf_counter()
    q_args = dict(arch="qwen3_1p7b", dataset="squad", batch_size=8,
                  steps=1, quantum=32)
    check_model_at_depth(q_args, main_path_batches(q_args)[0],
                         BF16_MODEL_RTOL)
    log(f"qwen3 check: {time.perf_counter() - t0:.1f} s")

    # -- seamless path: the encoder-decoder family, K1-K3 ---------------
    t0 = time.perf_counter()
    s_batches = main_path_batches(SEAMLESS_ARGS)
    s_cases = flash_main_cases(SEAMLESS_ARGS, s_batches)
    family_errs["seamless"] = check_kernels(fa, ops, list(s_cases), s_cases)
    log(f"flash kernel checks at the seamless path's shapes passed; max "
        f"abs error {family_errs['seamless']}")
    s_launches = run_family_path(
        SEAMLESS_ARGS, s_batches, [("flash kernels", ("flash_",))]
        + OTHER_GROUPS, SEAMLESS_LOSS_RTOL)
    check_plans_equal_keep(SEAMLESS_ARGS, s_batches[0], {
        "every unit OFFLOAD": lambda e, d: (Action.OFFLOAD,) * (e + d),
        "encoder REMAT, decoder OFFLOAD":
            lambda e, d: (Action.REMAT,) * e + (Action.OFFLOAD,) * d},
        layers=4)
    log(f"seamless path: {time.perf_counter() - t0:.1f} s")

    # -- qwen2-vl path: the vision-language family, K1-K3 ---------------
    t0 = time.perf_counter()
    v_batches = main_path_batches(QWEN2VL_ARGS)
    v_cases = flash_main_cases(QWEN2VL_ARGS, v_batches)
    family_errs["qwen2vl"] = check_kernels(fa, ops, list(v_cases), v_cases)
    log(f"flash kernel checks at the qwen2-vl path's shapes passed; max "
        f"abs error {family_errs['qwen2vl']}")
    v_launches = run_family_path(
        QWEN2VL_ARGS, v_batches, [("flash kernels", ("flash_",))]
        + OTHER_GROUPS, BF16_MODEL_RTOL)
    log(f"qwen2-vl path: {time.perf_counter() - t0:.1f} s")

    # -- stablelm and gemma3 paths: head dims 80 and 256, K1-K3 --------
    wide = {}
    for fam, args, extra_cases in (
            ("stablelm", STABLELM_ARGS, []),
            # squad lengths never reach the window: one case that does
            ("gemma3", GEMMA3_ARGS,
             [(2, 2048, 16, 8, 256, True, 1024, dt, True)
              for dt in ("bfloat16", "float32")])):
        t0 = time.perf_counter()
        f_batches = main_path_batches(args)
        wide[fam] = run_wide_path(fa, ops, kb, args, f_batches, extra_cases)
        family_errs[fam] = wide[fam]["errs"]
        log(f"{fam} path: {time.perf_counter() - t0:.1f} s")

    # -- serving: decode and the engine (no kernel on this path) --------
    t0 = time.perf_counter()
    serve_launches = run_serve_path(ops)
    log(f"serve path: {time.perf_counter() - t0:.1f} s")

    # -- phase E: the examples and Tables 3-4 (E1 runs K1-K3) ------------
    t0 = time.perf_counter()
    e_launches, family_errs["e1"] = run_examples_phase(fa, ops)
    log(f"examples phase: {time.perf_counter() - t0:.1f} s")

    # -- phase K6: AdamW's update and clip norm --------------------------
    t0 = time.perf_counter()
    adamw_row = run_adamw_path(ka)
    log(f"adamw phase: {time.perf_counter() - t0:.1f} s")

    launches["ssd_scan"] += h_launches["ssd_scan"]
    for name in FLASH_KERNELS:
        launches[name] += (h_launches[name] + g_launches[name]
                           + s_launches[name] + v_launches[name]
                           + r_launches[name] + sh_launches[name]
                           + d_launches[name] + e_launches[name]
                           + sum(w["launches"][name] for w in wide.values()))
        errs[name] = max([errs[name]] + [e[name]
                                         for e in family_errs.values()])
    kernels = []
    for name, source, replaces in KERNELS:
        t = timings[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "serve_launches": serve_launches[name]}
        for extra in ("fma_ms", "chunked_ms"):
            if extra in t:
                row[extra] = t[extra]
        if name in FLASH_KERNELS:
            # max_abs_err is over every main path's shapes; each bf16
            # family's part of it
            row.update({f"{f}_max_abs_err": e[name]
                        for f, e in family_errs.items()})
            # D2 and D3: bert's step on DTensor shards (part of launches)
            row["distributed_launches"] = d_launches[name]
            # E1: the end-to-end example (part of launches)
            row["examples_launches"] = e_launches[name]
            # the head-dim 80 and 256 instances at their paths' shapes
            for f, w in wide.items():
                row[f"{f}_launches"] = w["launches"][name]
                row.update({f"{f}_{k}": w["timing"][name][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")})
        if name == "ssd_scan":
            # the hymba path's instance (P = 50, N = 16) and the FMA
            # kernel's time at its shape, in turns
            row.update({f"hymba_{k}": hymba_k4[k] for k in (
                "ms", "fma_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")})
            row["hymba_launches"] = h_launches["ssd_scan"]
        kernels.append(row)
    kernels.append(adamw_row)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
