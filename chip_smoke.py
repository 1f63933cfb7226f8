#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the SD processor on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure ends the run with exit 1 and
no result line):

1. environment — the card's name and power limit, torch and CUDA versions;
2. build       — nvcc builds ``src/repro_torch/csrc/*.cu`` for sm_90a;
3. kernels     — each hand-written kernel at every shape the main path
                 gives it (plus a ragged case) against its plain PyTorch
                 version on the card, with times, bounds and tolerances;
                 PSSA also with gathered queries (Tq = T/8, the edit path),
                 timed with the stream held and inputs rotated past the L2,
                 its bound on the 3xTF32 tensor-core basis beside the fp32
                 one, the replaced fp32 kernel's time and the count of
                 scores its guard band recomputed;
                 the bit-slice matmul bit-exact under both dataflows at
                 its six shapes, a ragged K = 77 and the int32
                 wrap-around, timed with the stream held and inputs
                 rotated past the L2, beside the replaced int32 kernel's
                 time and the torch._int_mm pair;
                 TIPS cross-attention at res 64/32/16 and a ragged Tq,
                 timed with the stream held and inputs rotated past the
                 L2, its bound on the 3xTF32 basis beside the fp32 one,
                 the replaced fp32 kernel's time and SDPA's for the
                 output alone; the op on the UNet's head-split views
                 runs no copy and equals the 3-D call;
                 the SSD scan at the serve prompt, the CLI's default
                 prompt, a ragged T, an odd T (chunk 1), a large dt and
                 hymba-1.5b's prefill (state 16, 50 heads), its bound on
                 the 3xTF32 basis (C B^T once per batch row) beside the
                 fp32 one and the per-head count, the replaced kernel's
                 time and the chunked torch route's;
4. slice       — full-width BK-SDM-Tiny text-to-image, 25 DDIM steps at
                 guidance 7.5, through ``DiffusionEngine.generate`` on the
                 kernel route; launch counters must read 225/225/450;
5. mesh        — data-parallel diffusion on a device mesh in one NCCL
                 group of one rank: ``generate`` under ``make_data_mesh(1)``
                 bit-equal to the unsharded engine (images, latents, every
                 stats leaf; 9/9/18 launches a step), ``serve(mesh=)``'s
                 ledger bit-equal to ``serve(mesh=None)`` with a padded tail,
                 ``ClusterRouter(engines=[e0, e1])`` bit-equal to the
                 shared-engine router, ``--mesh 2`` refused on one card;
6. slots       — slot serving on the slice's engine: two requests through
                 2 slots bit-equal to ``generate`` at batch 2, ledger
                 headline key for key; a staggered ddim@25 + dpm2m@12 bank
                 drain of three requests, bit-equal to banked one-shot
                 runs on the float FFN and within a bound on the slice
                 route (DBSC's shared scale); 9/9/18 launches per step,
                 none in admit, decode or retire; s per slot_step at 1, 2
                 and 4 slots, each kernel against its plain version on a
                 4-slot step's inputs;
7. slot_reuse  — slot serving under temporal reuse on the slice's
                 weights, on the fused attention + float FFN route and the
                 slice route: two requests through 2 and 4 slots, bit-equal
                 across the slot counts and to one-shot ``generate`` on the
                 float FFN (within a bound on the slice route), the reuse
                 buckets and ratios from the accumulator; admission
                 invalidates a row's cache; a staggered ddim@25 +
                 dpm2m@12 (detail_guard) bank drain bit-equal to its
                 banked one-shot witnesses; 9/9/18 + 9 patch-delta
                 launches per step; s per slot_step under reuse beside
                 dense;
8. dit         — DiT-S/2 (12 x 384, 6 heads of 64, a 16x16 token grid) at
                 full width through the same engine: one-shot generate on
                 the slice route (300/300/600 launches, profile), the
                 kernels against their plain versions on the card over
                 two steps on three seeds, each kernel on one DiT step's
                 inputs (held and timed), a banked slot drain on 2 and 4
                 slots bit-equal to one-shot, temporal reuse;
9. serving     — the serving front-end (``launch.scheduler``,
                 ``launch.serve_diffusion``) at full width: eight
                 requests through ``ContinuousScheduler`` and
                 ``FixedBatchScheduler`` at 4 slots, at t = 0 on the slice
                 route (images bit-equal across the two, 9/9/18 launches a
                 step) and on a bursty trace on ``--kernels auto`` for
                 BK-SDM and DiT-S/2 (latency percentiles, queue wait,
                 goodput, occupancy; latents bit-equal to one-shot
                 witnesses at batch 4, the ledger against theirs); then
                 ``serve_diffusion.main`` in process at full width;
10. router     — the cluster router (``launch.router``) at full width,
                 replicas of 2 slots: eight requests through 1, 2 and 4
                 replicas on the float FFN (images, merged int64 buckets
                 and energy equal across the counts and to ``generate`` at
                 batch 2 on the batches served), the slice route at 1
                 against 2 replicas (bit-equal to its own batches, within
                 a share of the DBSC-to-float distance across them), SLO
                 overload degrading against queueing round for round,
                 DiT-S/2 at 1 against 2 replicas, the serving phase's
                 bursty trace through 2 x 2 replicas, previews,
                 ``router._main`` in process, and
                 ``serve_diffusion --replicas 2`` in process at full width
                 with a bank, an SLO and previews;
11. autotune   — the compiled-path kernel policy at full width: the
                 committed autotune table validates and covers its
                 geometries; at each, every launch-knob candidate bit-equal
                 to the launch rule, the winner timed beside the rule;
                 ``autotuned`` + DBSC bit-equal to ``fused`` + DBSC for
                 BK-SDM and DiT-S/2 (225/225/450, 300/300/600, the ledger
                 key for key) and every geometry of those runs, of a reuse
                 run and of a 4-slot step in the table;
                 ``ffn_quant=int8`` bit-equal to the DBSC route with no
                 bit-slice kernel launch; ``serve_diffusion.main`` in
                 process at full width on ``--kernels autotuned`` and on
                 ``--kernels ffn=dbsc,ffn_quant=int8``;
12. bitmap     — the PSXU entry point ``dispatch.patch_bitmap`` on the
                 pruned SAS of one cond row at res 64/32/16 (full-width
                 weights): kernel against plain bit for bit, per-row sums
                 of the counts against the PSSA popcount, 3 launches;
13. temporal   — the slice with temporal patch reuse: threshold 0 equals
                 the dense latents (as far as a dense witness agrees with
                 itself), threshold 0.05 launches 225/225/450/225;
14. edit       — img2img replay at capacity 1/8 against recorded base
                 caches: the same input computes nothing and returns the
                 base latents; a re-noised window stays within the cap and
                 runs PSSA on T/8 queries; an a-priori window runs no
                 patch delta;
15. parity     — two full-width steps from the same latents, route against
                 route: the reference policy against the fused attention
                 kernels, then reference attention + DBSC against the
                 slice's route (fused + DBSC) on three seeds, then the
                 reference route against the fused route with temporal
                 reuse; latents, ledger headlines and per-layer PSSA and
                 reuse counters must agree within the limits below.
16. serve      — mamba2-130m at full width (random weights from a seed)
                 through ``repro_torch.launch.serve.serve``: batch 4, a
                 4096-token prompt, 64 greedy tokens, prefill's scan on the
                 ``ssd_scan`` kernel (24 launches, none in decode); the
                 kernel route against the chunked bf16 route layer by
                 layer, at 2 layers and at 24; the float32 model's 24
                 layers on the kernel against the same model on the plain
                 recurrence (logits and final state); prefill(T) + one
                 decode step against prefill(T + 1) in float32 and bf16,
                 with a zeroed-state control; profiles of prefill and
                 decode.
17. lm         — llama3-8b (dense), qwen2-moe-a2.7b (moe) and hymba-1.5b
                 (hybrid) at their published geometry, one at a time,
                 through ``launch.serve.serve``: batch 4, a 2048-token
                 prompt (hymba's rings wrap), 16 greedy tokens; hymba's
                 prefill on ``ssd_scan`` (32 launches, none in decode) and
                 each of its mixers on the kernel against the chunked
                 route; the first token is prefill's argmax; the int8 KV
                 cache against the bf16 one (dense, moe); prefill(T) + one
                 decode step against prefill(T + 1) with zeroed-KV and
                 (hymba) zeroed-SSM-state controls; profiles of prefill
                 and 4 decode steps.
18. train      — LM training through ``launch.train.build`` and
                 ``train.make_train_step`` (AdamW on
                 ``linear_warmup_cosine``, remat on, PSSA and TIPS as
                 configured, bf16): hymba-1.5b at its published geometry,
                 depth not cut, batch 4 x 2048 from ``SyntheticLMDataset``:
                 (a) four steps with finite losses and grad norms above 0,
                 (b) step 1's loss against ``loss_fn`` of the initial
                 parameters under ``no_grad``, (c) the fourth loss on one
                 batch repeated below the first; qwen2-moe-a2.7b at its
                 published widths, depth cut to 2 of 24 layers, batch 4 x
                 1024: (a) and a finite aux above 0; at qwen2-moe's
                 widths cut to 1 layer and at hymba's cut to 4: (d) a
                 ``Trainer`` run killed at step 3 and resumed in a fresh
                 one ends where an uninterrupted run ends (bit for bit;
                 for hymba, or within ten times the gap between two
                 uninterrupted runs), (e) gradients with remat equal those
                 without (the same); hymba's (f) the ``ssd_scan`` kernel
                 route refuses to train; s a step, tokens/s, peak GB, the
                 busy share and the five largest device ops of one step,
                 the model-FLOP share of 989 TFLOP/s.  Then the tensor-
                 and expert-parallel path at degree 1, in a one-rank NCCL
                 group on ``make_elastic_mesh()``: (g) qwen2-moe's 2-layer
                 state and hymba's 4-layer one take ``make_train_step(
                 ctx=)``'s step bit for bit against the unsharded step
                 (loss, grad norm, parameters, moments), with and without
                 ``remat_save_collectives``, the collectives a step and
                 their host us printed; (h) hymba-1.5b whole prefills on
                 the ``ssd_scan`` kernel under the mesh bit for bit
                 against ``ctx=None`` (one call a layer each); (i)
                 ``launch.train --sharded`` takes 2 steps at smoke
                 geometry through its CLI; (j) ZeRO-3: (g)'s two states
                 take ``make_train_step(zero3=True)``'s step at degree 1
                 bit for bit against the unsharded step, every leaf
                 gathered through the one-rank group where it is used
                 (twice a layer leaf under remat) and its gradient
                 reduce-scattered, the counts and their host us printed.
19. dryrun     — the dry-run (``launch.dryrun``) on torch's fake process
                 group, fake CUDA tensors, no card memory: (a)
                 ``run_cell`` of mamba2-130m x train_4k (TP-folded onto
                 256 x 1) and llama3-8b x decode_32k on the 16 x 16 mesh:
                 status ok, flops, bytes and collective bytes above 0,
                 the dense decode's 1- and 2-layer extrapolation equal to
                 its full trace, ``memory_allocated`` the same before and
                 after; (b) the memory model: hymba-1.5b's whole step (4 x
                 2048) and qwen2-moe's 2-layer step (4 x 1024), traced on
                 a fake (1, 1) group, predict the peak that one real step
                 of the same step function reads from
                 ``max_memory_allocated`` within ``DRYRUN_MEM_RTOL``, and
                 issue the all-reduces the real step counts; (c) the
                 traces of the train phase's (g) steps give (g)'s model-
                 and data-axis all-reduce counts exactly; (d) llama3-8b x
                 decode_32k through the CLI (``dryrun.main``), its record
                 read back from ``--out``; (e) ZeRO-3 (``fsdp``):
                 ``run_cell(fsdp=True)`` of mamba2-130m x train_4k beside
                 (a)'s ZeRO-1 record, and llama3-8b x train_4k at full
                 width cut to 16 layers (the data degree 16 still divides
                 its layer axis), one microbatch, traced with and without
                 ``fsdp`` on the 16 x 16 group: the arguments less exactly
                 the sliced parameter bytes x (dp - 1) / dp, the same
                 FLOPs, a lower peak; and hymba's 4-layer ZeRO-3 step
                 traced on a fake (1, 1) group predicts one real step's
                 peak within ``DRYRUN_MEM_RTOL``, its gathers and scatters
                 counted the same.  The (a) cell of llama3-8b is
                 (d)'s record.  The traces need the host alone: they run
                 in a worker process started after the kernels phase
                 (``start_dryrun_traces``), beside the card's phases, and
                 this phase reads them and runs (b)'s real steps.
20. examples   — the five example twins (``repro_torch.examples``), each
                 ``main()`` in process on the card: ``quickstart`` (the
                 DBSC kernel's integers equal its oracle; one bit-slice
                 and one cross-attention launch), ``tips_visualization``,
                 ``generate_image`` at its defaults (BK-SDM-Tiny at full
                 width, 5 steps, 9 / 9 / 18 launches a step; its
                 ``mj_per_iter_with_ema`` against the reference attention
                 + DBSC within 1e-6), ``serve_lm`` at its defaults and
                 ``train_lm`` for 3 steps; their printed lines.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
TF32_FLOPS = 495e12         # TF32 tensor cores, dense
INT8_OPS = 1979e12          # int8 tensor cores, dense

THRESHOLD = 1.0 / 8192.0
TIE_REL = 1e-5              # |p - tau| / tau at a flipped key: a tie
PSSA_MAX_ROW_DIFF = 2       # counts per row (the JAX package's own drift)
PSSA_MAX_ROW_FRAC = 1e-3    # share of rows that may differ at T=4096
OUT_ATOL = 1e-3             # attention outputs: fp32 order + tie flips
CAS_ATOL = 1e-5             # CAS: fp32 summation order only
CLS_KEY_SCALE = 2.5         # puts the head-averaged CAS across the 0.05 cut
LATENT_ATOL = 1e-3          # parity, float FFN: latents after two steps
LEDGER_RTOL = 1e-6          # parity: ledger headlines, relative
# With the DBSC FFN on both routes an ulp of difference upstream flips
# INT12 codes by one step, and every later layer sees that step.  Readings
# on the first seed were latents 1.18e-3 and counters at 1.23 of the
# per-layer counter bound (PSSA_MAX_ROW_DIFF counts on PSSA_MAX_ROW_FRAC
# of the layer's rows); these limits leave room above them and stay well
# below what a wrong tile or a miscounted row gives (latents O(0.1),
# counters far past the bound).
DBSC_LATENT_ATOL = 1e-2
DBSC_COUNTER_SCALE = 4.0    # times the per-layer counter bound
DBSC_SEEDS = (11, 21, 31)
REUSE_THRESHOLD = 0.05      # ReusePolicy.temporal() / .edit() default
REUSE_TIE_REL = 1e-3        # |delta - thr| / thr at a flipped patch: a tie
EDIT_CAPACITY = 0.125
EDIT_WINDOW = (4, 4, 8, 8)  # latent pixels (y0, x0, h, w) re-noised
SLOT_TIPS_SCALE = (1.25, 1.0, 0.8)  # (b)'s dpm2m policy: TIPS cut by phase
SLOT_COUNTS = (1, 2, 4)             # s per slot_step at these slot counts
SLOT_TIMED_STEPS = 4                # timed steps per slot count (1 warm-up)
# On the DBSC route a staggered slot row shares its per-tensor INT12 scale
# with other requests and steps, which redraws its rounding: it is held
# to this share of the distance between its one-shot runs on the DBSC and
# the float FFN.  The H100 read 0.15-0.23 % (5.8e-3 to 7.3e-3 of 2.8 to
# 4.9); a request admitted one step ahead, or two rows' solver histories
# swapped, read far above it (PERF.md, PR 19).
DBSC_SLOT_SHARE = 0.01
# A request served on 2 slots against the same request on 4: cuBLAS picks
# its fp32 GEMM by the batch's row count, so the bits differ (ROADMAP
# Queue 3).  Ten times the largest difference the H100 read at
# REUSE_THRESHOLD (PERF.md §6): BK-SDM 7.42e-4 on the float FFN and
# 3.95e-3 on the slice route (the idle rows enter DBSC's per-tensor
# scale), DiT-S/2 4.96e-5 on the float FFN.
SLOT_COUNT_ATOL = {"float route": 7.4e-3, "slice route": 4e-2, "dit": 5e-4}
# The same on the reuse buckets: equal on the float FFN; on the slice
# route DBSC's shared scale can carry a patch delta across the threshold.
# Ten times the H100's reading at the median step-1 delta (1 patch of
# 16800 moved; PERF.md §6), as a share of the patches accounted.
SLICE_BUCKET_SHARE = 6e-4
# DiT-S/2's staggered slot rows on the slice route against their own
# batch's witness, as DBSC_SLOT_SHARE holds BK-SDM's: the H100 read
# 0.76-1.11 % of the rows' 4.5e-2-5.1e-2 DBSC-to-float distance (DiT's
# FFN error is small beside the UNet's 3.6-4.9); 4.5x the largest, as
# DBSC_SLOT_SHARE was set (PERF.md §6).
DIT_DBSC_SLOT_SHARE = 0.05
SLICE_ROUTE_PER_STEP = {"pssa_attention": 9, "cross_attention_tips": 9,
                        "bitslice_matmul": 18}
L2_BYTES = 50e6             # H100 L2: timed inputs rotate past it
# The bit-slice kernel this one replaced (an int32 GEMM on the CUDA
# cores) at the six main-path shapes, ms (PERF.md: NVIDIA H100 80GB HBM3,
# 700 W; CUDA events over launches back to back, inputs not rotated)
BITSLICE_INT32_MS = {"ff_geglu res64": 1.090, "ff_out res64": 0.752,
                    "ff_geglu res32": 1.128, "ff_out res32": 0.818,
                    "ff_geglu res16": 1.163, "ff_out res16": 1.102}
# The PSSA kernel this one replaced (fp32 CUDA cores) at the six shapes of
# pssa_rows, ms (PERF.md: NVIDIA H100 80GB HBM3, 700 W; CUDA events over
# launches back to back, inputs not rotated; the gathered and ragged rows
# from later runs of the same kernel)
PSSA_FP32_MS = {"res64 down0.0 cond-only": 2.279, "res64 up3.*": 4.364,
                "res32": 0.493, "res16": 0.246, "ragged T=48": 0.0515,
                "res64 gathered Tq=T/8": 0.7981}
# The cross-attention kernel this one replaced (fp32 CUDA cores) at the
# rows of cross_rows, ms (PERF.md: NVIDIA H100 80GB HBM3, 700 W; CUDA
# events over launches back to back, inputs not rotated; the ragged row
# from a later run of the same kernel)
CROSS_FP32_MS = {"res64": 0.0905, "res32": 0.0499, "res16": 0.0716,
                 "ragged Tq=100": 0.0280}
# SSD scan kernel against the sequential recurrence, |k - p| <= tol (1 +
# |p|): the JAX package's bound for its chunked kernel against its oracle
SSD_TOL = 2e-4
# The SSD scan kernel this one replaced (one block per row walking its
# chunks, fp32 CUDA cores) at the serve row, ms (PERF.md: NVIDIA H100 80GB
# HBM3, 700 W; inputs rotated past the L2)
SSD_ROWWISE_MS = {"serve prefill T=4096": 5.118}
# serve: mamba2-130m, batch 4, a 4096-token prompt (chunk 128), 64 tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 4096, 64
# prefill logits, kernel route against the chunked route (which rounds its
# diagonal-block operands to bf16), relative to the largest logit: the
# JAX package's own bound for this pair
ROUTE_RTOL = 2e-2
# The pair compounds with depth: the JAX package's own pair passes 2e-2
# at 2 layers and reads 4.3e-2 at 24 (tests/test_torch_ssm.py::
# test_route_pair_grows_with_depth_as_in_jax).  So each layer (on the same
# input) and the first 2 layers are held to ROUTE_RTOL, and the logits of
# all 24 only to ROUTE_DEEP_RTOL, a bound on the bf16 drift of the chunked
# route, not a check of the kernel.
ROUTE_DEEP_RTOL = 1e-1
# The full-depth check of the kernel: the float32 model's prefill logits
# and final state on the kernel against the same model on the plain
# float32 recurrence (ssd_scan_fused(use_kernel=False)) on the card.  No
# bf16 rounding on either side; only the sum order differs.
DEEP_F32_RTOL = 1e-4
# prefill(T) + one decode step against prefill(T + 1), relative to the
# largest logit.  float32 (weights and activations): only sum order
# differs, so the final state must carry over to ~float32 precision.
# bfloat16 (the model as served): decode rounds the conv and the
# projections at other points than prefill's T + 1 run, and that compounds
# over 24 layers; the same decode step from a zeroed state (the control)
# must land past the limit, so the limit can tell a lost state.
CARRY_F32_RTOL = 1e-4
CARRY_RTOL = 1e-1
# lm: llama3-8b, qwen2-moe-a2.7b and hymba-1.5b at their published
# geometry (random weights from a seed): batch 4, a 2048-token prompt
# (past hymba's 1024-token window, so its ring buffers wrap), 16 greedy
# tokens (32 before the train phase's (g)-(i) came: decode depth paid for
# them); profiles of prefill and of 4 decode steps
LM_BATCH, LM_PROMPT, LM_NEW, LM_PROFILE_STEPS = 4, 2048, 16, 4
LM_GEOMETRY = {
    "llama3-8b": dict(
        family="dense", num_layers=32, d_model=4096, num_heads=32,
        num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=128256,
        rope_theta=500000.0, dtype="bfloat16"),
    "qwen2-moe-a2.7b": dict(
        family="moe", num_layers=24, d_model=2048, num_heads=16,
        num_kv_heads=16, head_dim=128, num_experts=60, num_shared_experts=4,
        top_k=4, moe_d_ff=1408, vocab_size=151936, dtype="bfloat16"),
    "hymba-1.5b": dict(
        family="hybrid", num_layers=32, d_model=1600, num_heads=25,
        num_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
        ssm_state=16, ssm_heads=50, ssm_head_dim=64, sliding_window=1024,
        dtype="bfloat16"),
}
# prefill(T) + one decode_step against prefill(T + 1) with PSSA and TIPS
# off (TIPS fake-quantises on a per-sample scale, which a 1-token decode
# and a T-token prefill do not share), relative to the largest logit,
# batch 4.  llama3-8b and qwen2-moe-a2.7b in bf16, as served: the decode
# path rounds its GEMMs and attention sums at other points than the
# longer prefill, and that compounds over the layers; the bound of the
# mamba2 bf16 carry.  qwen2 routes every token to all 60 experts for this
# check (top_k = num_experts, capacity factor 1: no choice, no drop): at
# top-4 that rounding swaps a router's 4th and 5th gates now and then,
# and one expert swapped in one layer moves the logits by O(0.1) (the
# top-4 bf16 carry read 2.2e-1 on the H100 against 1.3 for its zeroed-KV
# control; float32 does not help, as decode_attention rounds q and the
# probabilities to bf16 whatever the model dtype: 2.3e-3 at smoke widths
# on the CPU).  hymba-1.5b in float32 (its bf16 weights cast in place):
# with random weights its SSM state decays within a few steps, so a
# zeroed state moves the logits by only 9e-2 (2 layers) to 1.7e-1 (8
# layers) at smoke widths on the CPU, beside a bf16 carry of 1.1e-2 to
# 2.0e-2 there (float32: 5e-7 to 8e-7).  Each control (the same step from
# a zeroed KV cache, and for hymba from a zeroed SSM state) must land
# past its bound.
LM_CARRY_RTOL = 1e-1
LM_CARRY_F32_RTOL = 1e-3
# One decode step's logits from the int8 KV cache against the same step
# from the bf16 cache (the same prefill): the int8 grid (0.05) rounds
# keys and values by up to 0.025.  A wrong scale or layout reads O(1).
LM_INT8_RTOL = 0.2

# The train phase.  TRAIN_LR: the CLI's default rate for (a).  (c) asks
# whether the gradient points down, so it steps at TRAIN_DESCENT_LR: a
# first Adam step moves every weight by about lr along the sign of its
# gradient, which at d_model 1600 moves a layer's output by about lr d
# times its scale (~0.5 at 3e-4, with no warm-up in four steps) and can
# step past the minimum along that direction.  TRAIN_LOSS_RTOL: (b)'s
# bound, step 1's loss (autograd recording, remat) against loss_fn under
# no_grad on the same parameters and batch: the same kernels in the same
# order give the same bits, and the bound leaves room for a reduction
# that cuBLAS or torch runs in another order under autograd (float32
# logsumexp and mean over 8192 tokens).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
TRAIN_MOE_SEQ, TRAIN_MOE_LAYERS = 1024, 2
TRAIN_MOE_FT_LAYERS = 1     # (d), (e): qwen2-moe's depth for resume, remat
TRAIN_FT_LAYERS, TRAIN_FT_SEQ = 4, 1024
TRAIN_LR, TRAIN_DESCENT_LR = 3e-4, 1e-5
TRAIN_LOSS_RTOL = 1e-5
# (g)-(i): the tensor- and expert-parallel path at degree 1, one NCCL rank
# (the host has one card): every collective is an identity over the one
# rank and the ops are those of ctx=None, so the sharded step, prefill and
# CLI are held bit for bit.  TRAIN_CLI_ARGS: launch.train --sharded at
# smoke geometry through its CLI.
TRAIN_CLI_ARGS = ("--arch", "hymba-1.5b", "--smoke", "--steps", "2",
                  "--batch", "4", "--seq", "64", "--sharded")
H100_BF16_DENSE_FLOPS = 989e12

REPLACES = {
    "pssa_attention":
        "src/repro/kernels/pssa_attention/kernel.py:156",
    "cross_attention_tips":
        "src/repro/kernels/cross_attention_tips/kernel.py:98",
    "bitslice_matmul":
        "src/repro/kernels/bitslice_matmul/kernel.py:87",
    "patch_delta":
        "src/repro/kernels/patch_reuse/kernel.py:40",
    "patch_bitmap":
        "src/repro/kernels/patch_bitmap/kernel.py:58",
    "ssd_scan":
        "src/repro/kernels/ssd_scan/kernel.py:92",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)
            out = fn(*a, **kw)
            print(f"== phase {name} ok in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return wrap


# ---------------------------------------------------------------------------
@phase("environment")
def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    require(torch.cuda.is_available(), "CUDA is not available")
    return smi[0] if smi else "nvidia-smi gave no output"


@phase("build")
def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"built {path.name} from {len(build.sources())} sources in "
          f"{time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
def bound(bytes_moved: float, ops: float, rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (bytes, operations) each kernel's function needs: each input read once,
# each output written once; PSSA's P V counts the kept scores only, the
# bit-slice matmul's lo plane only its INT12 rows (lo * prec is zero on
# the others).  The bounds take PSSA's and cross-attention's operations as
# three TF32 products each (their 3xTF32 scheme).
def pssa_work(bh, tq, tk, d, nnz):
    return (4.0 * (2 * bh * tq * d + 2 * bh * tk * d + 2 * bh * tq),
            2.0 * bh * tq * tk * d + 2.0 * nnz * d)


def cross_work(bh, tq, tk, d):
    return (4.0 * (2 * bh * tq * d + 2 * bh * tk * d + bh * tq),
            2.0 * 2.0 * bh * tq * tk * d)


def bitslice_work(m, k, n, int12):
    return (4.0 * ((m + int12) * k + k * n + m + m * n),
            2.0 * k * n * (m + int12))


def delta_work(b, p, w):
    return 4.0 * (2 * b * p * w + b * p), 3.0 * b * p * w


def rotating_ms(torch, fn, sets, reps: int = 30, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn(*args)`` by CUDA events, the calls cycling
    through ``sets`` of inputs that together exceed the L2 cache, so each
    call reads its inputs from device memory as the main path does: one
    round of ``runtime.min_ms`` (the stream held by a 20 ms sleep while
    the host queues every call, so the events time the calls back to back
    on the card)."""
    from repro_torch.kernels import runtime
    return runtime.min_ms(fn, sets, reps=1, calls=reps, warmup=warmup)


def same_bits(torch, a, b) -> bool:
    """Equal float32 tensors bit for bit, NaN where NaN (its payload
    aside)."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


def kernel_keep_bits(torch, q, k, bh, r, patch):
    """The kernel's own keep bits for query row ``r`` of head ``bh``, and
    its nnz for that row.

    The row runs alone, repeated over ceil(T/d) heads whose values are
    one-hot on d different keys each, so ``out`` holds the kernel's kept
    p of every key, 0 where it pruned.  A row's scores, max and sum do
    not depend on the other rows of its block, so its bits are the ones
    of the full launch.
    """
    from repro_torch.kernels.pssa_attention.kernel import (
        pssa_attention_kernel)
    t, d = k.shape[1], k.shape[2]
    nb = -(-t // d)
    keys = torch.arange(t, device=k.device)
    v = torch.zeros((nb, t, d), device=k.device)
    v[keys // d, keys, keys % d] = 1.0
    out, nnz, _ = pssa_attention_kernel(
        q[bh, r:r + 1].expand(nb, 1, d).contiguous(),
        k[bh].expand(nb, t, d).contiguous(), v, THRESHOLD, patch)
    return out.reshape(-1)[:t] > 0, int(nnz[0, 0])


def flipped_key_distance(torch, q, k, rows, nnz_k, nnz_p, patch):
    """Largest |p - tau| / tau, with p the plain softmax, over the keys
    whose keep bit the kernel flipped in the given (bh, query) rows.

    p is recomputed by the plain version's own operations, and the
    kernel's keep bits are read with ``kernel_keep_bits``; both are held
    to the row's nnz first.  Near 0 means the rows differ only on scores
    that sit on the threshold.
    """
    if rows.numel() == 0:
        return 0.0
    d = q.shape[-1]
    scores = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(float(d))
    probs = torch.softmax(scores, dim=-1)
    del scores
    worst = 0.0
    for bh, r in rows.tolist():
        p = probs[bh, r]
        keep_p = p >= THRESHOLD
        keep_k, nnz = kernel_keep_bits(torch, q, k, bh, r, patch)
        require(int(keep_p.sum()) == int(nnz_p[bh, r])
                and int(keep_k.sum()) == nnz == int(nnz_k[bh, r]),
                f"row ({bh}, {r}): keep bits do not add up to the nnz")
        flipped = keep_k != keep_p
        if not bool(flipped.any()):    # same bits, different counts
            return math.inf
        dist = (p[flipped] - THRESHOLD).abs().max() / THRESHOLD
        worst = max(worst, dist.item())
    return worst


def check_pssa(torch, label, q, k, patch, kern, plain, exact: bool):
    """Kernel against plain.  ``exact``: the counters must be equal.
    Otherwise (T=4096) rows may differ by PSSA_MAX_ROW_DIFF counts on
    PSSA_MAX_ROW_FRAC of the rows, and only on keys within TIE_REL of the
    threshold."""
    out_k, nnz_k, xor_k = kern
    out_p, nnz_p, xor_p = plain
    err = (out_k - out_p).abs().max().item()
    dn = (nnz_k - nnz_p).abs()
    dx = (xor_k - xor_p).abs()
    diff = (dn > 0) | (dx > 0)
    nrows = int(diff.sum().item())
    maxd = int(max(dn.max().item(), dx.max().item()))
    frac = nrows / diff.numel()
    rows = diff.nonzero()[:128]
    tie = flipped_key_distance(torch, q, k, rows, nnz_k, nnz_p, patch)
    print(f"  {label}: out max|err| {err:.3e}, counter rows differing "
          f"{nrows}/{diff.numel()} ({frac:.2e}), largest difference {maxd}, "
          f"largest |p-tau|/tau at a flipped key {tie:.2e}")
    require(err <= OUT_ATOL, f"{label}: out error {err} > {OUT_ATOL}")
    if exact:
        require(nrows == 0, f"{label}: {nrows} counter rows differ; the "
                            f"counters must be exact at this size")
        return err
    require(maxd <= PSSA_MAX_ROW_DIFF,
            f"{label}: a counter row differs by {maxd} > "
            f"{PSSA_MAX_ROW_DIFF}")
    require(frac <= PSSA_MAX_ROW_FRAC,
            f"{label}: {nrows} counter rows differ (> {PSSA_MAX_ROW_FRAC})")
    require(tie <= TIE_REL,
            f"{label}: counters differ at keys {tie:.2e} of tau from it, "
            f"past {TIE_REL}: not a tie")
    return err


def kernel_row(rows, name, label, shape, ms, plain_ms, b, err, main,
               library_ms=None, note=""):
    """Print one timed shape (``note`` appended to the printed line only);
    keep it as the kernel's row if ``main``."""
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    print(f"kernel {name} {label} shape={shape} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b[0]:.4f} "
          f"bound_by={b[1]} library_ms={lib} max_abs_err={err:.3e}"
          + (f" {note}" if note else ""), flush=True)
    if main:
        rows[name] = {"name": name, "route": "cuda",
                      "source": SOURCES[name],
                      "replaces": REPLACES[name], "shape": shape,
                      "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b[0],
                      "bound_by": b[1], "library_ms": library_ms}


def pssa_rows(torch, g) -> dict:
    """PSSA kernel against plain at every main-path shape, the gathered
    queries of the edit path included (Tq = T/8 against Tk = T), timed
    with the stream held and the inputs rotated past the L2.

    The bound counts 2*BH*Tq*Tk*d + 2*nnz*d operations, each as three TF32
    tensor-core products (the kernel's 3xTF32 scheme) at TF32_FLOPS.  The
    printed line also gives the fp32-core bound of the same operations and
    the replaced fp32 kernel's time (``PSSA_FP32_MS``, a constant, so not in
    the JSON row), and how many scores the kernel's guard band recomputed
    in fp32 in the checked launch."""
    from repro_torch.kernels.pssa_attention.kernel import (
        band_count, band_reset, pssa_attention_kernel)
    from repro_torch.kernels.pssa_attention.ref import (
        pssa_attention_stats_ref)
    rows = {}
    # (label, BH, Tq, Tk, d, patch, exact, main)
    for label, bh, tq, tk, d, patch, exact, main in [
            ("res64 down0.0 cond-only", 8, 4096, 4096, 40, 64, False,
             False),
            ("res64 up3.*", 16, 4096, 4096, 40, 64, False, True),
            ("res32", 16, 1024, 1024, 80, 32, True, False),
            ("res16", 16, 256, 256, 160, 16, True, False),
            ("ragged T=48", 2, 48, 48, 40, 16, True, False),
            ("res64 gathered Tq=T/8", 16, 512, 4096, 40, 64, False, False)]:
        q = torch.randn((bh, tq, d), generator=g, device="cuda")
        k, v = (torch.randn((bh, tk, d), generator=g, device="cuda")
                for _ in range(2))
        # the checked inputs come from ``g`` as before; the copies that the
        # timing rotates through come from a generator of their own
        rot = torch.Generator(device="cuda").manual_seed(tq + tk + d)
        sets = [(q, k, v)] + [
            tuple(torch.randn(x.shape, generator=rot, device="cuda")
                  for x in (q, k, v))
            for _ in range(1, math.ceil(
                2 * L2_BYTES / (4 * (bh * tq * d + 2 * bh * tk * d))))]
        band_reset()
        kern = pssa_attention_kernel(q, k, v, THRESHOLD, patch)
        torch.cuda.synchronize()
        band = band_count()
        plain = pssa_attention_stats_ref(q, k, v, THRESHOLD, patch)
        err = check_pssa(torch, f"pssa_attention {label}", q, k, patch,
                         kern, plain, exact)
        ms = rotating_ms(torch, lambda *a: pssa_attention_kernel(
            *a, THRESHOLD, patch), sets, reps=10)
        plain_ms = rotating_ms(torch, lambda *a: pssa_attention_stats_ref(
            *a, THRESHOLD, patch), sets, reps=3)
        nbytes, ops = pssa_work(bh, tq, tk, d, plain[1].sum().item())
        fp32 = bound(nbytes, ops, FP32_FLOPS)
        old = PSSA_FP32_MS[label]
        kernel_row(rows, "pssa_attention", label, [bh, tq, tk, d, patch],
                   ms, plain_ms, bound(nbytes, 3.0 * ops, TF32_FLOPS), err,
                   main, note=f"fp32_core_bound_ms={fp32[0]:.4f} "
                              f"fp32_kernel_ms={old} ({ms / old:.3f} of it) "
                              f"band_recomputed={band} of {bh * tq * tk}")
        del sets, q, k, v, kern, plain
    return rows


def patch_delta_rows(torch, g, kernel, plain_fn) -> dict:
    """patch_delta at the four full-width shapes (W = patch * C = 20480;
    the pre-dup down0.0 block has one row, the others two), a ragged case
    (P = 7, W = 2050: no float4, a partial chunk) and a NaN/inf case, each
    equal to the plain version bit for bit.  ``library_ms`` times
    ``F.pairwise_distance(p=inf, eps=0)``, the same max |x - r| per row."""
    import torch.nn.functional as F
    rows = {}
    for label, b, p, w, main in [
            ("res64 down0.0 cond-only", 1, 64, 20480, False),
            ("res64", 2, 64, 20480, True),
            ("res32", 2, 32, 20480, False),
            ("res16", 2, 16, 20480, False),
            ("ragged P=7 W=2050", 3, 7, 2050, False),
            ("nan and inf", 2, 16, 20480, False)]:
        set_bytes = 2 * 4 * b * p * w
        sets = []
        for _ in range(max(1, math.ceil(2 * L2_BYTES / set_bytes))):
            x = torch.randn((b, p, w), generator=g, device="cuda")
            r = x + 0.02 * torch.randn((b, p, w), generator=g,
                                       device="cuda")
            r[:, ::5] = x[:, ::5]              # unchanged patches: delta 0
            sets.append((x, r))
        x, r = sets[0]
        if label.startswith("nan"):
            x[0, 3, 100] = float("nan")
            r[1, 5, 7] = float("inf")
            x[1, 9, 2] = float("-nan")
        out = kernel(x, r)
        torch.cuda.synchronize()
        plain = plain_fn(x, r, 1)          # (B, P, W): P one-token patches
        require(same_bits(torch, out, plain),
                f"patch_delta {label}: not bit-exact against plain")
        if label.startswith("nan"):
            require(bool(torch.isnan(out[0, 3])) and bool(
                torch.isnan(out[1, 9])) and bool(torch.isinf(out[1, 5])),
                "patch_delta: NaN or inf did not propagate")
            print(f"  patch_delta {label}: NaN and inf propagate, "
                  f"bit-exact elsewhere")
            continue
        lib_out = F.pairwise_distance(x.reshape(-1, w), r.reshape(-1, w),
                                      p=math.inf, eps=0.0).reshape(b, p)
        lib_err = (lib_out - plain).abs().max().item()
        print(f"  patch_delta {label}: bit-exact; pairwise_distance "
              f"max|diff| {lib_err:.3e}")
        ms = rotating_ms(torch, kernel, sets, reps=60)
        plain_ms = rotating_ms(torch, lambda a, c: plain_fn(a, c, 1), sets,
                               reps=20)
        lib_ms = rotating_ms(
            torch, lambda a, c: F.pairwise_distance(
                a.reshape(-1, w), c.reshape(-1, w), p=math.inf, eps=0.0),
            sets, reps=20)
        nbytes, ops = delta_work(b, p, w)      # subtract, abs, max
        kernel_row(rows, "patch_delta", label, [b, p, w], ms, plain_ms,
                   bound(nbytes, ops, FP32_FLOPS), 0.0, main,
                   library_ms=lib_ms)
        del sets, x, r
    return rows


def _int_mm_pair(torch, sets):
    """The two int8 products alone, ``hi @ w`` and ``(lo * prec) @ w``,
    through ``torch._int_mm`` (cuBLASLt) on int8 copies of ``sets``, the
    copies rotated past the L2 too: a yardstick of the card's int8 GEMM,
    two library calls and no shift-add.  (ms, None), or (None, why) where
    ``_int_mm`` refuses the shape."""
    per_set = sum(x.numel() for x in sets[0][:3])       # int8 bytes
    pairs = []
    for i in range(max(1, math.ceil(2 * L2_BYTES / per_set))):
        hi, lo, w, prec = sets[i % len(sets)]
        pairs.append((hi.to(torch.int8), (lo * prec).to(torch.int8),
                      w.to(torch.int8)))

    def pair(h, l, w):
        return torch._int_mm(h, w), torch._int_mm(l, w)
    try:
        pair(*pairs[0])
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).strip().splitlines()[0][:160]
    return rotating_ms(torch, pair, pairs, reps=30), None


def bitslice_rows(torch, g) -> dict:
    """The DBSC bit-slice matmul at the six main-path shapes (ff_geglu and
    ff_out at res 64, 32 and 16; M = 2 * res^2 rows, CFG-fused) and a
    ragged case, bit-exact against the plain version under both
    dataflows, timed with the stream held and the inputs rotated past the
    L2, as the main path finds them.  Beside each row it prints the
    replaced int32 kernel's time at the same shape (``BITSLICE_INT32_MS``,
    a constant, so not in the JSON row), the ``torch._int_mm`` pair and
    the input_stationary order's time.  The bound counts what this run's
    first input set needs: the lo plane and its products only on INT12
    rows, since ``lo * prec`` is zero on the others."""
    from repro_torch.kernels.bitslice_matmul.kernel import (
        bitslice_matmul_kernel)
    from repro_torch.kernels.bitslice_matmul.ref import bitslice_matmul_ref
    rows = {}
    cases = []
    for res, c in ((64, 320), (32, 640), (16, 1280)):
        t2 = 2 * res * res
        cases.append((f"ff_geglu res{res}", t2, c, 8 * c, res == 64))
        cases.append((f"ff_out res{res}", t2, 4 * c, c, False))
    cases.append(("ragged", 100, 77, 50, False))
    for label, m, kk, n, main in cases:
        sets = []
        for _ in range(max(1, math.ceil(
                2 * L2_BYTES / (4 * (2 * m * kk + kk * n + m))))):
            hi, lo = (torch.randint(0, 64, (m, kk), generator=g,
                                    device="cuda", dtype=torch.int32)
                      for _ in range(2))
            w = torch.randint(-128, 128, (kk, n), generator=g,
                              device="cuda", dtype=torch.int32)
            prec = torch.randint(0, 2, (m, 1), generator=g, device="cuda",
                                 dtype=torch.int32)
            sets.append((hi, lo, w, prec))
        hi, lo, w, prec = sets[0]
        plain = bitslice_matmul_ref(hi, lo, w, prec)
        for dataflow in ("weight_stationary", "input_stationary"):
            out = bitslice_matmul_kernel(hi, lo, w, prec, dataflow)
            require(torch.equal(out, plain),
                    f"bitslice_matmul {label} {dataflow}: not bit-exact")
        ms = rotating_ms(torch, bitslice_matmul_kernel, sets, reps=30)
        is_ms = rotating_ms(torch, lambda *a: bitslice_matmul_kernel(
            *a, "input_stationary"), sets, reps=30)
        plain_ms = rotating_ms(torch, bitslice_matmul_ref, sets, reps=5)
        pair_ms, why = _int_mm_pair(torch, sets)
        nbytes, ops = bitslice_work(m, kk, n, prec.sum().item())
        kernel_row(rows, "bitslice_matmul", label, [m, kk, n], ms, plain_ms,
                   bound(nbytes, ops, INT8_OPS), 0.0, main)
        old = BITSLICE_INT32_MS.get(label)
        print(f"  bitslice_matmul {label}: bit-exact under both dataflows; "
              f"int32 kernel {old if old else 'null'} ms"
              + (f" (now {ms / old:.3f} of it)" if old else "")
              + "; _int_mm pair "
              + (f"{pair_ms:.4f} ms" if why is None else f"null ({why})")
              + f"; input_stationary {is_ms:.4f} ms", flush=True)
        if main:
            rows["bitslice_matmul"]["int_mm_pair_ms"] = pair_ms
        del sets, hi, lo, w, prec, plain, out
    # int32 wrap-around: 63 * 127 * 5120 << 6 passes 2**31
    hi = torch.full((64, 5120), 63, dtype=torch.int32, device="cuda")
    w = torch.full((5120, 64), 127, dtype=torch.int32, device="cuda")
    prec = torch.ones((64, 1), dtype=torch.int32, device="cuda")
    plain = bitslice_matmul_ref(hi, hi, w, prec)
    expect = (63 * 127 * 5120 * 65 + 2 ** 31) % 2 ** 32 - 2 ** 31
    for dataflow in ("weight_stationary", "input_stationary"):
        out = bitslice_matmul_kernel(hi, hi, w, prec, dataflow)
        require(torch.equal(out, plain) and int(out[0, 0]) == expect,
                f"bitslice_matmul overflow {dataflow}: {int(out[0, 0])} "
                f"!= {expect}")
    print(f"  bitslice_matmul int32 wrap-around case equal under both "
          f"dataflows ({int(out[0, 0])})")
    return rows


def cross_rows(torch, g) -> dict:
    """The TIPS cross-attention kernel against its plain version at the
    main path's three shapes and a ragged Tq, through the contiguous 3-D
    call, timed with the stream held and the inputs rotated past the L2:
    out within OUT_ATOL, CAS within CAS_ATOL and the importance masks
    downstream equal under fixed and adaptive spotting.

    The bound counts 4*BH*Tq*Tk*d operations (q k^T and p @ v), each as
    three TF32 tensor-core products (the kernel's 3xTF32 scheme) at
    TF32_FLOPS, against each input read once and out and cas written once.
    The printed line also gives the fp32-core bound, the replaced fp32
    kernel's time (``CROSS_FP32_MS``, a constant, so not in the JSON row)
    and, as a note, ``F.scaled_dot_product_attention``'s time for the
    output alone on the same inputs (it gives no CAS, so ``library_ms``
    stays null)."""
    import torch.nn.functional as F
    from repro_torch.core.precision import PrecisionPolicy, spot_cas
    from repro_torch.kernels.cross_attention_tips.kernel import (
        cross_attention_tips_kernel)
    from repro_torch.kernels.cross_attention_tips.ref import (
        cross_attention_tips_ref)
    rows = {}
    # (label, BH, Tq, Tk, d, main)
    for label, bh, tq, tk, d, main in [
            ("res64", 16, 4096, 77, 40, True),
            ("res32", 16, 1024, 77, 80, False),
            ("res16", 16, 256, 77, 160, False),
            ("ragged Tq=100", 2, 100, 77, 40, False)]:
        q = torch.randn((bh, tq, d), generator=g, device="cuda")
        k, v = (torch.randn((bh, tk, d), generator=g, device="cuda")
                for _ in range(2))
        k[:, 0] *= CLS_KEY_SCALE        # CAS on both sides of the cut
        rot = torch.Generator(device="cuda").manual_seed(tq + tk + d)
        sets = [(q, k, v)]
        for _ in range(1, math.ceil(
                2 * L2_BYTES / (4 * (bh * tq * d + 2 * bh * tk * d)))):
            sets.append(tuple(torch.randn(x.shape, generator=rot,
                                          device="cuda") for x in (q, k, v)))
            sets[-1][1][:, 0] *= CLS_KEY_SCALE
        out_k, cas_k = cross_attention_tips_kernel(q, k, v, 0)
        torch.cuda.synchronize()
        out_p, cas_p = cross_attention_tips_ref(q, k, v, 0)
        err_o = (out_k - out_p).abs().max().item()
        err_c = (cas_k - cas_p).abs().max().item()
        require(err_o <= OUT_ATOL and err_c <= CAS_ATOL,
                f"cross_attention_tips {label}: out {err_o} / cas {err_c}")
        # the importance mask downstream, through the port's spotting on
        # the head-averaged CAS (8 heads per row; the ragged case: 1 row)
        heads = 8 if bh % 8 == 0 else bh
        for pol in (PrecisionPolicy.fixed(), PrecisionPolicy.adaptive()):
            imp_k, imp_p = (
                spot_cas(c.reshape(bh // heads, heads, tq).mean(1),
                         pol).important for c in (cas_k, cas_p))
            print(f"  cross_attention_tips {label} {pol.spotting}: "
                  f"{imp_p.float().mean().item():.3f} of rows important, "
                  f"masks equal {bool(torch.equal(imp_k, imp_p))}")
            require(torch.equal(imp_k, imp_p),
                    f"cross_attention_tips {label}: {pol.spotting} "
                    f"importance masks differ")
        print(f"  cross_attention_tips {label}: out max|err| {err_o:.3e}, "
              f"cas max|err| {err_c:.3e}")
        ms = rotating_ms(torch, lambda *a: cross_attention_tips_kernel(
            *a, 0), sets, reps=30)
        plain_ms = rotating_ms(torch, lambda *a: cross_attention_tips_ref(
            *a, 0), sets, reps=10)
        sdpa_ms = rotating_ms(torch, F.scaled_dot_product_attention, sets,
                              reps=30)
        nbytes, ops = cross_work(bh, tq, tk, d)
        fp32 = bound(nbytes, ops, FP32_FLOPS)
        old = CROSS_FP32_MS[label]
        kernel_row(rows, "cross_attention_tips", label, [bh, tq, tk, d], ms,
                   plain_ms, bound(nbytes, 3.0 * ops, TF32_FLOPS),
                   max(err_o, err_c), main,
                   note=f"fp32_core_bound_ms={fp32[0]:.4f} "
                        f"fp32_kernel_ms={old} ({ms / old:.3f} of it) "
                        f"sdpa_out_only_ms={sdpa_ms:.4f}")
        if main:
            rows["cross_attention_tips"]["sdpa_out_only_ms"] = sdpa_ms
        del sets, q, k, v, out_k, out_p
    return rows


def cross_heads_check(torch, g) -> None:
    """``ops.cross_attention_cas`` on the UNet's own head-split views (res
    64 under CFG: B 2, H 8, Tq 4096, d 40): out and CAS equal to the
    contiguous 3-D call's bit for bit, the head merge a view of out's
    memory, and no device kernel in the op but the cross-attention
    kernel's, so neither q nor out is copied."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.diffusion.unet import _attn_heads, _merge_heads
    from repro_torch.kernels.cross_attention_tips.kernel import (
        cross_attention_tips_kernel)
    from repro_torch.kernels.cross_attention_tips.ops import (
        cross_attention_cas)
    b, h, tq, tk, d = 2, 8, 4096, 77, 40
    x = torch.randn((b, tq, h * d), generator=g, device="cuda")
    ctx = torch.randn((b, tk, h * d), generator=g, device="cuda")
    w_q, w_k, w_v = (torch.randn((h * d, h * d), generator=g, device="cuda")
                     / math.sqrt(h * d) for _ in range(3))
    q = _attn_heads(x, w_q, h)
    k, v = _attn_heads(ctx, w_k, h), _attn_heads(ctx, w_v, h)
    require(not q.is_contiguous(), "the head split gave a contiguous q")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, cas = cross_attention_cas(q, k, v, 0)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0)) > 0}
    merged = _merge_heads(out)
    flat = [x.reshape(b * h, t, d).contiguous()
            for x, t in ((q, tq), (k, tk), (v, tk))]
    out3, cas3 = cross_attention_tips_kernel(*flat, 0)
    same = (same_bits(torch, out.reshape(b * h, tq, d), out3)
            and same_bits(torch, cas.reshape(b * h, tq), cas3))
    print(f"  cross_attention_tips heads: device kernels in the op "
          f"{sorted(n[:60] for n in names)}; merge is a view "
          f"{merged.data_ptr() == out.data_ptr()}; equal to the 3-D call "
          f"{same}")
    require(len(names) == 1
            and "cross_attention_tips_kernel" in next(iter(names)),
            f"cross_attention_cas ran other device kernels: {names}")
    require(merged.data_ptr() == out.data_ptr()
            and merged.untyped_storage().data_ptr()
            == out.untyped_storage().data_ptr(),
            "the head merge copied out")
    require(same, "the head-split call differs from the 3-D call")


@phase("kernels")
def kernels_phase(torch):
    from repro_torch.kernels.patch_reuse.kernel import patch_delta_kernel
    from repro_torch.kernels.patch_reuse.ref import patch_delta_ref

    g = torch.Generator(device="cuda").manual_seed(1234)
    rows = pssa_rows(torch, g)

    rows.update(cross_rows(torch, g))
    cross_heads_check(torch, g)
    rows.update(bitslice_rows(torch, g))
    rows.update(patch_delta_rows(
        torch, torch.Generator(device="cuda").manual_seed(4321),
        patch_delta_kernel, patch_delta_ref))
    rows.update(ssd_scan_rows(
        torch, torch.Generator(device="cuda").manual_seed(5678)))
    return rows


def ssd_scan_rows(torch, g) -> dict:
    """The SSD scan kernel against its plain version (the sequential
    recurrence, on the TPU kernel's folded contract: B and C copied per
    head) at the serve prompt, the CLI's default prompt, a ragged T, an
    odd T (chunk 1; the kernel still runs 128-step tiles), a large dt
    whose |dA| sums past 88 inside a chunk, and hymba-1.5b's prefill
    (state 16, 50 heads: 16 state columns in the vectorised loads).  The
    kernel reads the model's per-batch B and C in place (``heads``), as
    the main path gives them.  Inputs as in tests/test_ssd_kernel.py.

    Beside each row: the bound on two counts of the work (C B^T once per
    batch row, which all heads share, or once per head as the replaced
    kernel's bound counted it), each on the 3xTF32 tensor-core basis and
    on the fp32 cores; and, for information only, the port's chunked
    torch route (``models.ssm.ssd_scan``: many cuBLAS calls on
    bf16-rounded operands, not one call of the same function) on the same
    inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels.runtime import cuda_ms
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ops import pick_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.ssm import ssd_scan as chunked_route
    rows = {}
    p = 64
    # (label, batch, T, state n, heads, dt scale, main): mamba2-130m's
    # serve shapes, then hymba-1.5b's prefill (state 16, 50 heads)
    for label, b, t, n, heads, dts, main in [
            ("serve prefill T=4096", 4, 4096, 128, 24, 1.0, True),
            ("CLI default prompt T=32", 4, 32, 128, 24, 1.0, False),
            ("ragged T=4000", 4, 4000, 128, 24, 1.0, False),
            ("odd prompt T=4095", 4, 4095, 128, 24, 1.0, False),
            ("large dt T=512", 1, 512, 128, 24, 12.0, False),
            ("hymba prefill T=2048", 4, LM_PROMPT, 16, 50, 1.0, False)]:
        bh, chunk = b * heads, pick_chunk(t, 128)
        set_bytes = 4 * (bh * t * p + bh * t + 2 * b * t * n)
        sets = []
        for _ in range(max(2, math.ceil(2 * L2_BYTES / set_bytes))):
            x = torch.randn((bh, t, p), generator=g, device="cuda")
            dA = -dts * F.softplus(torch.randn((bh, t), generator=g,
                                               device="cuda"))
            B, C = (0.3 * torch.randn((b, t, n), generator=g, device="cuda")
                    for _ in range(2))
            sets.append((x, dA, B, C))
        x, dA, B, C = sets[0]
        if dts > 1:
            most = float(-dA[:, :chunk].sum(dim=1).min())
            require(most > 88.0, f"ssd_scan {label}: |dA| sums to {most} in "
                                 f"a chunk, not past 88")
        y, s = ssd_scan_kernel(x, dA, B, C, chunk=chunk, heads=heads)
        torch.cuda.synchronize()
        Bh, Ch = (a.repeat_interleave(heads, 0) for a in (B, C))
        y_p, s_p = ssd_scan_ref(x, dA, Bh, Ch, chunk=chunk)
        finite = bool(torch.isfinite(y).all() and torch.isfinite(s).all())
        err = max((y - y_p).abs().max().item(), (s - s_p).abs().max().item())
        excess = max(((y - y_p).abs() / (1 + y_p.abs())).max().item(),
                     ((s - s_p).abs() / (1 + s_p.abs())).max().item())
        print(f"  ssd_scan {label}: BH {bh} chunk {chunk}, y/state max|err| "
              f"{err:.3e} (max |err|/(1+|p|) {excess:.3e}), finite {finite}")
        require(finite, f"ssd_scan {label}: NaN or inf in the output")
        require(excess <= SSD_TOL, f"ssd_scan {label}: error {excess:.3e} > "
                                   f"{SSD_TOL} (1 + |plain|)")
        ms = rotating_ms(torch, lambda *a: ssd_scan_kernel(
            *a, chunk=chunk, heads=heads), sets, reps=10, warmup=2)
        plain_ms = cuda_ms(ssd_scan_ref, x, dA, Bh, Ch, chunk, reps=2,
                           warmup=1)
        # the chunked route in the model's layout: x / dt with dt = -dA and
        # A = -1, so that its x * dt and dt * A give back x and dA.  It
        # keeps a (b, h, p, n) state per chunk, three times over: at chunk
        # 1 and T 4095 some 40 GB, so it is not timed there.
        dt = -dA
        xm = (x / dt[..., None]).reshape(b, heads, t, p).movedim(1, 2)
        dtm = dt.reshape(b, heads, t).movedim(1, 2)
        neg = -torch.ones(heads, device="cuda")
        route = "not timed (chunk 1)"
        if chunk > 1:
            route_ms = cuda_ms(chunked_route, xm, dtm, neg, B, C, chunk,
                               reps=3, warmup=1)
            route = f"{route_ms:.4f}"
        # per chunk of l steps: C B^T and ((C B^T) o L) @ x on the causal
        # half only (l (l + 1) / 2 pairs of 2n and 2p flops; L is zero
        # above the diagonal), C @ state^T and x^T @ B (2pn each per step).
        # C B^T is the same for the heads of a batch row: the function
        # needs it once per batch row (the replaced kernel's bound counted
        # it once per head).
        # B and C read once per batch row, in place.
        ops = (1.0 * b * t * (chunk + 1) * n
               + 1.0 * bh * t * ((chunk + 1) * p + 4 * p * n))
        ops_head = 1.0 * bh * t * ((chunk + 1) * (n + p) + 4 * p * n)
        nbytes = 4.0 * (2 * bh * t * p + bh * t + 2 * b * t * n
                        + bh * p * n)
        tf32 = bound(nbytes, 3 * ops, TF32_FLOPS)
        old = SSD_ROWWISE_MS.get(label)
        note = (f"bound_ms 3xTF32/fp32: shared C B^T "
                f"{3 * ops / TF32_FLOPS * 1e3:.4f}/"
                f"{ops / FP32_FLOPS * 1e3:.4f} ({ops / 1e9:.2f} GFLOP), "
                f"per head {3 * ops_head / TF32_FLOPS * 1e3:.4f}/"
                f"{ops_head / FP32_FLOPS * 1e3:.4f} ({ops_head / 1e9:.2f} "
                f"GFLOP); bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f}; "
                f"chunked torch route {route} (informational)"
                + (f"; replaced row-wise kernel {old}" if old else ""))
        kernel_row(rows, "ssd_scan", label, [bh, t, p, n, chunk, heads], ms,
                   plain_ms, tf32, err, main, note=note)
        del sets, x, dA, B, C, y, s, Bh, Ch, y_p, s_p, xm, dtm
    return rows


def _rel(a, ref) -> float:
    a, ref = a.float(), ref.float()
    return ((a - ref).abs().max() / ref.abs().max()).item()


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _route_pair_per_layer(torch, cfg, params, prompts) -> list:
    """Each layer's mixer, kernel route against chunked route, on the same
    input: the kernel route's own activations at that layer (an ssm
    layer is its mixer; a hybrid layer runs its whole block on)."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    chunked = cfg.scaled(use_ssd_kernel=False)
    x = L.embed(prompts, params["embed"])
    b, t = prompts.shape
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    pairs = []
    for i in range(cfg.num_layers):
        lp = _tree(lambda a: a[i], params["layers"])
        xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        hk = SSM.mamba_mixer(xa, lp["ssm"], cfg)
        pairs.append(_rel(hk, SSM.mamba_mixer(xa, lp["ssm"], chunked)))
        if cfg.family == "ssm":
            x = x + hk
        else:
            x, _, _ = T._block_train(x, lp, cfg, positions,
                                     is_global=T._is_global_layer(cfg, i))
    return pairs


@contextlib.contextmanager
def _plain_scan():
    """Route the model's ``ssd_scan_fused`` to its plain recurrence
    (``use_kernel=False``) inside the block."""
    from repro_torch.models import ssm as SSM
    fused = SSM.ssd_scan_fused
    SSM.ssd_scan_fused = functools.partial(fused, use_kernel=False)
    try:
        yield
    finally:
        SSM.ssd_scan_fused = fused


@phase("serve")
def serve_phase(torch):
    """mamba2-130m at full width through the port's serve entry point."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T

    cfg = get_arch("mamba2-130m").scaled(use_ssd_kernel=True)
    require((cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
             cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv_width,
             cfg.vocab_size, cfg.dtype) == (24, 768, 1536, 24, 64, 128, 4,
                                            50280, "bfloat16"),
            "not the published mamba2-130m geometry")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    torch.cuda.synchronize()
    print(f"full-width parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator(
                                device="cuda").manual_seed(1), device="cuda")
    serve(cfg, params, prompts[:, :256], 2)            # warm-up
    runtime.reset_launch_counts()
    tokens, tm = serve(cfg, params, prompts, SERVE_NEW)
    counts = runtime.launch_counts()
    print(f"launches {json.dumps(tm['launches'])}")
    layers = cfg.num_layers
    require(tm["launches"]["prefill"].get("ssd_scan") == layers
            and counts.get("ssd_scan") == layers,
            f"ssd_scan launches in prefill {tm['launches']['prefill']} "
            f"!= {layers}")
    require(tm["launches"]["decode"].get("ssd_scan", 0) == 0,
            f"ssd_scan launched in decode: {tm['launches']['decode']}")
    require(tuple(tokens.shape) == (SERVE_BATCH, SERVE_NEW)
            and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size,
            f"tokens {tuple(tokens.shape)} out of shape or vocabulary")
    steps = tm["decode_steps"]
    print(f"serve: prefill s {tm['prefill_s']:.4f} "
          f"({SERVE_BATCH * SERVE_PROMPT / tm['prefill_s']:.0f} prompt "
          f"tokens/s); decode ms/token {tm['decode_s'] / steps * 1e3:.3f} "
          f"(one step of the batch of {SERVE_BATCH}), decode tokens/s "
          f"{SERVE_BATCH * steps / tm['decode_s']:.1f}; {steps} steps")

    with torch.inference_mode():
        lk, cache = T.prefill(params, cfg, tokens=prompts)
        lc, _ = T.prefill(params, cfg.scaled(use_ssd_kernel=False),
                          tokens=prompts)
        per_layer = _route_pair_per_layer(torch, cfg, params, prompts)
        # the pair at the depth of the JAX package's own test (2 layers)
        cfg2 = cfg.scaled(num_layers=2)
        p2 = dict(params, layers=_tree(lambda a: a[:2], params["layers"]))
        lk2, _ = T.prefill(p2, cfg2, tokens=prompts)
        lc2, _ = T.prefill(p2, cfg2.scaled(use_ssd_kernel=False),
                           tokens=prompts)
        nxt = tokens[:, :1]
        longer = torch.cat([prompts, nxt], dim=1)
        ld, _ = T.decode_step(params, cache, nxt, SERVE_PROMPT, cfg)
        lf, _ = T.prefill(params, cfg, tokens=longer)
        lost = dict(cache, state=torch.zeros_like(cache["state"]))
        ld0, _ = T.decode_step(params, lost, nxt, SERVE_PROMPT, cfg)
        f32 = cfg.scaled(dtype="float32")
        p32 = _tree(lambda a: a.float(), params)
        lk32, c32 = T.prefill(p32, f32, tokens=prompts)
        ld32, _ = T.decode_step(p32, c32, nxt, SERVE_PROMPT, f32)
        lf32, _ = T.prefill(p32, f32, tokens=longer)
        before = runtime.launch_counts().get("ssd_scan", 0)
        with _plain_scan():
            lp32, cp32 = T.prefill(p32, f32, tokens=prompts)
        require(runtime.launch_counts().get("ssd_scan", 0) == before,
                "the plain float32 prefill launched ssd_scan")
    require(all(bool(torch.isfinite(a).all())
                for a in (lk, lc, lk2, lc2, ld, lf, lk32, lp32, ld32, lf32)),
            "non-finite logits")
    require(torch.equal(lk[:, -1].argmax(dim=-1), tokens[:, 0]),
            "serve's first token is not prefill's argmax")
    route, route2 = _rel(lk, lc), _rel(lk2, lc2)
    carry, control, carry32 = _rel(ld, lf), _rel(ld0, lf), _rel(ld32, lf32)
    deep32 = _rel(lk32, lp32)
    state32 = _rel(c32["state"], cp32["state"])
    worst = max(per_layer)
    print(f"  kernel route against the chunked bf16 route: each layer's "
          f"mixer on the same input, worst {worst:.3e} (layer "
          f"{per_layer.index(worst)}; limit {ROUTE_RTOL}); prefill logits "
          f"of the first 2 layers {route2:.3e} (limit {ROUTE_RTOL}); of all "
          f"{layers} {route:.3e} (bf16 drift bound {ROUTE_DEEP_RTOL})")
    print(f"  float32 model, {layers} layers, kernel against the plain "
          f"recurrence: prefill logits {deep32:.3e}, final state "
          f"{state32:.3e} (limit {DEEP_F32_RTOL})")
    print(f"  prefill(T={SERVE_PROMPT}) + decode_step against prefill(T+1) "
          f"(chunk 1): float32 {carry32:.3e} (limit {CARRY_F32_RTOL}); "
          f"bf16 {carry:.3e} (limit {CARRY_RTOL}); bf16 with the state "
          f"zeroed (control) {control:.3e} (must exceed {CARRY_RTOL})")
    require(worst <= ROUTE_RTOL, f"a layer's route pair {worst:.3e} > "
                                 f"{ROUTE_RTOL}")
    require(route2 <= ROUTE_RTOL, f"2-layer route pair {route2:.3e} > "
                                  f"{ROUTE_RTOL}")
    require(route <= ROUTE_DEEP_RTOL, f"route pair {route:.3e} > "
                                      f"{ROUTE_DEEP_RTOL}")
    require(max(deep32, state32) <= DEEP_F32_RTOL,
            f"float32 kernel against plain at full depth: logits "
            f"{deep32:.3e}, state {state32:.3e} > {DEEP_F32_RTOL}")
    require(carry32 <= CARRY_F32_RTOL,
            f"float32 carry {carry32:.3e} > {CARRY_F32_RTOL}")
    require(carry <= CARRY_RTOL < control,
            f"bf16 carry {carry:.3e} / control {control:.3e} against "
            f"{CARRY_RTOL}")

    def prefill_run():
        return serve(cfg, params, prompts, 1)[1]["prefill_s"]

    def decode_run():
        c, tok = cache, nxt
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(16):
                logits, c = T.decode_step(params, c, tok, SERVE_PROMPT + i,
                                          cfg)
                tok = logits[:, -1].argmax(dim=-1)[:, None]
            torch.cuda.synchronize()
        return time.perf_counter() - t0
    profile_breakdown(torch, prefill_run, "serve prefill")
    profile_breakdown(torch, decode_run, "serve decode (16 steps)")
    return counts


def _hold_geometry(cfg, name) -> None:
    want = LM_GEOMETRY[name]
    got = {k: getattr(cfg, k) for k in want}
    require(got == want, f"{name}: not the published geometry: {got}")


def _zero_kv(torch, cfg, cache):
    """A copy of a decode cache with every key and value zeroed (the
    hybrid SSM entries kept)."""
    if cfg.family == "hybrid":
        return [dict(c, k=torch.zeros_like(c["k"]),
                     v=torch.zeros_like(c["v"])) for c in cache]
    return {k: torch.zeros_like(a) for k, a in cache.items()}


def _zero_state(torch, cache):
    """A copy of a hybrid decode cache with every SSM state zeroed."""
    return [dict(c, k=c["k"].clone(), v=c["v"].clone(),
                 ssm=dict(c["ssm"], state=torch.zeros_like(c["ssm"]["state"])))
            for c in cache]


def _float_(tree) -> None:
    """Cast every leaf to float32 in place, one at a time, so that the
    peak is the float32 model and one bf16 leaf."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            _float_(tree[k])
        else:
            tree[k] = tree[k].float()


def _lm_carry(torch, cfg, params, prompts):
    """prefill(T) + decode_step against prefill(T + 1), with the
    controls; PSSA and TIPS off, and for moe every token routed to every
    expert at a capacity at which none drops (prefill routes B (T + 1)
    tokens and decode B, which drop differently at the configured
    factor; see LM_CARRY_RTOL for the routing).  Returns {label: relative
    distance}."""
    from repro_torch.models import transformer as T
    c = cfg.scaled(tips=False, pssa=False)
    if c.family == "moe":
        c = c.scaled(top_k=c.num_experts, moe_capacity_factor=1.0)
    t = prompts.shape[1]
    logits, pcache = T.prefill(params, c, tokens=prompts)
    nxt = logits[:, -1].argmax(dim=-1)[:, None]
    cache = T.decode_cache_from_prefill(c, pcache, t + 1)
    del pcache
    controls = {"zeroed KV (control)": _zero_kv(torch, c, cache)}
    if c.family == "hybrid":
        controls["zeroed SSM state (control)"] = _zero_state(torch, cache)
    # controls first: decode_step writes the new key and value in place
    out = {label: T.decode_step(params, cc, nxt, t, c)[0]
           for label, cc in controls.items()}
    del controls
    step, cache = T.decode_step(params, cache, nxt, t, c)
    del cache
    full, _ = T.prefill(params, c, tokens=torch.cat([prompts, nxt], dim=1))
    got = {"carry": _rel(step, full)}
    got.update({label: _rel(l0, full) for label, l0 in out.items()})
    return got


@phase("lm")
def lm_phase(torch):
    """llama3-8b (dense), qwen2-moe-a2.7b (moe) and hymba-1.5b (hybrid,
    prefill's scan on ``ssd_scan``) at their published geometry through
    the port's serve entry point, one model on the card at a time."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    for seed, name in enumerate(LM_GEOMETRY):
        t_model = time.perf_counter()
        cfg = get_arch(name)
        if cfg.family == "hybrid":
            cfg = cfg.scaled(use_ssd_kernel=True)
        _hold_geometry(cfg, name)
        t0 = time.perf_counter()
        params = T.init_params(
            torch.Generator(device="cuda").manual_seed(seed), cfg)
        torch.cuda.synchronize()
        n = sum(a.numel() for a in leaves(params))
        print(f"{name}: {n / 1e9:.3f} B parameters, "
              f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card, "
              f"initialised in {time.perf_counter() - t0:.2f} s")
        prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                                generator=torch.Generator(
                                    device="cuda").manual_seed(100 + seed),
                                device="cuda")
        serve(cfg, params, prompts[:, :128], 2)            # warm-up
        runtime.reset_launch_counts()
        tokens, tm = serve(cfg, params, prompts, LM_NEW)
        counts = runtime.launch_counts()
        want = cfg.num_layers if cfg.family == "hybrid" else 0
        print(f"  launches {json.dumps(tm['launches'])}")
        require(tm["launches"]["prefill"].get("ssd_scan", 0) == want
                and counts.get("ssd_scan", 0) == want,
                f"{name}: ssd_scan launches in prefill "
                f"{tm['launches']['prefill']} != {want}")
        require(tm["launches"]["decode"].get("ssd_scan", 0) == 0,
                f"{name}: ssd_scan launched in decode")
        require(tuple(tokens.shape) == (LM_BATCH, LM_NEW)
                and int(tokens.min()) >= 0
                and int(tokens.max()) < cfg.vocab_size,
                f"{name}: tokens {tuple(tokens.shape)} out of shape or "
                f"vocabulary")
        steps = tm["decode_steps"]
        print(f"  serve: prefill s {tm['prefill_s']:.4f} "
              f"({LM_BATCH * LM_PROMPT / tm['prefill_s']:.0f} prompt "
              f"tokens/s); decode ms/token "
              f"{tm['decode_s'] / steps * 1e3:.3f} (one step of the batch "
              f"of {LM_BATCH}), decode tokens/s "
              f"{LM_BATCH * steps / tm['decode_s']:.1f}; {steps} steps")

        with torch.inference_mode():
            logits, pcache = T.prefill(params, cfg, tokens=prompts)
            require(bool(torch.isfinite(logits).all()),
                    f"{name}: non-finite prefill logits")
            require(torch.equal(logits[:, -1].argmax(dim=-1), tokens[:, 0]),
                    f"{name}: serve's first token is not prefill's argmax")
            nxt = tokens[:, :1]
            cache = T.decode_cache_from_prefill(cfg, pcache, LM_PROMPT + 1)
            ld, _ = T.decode_step(params, cache, nxt, LM_PROMPT, cfg)
            require(bool(torch.isfinite(ld).all()),
                    f"{name}: non-finite decode logits")
            if cfg.family in ("dense", "moe"):
                c8 = cfg.scaled(kv_cache_dtype="int8")
                cache8 = T.decode_cache_from_prefill(c8, pcache,
                                                     LM_PROMPT + 1)
                require(cache8["k"].dtype == torch.int8,
                        f"{name}: the int8 cache is {cache8['k'].dtype}")
                ld8, _ = T.decode_step(params, cache8, nxt, LM_PROMPT, c8)
                del cache8
                int8 = _rel(ld8, ld)
                tokens8, tm8 = serve(c8, params, prompts, LM_NEW)
                require(tuple(tokens8.shape) == (LM_BATCH, LM_NEW)
                        and int(tokens8.min()) >= 0
                        and int(tokens8.max()) < cfg.vocab_size,
                        f"{name}: int8 KV tokens out of the vocabulary")
                print(f"  --kv-int8: decode step logits against the bf16 "
                      f"cache's {int8:.3e} (limit {LM_INT8_RTOL}); tokens "
                      f"equal to the bf16 run's "
                      f"{float((tokens8 == tokens).float().mean()):.3f}; "
                      f"prefill s {tm8['prefill_s']:.4f}, decode ms/token "
                      f"{tm8['decode_s'] / steps * 1e3:.3f}")
                require(int8 <= LM_INT8_RTOL,
                        f"{name}: int8 KV logits {int8:.3e} from the bf16 "
                        f"cache's, past {LM_INT8_RTOL}")
            del cache, pcache, logits, ld
            if cfg.family == "hybrid":
                pairs = _route_pair_per_layer(torch, cfg, params, prompts)
                worst = max(pairs)
                print(f"  each layer's mixer, kernel route against the "
                      f"chunked bf16 route on the same input: worst "
                      f"{worst:.3e} (layer {pairs.index(worst)}; limit "
                      f"{ROUTE_RTOL})")
                require(worst <= ROUTE_RTOL,
                        f"{name}: a layer's route pair {worst:.3e} > "
                        f"{ROUTE_RTOL}")

        def prefill_run():
            return serve(cfg, params, prompts, 1)[1]["prefill_s"]

        with torch.inference_mode():
            lg, pc = T.prefill(params, cfg, tokens=prompts)
            dcache = T.decode_cache_from_prefill(
                cfg, pc, LM_PROMPT + LM_PROFILE_STEPS)
            tok0 = lg[:, -1].argmax(dim=-1)[:, None]
            del lg, pc

        def decode_run():
            c, tok = dcache, tok0
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(LM_PROFILE_STEPS):
                    lg, c = T.decode_step(params, c, tok, LM_PROMPT + i, cfg)
                    tok = lg[:, -1].argmax(dim=-1)[:, None]
                torch.cuda.synchronize()
            return time.perf_counter() - t0
        t_prof = time.perf_counter()
        profile_breakdown(torch, prefill_run, f"{name} prefill")
        profile_breakdown(torch, decode_run,
                          f"{name} decode ({LM_PROFILE_STEPS} steps)")
        print(f"  profiles in {time.perf_counter() - t_prof:.2f} s")
        del dcache, tok0
        # the carry last: hymba's float32 casts the weights in place
        f32 = cfg.family == "hybrid"
        if f32:
            _float_(params)
            cfg = cfg.scaled(dtype="float32")
        with torch.inference_mode():
            carry = _lm_carry(torch, cfg, params, prompts)
        bound = LM_CARRY_F32_RTOL if f32 else LM_CARRY_RTOL
        print(f"  prefill(T) + decode_step against prefill(T+1), "
              f"{'float32' if f32 else 'bf16'}, PSSA and TIPS off"
              + (", all experts, no drop" if cfg.family == "moe"
                 else "") + ": "
              + "; ".join(f"{k} {v:.3e}" for k, v in carry.items())
              + f" (limit {bound}; controls must exceed it)")
        require(carry.pop("carry") <= bound, f"{name}: carry past {bound}")
        require(all(v > bound for v in carry.values()),
                f"{name}: a control within {bound}: {carry}")
        print(f"  peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
              f"{name} in {time.perf_counter() - t_model:.2f} s")
        del params, prompts, tokens
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


# ---------------------------------------------------------------------------
def _synced_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _train_readings(torch, name, cfg, step, state, ds, times, seq):
    """Print s a step (the median of steps 2-4), tokens/s, peak GB, the
    model-FLOP share, and profile one more step (busy share, the five
    largest device ops).  Returns the state after that step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.model_flops import model_flops
    s_step = sorted(times[1:])[len(times[1:]) // 2]
    flops = model_flops(cfg, ShapeConfig(name, seq, TRAIN_BATCH, "train"))
    print(f"  {name}: s a step {s_step:.4f} (median of steps 2-"
          f"{len(times)}; {', '.join(f'{t:.4f}' for t in times)}), "
          f"tokens/s {TRAIN_BATCH * seq / s_step:.0f}, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, model FLOPs "
          f"{flops / 1e12:.1f} T a step, "
          f"{flops / s_step / H100_BF16_DENSE_FLOPS:.2%} of "
          f"{H100_BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s")
    box = [state]
    batch = ds.batch_at(len(times), device="cuda")

    def one():
        dt, (box[0], _) = _synced_s(torch, lambda: step(box[0], batch))
        return dt
    profile_breakdown(torch, one, f"{name} train step", top=5)
    return box[0]


def _max_diff(torch, a_tree, b_tree) -> float:
    from repro_torch import tree as tree_util
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_util.leaves(a_tree),
                               tree_util.leaves(b_tree)))


def _resume_and_remat(torch, name, cfg, ds, opt, exact: bool):
    """The train phase's (d) and (e) for one model; returns the
    parameters after TRAIN_STEPS uninterrupted steps.

    (d) two uninterrupted runs of TRAIN_STEPS from ``Trainer``'s fresh
    state (its own step function, the batches it takes), then a
    ``Trainer`` killed at step 3 (checkpoints every 2 steps, under $TMPDIR,
    removed afterwards) and resumed in a fresh one: its final state
    against the first run's.  (e) gradients with remat against without,
    and two runs without.  ``exact``: both bit for bit; otherwise within
    ten times the run-to-run gap.
    """
    import shutil
    import tempfile

    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import _value_and_grad

    layers = f"{cfg.num_layers} layers, {TRAIN_BATCH} x {ds.seq_len}"
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def tc(sub, every):
            return TrainConfig(steps=TRAIN_STEPS, checkpoint_every=every,
                               log_every=1, checkpoint_dir=os.path.join(
                                   root, sub))

        class Killed(RuntimeError):
            pass

        def killer(i):
            if i == 3:
                raise Killed()

        def uninterrupted(trainer):
            st = trainer._fresh_state(
                torch.Generator(device="cuda").manual_seed(0))
            for i in range(TRAIN_STEPS):
                st, _ = trainer.step_fn(st, ds.batch_at(i, device="cuda"))
            return st
        t1 = Trainer(cfg, ds, opt, tc("clean", 1000), device="cuda")
        clean = uninterrupted(t1)
        st = uninterrupted(t1)
        gap = _max_diff(torch, clean, st)
        del st
        try:
            Trainer(cfg, ds, opt, tc("killed", 2), failure_hook=killer,
                    device="cuda").run()
            require(False, f"{name}: (d) the failure hook did not fire")
        except Killed:
            pass
        resumed, hist = Trainer(cfg, ds, opt, tc("killed", 2),
                                device="cuda").run()
        require(hist[0][0] == 3, f"{name}: (d) resumed at {hist[0][0]}")
        diff = _max_diff(torch, resumed, clean)
        bound = 0.0 if exact else 10 * gap
        print(f"  {name} ({layers}): (d) two uninterrupted runs differ by "
              f"{gap!r}; killed at step 3 and resumed against uninterrupted "
              f"{diff!r} (limit {'bit for bit' if bound == 0 else bound})")
        require(gap <= bound, f"{name}: (d) two runs differ by {gap}")
        require(diff <= bound, f"{name}: (d) resumed {diff} > {bound}")
        params = clean[0]
        del clean, resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    batch = ds.batch_at(0, device="cuda")
    g_on = _value_and_grad(params, batch, cfg)[1]
    g_off = _value_and_grad(params, batch, cfg, remat=False)[1]
    g_off2 = _value_and_grad(params, batch, cfg, remat=False)[1]
    g_gap = _max_diff(torch, g_off, g_off2)
    g_diff = _max_diff(torch, g_on, g_off)
    bound = 0.0 if exact else 10 * g_gap
    print(f"  {name}: (e) gradients, remat against none {g_diff!r}; two "
          f"runs without remat {g_gap!r} (limit "
          f"{'bit for bit' if bound == 0 else bound})")
    require(g_gap <= bound, f"{name}: (e) two runs differ by {g_gap}")
    require(g_diff <= bound, f"{name}: (e) remat moved the gradients")
    return params


def _sharded_steps(torch, name, cfg, step, state, batch, ctx, opt):
    """(g): one step of ``make_train_step(ctx=)`` at degree 1 against
    ``step`` (unsharded) from the same state and batch, with and without
    ``remat_save_collectives``: loss, grad norm, parameters and moments
    bit for bit.  Prints the collectives a step and their host us; returns
    the model- and data-axis all-reduces a step by
    ``remat_save_collectives``.  Then (j), ``_zero3_step``."""
    from repro_torch import tree as tree_util
    from repro_torch.models import parallel as PAR
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step

    require(T.param_layout(cfg, ctx.tp_size)["layers"] is None,
            f"{name}: (g) a leaf splits at degree 1")
    ref, mref = step(state, batch)
    seen = {}
    for save in (False, True):
        c = cfg.scaled(remat_save_collectives=save)
        sharded = make_train_step(c, opt, ctx=ctx)
        torch.cuda.synchronize()
        PAR.reset_collective_counts()
        dt, (got, mgot) = _synced_s(torch, lambda: sharded(state, batch))
        counts = PAR.collective_counts()
        n = counts["tp_all_reduce"] + counts["dp_all_reduce"]
        same = all(torch.equal(a, b) for a, b in zip(
            tree_util.leaves((ref, mref)), tree_util.leaves((got, mgot))))
        print(f"  {name}: (g) sharded step at degree 1 (mesh "
              f"{mesh_shape_of(ctx)}, remat_save_collectives {save}): "
              f"loss {float(mgot['loss'])!r} / {float(mref['loss'])!r}, "
              f"grad norm {float(mgot['grad_norm'])!r} / "
              f"{float(mref['grad_norm'])!r}; parameters, moments and "
              f"metrics bit-equal: {same}; {counts['tp_all_reduce']} model-"
              f"axis + {counts['dp_all_reduce']} data-axis all-reduces a "
              f"step, {counts['host_s'] / max(n, 1) * 1e6:.1f} us of host "
              f"time each, step {dt:.4f} s")
        require(same, f"{name}: (g) the sharded step is not bit-equal "
                      f"(remat_save_collectives {save})")
        require(counts["dp_all_reduce"] > 0, f"{name}: (g) no collective")
        seen[save] = (counts["tp_all_reduce"], counts["dp_all_reduce"])
        del got, mgot
    _zero3_step(torch, name, cfg, ref, mref, state, batch, ctx, opt)
    del ref, mref
    return seen


def _zero3_step(torch, name, cfg, ref, mref, state, batch, ctx, opt):
    """(j): one ``make_train_step(zero3=True)`` step at degree 1 from
    ``state`` (its ZeRO-3 slices: every leaf whole on the one data rank)
    against the unsharded step's ``ref`` / ``mref``: loss, grad norm,
    parameters and moments bit for bit, every leaf gathered through the
    one-rank group where it is used (twice a layer leaf under remat) and
    its gradient reduce-scattered.  Prints the gathers and scatters and
    their host us."""
    from repro_torch import tree as tree_util
    from repro_torch.models import parallel as PAR
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import zero3_plan, zero3_slices

    plan = zero3_plan(cfg, ctx)
    sliced = zero3_slices(state, plan)
    require(all(a is b for a, b in zip(tree_util.leaves(sliced),
                                       tree_util.leaves(state))),
            f"{name}: (j) a slice copied a leaf at degree 1")
    step = make_train_step(cfg, opt, ctx=ctx, zero3=True)
    torch.cuda.synchronize()
    PAR.reset_collective_counts()
    dt, (got, mgot) = _synced_s(torch, lambda: step(sliced, batch))
    counts = PAR.collective_counts()
    same = all(torch.equal(a, b) for a, b in zip(
        tree_util.leaves((ref, mref)), tree_util.leaves((got, mgot))))
    n_layer = len(tree_util.leaves(state[0]["layers"]))
    gathers, scatters = counts["dp_param_gather"], counts["dp_grad_scatter"]
    n = sum(v for k, v in counts.items() if k != "host_s")
    print(f"  {name}: (j) ZeRO-3 step at degree 1: loss "
          f"{float(mgot['loss'])!r} / {float(mref['loss'])!r}, grad norm "
          f"{float(mgot['grad_norm'])!r} / {float(mref['grad_norm'])!r}; "
          f"parameters, moments and metrics bit-equal: {same}; {gathers} "
          f"parameter gathers + {scatters} gradient scatters ({n_layer} "
          f"leaves x {cfg.num_layers} layers, remat) + "
          f"{counts['tp_all_reduce']} model-axis + "
          f"{counts['dp_all_reduce']} data-axis all-reduces, "
          f"{counts['host_s'] / max(n, 1) * 1e6:.1f} us of host time each "
          f"({counts['host_s'] * 1e3:.2f} ms in all), step {dt:.4f} s")
    require(same, f"{name}: (j) the ZeRO-3 step is not bit-equal")
    require(gathers == 2 * n_layer * cfg.num_layers + 3
            and scatters == n_layer * cfg.num_layers + 3,
            f"{name}: (j) {gathers} gathers, {scatters} scatters")
    del got, mgot


def mesh_shape_of(ctx) -> dict:
    from repro_torch.launch.mesh import mesh_shape
    return mesh_shape(ctx.mesh)


def _sharded_prefill(torch, ctx):
    """(h): hymba-1.5b whole (published geometry, bf16) prefill on the
    kernel route under ``ctx`` against ``ctx=None``: logits and cache bit
    for bit, one ``ssd_scan`` call a layer each (its four phase kernels)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    cfg = get_arch("hymba-1.5b").scaled(use_ssd_kernel=True)
    _hold_geometry(cfg, "hymba-1.5b")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    prompts = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                            generator=torch.Generator(
                                device="cuda").manual_seed(1), device="cuda")
    out, calls = {}, {}
    with torch.inference_mode():
        for tag, c in (("plain", None), ("sharded", ctx)):
            runtime.reset_launch_counts()
            out[tag] = T.prefill(T.shard_params(params, cfg, c), cfg,
                                 tokens=prompts, ctx=c)
            torch.cuda.synchronize()
            calls[tag] = runtime.launch_counts().get("ssd_scan", 0)
    same = all(torch.equal(a, b) for a, b in zip(leaves(out["plain"]),
                                                 leaves(out["sharded"])))
    print(f"  hymba-1.5b: (h) whole prefill ({TRAIN_BATCH} x {TRAIN_SEQ}) "
          f"on the kernel route under the mesh against ctx=None: logits and "
          f"cache bit-equal: {same}; ssd_scan calls {calls['sharded']} / "
          f"{calls['plain']} ({cfg.num_layers} layers) in "
          f"{time.perf_counter() - t0:.2f} s")
    require(same, "hymba-1.5b: (h) the sharded prefill is not bit-equal")
    require(calls == {"plain": cfg.num_layers, "sharded": cfg.num_layers},
            f"hymba-1.5b: (h) ssd_scan calls {calls}")
    del params, out


def _sharded_cli(torch):
    """(i): ``launch.train --sharded`` at smoke geometry through its CLI,
    in this process's one-rank group, checkpoints under $TMPDIR."""
    import io
    import shutil
    import tempfile

    from repro_torch.launch import train as train_cli
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            hist = train_cli.main([*TRAIN_CLI_ARGS, "--ckpt-dir", root])
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"    | {line}")
    require([h[0] for h in hist] == [1, 2] and all(
        math.isfinite(h[1]) for h in hist), f"(i) history {hist}")
    require("elastic mesh: {'data': 1, 'model': 1}" in lines,
            "(i) the CLI did not report its mesh")
    print(f"  (i) launch.train --sharded: 2 steps in {dt:.2f} s")


@phase("train")
def train_phase(torch):
    """LM training at published widths: hymba-1.5b whole, qwen2-moe-a2.7b
    cut to 2 layers (1 for the Trainer's fault tolerance and remat), and
    hymba cut to 4 layers for those and the ssd_scan guard (docstring,
    item 18); then (g)-(i), the tensor- and expert-parallel path at degree
    1 in a one-rank NCCL group (``make_elastic_mesh()`` on the one card)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.layers import ShardCtx
    with mesh_mod.process_group(device="cuda"):
        ctx = ShardCtx(mesh=mesh_mod.make_elastic_mesh(), dp_axes=("data",))
        require(mesh_shape_of(ctx) == {"data": 1, "model": 1},
                f"(g) elastic mesh {mesh_shape_of(ctx)} on one card")
        return _train_body(torch, ctx)


def _train_body(torch, ctx):
    import gc

    from repro_torch.kernels import runtime
    from repro_torch.launch.train import build
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import _value_and_grad
    from repro_torch.tree import leaves

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def zero():
        return torch.zeros((), device="cuda")

    runtime.reset_launch_counts()
    # hymba-1.5b at its published geometry, depth not cut
    name = "hymba-1.5b"
    t_model = time.perf_counter()
    cfg, ds, opt, _ = build(name, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                            TRAIN_LR)
    _hold_geometry(cfg, name)
    require(not cfg.use_ssd_kernel and cfg.tips and cfg.pssa,
            f"{name}: not the configured training path")
    free()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    n = sum(a.numel() for a in leaves(params))
    step = make_train_step(cfg, opt)
    state = (params, opt.init(params), zero())
    del params
    batch = ds.batch_at(0, device="cuda")
    with torch.no_grad():
        l0 = float(T.loss_fn(state[0], batch, cfg)[0])
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        batch = ds.batch_at(i, device="cuda")
        dt, (state, m) = _synced_s(torch, lambda: step(state, batch))
        times.append(dt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    print(f"  {name}: {n / 1e9:.3f} B parameters; losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}; grad norms "
          f"{', '.join(f'{v:.4f}' for v in norms)} (lr {TRAIN_LR})")
    require(all(math.isfinite(v) for v in losses + norms)
            and all(v > 0 for v in norms),
            f"{name}: (a) a loss or grad norm is not finite and positive")
    gap = abs(losses[0] - l0) / abs(l0)
    print(f"  {name}: (b) step 1's loss {losses[0]!r} against loss_fn "
          f"under no_grad {l0!r}: {gap:.3e} (limit {TRAIN_LOSS_RTOL})")
    require(gap <= TRAIN_LOSS_RTOL, f"{name}: (b) {gap:.3e}")
    state = _train_readings(torch, name, cfg, step, state, ds, times,
                            TRAIN_SEQ)
    # (c) on one batch repeated, from the trained parameters and a fresh
    # optimiser at the descent rate
    params = state[0]
    del state
    gc.collect()
    _, _, opt_c, _ = build(name, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                           TRAIN_DESCENT_LR)
    step_c = make_train_step(cfg, opt_c)
    state = (params, opt_c.init(params), zero())
    del params
    batch = ds.batch_at(TRAIN_STEPS + 1, device="cuda")
    same = []
    for i in range(TRAIN_STEPS):
        state, m = step_c(state, batch)
        same.append(float(m["loss"]))
    print(f"  {name}: (c) one batch repeated at lr {TRAIN_DESCENT_LR}: "
          f"losses {', '.join(f'{v:.5f}' for v in same)}")
    require(same[-1] < same[0], f"{name}: (c) the loss did not fall")
    del state, batch, m
    free()
    print(f"  {name} in {time.perf_counter() - t_model:.2f} s")

    # qwen2-moe-a2.7b at its published widths, 2 of 24 layers
    name = "qwen2-moe-a2.7b"
    t_model = time.perf_counter()
    cfg, ds, opt, _ = build(name, TRAIN_STEPS, TRAIN_BATCH, TRAIN_MOE_SEQ,
                            TRAIN_LR)
    _hold_geometry(cfg, name)
    cfg = cfg.scaled(num_layers=TRAIN_MOE_LAYERS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(1),
                           cfg)
    n = sum(a.numel() for a in leaves(params))
    step = make_train_step(cfg, opt)
    state = (params, opt.init(params), zero())
    del params
    losses, norms, auxes, times = [], [], [], []
    for i in range(TRAIN_STEPS):
        batch = ds.batch_at(i, device="cuda")
        dt, (state, m) = _synced_s(torch, lambda: step(state, batch))
        times.append(dt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        auxes.append(float(m["aux"]))
    print(f"  {name} ({TRAIN_MOE_LAYERS} of 24 layers): {n / 1e9:.3f} B "
          f"parameters; losses {', '.join(f'{v:.5f}' for v in losses)}; "
          f"grad norms {', '.join(f'{v:.4f}' for v in norms)}; aux "
          f"{', '.join(f'{v:.5f}' for v in auxes)}")
    require(all(math.isfinite(v) for v in losses + norms + auxes)
            and all(v > 0 for v in norms + auxes),
            f"{name}: (a) a loss, grad norm or aux is not finite and "
            f"positive")
    state = _train_readings(torch, name, cfg, step, state, ds, times,
                            TRAIN_MOE_SEQ)
    t_g = time.perf_counter()
    g_counts = {name: _sharded_steps(
        torch, name, cfg, step, state,
        ds.batch_at(TRAIN_STEPS + 1, device="cuda"), ctx, opt)}
    print(f"  {name}: (g) in {time.perf_counter() - t_g:.2f} s")
    del state, batch, m
    free()
    print(f"  {name} in {time.perf_counter() - t_model:.2f} s")

    # (d), (e) at qwen2-moe's widths cut to TRAIN_MOE_FT_LAYERS, bit for
    # bit (its combine adds in a fixed order), then at hymba's cut to 4;
    # (f)
    name = "qwen2-moe-a2.7b"
    t_model = time.perf_counter()
    cfg, ds, opt, _ = build(name, TRAIN_STEPS, TRAIN_BATCH, TRAIN_MOE_SEQ,
                            TRAIN_LR)
    _resume_and_remat(torch, name,
                      cfg.scaled(num_layers=TRAIN_MOE_FT_LAYERS), ds, opt,
                      exact=True)
    free()
    print(f"  {name} ({TRAIN_MOE_FT_LAYERS} layer) (d), (e) in "
          f"{time.perf_counter() - t_model:.2f} s")
    name = "hymba-1.5b"
    t_model = time.perf_counter()
    cfg, ds, opt, _ = build(name, TRAIN_STEPS, TRAIN_BATCH, TRAIN_FT_SEQ,
                            TRAIN_LR)
    cfg = cfg.scaled(num_layers=TRAIN_FT_LAYERS)
    params = _resume_and_remat(torch, name, cfg, ds, opt, exact=False)
    t_g = time.perf_counter()
    g_counts[name] = _sharded_steps(torch, name, cfg,
                                    make_train_step(cfg, opt),
                                    (params, opt.init(params), zero()),
                                    ds.batch_at(1, device="cuda"), ctx, opt)
    print(f"  {name}: (g) in {time.perf_counter() - t_g:.2f} s")
    batch = ds.batch_at(0, device="cuda")
    kcfg = cfg.scaled(use_ssd_kernel=True)
    before = runtime.launch_counts().get("ssd_scan", 0)
    try:
        _value_and_grad(params, batch, kcfg)
        refused = "no error"
    except RuntimeError as exc:
        refused = str(exc)
    require("no backward" in refused,
            f"{name}: (f) the ssd_scan route took a gradient: {refused}")
    require(runtime.launch_counts().get("ssd_scan", 0) == before,
            f"{name}: (f) ssd_scan launched while refusing")
    print(f"  {name}: (f) use_ssd_kernel=True refuses to train: "
          f"RuntimeError")
    counts = runtime.launch_counts()
    require(sum(counts.values()) == 0,
            f"train: a hand-written kernel launched: {counts}")
    del params, batch
    free()
    print(f"  {name} ({TRAIN_FT_LAYERS} layers) in "
          f"{time.perf_counter() - t_model:.2f} s")
    t_h = time.perf_counter()
    _sharded_prefill(torch, ctx)
    free()
    _sharded_cli(torch)
    free()
    print(f"  (h), (i) in {time.perf_counter() - t_h:.2f} s")
    return g_counts


# ---------------------------------------------------------------------------
# dryrun: the dry-run on fake ranks, and its memory model against the card
# ---------------------------------------------------------------------------
# DRYRUN_MEM_RTOL: (b)'s bound, |predicted - measured| / measured peak of a
# train step.  The prediction counts every storage the step's dispatched
# ops create, at its exact size; the card's allocator rounds each block up
# (to 512 B, a large one up to the free block it splits) and cuBLAS keeps
# its workspaces through the same allocator.  The first readings (PERF.md,
# PR 29) were -0.20 % (hymba-1.5b, 41.03 GB) and -0.01 % (qwen2-moe, 46.89
# GB); the bound is ten times the larger.
DRYRUN_MEM_RTOL = 0.02
DRYRUN_CELLS = (("mamba2-130m", "train_4k"), ("llama3-8b", "decode_32k"))
# (e): llama3-8b x train_4k at full width cut to 16 of 32 layers, which the
# data degree 16 still divides (a rank owns whole layers)
DRYRUN_FSDP_LAYERS = 16


def _dryrun_cfgs() -> dict:
    """(c)'s, (b)'s and (e)'s train steps: name -> (arch, layers, seq,
    save); (c) the train phase's (g) steps, (b) its hymba-1.5b whole step
    and qwen2-moe 2-layer step, (e) hymba's 4-layer (g) state under
    ZeRO-3 (traced with ``fsdp``)."""
    cells = {}
    for arch, layers, seq in (("qwen2-moe-a2.7b", TRAIN_MOE_LAYERS,
                               TRAIN_MOE_SEQ),
                              ("hymba-1.5b", TRAIN_FT_LAYERS, TRAIN_FT_SEQ)):
        for save in (False, True):
            cells["c", arch, save] = (arch, layers, seq, save)
    cells["b", "hymba-1.5b"] = ("hymba-1.5b", None, TRAIN_SEQ, False)
    cells["b", "qwen2-moe-a2.7b"] = ("qwen2-moe-a2.7b", TRAIN_MOE_LAYERS,
                                     TRAIN_MOE_SEQ, False)
    cells["e", "hymba-1.5b"] = ("hymba-1.5b", TRAIN_FT_LAYERS, TRAIN_FT_SEQ,
                                False)
    return cells


def _dryrun_cfg(arch, layers, save):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).scaled(remat_save_collectives=save)
    return cfg if layers is None else cfg.scaled(num_layers=layers)


def _train_shape(arch: str, seq: int):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"{arch}_{TRAIN_BATCH}x{seq}", seq, TRAIN_BATCH,
                       "train")


def dryrun_traces() -> dict:
    """Every trace of the dryrun phase, on fakes: (a) ``run_cell`` of
    ``DRYRUN_CELLS[0]``, (d) ``DRYRUN_CELLS[1]`` through the CLI (its
    record read back from ``--out``), the traces of ``_dryrun_cfgs``
    on a fake (1, 1) group, the model axis kept as (g)'s mesh keeps it,
    and (e)'s ZeRO-3 pairs (``_fsdp_pairs``).
    It runs on the host alone (fake CUDA tensors, no card memory), so the
    smoke runs it in a worker process beside the card's phases
    (``start_dryrun_traces``); ``memory_allocated`` is read in that
    process before and after."""
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    out = {"mem_before": torch.cuda.memory_allocated(), "cells": {}}
    t0 = time.perf_counter()
    out["cells"][DRYRUN_CELLS[0]] = D.run_cell(*DRYRUN_CELLS[0], False,
                                               verbose=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        t1 = time.perf_counter()
        argv = ["--arch", DRYRUN_CELLS[1][0], "--shape",
                DRYRUN_CELLS[1][1], "--out", tmp]
        with contextlib.redirect_stdout(None):
            (cli,) = D.main(argv)
        with open(os.path.join(tmp, D._record_name(cli))) as f:
            out["cells"][DRYRUN_CELLS[1]] = json.load(f)
        out["cli"] = (" ".join(argv[:4]), D._record_name(cli),
                      time.perf_counter() - t1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["ad_s"] = time.perf_counter() - t0
    out["traces"] = {}
    for key, (arch, layers, seq, save) in _dryrun_cfgs().items():
        with mesh_mod.fake_process_group(1):
            out["traces"][key] = D._trace_cell(
                _dryrun_cfg(arch, layers, save), _train_shape(arch, seq),
                mesh_mod.make_smoke_mesh(), device="cuda", tp_fold=False,
                fsdp=key[0] == "e")
    t2 = time.perf_counter()
    out["fsdp"] = _fsdp_pairs(out["cells"][DRYRUN_CELLS[0]])
    out["e_s"] = time.perf_counter() - t2
    out["mem_after"] = torch.cuda.memory_allocated()
    out["s"] = time.perf_counter() - t0
    return out


def _sliced_drop(cfg, shape, mesh) -> tuple:
    """-> (what ``--fsdp`` takes off a train cell's arguments: the sliced
    parameters' model-shard bytes times (dp - 1) / dp, the data degree,
    the stacked leaves sliced on their layer axis, those sliced inside
    the layer); in a fake group."""
    from repro_torch import tree as tree_util
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import zero3_plan
    ctx = D._ctx(mesh, D.choose_tp_fold(cfg, shape, D._mesh_size(mesh)))
    plan = zero3_plan(cfg, ctx)
    shard = T.shard_params(T.abstract_params(cfg), cfg, ctx)
    drop = sum(a.numel() * a.element_size() // plan.size * (plan.size - 1)
               for a, d in zip(tree_util.leaves(shard), plan.dims)
               if d is not None)
    index = tree_util.unflatten(shard, range(len(plan.dims)))
    stacked = [plan.dims[i] for i in tree_util.leaves(index["layers"])]
    return drop, plan.size, stacked.count(0), sum(
        d not in (None, 0) for d in stacked)


def _fsdp_pairs(zero1_cell: dict) -> dict:
    """(e)'s traces, each a (ZeRO-1, ZeRO-3, drop) pair:
    ``run_cell(fsdp=True)`` of ``DRYRUN_CELLS[0]`` beside (a)'s record
    ``zero1_cell``, and llama3-8b x train_4k at full width cut to
    ``DRYRUN_FSDP_LAYERS`` layers, one microbatch, traced with and without
    ``fsdp`` on the fake 16 x 16 group."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_mod
    arch, shape = DRYRUN_CELLS[0]
    pairs = {}
    rec = D.run_cell(arch, shape, False, verbose=False, fsdp=True)
    with mesh_mod.fake_process_group(256):
        drop = _sliced_drop(get_arch(arch), SHAPES[shape],
                            mesh_mod.make_production_mesh())
    pairs[f"{arch} x {shape} (run_cell)"] = (zero1_cell, rec, drop)
    cfg = get_arch("llama3-8b").scaled(num_layers=DRYRUN_FSDP_LAYERS)
    with mesh_mod.fake_process_group(256):
        mesh = mesh_mod.make_production_mesh()
        z1, z3 = (D._trace_cell(cfg, SHAPES["train_4k"], mesh, force_m=1,
                                device="cuda", fsdp=f) for f in (False, True))
        drop = _sliced_drop(cfg, SHAPES["train_4k"], mesh)
    pairs[f"llama3-8b x train_4k, {DRYRUN_FSDP_LAYERS} layers, one "
          f"microbatch (_trace_cell)"] = (z1, z3, drop)
    return pairs


def _hold_fsdp(pairs: dict) -> None:
    """(e): each ZeRO-3 trace against its ZeRO-1 twin: the arguments less
    exactly the sliced parameter bytes, the same FLOPs, a lower predicted
    peak (arguments + temp), gathers and scatters in place of ZeRO-1's
    post-update all-gathers."""
    for label, (z1, z3, (drop, dp, axis, inner)) in pairs.items():
        require(z3.get("status", "ok") == "ok",
                f"(e) {label}: {z3.get('error')}\n{z3.get('traceback')}")
        m1, m3 = z1["memory_analysis"], z3["memory_analysis"]
        a1, a3 = m1["argument_size_in_bytes"], m3["argument_size_in_bytes"]
        p1 = a1 + m1["temp_size_in_bytes"]
        p3 = a3 + m3["temp_size_in_bytes"]
        c1, c3 = (z["collective_bytes"] for z in (z1, z3))
        print(f"  (e) {label}, dp {dp} ({axis} stacked leaves sliced on the "
              f"layer axis, {inner} inside the layer): arguments "
              f"{_gb(a1)} -> {_gb(a3)} (drop {a1 - a3}, predicted "
              f"{drop}); peak {_gb(p1)} -> {_gb(p3)} (temp "
              f"{_gb(m1['temp_size_in_bytes'])} -> "
              f"{_gb(m3['temp_size_in_bytes'])}); flops {z1['flops']:.6e} "
              f"-> {z3['flops']:.6e}; collective bytes "
              f"{c1['total']:.4e} -> {c3['total']:.4e} (counts "
              f"{c1['counts']} -> {c3['counts']}); traces "
              f"{z1['trace_s']} / {z3['trace_s']} s")
        require(a1 - a3 == drop > 0, f"(e) {label}: arguments fell by "
                                     f"{a1 - a3}, predicted {drop}")
        require(z3["flops"] == z1["flops"], f"(e) {label}: flops moved")
        if "flops_global" in z1:
            require(z3["flops_global"] == z1["flops_global"],
                    f"(e) {label}: global flops moved")
        require(p3 < p1, f"(e) {label}: peak {p3} not below {p1}")
        require(c3["counts"]["reduce-scatter"] > 0
                and c1["counts"]["reduce-scatter"] == 0,
                f"(e) {label}: scatters {c1['counts']} -> {c3['counts']}")


def start_dryrun_traces():
    """``dryrun_traces`` in a spawned worker process; -> (executor,
    future).  The caller shuts the executor down."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(dryrun_traces)


def _hold_cell(rec: dict, label: str) -> None:
    coll = rec.get("collective_bytes", {})
    require(rec["status"] == "ok",
            f"(a) {label}: {rec.get('error')}\n{rec.get('traceback')}")
    require(rec["flops"] > 0 and rec["bytes_accessed"] > 0
            and coll["total"] > 0, f"(a) {label}: a zero count {rec}")
    mem = rec["memory_analysis"]
    print(f"  {label}: trace {rec['trace_s']} s; a rank's flops "
          f"{rec['flops']:.4e} (global {rec['flops_global']:.4e}), bytes "
          f"{rec['bytes_accessed']:.4e}, collective bytes {coll['total']:.4e} "
          f"(weighted {coll['weighted']:.4e}, counts {coll['counts']}); "
          f"arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
          f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, alias "
          f"{mem['alias_size_in_bytes'] / 1e9:.3f} GB; extrapolated flops "
          f"{rec['extrapolated']['flops']:.4e}")


def _gb(n) -> str:
    return f"{n / 1e9:.3f} GB"


def _memory_model(torch, key: tuple, rec: dict):
    """(b) for one step (``key`` of ``_dryrun_cfgs``; (e) the ZeRO-3 step
    under ``fsdp``): the fake (1, 1) trace ``rec``'s peak against one real
    step of ``dryrun.step_callable`` in a one-rank NCCL group, and the
    collectives each counts."""
    import gc

    from repro_torch import tree as tree_util
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import parallel as PAR
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import zero3_plan, zero3_slices

    arch, fsdp = key[1], key[0] == "e"
    _, layers, seq, save = _dryrun_cfgs()[key]
    cfg = _dryrun_cfg(arch, layers, save)
    mem = rec["memory_analysis"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    with mesh_mod.process_group(device="cuda"):
        mesh = mesh_mod.make_smoke_mesh()
        step = D.step_callable(cfg, _train_shape(arch, seq), mesh,
                               tp_fold=False, fsdp=fsdp)
        params = T.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        opt = AdamW()
        state = (params, opt.init(params),
                 torch.zeros((), device="cuda"))
        if fsdp:        # the slices: the leaves themselves on one rank
            state = zero3_slices(state, zero3_plan(cfg, D._ctx(mesh,
                                                               False)))
        del params
        ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                                global_batch=TRAIN_BATCH, seed=0,
                                embedding_input=cfg.embedding_input,
                                d_model=cfg.d_model)
        batch = ds.batch_at(0, device="cuda")
        args = sum(a.numel() * a.element_size()
                   for a in tree_util.leaves((state, batch)))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        other = torch.cuda.memory_allocated() - args
        PAR.reset_collective_counts()
        dt, (new, m) = _synced_s(torch, lambda: step(state, batch))
        counts = PAR.collective_counts()
        measured = torch.cuda.max_memory_allocated() - other
        loss = float(m["loss"])
        del state, batch, new, m
    gc.collect()
    torch.cuda.empty_cache()
    out = mem["output_size_in_bytes"]
    gap = (predicted - measured) / measured
    print(f"  {'(e) ' if fsdp else ''}{arch} ({cfg.num_layers} layers, "
          f"{TRAIN_BATCH} x {seq}{', ZeRO-3' if fsdp else ''}): "
          f"predicted peak {_gb(predicted)} = arguments "
          f"{_gb(mem['argument_size_in_bytes'])} (the train state and the "
          f"batch; {_gb(args)} on the card) + temp "
          f"{_gb(mem['temp_size_in_bytes'])} (the new state "
          f"{_gb(out)}, gradients and activations "
          f"{_gb(mem['temp_size_in_bytes'] - out)}); measured "
          f"{_gb(measured)} (max_memory_allocated less "
          f"{_gb(other)} held outside the step), {gap:+.4f} (limit "
          f"{DRYRUN_MEM_RTOL}); trace {rec['trace_s']} s, real step "
          f"{dt:.3f} s, loss {loss!r}")
    require(args == mem["argument_size_in_bytes"],
            f"(b) {arch}: argument bytes {args} on the card, "
            f"{mem['argument_size_in_bytes']} traced")
    require(math.isfinite(loss), f"(b) {arch}: loss {loss}")
    require(abs(gap) <= DRYRUN_MEM_RTOL, f"(b) {arch}: peak {gap:+.4f}")
    traced = rec["collective_axes"]
    kinds = ("tp_all_reduce", "dp_all_reduce") + (
        ("dp_param_gather", "dp_grad_scatter") if fsdp else ())
    for k in kinds:
        require(counts[k] == traced[k],
                f"(b) {arch}: {k} {counts[k]} run, {traced[k]} traced")
    require(not fsdp or counts["dp_param_gather"] > 0,
            f"(e) {arch}: no parameter gathered")


@phase("dryrun")
def dryrun_phase(torch, g_counts, traced):
    """The dry-run on the card host (docstring, item 19).  ``g_counts``:
    the train phase's (g) all-reduces by model and save flag; ``traced``:
    ``dryrun_traces()``'s result (from its worker process)."""
    print(f"  the traces took {traced['s']:.2f} s in their worker process "
          f"((a), (d) {traced['ad_s']:.2f} s)")
    cmd, name, cli_s = traced["cli"]
    print(f"  (d) dryrun.main({cmd} --out <tmp>) in {cli_s:.2f} s, record "
          f"{name} read back")
    recs = traced["cells"]
    for (arch, shape), rec in recs.items():
        _hold_cell(rec, f"{arch} x {shape} x {rec['mesh']}")
    fold = recs[DRYRUN_CELLS[0]]
    require(fold["collective_axes"]["tp_all_reduce"] == 0,
            f"(a) mamba2-130m not TP-folded: {fold['collective_axes']}")
    dec = recs[DRYRUN_CELLS[1]]
    require(dec["extrapolated"]["flops"] == dec["flops"],
            f"(a) llama3-8b decode: extrapolated {dec['extrapolated']} "
            f"against {dec['flops']}")
    print(f"  (a) memory_allocated {traced['mem_before']} before, "
          f"{traced['mem_after']} after")
    require(traced["mem_after"] == traced["mem_before"],
            "(a) the dry-run took card memory")
    print(f"  (e) the ZeRO-3 traces took {traced['e_s']:.2f} s in the worker")
    _hold_fsdp(traced["fsdp"])
    for key, rec in traced["traces"].items():
        if key[0] != "c":
            continue
        _, arch, save = key
        ax = rec["collective_axes"]
        got = (ax["tp_all_reduce"], ax["dp_all_reduce"])
        print(f"  {arch} (remat_save_collectives {save}): (c) traced "
              f"{got[0]} model-axis + {got[1]} data-axis all-reduces a "
              f"step in {rec['trace_s']} s, (g) ran {g_counts[arch][save]}")
        require(got == g_counts[arch][save],
                f"(c) {arch} save {save}: {got} against "
                f"{g_counts[arch][save]}")
    t0 = time.perf_counter()
    for key in (("b", "hymba-1.5b"), ("b", "qwen2-moe-a2.7b"),
                ("e", "hymba-1.5b")):
        _memory_model(torch, key, traced["traces"][key])
    print(f"  (b)'s and (e)'s real steps in {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# examples: the example twins in this process
# ---------------------------------------------------------------------------
EXAMPLE_STEPS = 5           # generate_image's default --steps
TRAIN_LM_ARGS = ("--steps", "3", "--seq", "64")


def _run_example(torch, mod, argv, label, show=None):
    """``mod.main(argv)`` in this process with the launch counters set to 0
    just before: (its result, the lines it printed, the launches).  An
    exception or a ``SystemExit`` (argparse) fails the phase; the lines
    ``show`` selects (all by default) are echoed, indented."""
    import io

    from repro_torch.kernels import runtime
    buf = io.StringIO()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = mod.main(list(argv))
    except SystemExit as exc:
        raise PhaseError(f"{label}: exited with {exc.code!r}:\n"
                         f"{buf.getvalue()}") from None
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = runtime.launch_counts()
    lines = buf.getvalue().splitlines()
    print(f"  {label} in {dt:.2f} s, launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for line in (lines if show is None else show(lines)):
        print(f"    | {line}")
    return res, lines, counts


def _only(counts, want: dict, label: str) -> None:
    """Every kernel's launches equal ``want``'s (0 where it names none)."""
    got = {k: v for k, v in counts.items() if v}
    want = {k: v for k, v in want.items() if v}
    require(got == want, f"{label}: launches {got}, expected {want}")


@phase("examples")
def examples_phase(torch):
    """The five example twins (``repro_torch.examples``), each ``main()``
    in this process on the card by default:

    (a) ``quickstart`` whole: its lines, the PSSA round trip lossless, the
        DBSC kernel's int32 accumulators equal to the twin's int64 oracle
        (``kernel vs oracle max diff: 0.00e+00``), one launch each of
        ``bitslice_matmul`` and ``cross_attention_tips``, none other;
    (b) ``tips_visualization`` whole: its lines, a low-precision ratio in
        (0, 1), neighbour agreement above 85 % (the twin asserts it); no
        launch;
    (c) ``generate_image`` at its defaults (BK-SDM-Tiny at full width, 5
        steps, guidance 1.0, the main path's kernels): a finite (1, 512,
        512, 3) image, the ledger lines, 9 / 9 / 18 launches a step; then
        on the reference attention + DBSC (``--kernels ffn=dbsc``, the
        parity phase's DBSC reference): ``mj_per_iter_with_ema`` within
        LEDGER_RTOL;
    (d) ``serve_lm`` at its defaults (llama3-8b's smoke geometry, batch 4,
        a 24-token prompt, 16 tokens): its lines, 16 tokens a row in the
        vocabulary, a finite DBSC tile; one ``bitslice_matmul`` launch;
    (e) ``train_lm`` (the ~100M llama) with TRAIN_LM_ARGS and a checkpoint
        dir of its own under $TMPDIR (removed afterwards): its lines, a
        finite first loss, the final checkpoint written; no launch.
    """
    import shutil
    import tempfile

    from repro_torch.examples import (generate_image, quickstart, serve_lm,
                                      tips_visualization, train_lm)

    # (a)
    res, lines, counts = _run_example(torch, quickstart, [],
                                      "(a) quickstart")
    require(lines[0] == "== PSSA: self-attention score compression ==" and
            "  round-trip lossless: OK" in lines and
            "== DBSC: bit-slice mixed-precision matmul (CUDA kernel) =="
            in lines and lines[-1] == "done.", "(a) quickstart's lines")
    require("  kernel vs oracle max diff: 0.00e+00" in lines and torch.equal(
        res["acc"].to(torch.int64), res["oracle"]),
        "(a) the DBSC kernel's integers differ from the oracle")
    require(0 < res["ema_reduction"] < 1 and 0 < res["low_precision_ratio"]
            < 1 and 0 < res["datapath_rel_err"] < 0.1,
            f"(a) quickstart's numbers {res}")
    _only(counts, {"bitslice_matmul": 1, "cross_attention_tips": 1},
          "(a) quickstart")
    print(f"  (a): the kernel's {res['acc'].numel()} int32 accumulators "
          f"equal the int64 oracle's")

    # (b)
    res, lines, counts = _run_example(
        torch, tips_visualization, [], "(b) tips_visualization",
        show=lambda ls: ls[:2])
    require(lines[0].startswith("important-pixel ratio: ") and lines[3] ==
            "TIPS importance map (64x64, # = important = INT12):" and
            len(lines) == 4 + 32, "(b) tips_visualization's lines")
    require(0 < res["low_precision_ratio"] < 1,
            f"(b) low-precision ratio {res['low_precision_ratio']}")
    _only(counts, {}, "(b) tips_visualization")

    # (c)
    root = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        res, lines, counts = _run_example(
            torch, generate_image, ["--out", os.path.join(root, "a.npy")],
            "(c) generate_image")
        require(res["image_shape"] == (1, 512, 512, 3) and res["finite"]
                and res["latent_size"] == 64,
                f"(c) image {res['image_shape']}, finite {res['finite']}")
        require(lines[0].startswith("pipeline: model unet, latent 64^2, "
                                    "sampler ddim x5, guidance 1.0, engine")
                and lines[4] == "full-geometry (BK-SDM-Tiny, family=unet) "
                "energy ledger:" and len(lines) == 5 + len(res["summary"]),
                "(c) generate_image's lines")
        _hold_launches(counts, EXAMPLE_STEPS, SLICE_ROUTE_PER_STEP,
                       "(c) generate_image")
        ref, _, _ = _run_example(
            torch, generate_image, ["--kernels", "ffn=dbsc", "--out",
                                    os.path.join(root, "b.npy")],
            "(c) generate_image --kernels ffn=dbsc", show=lambda ls: [])
        a = res["summary"]["mj_per_iter_with_ema"]
        b = ref["summary"]["mj_per_iter_with_ema"]
        gap = abs(a - b) / abs(b)
        print(f"  (c): mj_per_iter_with_ema {a!r} (main path) against {b!r} "
              f"(reference attention + dbsc): {gap:.3e} relative (limit "
              f"{LEDGER_RTOL})")
        require(gap <= LEDGER_RTOL, f"(c) mj_per_iter_with_ema {gap:.3e}")

        # (d)
        res, lines, counts = _run_example(torch, serve_lm, [],
                                          "(d) serve_lm")
        require(lines[0] == "serving llama3-8b-smoke (smoke geometry), "
                "batch=4, prompt=24, decode=16" and
                lines[2].startswith("decoded 16 tokens x 4 seqs in ") and
                lines[4].startswith("DBSC bit-slice FFN tile: (4, ") and
                lines[4].endswith("finite=True"), "(d) serve_lm's lines")
        toks = res["tokens"]
        require(toks.shape == (4, 16) and int(toks.min()) >= 0 and
                int(toks.max()) < 512, f"(d) tokens {tuple(toks.shape)}")
        _only(counts, {"bitslice_matmul": 1}, "(d) serve_lm")

        # (e)
        ckpt = os.path.join(root, "train_lm")
        res, lines, counts = _run_example(
            torch, train_lm, [*TRAIN_LM_ARGS, "--ckpt-dir", ckpt],
            "(e) train_lm")
        hist = res["history"]
        require(lines[0] == "arch llama3-100m: 98.7 M params" and
                lines[-1].startswith(f"loss {hist[0][1]:.3f} -> ") and
                hist[0][0] == 1 and math.isfinite(hist[0][1]),
                f"(e) train_lm's lines, history {hist}")
        require(os.path.isdir(os.path.join(ckpt, "step_00000003")),
                "(e) no checkpoint at step 3")
        _only(counts, {}, "(e) train_lm")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
def _tokens(torch, cfg, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(1, cfg.text.vocab_size, (1, cfg.text.max_len),
                         generator=g, device="cuda", dtype=torch.int32)
    toks[:, 0] = 0                               # CLS first
    return toks, torch.zeros_like(toks)


@phase("slice")
def slice_phase(torch):
    from repro_torch.configs import bk_sdm
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import energy_report
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy

    cfg = bk_sdm.with_kernel_policy(
        bk_sdm.CONFIG, KernelPolicy(self_attention="fused",
                                    cross_attention="fused", ffn="dbsc"))
    require(cfg.ddim.num_inference_steps == 25
            and cfg.ddim.guidance_scale == 7.5, "not the paper's schedule")
    t0 = time.perf_counter()
    eng = DiffusionEngine(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"full-width parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    toks, un = _tokens(torch, cfg, 7)
    latents = eng.init_latents(1, torch.Generator(device="cuda")
                               .manual_seed(8))
    eng.generate(toks, uncond_tokens=un, latents=latents.clone())  # warm-up
    print(f"warm-up generate {eng.last_wall_s:.3f} s")

    runtime.reset_launch_counts()
    out = eng.generate(toks, uncond_tokens=un, latents=latents.clone())
    counts = runtime.launch_counts()
    wall = eng.last_wall_s
    print(f"launches {json.dumps(counts)}")
    require(tuple(out.images.shape) == (1, 512, 512, 3),
            f"image shape {tuple(out.images.shape)}")
    require(bool(torch.isfinite(out.images).all()), "non-finite image")
    require(bool(torch.isfinite(out.latents).all()), "non-finite latents")
    want = {"pssa_attention": 225, "cross_attention_tips": 225,
            "bitslice_matmul": 450}
    require(all(counts.get(k) == v for k, v in want.items()),
            f"launch counts {counts} != {want}")
    steps = cfg.ddim.num_inference_steps
    print(f"s/image {wall:.4f}  ms/step {wall / steps * 1e3:.3f} "
          f"(wall of one generate incl. text encode and VAE decode, "
          f"over {steps} steps)")
    summary = energy_report(cfg, out.stats).summary()
    print("energy_report " + json.dumps(summary))
    require(all(math.isfinite(v) for v in summary.values()),
            "non-finite energy report")
    def generate():
        eng.generate(toks, uncond_tokens=un, latents=latents.clone())
        return eng.last_wall_s
    profile_breakdown(torch, generate, "slice")
    return eng, counts


MESH_STEPS = 5              # (b), (c): DDIM steps of the served requests


def _same_outputs(torch, label, a, b) -> None:
    """Images, latents and every stats leaf bit-equal (dtype and shape
    too)."""
    from repro_torch.tree import leaves
    require(torch.equal(a.images, b.images), f"{label}: images differ")
    require(torch.equal(a.latents, b.latents), f"{label}: latents differ")
    la = leaves([a.stats.pssa, a.stats.tips, a.stats.reuse])
    lb = leaves([b.stats.pssa, b.stats.tips, b.stats.reuse])
    require(len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb)), f"{label}: a stats leaf differs")
    print(f"  {label}: images, latents and {len(la)} stats leaves bit-equal")


@phase("mesh")
def mesh_phase(torch, eng):
    """Data-parallel diffusion on a device mesh (``launch.mesh``) at
    BK-SDM-Tiny's full width, on the slice's weights, inside one NCCL group
    of one rank (a ``FileStore`` in a temporary directory), destroyed at
    the end.  The card holds only degree 1: NCCL takes one rank a device,
    and this host has one card (degree 2 is held on the CPU under gloo,
    ``tests/test_torch_mesh.py``).

    (a) ``generate`` under ``make_data_mesh(1)`` against the unsharded
        engine: the same weights, tokens and latents, batch 1, guidance
        7.5, 25 steps on the slice route: images, latents and every stats
        leaf bit-equal (the JAX package's dp = 1 contract); 9 / 9 / 18
        launches a step under the mesh.
    (b) ``serve(mesh=make_data_mesh(1))`` against ``serve(mesh=None)``:
        3 requests at micro-batch 2 (a padded tail), MESH_STEPS steps, the
        slice route: the ledger bit-equal, the JAX package's ``mesh``
        dict; 9 / 9 / 18 launches a step, the warm-ups included.
    (c) ``ClusterRouter(engines=[e0, e1])`` against ``ClusterRouter(e0,
        2, 2)``: two engines on one set of weights, 2 replicas x 2 slots, 4
        requests at t = 0, MESH_STEPS steps, the slice route: images and
        the merged int64 buckets and energy bit-equal; 9 / 9 / 18 launches
        a replica step.
    (d) ``serve_diffusion.main(["--mesh", "2"])`` raises
        ``make_data_mesh``'s message on this one-card host.
    """
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import merge_ledger_accums
    from repro_torch.kernels import runtime
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve_diffusion
    from repro_torch.launch.router import ClusterRouter
    from repro_torch.launch.scheduler import make_requests

    cfg = eng.cfg
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}
    short = dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, num_inference_steps=MESH_STEPS,
        tips_active_iters=MESH_STEPS - 1))
    with mesh_mod.process_group(device="cuda"):
        mesh = mesh_mod.make_data_mesh(1)
        print(f"  NCCL group of {torch.distributed.get_world_size()}; mesh "
              f"{mesh_mod.mesh_shape(mesh)}, signature "
              f"{mesh_mod.mesh_signature(mesh)}")

        # (a)
        meng = DiffusionEngine(cfg, params=params, mesh=mesh)
        toks, un = _tokens(torch, cfg, 7)
        lat = eng.init_latents(1, torch.Generator(device="cuda")
                               .manual_seed(8))
        ref = eng.generate(toks, uncond_tokens=un, latents=lat.clone())
        runtime.reset_launch_counts()
        out = meng.generate(toks, uncond_tokens=un, latents=lat.clone())
        _hold_launches(runtime.launch_counts(), cfg.ddim.num_inference_steps,
                       SLICE_ROUTE_PER_STEP, "(a) generate under the mesh")
        _same_outputs(torch, "(a) make_data_mesh(1) against unsharded", out,
                      ref)
        print(f"  (a) s/image {meng.last_wall_s:.4f} under the mesh, "
              f"{eng.last_wall_s:.4f} unsharded")

        # (b)
        reqs = serve_diffusion.synthetic_requests(short, 3)
        want = serve_diffusion.serve(short, reqs, 2, ledger=True)
        runtime.reset_launch_counts()
        got = serve_diffusion.serve(short, reqs, 2, ledger=True, mesh=mesh)
        _hold_launches(runtime.launch_counts(), 4 * MESH_STEPS,
                       SLICE_ROUTE_PER_STEP,
                       "(b) serve under the mesh (2 warm-ups, 2 calls)")
        require(got["mesh"] == {"dp": 1, "shape": {"data": 1, "model": 1},
                                "devices": 1} and want["mesh"] is None,
                f"(b) mesh {got['mesh']} / {want['mesh']}")
        require(got["micro_batch"] == 2 and got["engine_calls"] == 2
                and got["padded_rows"] == 1, f"(b) {got}")
        for k in ("energy", "tips_low_ratio_per_iter",
                  "tips_workload_low_fraction", "reuse_ratio_per_iter"):
            require(got[k] == want[k], f"(b) {k}: {got[k]} != {want[k]}")
        print(f"  (b) serve: ledger bit-equal under the mesh "
              f"(mj_per_iter_with_ema "
              f"{got['energy']['mj_per_iter_with_ema']!r}); mesh "
              f"{json.dumps(got['mesh'])}; imgs/s {got['imgs_per_s']:.4f} "
              f"against {want['imgs_per_s']:.4f}")

        # (c)
        e0 = DiffusionEngine(short, params=params)
        e1 = DiffusionEngine(short, params=params)
        runs = {}
        for label, engines in (("shared engine", None),
                               ("engines=[e0, e1]", [e0, e1])):
            router = ClusterRouter(e0, 2, 2, engines=engines)
            router.warmup()
            reqs = make_requests(short, 4, seed=41)
            m, _ = _route_run(torch, router, reqs, f"(c) {label}",
                              SLICE_ROUTE_PER_STEP)
            runs[label] = (m, reqs)
        (m0, r0), (m1, r1) = runs.values()
        require(all(a.image.tobytes() == b.image.tobytes()
                    for a, b in zip(r0, r1)), "(c) images differ")
        a0 = merge_ledger_accums(st.accum for st in m0["states"])
        a1 = merge_ledger_accums(st.accum for st in m1["states"])
        require(all(torch.equal(getattr(a0, f.name), getattr(a1, f.name))
                    for f in dataclasses.fields(a0)), "(c) buckets differ")
        require(m0["energy"] == m1["energy"], "(c) energy differs")
        print(f"  (c) router: 4 images, the merged int64 buckets (6 planes) "
              f"and the energy bit-equal with one engine a replica")

        # (d)
        try:
            serve_diffusion.main(["--mesh", "2", "--smoke"])
        except ValueError as e:
            msg = str(e)
        else:
            msg = None
        require(msg == "--mesh 2 needs 2 devices, have 1",
                f"(d) --mesh 2 on one card: {msg!r}")
        print(f"  (d) serve_diffusion --mesh 2 on one card: {msg}")
    require(not torch.distributed.is_initialized(), "the group outlived "
            "the phase")


def _slot_request(torch, eng, seed):
    toks, un = _tokens(torch, eng.cfg, seed)
    lat = eng.init_latents(1, torch.Generator(device="cuda")
                           .manual_seed(seed + 1))
    return toks, un, lat


def _drain_slots(torch, eng, reqs, num_slots, bank=None, policies=None):
    """Serve ``reqs`` in queue order through ``num_slots`` slots, filling
    every free slot between steps.  Returns the drained state, each
    request's final latents, image and decode chunk size, the slot_step
    walls and the drain's wall seconds (admissions, steps, decodes and
    retirements).  Admissions, decodes and retirements must launch no
    kernel: the counters may move only inside ``slot_step``."""
    from repro_torch.kernels import runtime

    queue = list(range(len(reqs)))
    owner, lats, imgs, chunk, walls = {}, {}, {}, {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = eng.init_slots(num_slots, bank=bank)

    def quiet(fn):
        before = runtime.launch_counts()
        out = fn()
        require(runtime.launch_counts() == before,
                f"{fn.__name__} launched a kernel")
        return out

    def fill(state):
        for s in range(num_slots):
            if s not in owner and queue:
                r = queue.pop(0)
                toks, un, lat = reqs[r]

                def admit():
                    return eng.admit(state, s, toks, uncond_tokens=un,
                                     latents=lat, policy_index=(
                                         0 if policies is None
                                         else policies[r]))
                state = quiet(admit)
                owner[s] = r
        return state

    state = fill(state)
    while owner:
        state = eng.slot_step(state)
        walls.append(eng.last_wall_s)
        done = eng.finished_slots(state)
        if done:
            def decode():
                return eng.decode_slots(state, done)
            images = quiet(decode)
            for j, s in enumerate(done):
                r = owner.pop(s)
                lats[r] = state.latents[s:s + 1].clone()
                imgs[r] = images[j:j + 1]
                chunk[r] = len(done)

            def retire():
                return eng.retire(state, done)
            state = quiet(retire)
        state = fill(state)
    torch.cuda.synchronize()
    return state, lats, imgs, chunk, walls, time.perf_counter() - t0


def _hold_launches(counts, steps, per_step, label):
    want = {k: v * steps for k, v in per_step.items()}
    got = {k: counts.get(k, 0) for k in want}
    print(f"  {label}: launches {json.dumps(got)} over {steps} slot steps")
    require(got == want, f"{label}: launches {got} != {want}")


def _policy_witnesses(torch, eng, reqs, policies, bank, rows: int = 2):
    """One-shot witnesses of a banked drain: one ``generate`` per policy
    under the whole bank, that policy's requests tiled to the ``rows``
    rows of one batch (the slot count: on the card cuBLAS picks its fp32
    GEMM by the row count, so a row's bits follow the batch's shape;
    ROADMAP Queue 3).  Returns each request's output row (an
    ``EngineOutput`` of one row) and each policy's output.

    One call per policy sums the policy's counters over its requests in
    integers before the one float32 conversion, as the accumulator does;
    calls of one request each would convert apart, and at full width
    (nnz past 2^24) the sums then differ in float32's last place.  A
    lone request's terms double exactly; a policy with no request makes
    no call.  (``stats_rows`` cannot pick
    one row: under fused CFG the first block's self-attention runs
    before the tiling to [cond | uncond] and accounts every request row,
    as in the JAX package; ROADMAP Queue 3.)  Tiling scales every term
    by a power of two, exactly."""
    out_rows, outs = {}, {}
    for p, pol in enumerate(bank):
        mine = [r for r in range(len(reqs)) if policies[r] == p]
        if not mine:
            continue
        require(rows % len(mine) == 0 and (rows // len(mine)) & (
            rows // len(mine) - 1) == 0, f"{len(mine)} requests do not "
            f"tile {rows} rows by a power of two")
        take = mine * (rows // len(mine))
        out = outs[p] = eng.generate(
            torch.cat([reqs[r][0] for r in take]),
            uncond_tokens=torch.cat([reqs[r][1] for r in take]),
            latents=torch.cat([reqs[r][2] for r in take]),
            sampler_policy=pol, sampler_bank=bank)
        for j, r in enumerate(mine):
            out_rows[r] = dataclasses.replace(
                out, images=out.images[j:j + 1],
                latents=out.latents[j:j + 1])
    return out_rows, outs


def _hold_images(torch, eng, label, r, img, chunk, witness):
    """A slot image against its one-shot witness (decoded at batch 2):
    bit for bit when it was decoded in a chunk of 2, else within what
    decoding the witness latents at batch 1 moves them (printed)."""
    from repro_torch.diffusion.vae import decode
    if chunk == 2:
        require(same_bits(torch, img, witness.images[:1]),
                f"{label} request {r}: image differs from the one-shot "
                f"image at equal decode batch")
        print(f"  {label} request {r}: image bit-equal (decode batch 2)")
        return
    b1 = decode(eng.vae_params, witness.latents[:1], eng.cfg.vae)
    move = (b1 - witness.images[:1]).abs().max().item()
    diff = (img - witness.images[:1]).abs().max().item()
    print(f"  {label} request {r}: image (decode batch 1) against the "
          f"one-shot image (batch 2) max|diff| {diff:.3e}; decoding the "
          f"one-shot latents at batch 1 moves them {move:.3e}")
    require(diff <= move, f"{label} request {r}: image differs by {diff} "
            f"> {move}")


def _encode_cost(torch, eng, batches=(4,), reps=5):
    """What encoding prompts one row at a time (``DiffusionEngine._encode``,
    which slot serving's bit-equality needs) costs ``generate`` at batch B
    against encoding the batch in one call, as the engine did before:
    the two encodes' median ms each way, one ``generate`` wall each way
    (the batched one replays the engine's steps with the batch encoded in
    one call) and how far the contexts and final latents move."""
    from repro_torch.diffusion.sampler import sample_scan
    from repro_torch.diffusion.text_encoder import encode_text
    from repro_torch.diffusion.vae import decode

    cfg = eng.cfg

    def median_ms(fn):
        fn()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return sorted(walls)[reps // 2]

    for b in batches:
        pairs = [_tokens(torch, cfg, 71 + i) for i in range(b)]
        toks = torch.cat([p[0] for p in pairs])
        un = torch.cat([p[1] for p in pairs])
        lat = eng.init_latents(b, torch.Generator(device="cuda")
                               .manual_seed(81 + b))

        def whole(t):
            return encode_text(eng.text_params, t, cfg.text)

        ctx_diff = (eng._encode(toks) - whole(toks)).abs().max().item()
        rows_ms = median_ms(lambda: (eng._encode(toks), eng._encode(un)))
        whole_ms = median_ms(lambda: (whole(toks), whole(un)))

        def batched_generate():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = sample_scan(eng._unet_apply, lat.clone(), whole(toks),
                                 whole(un), cfg.ddim)
            decode(eng.vae_params, out, cfg.vae)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        eng.generate(toks, uncond_tokens=un, latents=lat.clone())  # warm-up
        before, before_s = batched_generate()
        after = eng.generate(toks, uncond_tokens=un, latents=lat.clone())
        moved = (after.latents - before).abs().max().item()
        print(f"generate at batch {b}: {eng.last_wall_s:.4f} s encoding row "
              f"by row, {before_s:.4f} s encoding the batch in one call; "
              f"the two encodes {rows_ms:.3f} ms against {whole_ms:.3f} ms; "
              f"contexts max|diff| {ctx_diff:.3e}, final latents "
              f"{moved:.3e}")
        require(math.isfinite(moved), f"batch {b}: non-finite latents")


def _capture_kernel_inputs(run):
    """``run()`` with the three main-path kernel wrappers wrapped, so that
    the first call of each distinct set of input shapes keeps its inputs
    (the tensors as the path hands them over: strided views included)."""
    from repro_torch.kernels.bitslice_matmul import ops as dbsc_ops
    from repro_torch.kernels.cross_attention_tips import ops as cross_ops
    from repro_torch.kernels.pssa_attention import ops as pssa_ops

    seen = {}
    patched = [(pssa_ops, "pssa_attention_kernel"),
               (cross_ops, "cross_attention_heads_kernel"),
               (dbsc_ops, "bitslice_matmul_kernel")]
    origs = [getattr(m, n) for m, n in patched]
    for (mod, name), orig in zip(patched, origs):
        def keep(*a, _orig=orig, _name=name, **kw):
            key = (_name,) + tuple(tuple(x.shape) for x in a
                                   if hasattr(x, "shape"))
            seen.setdefault(key, (a, kw))
            return _orig(*a, **kw)
        setattr(mod, name, keep)
    try:
        run()
    finally:
        for (mod, name), orig in zip(patched, origs):
            setattr(mod, name, orig)
    return seen


def _hold_slot_kernels(torch, seen, label, cfg, slots):
    """Each kernel against its plain version on the inputs one slot step
    of ``slots`` slots handed it: PSSA as the kernels phase holds it
    (counters exact below T = 4096, the tie rule at it), cross-attention
    within OUT_ATOL and CAS_ATOL, the bit-slice matmul bit for bit.  All
    three wrappers must have been caught at the step's largest shapes:
    2 * slots UNet rows under fused CFG, so PSSA BH = rows * heads, the
    cross-attention's B = rows and the bit-slice M = rows * T, T the
    tokens of the largest attention resolution (the UNet's latent**2,
    DiT's token grid)."""
    from repro_torch.kernels.bitslice_matmul.kernel import (
        bitslice_matmul_kernel)
    from repro_torch.kernels.bitslice_matmul.ref import bitslice_matmul_ref
    from repro_torch.kernels.cross_attention_tips.kernel import (
        cross_attention_heads_kernel)
    from repro_torch.kernels.cross_attention_tips.ref import (
        cross_attention_tips_ref)
    from repro_torch.kernels.pssa_attention.kernel import (
        pssa_attention_kernel)
    from repro_torch.kernels.pssa_attention.ref import (
        pssa_attention_stats_ref)

    rows = 2 * slots
    lead = {}
    for name, first, *_ in seen:
        lead[name] = max(lead.get(name, 0), first[0])
    want = {"pssa_attention_kernel": rows * cfg.unet.num_heads,
            "cross_attention_heads_kernel": rows,
            "bitslice_matmul_kernel":
                rows * cfg.unet.attn_resolutions()[0] ** 2}
    print(f"  {label}: largest leading dimension caught {json.dumps(lead)}")
    require(lead == want, f"{label}: kernel inputs caught at leading "
            f"dimensions {lead}, want {want}")
    for key, (a, kw) in seen.items():
        name, shapes = key[0], key[1:]
        if name == "pssa_attention_kernel":
            q, k, v, thr, patch = a
            check_pssa(torch, f"{label} pssa_attention {list(shapes[0])}",
                       q, k, patch, pssa_attention_kernel(q, k, v, thr, patch),
                       pssa_attention_stats_ref(q, k, v, thr, patch),
                       exact=k.shape[1] < 4096)
        elif name == "cross_attention_heads_kernel":
            q, k, v, cls = a
            b, h, tq, d = q.shape
            out_k, cas_k = cross_attention_heads_kernel(q, k, v, cls)
            out_p, cas_p = cross_attention_tips_ref(
                *(x.reshape(b * h, x.shape[2], d) for x in (q, k, v)), cls)
            err_o = (out_k.reshape(b * h, tq, d) - out_p).abs().max().item()
            err_c = (cas_k.reshape(b * h, tq) - cas_p).abs().max().item()
            print(f"  {label} cross_attention_tips {list(q.shape)}: out "
                  f"max|err| {err_o:.3e}, CAS {err_c:.3e}")
            require(err_o <= OUT_ATOL and err_c <= CAS_ATOL,
                    f"{label} cross_attention_tips {list(q.shape)}: out "
                    f"{err_o}, CAS {err_c}")
        else:
            hi, lo, w, prec = a
            same = torch.equal(bitslice_matmul_kernel(hi, lo, w, prec, **kw),
                               bitslice_matmul_ref(hi, lo, w, prec))
            mkn = [hi.shape[0], hi.shape[1], w.shape[1]]
            print(f"  {label} bitslice_matmul {mkn}: bit-exact {same}")
            require(same, f"{label} bitslice_matmul {list(hi.shape)}: not "
                          f"bit-exact")


@phase("slots")
def slots_phase(torch, eng):
    """Slot serving (continuous batching) at full width on the slice's
    weights and guidance 7.5.

    (a) Two ddim@25 requests admitted together into 2 slots: the final
        latents bit-equal to ``generate`` at batch 2 on the same tokens
        and latents, the images too (one decode chunk of 2), and
        ``energy_report_from_accum`` equal to ``energy_report_multi`` of
        that call key for key.  Slice route (fused + DBSC); 9 / 9 / 18
        launches per slot_step, none in admit, decode or retire.  Then
        what encoding prompts row by row costs ``generate`` at batch 4
        (``_encode_cost``).
    (b) A bank of ddim@25 and dpm2m@12, the dpm2m policy with a phase
        schedule on ``tips_scale`` only (so every step still runs the
        three kernels): three requests through 2 slots, the third
        admitted into the slot the dpm2m request frees, so rows sit at
        different steps and policies in one call.  Each request's final
        latents against ``generate(sampler_policy=p, sampler_bank=bank)``
        at batch 2 (the policy's two requests, or its one request tiled)
        and the per-policy headlines of ``energy_report_banked`` against
        those one-shot runs (``_policy_witnesses``).  On the fused attention + float FFN route they must be
        bit-equal and key-for-key equal.  On the slice route the DBSC FFN
        quantizes on one scale over the whole (rows x tokens, C) matrix,
        so a row's codes follow what shares its batch (ROADMAP Queue 3):
        each request's latents, ``mj_per_iter_with_ema`` and optimized
        EMA bytes are held to DBSC_SLOT_SHARE of the distance between its
        one-shot runs on the two routes (the headlines at least to
        LEDGER_RTOL); launches 9 / 9 / 18 per slot_step.
    Then s per slot_step at SLOT_COUNTS slots; at the largest (PSSA BH
    64, the bit-slice matmul M 32768) each kernel is held against its
    plain version on the inputs that slot step handed it, and one more
    step runs under the profiler.  Nothing timed sets a limit.
    """
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import (energy_report_banked,
                                                energy_report_from_accum,
                                                energy_report_multi)
    from repro_torch.diffusion.solvers import PhaseSchedule, SamplerPolicy
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy

    cfg = eng.cfg
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}

    # (a) equal-shape oracle on the slice route
    reqs = [_slot_request(torch, eng, seed) for seed in (41, 43)]
    runtime.reset_launch_counts()
    state, lats, imgs, chunk, walls, wall = _drain_slots(torch, eng, reqs, 2)
    counts = runtime.launch_counts()
    print(f"(a) two ddim@{cfg.ddim.num_inference_steps} requests, 2 slots: "
          f"{len(walls)} slot steps, drain {wall:.3f} s")
    _hold_launches(counts, len(walls), SLICE_ROUTE_PER_STEP, "(a)")
    out = eng.generate(torch.cat([r[0] for r in reqs]),
                       uncond_tokens=torch.cat([r[1] for r in reqs]),
                       latents=torch.cat([r[2] for r in reqs]))
    for r in range(2):
        require(same_bits(torch, lats[r], out.latents[r:r + 1]),
                f"(a) request {r}: latents differ from generate at batch 2 "
                f"by {(lats[r] - out.latents[r:r + 1]).abs().max().item()}")
        _hold_images(torch, eng, "(a)", r, imgs[r], chunk[r],
                     dataclasses.replace(out, images=out.images[r:r + 1],
                                         latents=out.latents[r:r + 1]))
    acc_rep = energy_report_from_accum(cfg, state.accum).summary()
    one_rep = energy_report_multi(cfg, [out.stats]).summary()
    print("  energy_report_from_accum " + json.dumps(acc_rep))
    require(acc_rep == one_rep, f"(a) accumulator headline {acc_rep} != "
            f"one-shot {one_rep}")
    print("  (a) latents bit-equal, headline equal key for key")
    _encode_cost(torch, eng)

    # (b) staggered banked drain, on two routes
    bank = (SamplerPolicy.ddim(cfg.ddim.num_inference_steps),
            SamplerPolicy.dpm2m(12, phases=PhaseSchedule(
                tips_scale=SLOT_TIPS_SCALE)))
    policies = [0, 1, 1]
    reqs = [_slot_request(torch, eng, seed) for seed in (51, 53, 55)]
    routes = (("fused attention + float FFN", KernelPolicy(
                  self_attention="fused", cross_attention="fused")),
              ("slice route", cfg.unet.kernel_policy))
    witnesses, heads = {}, {}
    for label, pol in routes:
        exact = pol.ffn != "dbsc"
        rcfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, kernel_policy=pol))
        e = eng if exact is False else DiffusionEngine(rcfg, params=params)
        runtime.reset_launch_counts()
        state, lats, imgs, chunk, walls, wall = _drain_slots(
            torch, e, reqs, 2, bank=bank, policies=policies)
        counts = runtime.launch_counts()
        print(f"(b) {label}: {len(walls)} slot steps, drain {wall:.3f} s, "
              f"{len(reqs) / wall:.3f} images/s")
        per_step = dict(SLICE_ROUTE_PER_STEP)
        if exact:
            per_step["bitslice_matmul"] = 0
        _hold_launches(counts, len(walls), per_step, f"(b) {label}")
        banked = energy_report_banked(rcfg, state.accum, bank)
        print(f"  energy_report_banked ({label}) "
              + json.dumps(banked.summary()))
        wit, outs = _policy_witnesses(torch, e, reqs, policies, bank)
        witnesses[label] = wit
        moved, dist = {}, {}
        for r in range(len(reqs)):
            d = moved[r] = (lats[r] - wit[r].latents[:1]).abs().max().item()
            print(f"  {label} request {r} ({bank[policies[r]].key()}): "
                  f"latents max|diff| {d:.3e} against generate at batch 2")
            if not exact:
                fl = witnesses[routes[0][0]][r].latents[:1]
                dist[r] = (wit[r].latents[:1] - fl).abs().max().item()
                print(f"    the one-shot run's own DBSC against float FFN "
                      f"distance {dist[r]:.3e}")
        for r in range(len(reqs)):
            require(bool(torch.isfinite(lats[r]).all()),
                    f"(b) {label} request {r}: non-finite latents")
            if exact:
                require(same_bits(torch, lats[r], wit[r].latents[:1]),
                        f"(b) {label} request {r}: latents differ by "
                        f"{moved[r]}")
                _hold_images(torch, e, f"(b) {label}", r, imgs[r],
                             chunk[r], wit[r])
            else:
                lim = DBSC_SLOT_SHARE * dist[r]
                require(moved[r] <= lim, f"(b) {label} request {r}: "
                        f"latents differ by {moved[r]} > {lim}")
        heads[label] = []
        for p, entry in enumerate(banked.entries):
            ref = energy_report_multi(rcfg, [outs[p].stats],
                                      sampler_policy=bank[p]).summary()
            heads[label].append(ref)
            got = entry.report.summary()
            require(entry.images == policies.count(p), f"(b) {label}: "
                    f"{entry.images} images under {bank[p].key()}")
            if exact:
                require(got == ref, f"(b) {label} {bank[p].key()}: "
                        f"headline {got} != one-shot {ref}")
                continue
            fl = heads[routes[0][0]][p]
            rel, lim = {}, {}
            for k in HEADLINES:
                rel[k] = abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)
                lim[k] = max(LEDGER_RTOL, DBSC_SLOT_SHARE * abs(
                    ref[k] - fl[k]) / max(abs(ref[k]), 1e-30))
            print(f"  {label} {bank[p].key()}: headline relative "
                  + ", ".join(f"{k} {rel[k]:.3e} (limit {lim[k]:.3e})"
                              for k in HEADLINES))
            for k in ("ema_gb_per_iter_optimized", "mj_per_iter_with_ema"):
                require(rel[k] <= lim[k], f"(b) {label} "
                        f"{bank[p].key()}: {k} differs by {rel[k]}")
        if exact:
            print(f"  (b) {label}: latents bit-equal, per-policy headlines "
                  f"equal key for key")

    # s per slot_step on the slice route; at the largest slot count the
    # warm-up step's kernel inputs are held against the plain versions
    for n in SLOT_COUNTS:
        state = eng.init_slots(n)
        for s in range(n):
            toks, un, lat = _slot_request(torch, eng, 61 + s)
            state = eng.admit(state, s, toks, uncond_tokens=un, latents=lat)
        if n == SLOT_COUNTS[-1]:
            box = []
            seen = _capture_kernel_inputs(
                lambda: box.append(eng.slot_step(state)))
            state = box[0]
            _hold_slot_kernels(torch, seen, f"{n} slots", cfg, n)
            del seen
        else:
            state = eng.slot_step(state)              # warm-up
        walls = []
        for _ in range(SLOT_TIMED_STEPS):
            state = eng.slot_step(state)
            walls.append(eng.last_wall_s)
        require(bool(torch.isfinite(state.latents).all()),
                f"{n} slots: non-finite latents")
        print(f"slot_step at {n} slots: s {' '.join(f'{w:.4f}' for w in walls)}"
              f" (median {sorted(walls)[len(walls) // 2]:.4f})")
    box = [state]

    def step():
        box[0] = eng.slot_step(box[0])
        return eng.last_wall_s
    profile_breakdown(torch, step, f"slot_step {SLOT_COUNTS[-1]} slots")


def _reuse_sums(torch, accum):
    """(computed, total) reuse buckets, summed over layers, on the host."""
    return (accum.reuse_computed.sum(1).cpu(),
            accum.reuse_total.sum(1).cpu())


def _stats_reuse_sums(torch, stats):
    """A one-shot run's reuse counters summed over layers and rows, per
    step: what its requests add to the accumulator's buckets."""
    comp = sum(c.computed.to(torch.int64).sum(1) for c in stats.reuse)
    tot = sum(c.total.to(torch.int64).sum(1) for c in stats.reuse)
    return comp.cpu(), tot.cpu()


def _slot_step_times(torch, eng, seed):
    """s per slot_step at SLOT_COUNTS slots, every slot admitted at step
    0: one warm-up step, then SLOT_TIMED_STEPS timed ones; returns
    {slots: (median s, the timed steps' reuse ratio or None)}."""
    out = {}
    for n in SLOT_COUNTS:
        state = eng.init_slots(n)
        for s in range(n):
            toks, un, lat = _slot_request(torch, eng, seed + s)
            state = eng.admit(state, s, toks, uncond_tokens=un, latents=lat)
        state = eng.slot_step(state)                  # warm-up
        walls = []
        for _ in range(SLOT_TIMED_STEPS):
            state = eng.slot_step(state)
            walls.append(eng.last_wall_s)
        require(bool(torch.isfinite(state.latents).all()),
                f"{n} slots: non-finite latents")
        ratio = None
        if state.reuse_cache is not None:
            comp, tot = _reuse_sums(torch, state.accum)
            timed = slice(1, 1 + SLOT_TIMED_STEPS)
            ratio = 1.0 - comp[timed].sum().item() / tot[timed].sum().item()
        out[n] = (sorted(walls)[len(walls) // 2], ratio)
        print(f"  slot_step at {n} slots: s "
              f"{' '.join(f'{w:.4f}' for w in walls)} (median "
              f"{out[n][0]:.4f})" + ("" if ratio is None else
                                     f", reuse ratio {ratio:.4f}"))
    return out


def _median_step1_delta(torch, e, reqs):
    """The median per-patch delta over every block and row at step 1 of
    ``e.generate`` of ``reqs`` (tokens, uncond tokens, latents) under
    reuse at threshold 0.  Step 0 computes every patch, so step 1's
    deltas are those of a run at any threshold, and about half of that
    step's patches fall under this one.  With random weights every delta
    exceeds REUSE_THRESHOLD (nothing is reused there), so this is the
    threshold at which the card checks see rows in different reuse
    states, the scatter over the cache and the reuse_scale lane."""
    from repro_torch.core.reuse import ReusePolicy
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.kernels import dispatch

    cfg = _with_reuse(e.cfg, ReusePolicy.temporal(0.0))
    layers = len(cfg.unet.layer_order())
    deltas, orig = [], dispatch.patch_delta

    def keep(*a, **kw):
        out = orig(*a, **kw)
        deltas.append(out[0].flatten())
        return out
    dispatch.patch_delta = keep
    try:
        DiffusionEngine(cfg, params={"text": e.text_params,
                                     "unet": e.unet_params,
                                     "vae": e.vae_params}).generate(
            torch.cat([r[0] for r in reqs]),
            uncond_tokens=torch.cat([r[1] for r in reqs]),
            latents=torch.cat([r[2] for r in reqs]))
    finally:
        dispatch.patch_delta = orig
    require(len(deltas) == layers * cfg.ddim.num_inference_steps,
            f"{len(deltas)} patch deltas over "
            f"{cfg.ddim.num_inference_steps} steps of {layers} blocks")
    return torch.cat(deltas[layers:2 * layers]).median().item()


def _hold_mid_ratios(ratios, label):
    """At the median step-1 delta: nothing reused at step 0 (every cache
    row starts invalid), and over the later steps some patches reused and
    some computed."""
    mean = sum(ratios[1:]) / len(ratios[1:])
    print(f"  {label}: mean reuse ratio over steps 1.. {mean:.4f}")
    require(ratios[0] == 0.0 and 0.0 < mean < 1.0
            and all(0.0 <= r <= 1.0 for r in ratios),
            f"{label}: reuse ratios {ratios} not inside (0, 1)")


@phase("slot_reuse")
def slot_reuse_phase(torch, eng):
    """Slot serving under temporal reuse at full width on the slice's
    weights, guidance 7.5, on two routes: fused attention + float FFN, and
    the slice route (fused + DBSC), both with the patch-delta kernel; at
    REUSE_THRESHOLD (the policy's default, where the untrained model
    reuses nothing) and at the median step-1 patch delta
    (``_median_step1_delta``, where it reuses some patches of most rows).

    (a) Two ddim@25 requests admitted at step 0 into 2 slots and into 4
        slots, 25 slot steps, at both thresholds.  Float route: each
        request's latents bit-equal to ``generate`` of the two tiled to
        the slot count under the same policy, the reuse buckets equal to
        that run's reuse counters, ``energy_report_from_accum`` key for
        key its ``energy_report_multi``.  Slice route: each request within
        DBSC_SLOT_SHARE of its DBSC-to-float one-shot distance, the
        headlines within LEDGER_RTOL (DBSC's per-tensor scale couples the
        rows).  Across 2 and 4 slots the latents within SLOT_COUNT_ATOL
        (cuBLAS picks its fp32 GEMM by the row count; ROADMAP Queue 3),
        the reuse buckets equal (slice route: within SLICE_BUCKET_SHARE).  ``reuse_ratios_from_accum`` reads 0
        at step 0 and lies in [0, 1], at the median strictly between 0
        and 1 over the later steps.  9 / 9 / 18 launches per slot step (no
        bit-slice launch on the float route) and 9 patch deltas; none in
        admit, decode or retire.
    (b) Admission invalidates: at threshold 1e9, one slot, a step, a
        retirement, a new request, a step; the new occupant's first step
        computes every patch.
    (c) A staggered drain of ddim@25 and dpm2m@12 under
        ``PhaseSchedule.detail_guard()`` (which schedules ``reuse_scale``
        and ``pssa_scale``; the per-row PSSA threshold takes the plain
        self-attention, so no PSSA launch) on 2 slots, float route, at
        both thresholds: each request bit-equal to its banked one-shot
        witness under reuse, both policies' headlines key for key, and at
        the median some patches reused.
    Then s per slot_step at SLOT_COUNTS slots under reuse at
    REUSE_THRESHOLD beside the dense slice engine's, with the timed
    steps' reuse ratio (recorded only).
    """
    from repro_torch.core.reuse import ReusePolicy
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import (energy_report_banked,
                                                energy_report_from_accum,
                                                energy_report_multi,
                                                reuse_ratios_from_accum)
    from repro_torch.diffusion.solvers import PhaseSchedule, SamplerPolicy
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy

    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}
    routes = (("float route", KernelPolicy(
                  self_attention="fused", cross_attention="fused",
                  reuse="kernel")),
              ("slice route", KernelPolicy(**SLICE_ROUTE)))

    def engine(pol, thr):
        return DiffusionEngine(_with_reuse(dataclasses.replace(
            eng.cfg, unet=dataclasses.replace(eng.cfg.unet,
                                              kernel_policy=pol)),
            ReusePolicy.temporal(thr)), params=params)

    # (a) two requests at step 0, 2 and 4 slots, each held against
    # generate of the two tiled to the slot count (equal shapes)
    reqs = [_slot_request(torch, eng, seed) for seed in (141, 143)]
    mid = _median_step1_delta(torch, engine(routes[0][1], 0.0), reqs)
    print(f"(a) median step-1 patch delta {mid!r}")
    for thr in (REUSE_THRESHOLD, mid):
        one_shot = {}
        for label, pol in routes:
            e = engine(pol, thr)
            cfg = e.cfg
            name = f"{label} at threshold {thr:.6g}"
            exact = pol.ffn != "dbsc"
            per_step = dict(SLICE_ROUTE_PER_STEP, patch_delta=9)
            if exact:
                per_step["bitslice_matmul"] = 0
            runs = {}
            for n in (2, 4):
                take = [reqs[i % 2] for i in range(n)]
                out = one_shot[label, n] = e.generate(
                    torch.cat([r[0] for r in take]),
                    uncond_tokens=torch.cat([r[1] for r in take]),
                    latents=torch.cat([r[2] for r in take]))
                one_rep = energy_report_multi(cfg, [out.stats]).summary()
                runtime.reset_launch_counts()
                state, lats, _, _, walls, wall = _drain_slots(torch, e, reqs,
                                                              n)
                _hold_launches(runtime.launch_counts(), len(walls), per_step,
                               f"(a) {name}, {n} slots")
                runs[n] = (state, lats)
                ratios = reuse_ratios_from_accum(cfg, state.accum)
                print(f"(a) {name}, {n} slots: {len(walls)} slot steps, "
                      f"drain {wall:.3f} s; reuse ratio per step "
                      + json.dumps([round(r, 6) for r in ratios]))
                if thr == mid:
                    _hold_mid_ratios(ratios, f"(a) {name}, {n} slots")
                require(ratios[0] == 0.0
                        and all(0.0 <= r <= 1.0 for r in ratios),
                        f"(a) {name} {n} slots: reuse ratios {ratios}")
                rep = energy_report_from_accum(cfg, state.accum).summary()
                for r in range(2):
                    moved = (lats[r] - out.latents[r:r + 1]).abs().max().item()
                    print(f"  {name} {n} slots request {r}: latents max|diff| "
                          f"{moved:.3e} against generate at batch {n}")
                    if exact:
                        require(same_bits(torch, lats[r],
                                          out.latents[r:r + 1]),
                                f"(a) {name} {n} slots request {r}: latents "
                                f"differ from one-shot by {moved}")
                    else:
                        fl = one_shot[routes[0][0], n].latents[r:r + 1]
                        dist = (out.latents[r:r + 1] - fl).abs().max().item()
                        lim = DBSC_SLOT_SHARE * dist
                        print(f"    the one-shot run's DBSC against float FFN "
                              f"distance {dist:.3e}, limit {lim:.3e}")
                        require(moved <= lim, f"(a) {name} {n} slots request "
                                f"{r}: latents differ by {moved} > {lim}")
                comp, tot = _reuse_sums(torch, state.accum)
                w_comp, w_tot = _stats_reuse_sums(torch, out.stats)
                scale = n // 2               # the witness holds each twice
                if exact:
                    require(torch.equal(comp * scale, w_comp)
                            and torch.equal(tot * scale, w_tot),
                            f"(a) {name} {n} slots: reuse buckets "
                            f"{comp.tolist()} / {tot.tolist()} != one-shot "
                            f"{w_comp.tolist()} / {w_tot.tolist()} over "
                            f"{scale}")
                    require(rep == one_rep, f"(a) {name} {n} slots: headline "
                            f"{rep} != one-shot {one_rep}")
                else:
                    rel = {k: abs(rep[k] - one_rep[k])
                           / max(abs(one_rep[k]), 1e-30) for k in HEADLINES}
                    print(f"  {name} {n} slots headline relative "
                          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
                    for k in ("ema_gb_per_iter_optimized",
                              "mj_per_iter_with_ema"):
                        require(rel[k] <= LEDGER_RTOL, f"(a) {name} {n} "
                                f"slots: {k} differs by {rel[k]}")
            # across slot counts the batch's shape changes, and with it the
            # algorithm cuBLAS picks for some fp32 GEMMs (ROADMAP Queue 3)
            (s2, l2), (s4, l4) = runs[2], runs[4]
            for r in range(2):
                d = (l2[r] - l4[r]).abs().max().item()
                lim = SLOT_COUNT_ATOL[label]
                print(f"  {name} request {r}: 2 slots against 4 slots "
                      f"max|diff| {d:.3e} (limit {lim:.1e}, bit-equal "
                      f"{same_bits(torch, l2[r], l4[r])})")
                require(d <= lim, f"(a) {name} request {r}: 2 and 4 slots "
                        f"differ by {d}")
            for f in ("reuse_computed", "reuse_total"):
                a, b = getattr(s2.accum, f), getattr(s4.accum, f)
                moved = int((a - b).abs().sum())
                lim = 0 if exact else int(SLICE_BUCKET_SHARE
                                          * int(s2.accum.reuse_total.sum()))
                print(f"  {name} {f} buckets across 2 and 4 slots: {moved} "
                      f"patches moved (limit {lim}; sums {int(a.sum())} / "
                      f"{int(b.sum())})")
                require(moved <= lim, f"(a) {name}: {f} buckets differ by "
                        f"{moved} patches across slot counts")

    # (b) admission invalidates the row's cache
    e = engine(routes[0][1], 1e9)
    state = e.init_slots(1)
    toks, un, lat = _slot_request(torch, eng, 151)
    state = e.slot_step(e.admit(state, 0, toks, uncond_tokens=un,
                                latents=lat))
    require(bool(state.reuse_cache.valid[0]), "(b) cache invalid after a step")
    state = e.retire(state, [0])
    toks, un, lat = _slot_request(torch, eng, 153)
    state = e.admit(state, 0, toks, uncond_tokens=un, latents=lat)
    require(not bool(state.reuse_cache.valid[0]), "(b) admit kept the cache")
    before = _reuse_sums(torch, state.accum)
    state = e.slot_step(state)
    after = _reuse_sums(torch, state.accum)
    d_comp = int(after[0][0] - before[0][0])
    d_tot = int(after[1][0] - before[1][0])
    print(f"(b) threshold 1e9: the new occupant's first step computed "
          f"{d_comp} of {d_tot} patches")
    require(d_tot > 0 and d_comp == d_tot, f"(b) the new occupant computed "
            f"{d_comp} of {d_tot} patches")

    # (c) staggered banked drain under reuse, float route
    policies = [0, 1, 1]
    reqs = [_slot_request(torch, eng, seed) for seed in (161, 163, 165)]
    for thr in (REUSE_THRESHOLD, mid):
        e = engine(routes[0][1], thr)
        bank = (SamplerPolicy.ddim(e.cfg.ddim.num_inference_steps),
                SamplerPolicy.dpm2m(12, phases=PhaseSchedule.detail_guard()))
        name = f"float route at threshold {thr:.6g}"
        runtime.reset_launch_counts()
        state, lats, _, _, walls, wall = _drain_slots(
            torch, e, reqs, 2, bank=bank, policies=policies)
        _hold_launches(runtime.launch_counts(), len(walls),
                       {"pssa_attention": 0, "cross_attention_tips": 9,
                        "bitslice_matmul": 0, "patch_delta": 9},
                       f"(c) {name}")
        comp, tot = _reuse_sums(torch, state.accum)
        ratio = 1.0 - comp.sum().item() / tot.sum().item()
        print(f"(c) {name}, bank {[p.key() for p in bank]}: "
              f"{len(walls)} slot steps, drain {wall:.3f} s, "
              f"{len(reqs) / wall:.3f} images/s, reuse ratio {ratio:.4f}")
        if thr == mid:
            require(0.0 < ratio < 1.0, f"(c) {name}: reuse ratio {ratio}")
        wit, outs = _policy_witnesses(torch, e, reqs, policies, bank)
        for r in range(len(reqs)):
            d = (lats[r] - wit[r].latents[:1]).abs().max().item()
            print(f"  request {r} ({bank[policies[r]].key()}): latents "
                  f"max|diff| {d:.3e} against its banked one-shot witness")
            require(same_bits(torch, lats[r], wit[r].latents[:1]),
                    f"(c) {name} request {r}: latents differ by {d}")
        banked = energy_report_banked(e.cfg, state.accum, bank)
        for p, entry in enumerate(banked.entries):
            ref = energy_report_multi(e.cfg, [outs[p].stats],
                                      sampler_policy=bank[p]).summary()
            got = entry.report.summary()
            print(f"  {bank[p].key()}: {entry.images} images, "
                  f"mj_per_iter_with_ema {got['mj_per_iter_with_ema']!r}")
            require(got == ref, f"(c) {name} {bank[p].key()}: headline "
                    f"{got} != one-shot {ref}")

    # s per slot_step under reuse beside the dense slice engine
    print("slot_step times, dense slice route:")
    dense = _slot_step_times(torch, eng, 171)
    print(f"slot_step times, slice route under reuse (threshold "
          f"{REUSE_THRESHOLD}):")
    e = engine(routes[1][1], REUSE_THRESHOLD)
    reused = _slot_step_times(torch, e, 171)
    for n in SLOT_COUNTS:
        print(f"slot_step {n} slots: dense {dense[n][0]:.4f} s, under "
              f"reuse {reused[n][0]:.4f} s (reuse ratio "
              f"{reused[n][1]:.4f})")
    box = [e.init_slots(SLOT_COUNTS[-1])]
    for s in range(SLOT_COUNTS[-1]):
        toks, un, lat = _slot_request(torch, eng, 191 + s)
        box[0] = e.admit(box[0], s, toks, uncond_tokens=un, latents=lat)
    box[0] = e.slot_step(box[0])

    def step():
        box[0] = e.slot_step(box[0])
        return e.last_wall_s
    profile_breakdown(torch, step, f"slot_step {SLOT_COUNTS[-1]} slots "
                                   f"under reuse")


DIT_PER_STEP = {"pssa_attention": 12, "cross_attention_tips": 12,
                "bitslice_matmul": 24}


@contextlib.contextmanager
def _plain_bitslice():
    """Route the DBSC FFN's integer matmul to its plain version (the same
    integers) inside the block, so that a reference route on the card
    launches no kernel at all."""
    from repro_torch.kernels.bitslice_matmul import ops as dbsc_ops
    from repro_torch.kernels.bitslice_matmul.ref import bitslice_matmul_ref
    kern = dbsc_ops.bitslice_matmul_kernel
    dbsc_ops.bitslice_matmul_kernel = (
        lambda hi, lo, w, prec, dataflow=None:
        bitslice_matmul_ref(hi, lo, w, prec))
    try:
        yield
    finally:
        dbsc_ops.bitslice_matmul_kernel = kern


def _time_captured(torch, seen, label):
    """Each captured kernel input set timed on the kernel and on its plain
    version, the inputs rotated past the L2 as the kernels phase does,
    with the bound counted as that phase counts it (PSSA and
    cross-attention on the 3xTF32 basis, the bit-slice matmul on the int8
    one; PSSA's kept products and the INT12 rows from the captured
    inputs)."""
    from repro_torch.kernels.bitslice_matmul.kernel import (
        bitslice_matmul_kernel)
    from repro_torch.kernels.bitslice_matmul.ref import bitslice_matmul_ref
    from repro_torch.kernels.cross_attention_tips.kernel import (
        cross_attention_tips_kernel)
    from repro_torch.kernels.cross_attention_tips.ref import (
        cross_attention_tips_ref)
    from repro_torch.kernels.pssa_attention.kernel import (
        pssa_attention_kernel)
    from repro_torch.kernels.pssa_attention.ref import (
        pssa_attention_stats_ref)

    rot = torch.Generator(device="cuda").manual_seed(97)

    def rotated(first, make):
        size = sum(x.numel() * x.element_size() for x in first)
        return [first] + [make() for _ in range(
            1, max(1, math.ceil(2 * L2_BYTES / size)))]

    for key, (a, kw) in sorted(seen.items()):
        name = key[0]
        if name == "pssa_attention_kernel":
            q, k, v, thr, patch = a
            q, k, v = (x.contiguous() for x in (q, k, v))
            bh, tq, d = q.shape
            tk = k.shape[1]
            sets = rotated((q, k, v), lambda: tuple(
                torch.randn(x.shape, generator=rot, device="cuda")
                for x in (q, k, v)))
            nnz = pssa_attention_stats_ref(q, k, v, thr, patch)[1]
            ms = rotating_ms(torch, lambda *x: pssa_attention_kernel(
                *x, thr, patch), sets, reps=30)
            plain_ms = rotating_ms(torch, lambda *x: pssa_attention_stats_ref(
                *x, thr, patch), sets, reps=10)
            nbytes, ops = pssa_work(bh, tq, tk, d, nnz.sum().item())
            b = bound(nbytes, 3.0 * ops, TF32_FLOPS)
            shape = [bh, tq, tk, d, patch]
            kname = "pssa_attention"
        elif name == "cross_attention_heads_kernel":
            q, k, v, cls = a
            bb, h, tq, d = q.shape
            tk = k.shape[2]
            flat = tuple(x.reshape(bb * h, x.shape[2], d).contiguous()
                         for x in (q, k, v))
            sets = rotated(flat, lambda: tuple(
                torch.randn(x.shape, generator=rot, device="cuda")
                for x in flat))
            ms = rotating_ms(torch, lambda *x: cross_attention_tips_kernel(
                *x, cls), sets, reps=30)
            plain_ms = rotating_ms(torch, lambda *x: cross_attention_tips_ref(
                *x, cls), sets, reps=10)
            nbytes, ops = cross_work(bb * h, tq, tk, d)
            b = bound(nbytes, 3.0 * ops, TF32_FLOPS)
            shape = [bb, h, tq, tk, d]
            kname = "cross_attention_tips"
        else:
            hi, lo, w, prec = a
            m, kk = hi.shape
            n = w.shape[1]

            def planes():
                return (torch.randint(0, 64, (m, kk), generator=rot,
                                      device="cuda", dtype=torch.int32),
                        torch.randint(0, 64, (m, kk), generator=rot,
                                      device="cuda", dtype=torch.int32),
                        w, prec)
            sets = rotated((hi, lo, w, prec), planes)
            ms = rotating_ms(torch, lambda *x: bitslice_matmul_kernel(
                *x, **kw), sets, reps=30)
            plain_ms = rotating_ms(torch, bitslice_matmul_ref, sets, reps=10)
            b = bound(*bitslice_work(m, kk, n, prec.sum().item()), INT8_OPS)
            shape = [m, kk, n]
            kname = "bitslice_matmul"
        print(f"  {label} {kname} shape={shape} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b[0]:.4f} "
              f"bound_by={b[1]} ({b[0] / ms:.1%} of the bound)", flush=True)
        del sets


def _time_patch_delta(torch, shapes, label):
    """The patch-delta kernel at ``shapes`` (B, P, W): bit-exact against
    its plain version, then timed beside it and ``F.pairwise_distance``
    as the kernels phase times it (inputs rotated past the L2), with the
    same bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.patch_reuse.kernel import patch_delta_kernel
    from repro_torch.kernels.patch_reuse.ref import patch_delta_ref
    g = torch.Generator(device="cuda").manual_seed(6144)
    for b, p, w in shapes:
        sets = []
        for _ in range(max(1, math.ceil(2 * L2_BYTES / (8 * b * p * w)))):
            x = torch.randn((b, p, w), generator=g, device="cuda")
            sets.append((x, x + 0.02 * torch.randn((b, p, w), generator=g,
                                                   device="cuda")))
        x, r = sets[0]
        require(same_bits(torch, patch_delta_kernel(x, r),
                          patch_delta_ref(x, r, 1)),
                f"{label} patch_delta {[b, p, w]}: not bit-exact")
        ms = rotating_ms(torch, patch_delta_kernel, sets, reps=60)
        plain_ms = rotating_ms(torch, lambda a, c: patch_delta_ref(a, c, 1),
                               sets, reps=20)
        lib_ms = rotating_ms(torch, lambda a, c: F.pairwise_distance(
            a.reshape(-1, w), c.reshape(-1, w), p=math.inf, eps=0.0),
            sets, reps=20)
        bnd = bound(*delta_work(b, p, w), FP32_FLOPS)
        print(f"  {label} patch_delta shape={[b, p, w]} bit-exact; "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bnd[0]:.4f} "
              f"bound_by={bnd[1]} ({bnd[0] / ms:.1%} of the bound)",
              flush=True)
        del sets


@phase("dit")
def dit_phase(torch):
    """DiT-S/2 (``configs.dit_s``) at full width: 12 blocks of d_model 384,
    6 heads of 64, 32x32x4 latents (a 16x16 token grid), the CLIP ViT-L/14
    text tower and the SD-v1 VAE decoder, random weights from a seed;
    batch 1, guidance 7.5, 25 DDIM steps.

    (a) One-shot ``generate`` on the slice route (fused + DBSC) after a
        warm-up: s/image, ms/step, 300 / 300 / 600 launches; one more
        under the profiler.
    (b) The slice route against the reference route with every kernel's
        plain version on the card (``_plain_bitslice``; no launch), two
        steps from the same latents on each of DBSC_SEEDS, held as the
        parity phase holds its DBSC pair: latents DBSC_LATENT_ATOL, PSSA
        counters DBSC_COUNTER_SCALE times the bound, the optimized EMA
        bytes and ``mj_per_iter_with_ema`` LEDGER_RTOL.
    (c) Each kernel against its plain version on the inputs one fused-CFG
        DiT step hands it (PSSA (6, 256, 64) in block 0 and (12, 256, 64)
        after it, cross-attention (2, 6, 256, 77, 64), the bit-slice
        matmul at (512, 384, 3072) and (512, 1536, 384)), then timed
        there beside the plain version and the bound.
    (d) A staggered drain of ddim@25 and dpm2m@12 + detail_guard on the
        fused attention + float FFN route, on 2 and on 4 slots: each
        request bit-equal to its banked one-shot witness, the banked
        energy summary equal key for key across the slot counts and the
        latents within SLOT_COUNT_ATOL.  Then ddim@25 and dpm2m@12 with no
        phases (no per-row PSSA threshold) on 2 slots on the slice route:
        12 / 12 / 24 launches a step, each request within
        DIT_DBSC_SLOT_SHARE of its one-shot DBSC-to-float distance.
    (e) Temporal reuse on the slice route + the patch-delta kernel:
        threshold 0 equal to the dense latents (as far as a dense witness
        equals itself); at REUSE_THRESHOLD and at the median step-1 patch
        delta the reuse ratio (inside (0, 1) at the median) and 12
        patch-delta launches a step; at the median, (d)'s detail_guard
        bank on 2 slots, float FFN, bit-equal to its banked witnesses; the
        patch delta timed at DiT's shapes, (1, 16, 6144) in block 0 and
        (2, 16, 6144) after it.
    """
    from repro_torch.configs import dit_s
    from repro_torch.core.reuse import ReusePolicy
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import (
        aggregated_reuse_ratios_per_iter, energy_report,
        energy_report_banked, energy_report_multi)
    from repro_torch.diffusion.solvers import PhaseSchedule, SamplerPolicy
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy

    slice_pol = KernelPolicy(self_attention="fused", cross_attention="fused",
                             ffn="dbsc")
    cfg = dit_s.with_kernel_policy(dit_s.CONFIG, slice_pol)
    u = cfg.unet
    require((u.depth, u.hidden_size, u.num_heads, u.latent_size, u.patch)
            == (12, 384, 6, 32, 2) and cfg.ddim.num_inference_steps == 25
            and cfg.ddim.guidance_scale == 7.5, "not DiT-S/2's geometry "
            "and the paper's schedule")
    t0 = time.perf_counter()
    eng = DiffusionEngine(cfg, generator=torch.Generator(
        device="cuda").manual_seed(20))
    torch.cuda.synchronize()
    print(f"DiT-S/2 parameters initialised in {time.perf_counter() - t0:.2f}"
          f" s")
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}
    steps = cfg.ddim.num_inference_steps

    # (a) one-shot generate on the slice route
    toks, un = _tokens(torch, cfg, 27)
    latents = eng.init_latents(1, torch.Generator(device="cuda")
                               .manual_seed(28))
    eng.generate(toks, uncond_tokens=un, latents=latents.clone())  # warm-up
    runtime.reset_launch_counts()
    out = eng.generate(toks, uncond_tokens=un, latents=latents.clone())
    counts = runtime.launch_counts()
    wall = eng.last_wall_s
    want = {k: v * steps for k, v in DIT_PER_STEP.items()}
    print(f"(a) launches {json.dumps(counts)}")
    require(all(counts.get(k) == v for k, v in want.items()),
            f"(a) launch counts {counts} != {want}")
    require(tuple(out.images.shape) == (1, 256, 256, 3),
            f"image shape {tuple(out.images.shape)}")
    require(bool(torch.isfinite(out.images).all())
            and bool(torch.isfinite(out.latents).all()),
            "non-finite DiT output")
    print(f"(a) DiT-S/2 s/image {wall:.4f}  ms/step "
          f"{wall / steps * 1e3:.3f} (wall of one generate incl. text "
          f"encode and VAE decode, over {steps} steps)")
    summary = energy_report(cfg, out.stats).summary()
    print("(a) energy_report " + json.dumps(summary))
    require(all(math.isfinite(v) for v in summary.values()),
            "non-finite DiT energy report")

    def generate():
        eng.generate(toks, uncond_tokens=un, latents=latents.clone())
        return eng.last_wall_s
    profile_breakdown(torch, generate, "dit")

    # (b) the slice route against the plain versions on the card
    two = dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, num_inference_steps=2))
    ref_cfg = dit_s.with_kernel_policy(two, KernelPolicy(ffn="dbsc"))
    ker_cfg = dit_s.with_kernel_policy(two, slice_pol)
    for seed in DBSC_SEEDS:
        toks_s, un_s = _tokens(torch, cfg, seed)
        lat_s = eng.init_latents(1, torch.Generator(device="cuda")
                                 .manual_seed(seed + 1))
        runs = []
        for name, c in (("reference (plain on the card)", ref_cfg),
                        ("slice route", ker_cfg)):
            e = DiffusionEngine(c, params=params)
            runtime.reset_launch_counts()
            if c is ref_cfg:
                with _plain_bitslice():
                    o = e.generate(toks_s, uncond_tokens=un_s,
                                   latents=lat_s.clone())
                n_launch = sum(runtime.launch_counts().values())
                require(n_launch == 0, f"(b) the reference route launched "
                        f"{runtime.launch_counts()}")
            else:
                o = e.generate(toks_s, uncond_tokens=un_s,
                               latents=lat_s.clone())
            runs.append((o, energy_report(c, o.stats).summary()))
        print(f"(b) DiT slice route against plain, seed {seed}, two steps:")
        diff = _differences(torch, runs[0][0], runs[1][0],
                            (runs[0][1], runs[1][1]), heads=u.num_heads)
        require(diff["latents"] <= DBSC_LATENT_ATOL, f"(b) seed {seed}: "
                f"latents differ by {diff['latents']}")
        require(diff["counters"] <= DBSC_COUNTER_SCALE, f"(b) seed {seed}: "
                f"counters at {diff['counters']:.2f} of the bound")
        for k in ("ema_gb_per_iter_optimized", "mj_per_iter_with_ema"):
            require(diff[k] <= LEDGER_RTOL, f"(b) seed {seed}: {k} differs "
                    f"by {diff[k]}")
        rs, fs = runs[0][0].stats.cpu(), runs[1][0].stats.cpu()
        tips_same = all(torch.equal(a.important, b.important)
                        for a, b in zip(rs.tips, fs.tips))
        pssa_same = all(torch.equal(a.nnz, b.nnz) and torch.equal(
            a.bitmap_ones_xor, b.bitmap_ones_xor)
            for a, b in zip(rs.pssa, fs.pssa))
        print(f"  PSSA counters exact {pssa_same}; TIPS masks exact "
              f"{tips_same}")
        require(tips_same, f"(b) seed {seed}: TIPS counts differ")

    # (c) each kernel on the inputs of one DiT step
    state = eng.init_slots(1)
    state = eng.admit(state, 0, toks, uncond_tokens=un, latents=latents)
    seen = _capture_kernel_inputs(lambda: eng.slot_step(state))
    _hold_slot_kernels(torch, seen, "(c) DiT step", cfg, 1)
    _time_captured(torch, seen, "(c) DiT step")
    del seen

    # (d) banked slots on the fused attention + float FFN route
    fcfg = dit_s.with_kernel_policy(cfg, KernelPolicy(
        self_attention="fused", cross_attention="fused"))
    e = DiffusionEngine(fcfg, params=params)
    bank = (SamplerPolicy.ddim(steps),
            SamplerPolicy.dpm2m(12, phases=PhaseSchedule.detail_guard()))
    policies = [0, 1, 1]
    reqs = [_slot_request(torch, e, seed) for seed in (181, 183, 185)]
    summaries, lats_at = {}, {}
    for n in (2, 4):
        wit, _ = _policy_witnesses(torch, e, reqs, policies, bank, rows=n)
        runtime.reset_launch_counts()
        state, lats, _, _, walls, wall = _drain_slots(
            torch, e, reqs, n, bank=bank, policies=policies)
        _hold_launches(runtime.launch_counts(), len(walls),
                       {"pssa_attention": 0, "cross_attention_tips": 12,
                        "bitslice_matmul": 0}, f"(d) {n} slots")
        print(f"(d) DiT bank {[p.key() for p in bank]}, {n} slots: "
              f"{len(walls)} slot steps, drain {wall:.3f} s, "
              f"{len(reqs) / wall:.3f} images/s")
        for r in range(len(reqs)):
            d = (lats[r] - wit[r].latents[:1]).abs().max().item()
            print(f"  request {r} ({bank[policies[r]].key()}): latents "
                  f"max|diff| {d:.3e} against its banked one-shot witness "
                  f"at batch {n}")
            require(same_bits(torch, lats[r], wit[r].latents[:1]),
                    f"(d) {n} slots request {r}: latents differ by {d}")
        summaries[n], lats_at[n] = energy_report_banked(
            fcfg, state.accum, bank).summary(), lats
    for r in range(len(reqs)):
        d = (lats_at[2][r] - lats_at[4][r]).abs().max().item()
        lim = SLOT_COUNT_ATOL["dit"]
        print(f"  request {r}: 2 slots against 4 slots max|diff| {d:.3e} "
              f"(limit {lim:.1e})")
        require(d <= lim, f"(d) request {r}: 2 and 4 slots differ by {d}")
    print("(d) energy_report_banked (2 slots) " + json.dumps(summaries[2]))
    require(summaries[2] == summaries[4], "(d) the banked summary differs "
            "across 2 and 4 slots")

    # (d) on the slice route, a bank that schedules no pssa_scale (the
    # per-row PSSA threshold takes the plain self-attention), so every
    # slot step runs the three kernels; DBSC's per-tensor scale couples
    # the rows, so each request is held to DIT_DBSC_SLOT_SHARE of the
    # distance between its one-shot runs on the DBSC and the float FFN
    plain_bank = (SamplerPolicy.ddim(steps), SamplerPolicy.dpm2m(12))
    fwit, fouts = _policy_witnesses(torch, e, reqs, policies, plain_bank)
    swit, souts = _policy_witnesses(torch, eng, reqs, policies, plain_bank)
    runtime.reset_launch_counts()
    state, lats, _, _, walls, wall = _drain_slots(
        torch, eng, reqs, 2, bank=plain_bank, policies=policies)
    _hold_launches(runtime.launch_counts(), len(walls), DIT_PER_STEP,
                   "(d) slice route, 2 slots")
    print(f"(d) DiT slice route, bank {[p.key() for p in plain_bank]}, 2 "
          f"slots: {len(walls)} slot steps, drain {wall:.3f} s, "
          f"{len(reqs) / wall:.3f} images/s")
    for r in range(len(reqs)):
        moved = (lats[r] - swit[r].latents[:1]).abs().max().item()
        dist = (swit[r].latents[:1] - fwit[r].latents[:1]).abs().max().item()
        lim = DIT_DBSC_SLOT_SHARE * dist
        print(f"  request {r} ({plain_bank[policies[r]].key()}): latents "
              f"max|diff| {moved:.3e} against its banked one-shot witness; "
              f"DBSC against float FFN {dist:.3e}, limit {lim:.3e}")
        require(moved <= lim, f"(d) slice route request {r}: latents differ "
                f"by {moved} > {lim}")
    banked = energy_report_banked(cfg, state.accum, plain_bank)
    for p, entry in enumerate(banked.entries):
        ref, fl = (energy_report_multi(c, [o[p].stats],
                                       sampler_policy=plain_bank[p]).summary()
                   for c, o in ((cfg, souts), (fcfg, fouts)))
        got = entry.report.summary()
        for k in ("ema_gb_per_iter_optimized", "mj_per_iter_with_ema"):
            rel = abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)
            lim = max(LEDGER_RTOL, DIT_DBSC_SLOT_SHARE
                      * abs(ref[k] - fl[k]) / max(abs(ref[k]), 1e-30))
            print(f"  {plain_bank[p].key()} {k}: relative {rel:.3e} "
                  f"(limit {lim:.3e})")
            require(rel <= lim, f"(d) slice route {plain_bank[p].key()}: "
                    f"{k} differs by {rel}")

    # (e) temporal reuse on the slice route with the patch-delta kernel
    rpol = KernelPolicy(**SLICE_ROUTE)

    def run(name, reuse):
        c = _with_reuse(dit_s.with_kernel_policy(cfg, rpol), reuse)
        runtime.reset_launch_counts()
        o = DiffusionEngine(c, params=params).generate(
            toks, uncond_tokens=un, latents=latents.clone())
        print(f"(e) {name}: launches {json.dumps(runtime.launch_counts())}")
        return o, runtime.launch_counts(), c

    dense, _, _ = run("dense", ReusePolicy.off())
    witness, _, _ = run("dense witness", ReusePolicy.off())
    thr0, _, _ = run("threshold 0", ReusePolicy.temporal(0.0))
    w_d = (dense.latents - witness.latents).abs().max().item()
    t_d = (dense.latents - thr0.latents).abs().max().item()
    w_eq = torch.equal(dense.latents, witness.latents)
    print(f"(e) dense against dense bit-equal {w_eq} (max|diff| {w_d:.3e});"
          f" threshold 0 against dense bit-equal "
          f"{torch.equal(dense.latents, thr0.latents)} (max|diff| {t_d:.3e})")
    require(torch.equal(dense.latents, thr0.latents) if w_eq else t_d <= w_d,
            f"(e) threshold 0 differs from dense by {t_d}")
    temporal, counts, rcfg = run(f"threshold {REUSE_THRESHOLD}",
                                 ReusePolicy.temporal(REUSE_THRESHOLD))
    require(counts.get("patch_delta") == 12 * steps,
            f"(e) patch_delta launches {counts.get('patch_delta')} != "
            f"{12 * steps}")
    ratios = aggregated_reuse_ratios_per_iter(rcfg, [temporal.stats])
    print("(e) reuse ratio per iteration " + json.dumps(ratios))
    require(ratios[0] == 0.0, "(e) step 0 reused a patch from an invalid "
            "cache")
    mid = _median_step1_delta(torch, DiffusionEngine(
        dit_s.with_kernel_policy(cfg, rpol), params=params),
        [(toks, un, latents)])
    temporal, counts_mid, rcfg = run(f"threshold {mid:.6g} (the median "
                                     f"step-1 delta)",
                                     ReusePolicy.temporal(mid))
    require(counts_mid.get("patch_delta") == 12 * steps,
            f"(e) patch_delta launches {counts_mid.get('patch_delta')} != "
            f"{12 * steps}")
    ratios = aggregated_reuse_ratios_per_iter(rcfg, [temporal.stats])
    print("(e) reuse ratio per iteration " + json.dumps(ratios))
    _hold_mid_ratios(ratios, f"(e) threshold {mid:.6g}")

    # (e) (d)'s bank, detail_guard and its reuse_scale lane included, on 2
    # slots under reuse at the median: bit-equal to its banked witnesses
    e = DiffusionEngine(_with_reuse(dit_s.with_kernel_policy(
        cfg, KernelPolicy(self_attention="fused", cross_attention="fused",
                          reuse="kernel")), ReusePolicy.temporal(mid)),
        params=params)
    wit, outs = _policy_witnesses(torch, e, reqs, policies, bank)
    runtime.reset_launch_counts()
    state, lats, _, _, walls, wall = _drain_slots(
        torch, e, reqs, 2, bank=bank, policies=policies)
    _hold_launches(runtime.launch_counts(), len(walls),
                   {"pssa_attention": 0, "cross_attention_tips": 12,
                    "bitslice_matmul": 0, "patch_delta": 12},
                   f"(e) float route at threshold {mid:.6g}, 2 slots")
    comp, tot = _reuse_sums(torch, state.accum)
    ratio = 1.0 - comp.sum().item() / tot.sum().item()
    print(f"(e) DiT bank {[p.key() for p in bank]} under reuse, 2 slots: "
          f"{len(walls)} slot steps, drain {wall:.3f} s, reuse ratio "
          f"{ratio:.4f}")
    require(0.0 < ratio < 1.0, f"(e) slots reuse ratio {ratio}")
    for r in range(len(reqs)):
        d = (lats[r] - wit[r].latents[:1]).abs().max().item()
        print(f"  request {r} ({bank[policies[r]].key()}): latents max|diff| "
              f"{d:.3e} against its banked one-shot witness")
        require(same_bits(torch, lats[r], wit[r].latents[:1]),
                f"(e) slots request {r}: latents differ by {d}")
    banked = energy_report_banked(e.cfg, state.accum, bank)
    for p, entry in enumerate(banked.entries):
        ref = energy_report_multi(e.cfg, [outs[p].stats],
                                  sampler_policy=bank[p]).summary()
        require(entry.report.summary() == ref, f"(e) slots "
                f"{bank[p].key()}: headline differs from one-shot")
    print("  (e) slots under reuse: latents bit-equal, per-policy headlines "
          "equal key for key")
    patch = u.patch_size(u.token_res)
    width = patch * u.hidden_size
    _time_patch_delta(torch, [(1, u.token_res ** 2 // patch, width),
                              (2, u.token_res ** 2 // patch, width)],
                      "(e)")
    return counts


# ---------------------------------------------------------------------------
# serving: the schedulers and the serve_diffusion CLI at full width
# ---------------------------------------------------------------------------
SERVING_REQUESTS, SERVING_SLOTS, SERVING_BURST = 8, 4, 2
# DDIM steps of the in-process serve_diffusion.main runs (serving (d),
# autotune (e)): their checks scale with the steps, so 12 hold what 25 did
# in about half the time
CLI_STEPS = 12
SERVING_LOAD = 0.75          # (b), (c): arrival rate / the t = 0 drain's
FLOAT_ROUTE_PER_STEP = {"pssa_attention": 9, "cross_attention_tips": 9,
                        "bitslice_matmul": 0}
DIT_FLOAT_PER_STEP = {"pssa_attention": 12, "cross_attention_tips": 12,
                      "bitslice_matmul": 0}


@contextlib.contextmanager
def _decodes_seen(eng):
    """Record each ``decode_slots`` call of ``eng``: its slots, their
    latents and the decoded images (the scheduler keeps neither)."""
    seen, orig = [], eng.decode_slots

    def decode_slots(state, slots=None):
        out = orig(state, slots)
        slots = list(slots)
        seen.append((slots, state.latents[slots].clone(), out))
        return out
    eng.decode_slots = decode_slots
    try:
        yield seen
    finally:
        del eng.decode_slots


def _served_rows(torch, reqs, seen):
    """Each request's (decode call, row) among the recorded decodes,
    matched by its image."""
    rows = {}
    for c, (slots, _, imgs) in enumerate(seen):
        host = imgs.cpu().numpy()
        for j in range(len(slots)):
            for r in reqs:
                if r.rid not in rows and host[j].tobytes() == \
                        r.image.tobytes():
                    rows[r.rid] = (c, j)
    require(sorted(rows) == [r.rid for r in reqs],
            f"requests {sorted(rows)} matched to decodes")
    return rows


def _batch_witnesses(torch, eng, reqs, rows: int):
    """One-shot ``generate`` of the requests in order, ``rows`` at a time
    (the slot count: the card's GEMMs follow the row count)."""
    outs = []
    for i in range(0, len(reqs), rows):
        chunk = reqs[i:i + rows]
        outs.append(eng.generate(
            torch.cat([r.tokens for r in chunk]),
            uncond_tokens=torch.cat([r.uncond_tokens for r in chunk]),
            latents=torch.cat([r.latents for r in chunk])))
    return outs


def _hold_served(torch, eng, label, reqs, seen, witnesses, rows: int):
    """Each request's final latents bit-equal to its witness row, and
    each recorded decode bit-equal to ``decode_slots`` of the same slots
    holding the witnesses' latents (the same chunk sizes, the same rows
    in each chunk)."""
    import types
    served = _served_rows(torch, reqs, seen)
    wit = {r.rid: witnesses[r.rid // rows].latents[r.rid % rows]
           for r in reqs}
    by_call = {}
    for r in reqs:
        c, j = served[r.rid]
        by_call.setdefault(c, {})[j] = r.rid
        require(same_bits(torch, seen[c][1][j], wit[r.rid]),
                f"{label} request {r.rid}: latents differ from the batch-"
                f"{rows} witness")
    sizes = {}
    for c, (slots, lats, imgs) in enumerate(seen):
        buf = torch.zeros((max(slots) + 1,) + tuple(lats.shape[1:]),
                          dtype=lats.dtype, device=lats.device)
        for j, s in enumerate(slots):
            buf[s] = wit[by_call[c][j]]
        want = type(eng).decode_slots(
            eng, types.SimpleNamespace(latents=buf), slots)
        require(same_bits(torch, imgs, want),
                f"{label} decode {c} (slots {slots}): images differ from "
                f"decoding the witness latents at the same chunks")
        sizes[len(slots)] = sizes.get(len(slots), 0) + 1
    print(f"  {label}: {len(reqs)} requests' latents bit-equal to batch-"
          f"{rows} witnesses; {len(seen)} decodes (slots per decode "
          f"{json.dumps(sizes)}) bit-equal to decoding the witness latents "
          f"at the same chunks")


@contextlib.contextmanager
def _calls_seen(eng):
    """Record each ``generate`` call of ``eng``: its stats, and the int64
    PSSA counters (nnz, ones_xor) that the fused self-attention folds
    into each layer's float32 ``PSSAStats``, in call order."""
    from repro_torch.core import pssa
    calls, generate, fold = [], eng.generate, pssa.stats_from_counters

    def counting_fold(nnz, ones_xor, *a, **kw):
        calls[-1]["counters"].append((nnz, ones_xor))
        return fold(nnz, ones_xor, *a, **kw)

    def recording_generate(*a, **kw):
        calls.append({"counters": []})
        out = generate(*a, **kw)
        calls[-1]["stats"] = out.stats
        return out
    eng.generate, pssa.stats_from_counters = recording_generate, \
        counting_fold
    try:
        yield calls
    finally:
        del eng.generate
        pssa.stats_from_counters = fold


def _calls_buckets(torch, cfg, calls) -> dict:
    """The integer buckets a set of one-shot calls adds up to: per step
    and layer (``attn_layer_order``), nnz and ones_xor from the folded
    kernel counters, imp from the stats' important-token masks; rows per
    step from the accounted row counts."""
    from repro_torch.diffusion.stats import attn_layer_order
    order = attn_layer_order(cfg.unet)
    n, nl = cfg.ddim.num_inference_steps, len(order)
    out = None
    for c in calls:
        st = c["stats"]
        require(tuple(st.layers) == tuple(order)
                and len(c["counters"]) == n * nl,
                f"a call folded {len(c['counters'])} counters, not {n}x{nl}")
        nnz, xor = (torch.stack([x[i] for x in c["counters"]]).view(n, nl)
                    .to(torch.int64) for i in (0, 1))
        imp = torch.stack([t.important.flatten(2).sum(2, dtype=torch.int64)
                           .sum(1) for t in st.tips], dim=1)
        rows = torch.full((n,), st.tips[0].important.shape[1],
                          dtype=torch.int64, device=nnz.device)
        add = {"nnz": nnz, "ones_xor": xor, "imp": imp, "rows": rows}
        out = add if out is None else {k: out[k] + add[k] for k in out}
    return out


def _hold_buckets(torch, label, accum, want: dict):
    """A drained ``LedgerAccum``'s int64 buckets equal, bucket for bucket,
    to what one-shot calls add up to (``_calls_buckets``)."""
    for k, v in want.items():
        got = getattr(accum, k)
        require(torch.equal(got, v.to(got.device)),
                f"{label}: {k} buckets differ from the one-shot calls' "
                f"(max |diff| {(got - v.to(got.device)).abs().max().item()})")
    print(f"  {label}: int64 buckets (nnz, ones_xor, imp, rows) equal to "
          f"the one-shot calls' sums, {want['nnz'].numel()} per counter; "
          f"nnz total {int(want['nnz'].sum())}")


def _hold_energy(label, got: dict, want: dict, exact: bool):
    """A drained accumulator's energy dict against the one-shot ledger's.
    The accumulator converts each bucket's integer sum over all requests
    to float32 once; ``energy_report_multi`` converts each call's sum and
    adds the calls, which rounds otherwise where one call's counter
    passes 2^24 (BK-SDM's res-64 layers at full width, four rows a call).
    So ``exact`` holds key for key, else each key to LEDGER_RTOL; the
    integer buckets under both are held exactly by ``_hold_buckets``."""
    require(set(got) == set(want), f"{label}: energy keys differ")
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
              for k in want)
    same = all(got[k] == want[k] for k in want)
    print(f"  {label}: energy key for key {same}, max relative difference "
          f"{rel:.3e}; mj_per_iter_with_ema {got['mj_per_iter_with_ema']!r}"
          f" / {want['mj_per_iter_with_ema']!r}")
    require(same if exact else rel <= LEDGER_RTOL,
            f"{label}: energy {got} != one-shot {want}")


def _latency_line(label, m, occupancy):
    lat, q = m["latency_s"], m["queue_wait_s"]
    print(f"  {label}: latency s p50 {lat['p50']:.4f} p95 {lat['p95']:.4f} "
          f"max {lat['max']:.4f}; queue wait p95 {q['p95']:.4f}; goodput "
          f"{m['goodput_imgs_per_s']:.4f} images/s; occupancy "
          f"{occupancy:.4f}; makespan {m['makespan_s']:.3f} s")


def _fixed_occupancy(m, micro_batch):
    """Valid rows per batch row of a fixed-batch run."""
    return m["requests"] / (m["engine_calls"] * micro_batch)


def _serve_traffic(torch, eng, label, make, rate, per_step, exact_energy):
    """(b) / (c): ``make()``'s requests on a bursty trace (SERVING_BURST
    at a time, ``rate`` images/s) through ``ContinuousScheduler`` (latents
    recorded at decode) and ``FixedBatchScheduler`` on ``eng``; launches
    per slot step and per call, latents, images and the ledger against
    one-shot witnesses at batch SERVING_SLOTS."""
    from repro_torch.diffusion.pipeline import energy_report_multi
    from repro_torch.kernels import runtime
    from repro_torch.launch.scheduler import (ContinuousScheduler,
                                              FixedBatchScheduler,
                                              apply_trace, bursty_trace)

    n, s = SERVING_REQUESTS, SERVING_SLOTS
    gap = SERVING_BURST / rate
    trace = bursty_trace(n, SERVING_BURST, gap)
    print(f"  {label}: {n} requests, {SERVING_BURST} every {gap:.4f} s "
          f"({rate:.4f} images/s), {s} slots / micro-batch {s}")
    cont = ContinuousScheduler(eng, s)
    cont.warmup()
    reqs = apply_trace(make(), trace)
    runtime.reset_launch_counts()
    with _decodes_seen(eng) as seen:
        mc = cont.run(reqs, ledger=True)
    accum = mc.pop("state").accum
    _hold_launches(runtime.launch_counts(), mc["engine_steps"], per_step,
                   f"{label} continuous")
    fixed = FixedBatchScheduler(eng, s)
    fixed.warmup()
    rf = apply_trace(make(), trace)
    runtime.reset_launch_counts()
    with _calls_seen(eng) as fcalls:
        mf = fixed.run(rf)
    steps = eng.cfg.ddim.num_inference_steps
    _hold_launches(runtime.launch_counts(), mf["engine_calls"] * steps,
                   per_step, f"{label} fixed batch ({mf['engine_calls']} "
                   f"calls x {steps} steps)")
    _latency_line(f"{label} continuous", mc, mc["mean_occupancy"])
    _latency_line(f"{label} fixed batch", mf, _fixed_occupancy(mf, s))
    print(f"  {label} continuous: iter_wall_ms {mc['iter_wall_ms']:.3f} "
          f"over {mc['engine_steps']} slot steps")
    with _calls_seen(eng) as wcalls:
        witnesses = _batch_witnesses(torch, eng, reqs, s)
    _hold_served(torch, eng, label, reqs, seen, witnesses, s)
    for r in rf:
        out = witnesses[r.rid // s]
        require(same_bits(torch, torch.from_numpy(r.image).to(
            out.images.device), out.images[r.rid % s]),
            f"{label} fixed batch request {r.rid}: image differs from the "
            f"batch-{s} witness")
    print(f"  {label} fixed batch: {n} images bit-equal to the batch-{s} "
          f"witnesses")
    want = _calls_buckets(torch, eng.cfg, wcalls)
    _hold_buckets(torch, f"{label} continuous", accum, want)
    fixed_buckets = _calls_buckets(torch, eng.cfg, fcalls)
    require(all(torch.equal(fixed_buckets[k], want[k]) for k in want),
            f"{label}: the fixed batch's integer counters differ from the "
            f"witnesses'")
    rep = energy_report_multi(eng.cfg, [w.stats for w in witnesses])
    _hold_energy(label, mc["energy"],
                 {k: float(v) for k, v in rep.summary().items()},
                 exact_energy)


@phase("serving")
def serving_phase(torch, eng):
    """The serving front-end (``launch.scheduler``,
    ``launch.serve_diffusion``) at full width, on the slice's weights.

    (a) Eight requests at t = 0 on the slice route (fused + DBSC) through
        ``ContinuousScheduler(eng, 4)`` and ``FixedBatchScheduler(eng,
        4)``, both with the ledger: 9 / 9 / 18 launches per slot step and
        per call step; each request's image bit-equal across the two
        (each slot batch holds one micro-batch's requests, so DBSC's
        shared scale is equal); the accumulator's int64 buckets equal to
        the fixed batch's counters summed over its calls, the energy
        dicts by ``_hold_energy``; images/s, ``iter_wall_ms`` and mean
        occupancy for both.
    (b) The same requests on a bursty trace (2 at a time at SERVING_LOAD
        x (a)'s continuous images/s) on ``--kernels auto`` (fused, float
        FFN: 9 / 9 / 0) through both schedulers: latency p50 / p95 /
        max, queue wait p95, goodput, occupancy; launches per slot step
        and per call step; each request's final latents bit-equal to
        one-shot ``generate`` at batch 4, each decode bit-equal to
        decoding the witness latents at the same chunks, the fixed
        batch's images bit-equal to the witnesses'; the accumulator's
        int64 buckets (and the fixed batch's counters) equal to the
        witnesses' summed, the float energy against
        ``energy_report_multi`` over the witnesses by ``_hold_energy``.
    (c) DiT-S/2 at full width the same way: a t = 0 drain for the rate,
        then the trace, float FFN, 12 / 12 / 0 launches a step, the same
        bitwise and integer checks, the energy key for key (no call's
        counter passes 2^24 at T = 256).
    (d) ``serve_diffusion.main`` in this process at full width:
        ``--continuous --slots 4 --requests 4 --steps 25 --guidance 7.5
        --ledger`` on the slice route; its JSON names the ``cuda``
        backend, four requests, a finite ``mj_per_iter_with_ema``, and
        9 / 9 / 18 launches per slot step (the warm-up's one included).
    """
    import io

    from repro_torch.configs import dit_s
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.launch import serve_diffusion
    from repro_torch.launch.scheduler import (ContinuousScheduler,
                                              FixedBatchScheduler,
                                              make_requests)

    cfg, n, s = eng.cfg, SERVING_REQUESTS, SERVING_SLOTS
    require(cfg.unet.kernel_policy == KernelPolicy(
        self_attention="fused", cross_attention="fused", ffn="dbsc"),
        "the slice engine is not on the slice route")

    dev = eng.device

    def make():
        return make_requests(cfg, n, seed=31, device=dev)

    # (a)
    cont = ContinuousScheduler(eng, s)
    cont.warmup()
    ra = make()
    runtime.reset_launch_counts()
    mc = cont.run(ra, ledger=True)
    accum = mc.pop("state").accum
    _hold_launches(runtime.launch_counts(), mc["engine_steps"],
                   SLICE_ROUTE_PER_STEP, "(a) continuous")
    require(mc["engine_steps"] == 2 * cfg.ddim.num_inference_steps,
            f"(a) {mc['engine_steps']} slot steps")
    fixed = FixedBatchScheduler(eng, s)
    fixed.warmup()
    rf = make()
    steps = cfg.ddim.num_inference_steps
    runtime.reset_launch_counts()
    with _calls_seen(eng) as fcalls:
        mf = fixed.run(rf, ledger=True)
    _hold_launches(runtime.launch_counts(), mf["engine_calls"] * steps,
                   SLICE_ROUTE_PER_STEP, f"(a) fixed batch "
                   f"({mf['engine_calls']} calls x {steps} steps)")
    for a, b in zip(ra, rf):
        require(a.image.tobytes() == b.image.tobytes(),
                f"(a) request {a.rid}: continuous image differs from the "
                f"fixed batch's (max |diff| "
                f"{abs(a.image - b.image).max():.3e})")
    print(f"  (a): {n} images bit-equal across the schedulers")
    _hold_buckets(torch, "(a) continuous against the fixed batch", accum,
                  _calls_buckets(torch, cfg, fcalls))
    _hold_energy("(a)", mc["energy"], mf["energy"], exact=False)
    for label, m, iter_ms, occ in (
            ("continuous", mc, mc["iter_wall_ms"], mc["mean_occupancy"]),
            ("fixed batch", mf,
             1e3 * mf["call_wall_s"] / (mf["engine_calls"] * steps),
             _fixed_occupancy(mf, s))):
        print(f"  (a) {label}: {m['goodput_imgs_per_s']:.4f} images/s, "
              f"iter_wall_ms {iter_ms:.3f}, mean occupancy {occ:.4f}, "
              f"makespan {m['makespan_s']:.3f} s")
    rate = SERVING_LOAD * mc["goodput_imgs_per_s"]

    # (b)
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}
    auto = KernelPolicy.parse("auto", device=dev)
    require(auto == KernelPolicy.fused() and auto.ffn == "reference",
            f"auto on the card is {auto}")
    float_eng = DiffusionEngine(dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, kernel_policy=auto)),
        device=dev, params=params)
    _serve_traffic(torch, float_eng, "(b)", make, rate,
                   FLOAT_ROUTE_PER_STEP, exact_energy=False)

    # (c)
    dcfg = dit_s.with_kernel_policy(dit_s.CONFIG, auto)
    deng = DiffusionEngine(dcfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(20))

    def dmake():
        return make_requests(dcfg, n, seed=32, device=dev)
    dcont = ContinuousScheduler(deng, s)
    dcont.warmup()
    m0 = dcont.run(dmake())
    m0.pop("state")
    _latency_line("(c) t = 0", m0, m0["mean_occupancy"])
    _serve_traffic(torch, deng, "(c)", dmake,
                   SERVING_LOAD * m0["goodput_imgs_per_s"],
                   DIT_FLOAT_PER_STEP, exact_energy=True)

    # (d)
    argv = ["--continuous", "--slots", "4", "--requests", "4", "--steps",
            str(CLI_STEPS), "--guidance", "7.5", "--ledger", "--kernels",
            "self_attention=fused,cross_attention=fused,ffn=dbsc"]
    runtime.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_diffusion.main(argv)
    head, _, body = buf.getvalue().partition("\n")
    print(f"  (d) {head}")
    m = json.loads(body)
    require(m["requests"] == 4, f"(d) {m['requests']} requests")
    require(math.isfinite(m["energy"]["mj_per_iter_with_ema"]),
            "(d) non-finite mj_per_iter_with_ema")
    require(m["kernel_policy"]["backend"] == "cuda"
            and m["kernel_policy"]["ffn"] == "dbsc",
            f"(d) kernel policy {m['kernel_policy']}")
    _hold_launches(runtime.launch_counts(), m["engine_steps"] + 1,
                   SLICE_ROUTE_PER_STEP, "(d) CLI (warm-up step included)")
    _latency_line("(d) CLI", m, m["mean_occupancy"])
    print(f"  (d) CLI: mj_per_iter_with_ema "
          f"{m['energy']['mj_per_iter_with_ema']!r}, iter_wall_ms "
          f"{m['iter_wall_ms']:.3f}, compile_s {m['compile_s']:.2f}")


# ---------------------------------------------------------------------------
# router: the cluster router at full width
# ---------------------------------------------------------------------------
ROUTER_REQUESTS, ROUTER_SLOTS = 8, 2
ROUTER_TRACE_REQUESTS = 4   # (e)'s bursty trace
ROUTER_REPLICAS = (1, 2, 4)
ROUTER_BANK = ("ddim,steps=25", "ddim,steps=12")
ROUTER_DEADLINE = 37        # rounds: one ddim@25 wave, then a ddim@12 one
ROUTER_PREVIEW_EVERY = 5
# On the slice route a replica's two rows share DBSC's per-tensor INT12
# scale, so a request served beside another one (1 against 2 replicas)
# is rounded otherwise (ROADMAP Queue 3 item 13).  Each image is held to
# this share of its own DBSC-to-float distance, as DBSC_SLOT_SHARE holds
# slot rows: ten times the largest share the H100 read, 0.1716 % (1.8e-4
# to 2.1e-4 of 0.117 to 0.140; PERF.md §6).
ROUTER_DBSC_SHARE = 0.0172


def _route_run(torch, router, reqs, label, per_step, ledger=True):
    """``router.run(reqs)`` with the events it streamed; launches per
    replica step held to ``per_step``, no request dropped."""
    from repro_torch.kernels import runtime
    events, stream = [], router.stream

    def recording(r):
        for ev in stream(r):
            events.append(ev)
            yield ev
    router.stream = recording
    try:
        runtime.reset_launch_counts()
        m = router.run(reqs, ledger=ledger)
        counts = runtime.launch_counts()
    finally:
        del router.stream
    _hold_launches(counts, m["engine_steps"], per_step, label)
    require(m["dropped"] == 0, f"{label}: {m['dropped']} dropped")
    return m, events


def _router_batches(events):
    """The requests each replica admitted together (one admission round
    fills a replica at t = 0), in slot order."""
    groups = {}
    for ev in events:
        if ev["event"] == "admitted":
            groups.setdefault((ev["replica"], ev["round"]), {})[
                ev["slot"]] = ev["rid"]
    return [tuple(g[s] for s in sorted(g)) for _, g in sorted(groups.items())]


def _hold_batches(torch, eng, label, reqs, batches):
    """Each request's image bit-equal to ``generate`` at batch
    ROUTER_SLOTS on the batch it was served in; returns the witnesses
    and the calls' integer counters (``_calls_seen``)."""
    with _calls_seen(eng) as calls:
        wit = _batch_witnesses(torch, eng, [reqs[i] for b in batches
                                            for i in b], ROUTER_SLOTS)
    for out, batch in zip(wit, batches):
        host = out.images.cpu().numpy()
        for j, rid in enumerate(batch):
            require(reqs[rid].image.tobytes() == host[j].tobytes(),
                    f"{label} request {rid}: image differs from generate "
                    f"at batch {ROUTER_SLOTS} on its batch {batch}")
    print(f"  {label}: {len(reqs)} images bit-equal to generate at batch "
          f"{ROUTER_SLOTS} on the batches served {batches}")
    return wit, calls


def _router_line(label, m):
    print(f"  {label}: rounds {m['rounds']}, engine_steps "
          f"{m['engine_steps']}, step_wall_s {m['step_wall_s']:.4f} "
          f"({1e3 * m['step_wall_s'] / max(m['engine_steps'], 1):.3f} ms "
          f"a replica step), mean occupancy {m['mean_occupancy']:.4f}, "
          f"{m['goodput_imgs_per_s']:.4f} images/s, makespan "
          f"{m['makespan_s']:.3f} s")


def _hold_across(torch, label, runs):
    """Runs at several replica counts: images, merged int64 buckets (all
    six planes) and energy dicts equal to the first count's."""
    from repro_torch.diffusion.pipeline import merge_ledger_accums
    (n0, (m0, reqs0, _)), rest = runs[0], runs[1:]
    merged0 = merge_ledger_accums(st.accum for st in m0["states"])
    for n, (m, reqs, _) in rest:
        for a, b in zip(reqs0, reqs):
            require(a.image.tobytes() == b.image.tobytes(),
                    f"{label} request {a.rid}: {n} replicas against {n0}: "
                    f"max |diff| {abs(a.image - b.image).max():.3e}")
        merged = merge_ledger_accums(st.accum for st in m["states"])
        for f in dataclasses.fields(merged):
            require(torch.equal(getattr(merged, f.name),
                                getattr(merged0, f.name)),
                    f"{label}: {f.name} buckets differ at {n} replicas")
        require(m["energy"] == m0["energy"],
                f"{label}: energy at {n} replicas differs from {n0}")
    print(f"  {label}: images, the merged int64 buckets (6 planes) and the "
          f"energy dict equal at {[n for n, _ in runs]} replicas; "
          f"mj_per_iter_with_ema {m0['energy']['mj_per_iter_with_ema']!r}")
    return merged0


@phase("router")
def router_phase(torch, eng):
    """The cluster router (``launch.router``) at full width, on the
    slice's weights, replicas of ROUTER_SLOTS slots each.

    (a) ``--kernels auto`` (fused, float FFN: 9 / 9 / 0 a replica step):
        eight requests at t = 0 through 1, 2 and 4 replicas; images, the
        merged int64 buckets and the energy equal across the counts; the
        2-replica run's images bit-equal to ``generate`` at batch 2 on the
        batches it served (the other counts follow), its buckets equal to
        those calls' counters, its energy held by ``_hold_energy``.
    (b) The slice route (fused + DBSC: 9 / 9 / 18), four of (a)'s
        requests through 1 and 2 replicas: each bit-equal to ``generate``
        on its own batches; across the counts each image within
        ROUTER_DBSC_SHARE of its DBSC-to-float distance (from (a)).
    (c) SLO overload on the float FFN: bank ddim@25 / ddim@12, 1 replica,
        six requests at tier 0, a deadline of ROUTER_DEADLINE rounds;
        degrading finishes [25, 25, 37, 37, 49, 49] rounds after arrival
        (4 met), queueing [25, 25, 50, 50, 75, 75] (2 met); each image
        bit-equal to a banked ``generate`` at batch 2 of its batch at
        the tier it was served.
    (d) DiT-S/2 on the float FFN, 1 against 2 replicas: images, buckets
        and the energy key for key; 12 / 12 / 0 a replica step.
    (e) ROUTER_TRACE_REQUESTS requests on serving's bursty trace (2 at a
        time at SERVING_LOAD x (a)'s 2 x 2 t = 0 goodput) through
        ``ClusterRouter(eng, 2, 2)``: requests
        arrive while the router runs; 9 / 9 / 0 launches a replica step,
        none dropped; latency p50 / p95, queue wait p95, goodput, rounds,
        steps and step walls recorded.
    (f) Previews every ROUTER_PREVIEW_EVERY rounds on one run: the count,
        the time to the first, every step in (0, 25); the images equal
        (a)'s; a preview of the final latents equals the image.
    (g) ``router._main(["--check-identity"])`` in this process (smoke
        widths, on the card by default).
    (h) ``serve_diffusion.main --replicas 2`` in this process at full
        width (no ``--smoke``, the card by default, ``--kernels auto``):
        2 x 2 slots, four requests, 25 steps, guidance 7.5, the ledger,
        ROUTER_BANK as ``--tiers``, ROUTER_DEADLINE as ``--slo-steps``,
        previews every ROUTER_PREVIEW_EVERY rounds; its JSON names the
        ``cuda`` backend on the float FFN, every request finished, a
        finite ``mj_per_iter_with_ema`` for each tier, the SLO met by
        all four, and 9 / 9 / 0 launches per replica step (the warm-up's
        one included).
    """
    import io

    from repro_torch.configs import dit_s
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import energy_report_multi
    from repro_torch.diffusion.solvers import SamplerPolicy
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.launch import router as router_mod
    from repro_torch.launch import serve_diffusion
    from repro_torch.launch.router import ClusterRouter, RouterSLO
    from repro_torch.launch.scheduler import (apply_trace, bursty_trace,
                                              make_requests)

    dev, s = eng.device, ROUTER_SLOTS
    require(eng.cfg.unet.kernel_policy == KernelPolicy(
        self_attention="fused", cross_attention="fused", ffn="dbsc"),
        "the slice engine is not on the slice route")
    auto = KernelPolicy.parse("auto", device=dev)
    float_eng = DiffusionEngine(dataclasses.replace(
        eng.cfg, unet=dataclasses.replace(eng.cfg.unet, kernel_policy=auto)),
        device=dev, params={"text": eng.text_params,
                            "unet": eng.unet_params, "vae": eng.vae_params})
    steps = eng.cfg.ddim.num_inference_steps

    def requests(e, n=ROUTER_REQUESTS, **kw):
        return make_requests(e.cfg, n, seed=41, device=dev, **kw)

    # (a)
    runs = []
    for n in ROUTER_REPLICAS:
        router = ClusterRouter(float_eng, n, s)
        router.warmup()
        reqs = requests(float_eng)
        m, ev = _route_run(torch, router, reqs, f"(a) {n} x {s}",
                           FLOAT_ROUTE_PER_STEP)
        _router_line(f"(a) {n} x {s}", m)
        runs.append((n, (m, reqs, ev)))
    merged = _hold_across(torch, "(a)", runs)
    m2, reqs2, ev2 = dict(runs)[2]
    wit, calls = _hold_batches(torch, float_eng, "(a) 2 replicas", reqs2,
                               _router_batches(ev2))
    _hold_buckets(torch, "(a) merged", merged,
                  _calls_buckets(torch, float_eng.cfg, calls))
    rep = energy_report_multi(float_eng.cfg, [w.stats for w in wit])
    _hold_energy("(a)", m2["energy"],
                 {k: float(v) for k, v in rep.summary().items()},
                 exact=False)
    float_images = {r.rid: r.image for r in reqs2}

    # (b)
    served = {}
    for n in (1, 2):
        router = ClusterRouter(eng, n, s)
        router.warmup()
        reqs = requests(eng, 4)
        require(all(torch.equal(a.latents, b.latents)
                    for a, b in zip(reqs, reqs2)), "(b) requests differ")
        m, ev = _route_run(torch, router, reqs, f"(b) {n} x {s}",
                           SLICE_ROUTE_PER_STEP)
        m.pop("states")
        _router_line(f"(b) {n} x {s}", m)
        _hold_batches(torch, eng, f"(b) {n} replica(s)", reqs,
                      _router_batches(ev))
        served[n] = reqs
    shares = []
    for a, b in zip(served[1], served[2]):
        dist = float(abs(a.image - float_images[a.rid]).max())
        diff = float(abs(a.image - b.image).max())
        require(dist > 0, f"(b) request {a.rid}: DBSC equals the float FFN")
        shares.append(diff / dist)
        print(f"  (b) request {a.rid}: 1 against 2 replicas max|diff| "
              f"{diff:.3e}, DBSC-to-float {dist:.3e}, share "
              f"{diff / dist:.4%}")
    require(max(shares) <= ROUTER_DBSC_SHARE,
            f"(b) share {max(shares):.4%} > {ROUTER_DBSC_SHARE:.2%}")

    # (c)
    bank = tuple(SamplerPolicy.parse(b) for b in ROUTER_BANK)
    want = {True: ([25, 25, 37, 37, 49, 49], 4),
            False: ([25, 25, 50, 50, 75, 75], 2)}
    cache = {}
    for degrade in (True, False):
        label = f"(c) {'degrade' if degrade else 'queue'}"
        router = ClusterRouter(float_eng, 1, s, bank=bank, slo=RouterSLO(
            ROUTER_DEADLINE, degrade))
        router.warmup()
        reqs = requests(float_eng, 6, bank=bank)
        for r in reqs:
            r.policy_index, r.tier = 0, bank[0].label()
        m, ev = _route_run(torch, router, reqs, label, FLOAT_ROUTE_PER_STEP)
        m.pop("states")
        waits = [r.finish_round - r.arrival_round for r in reqs]
        print(f"  {label}: rounds after arrival {waits}, met "
              f"{m['slo']['met']}, degraded {m.get('degraded_per_tier')}, "
              f"images per policy "
              f"{[e['images'] for e in m['energy']['per_policy']]}")
        require(waits == want[degrade][0] and
                m["slo"]["met"] == want[degrade][1],
                f"{label}: {waits}, met {m['slo']['met']}")
        if degrade:
            require(m["degraded_per_tier"] == {bank[0].label(): 4}
                    and [e["images"] for e in m["energy"]["per_policy"]]
                    == [2, 4], f"{label}: {m.get('degraded_per_tier')}")
        _router_line(label, m)
        for batch in _router_batches(ev):
            pol = reqs[batch[0]].policy_index
            if (batch, pol) not in cache:
                cache[batch, pol] = _policy_witnesses(
                    torch, float_eng, [(reqs[i].tokens, reqs[i].uncond_tokens,
                                        reqs[i].latents) for i in batch],
                    [pol] * len(batch), bank, rows=s)[0]
            for j, i in enumerate(batch):
                require(reqs[i].policy_index == pol and reqs[i].image
                        .tobytes() == cache[batch, pol][j].images[0].cpu()
                        .numpy().tobytes(), f"{label} request {i}: image "
                        f"differs from its batch's witness at policy {pol}")
    print(f"  (c): every image bit-equal to a banked generate at batch {s} "
          f"of its batch at the tier served ({len(cache)} witnesses)")

    # (d)
    dcfg = dit_s.with_kernel_policy(dit_s.CONFIG, auto)
    deng = DiffusionEngine(dcfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(20))
    druns = []
    for n in (1, 2):
        router = ClusterRouter(deng, n, s)
        router.warmup()
        reqs = make_requests(dcfg, 4, seed=42, device=dev)
        m, ev = _route_run(torch, router, reqs, f"(d) DiT {n} x {s}",
                           DIT_FLOAT_PER_STEP)
        _router_line(f"(d) DiT {n} x {s}", m)
        druns.append((n, (m, reqs, ev)))
    _hold_across(torch, "(d) DiT", druns)

    # (e)
    rate = SERVING_LOAD * m2["goodput_imgs_per_s"]
    gap = SERVING_BURST / rate
    trace = bursty_trace(ROUTER_TRACE_REQUESTS, SERVING_BURST, gap)
    print(f"  (e): {ROUTER_TRACE_REQUESTS} requests, {SERVING_BURST} every "
          f"{gap:.4f} s ({rate:.4f} images/s, {SERVING_LOAD} x (a)'s 2 x 2 "
          f"t = 0 goodput)")
    router = ClusterRouter(float_eng, 2, s)
    mr, _ = _route_run(torch, router, apply_trace(
        requests(float_eng, ROUTER_TRACE_REQUESTS), trace),
        "(e) router 2 x 2", FLOAT_ROUTE_PER_STEP)
    mr.pop("states")
    _latency_line("(e) router 2 x 2", mr, mr["mean_occupancy"])
    _router_line("(e) router 2 x 2", mr)

    # (f)
    router = ClusterRouter(float_eng, 1, s, preview_every=ROUTER_PREVIEW_EVERY)
    reqs = requests(float_eng, 2)
    m, ev = _route_run(torch, router, reqs, "(f) previews",
                       FLOAT_ROUTE_PER_STEP)
    previews = [e for e in ev if e["event"] == "preview"]
    n_pv = 2 * ((steps - 1) // ROUTER_PREVIEW_EVERY)
    require(len(previews) == n_pv == m["preview"]["decodes"],
            f"(f) {len(previews)} previews, expected {n_pv}")
    require(all(0 < e["step"] < steps and e["image"].shape == (512, 512, 3)
                for e in previews), "(f) a preview's step or shape")
    for r in reqs:
        require(r.image.tobytes() == float_images[r.rid].tobytes(),
                f"(f) request {r.rid}: image differs from (a)'s")
        require(r.first_preview_s <= r.finished_s,
                f"(f) request {r.rid}: first preview after the image")
    final = float_eng.decode_preview(m["states"][0], [0, 1]).cpu().numpy()
    for j, r in enumerate(reqs):
        require(final[j].tobytes() == r.image.tobytes(),
                f"(f) request {r.rid}: a preview of the final latents "
                f"differs from the image")
    fp = m["preview"]["first_preview_s"]
    print(f"  (f): {len(previews)} previews at steps "
          f"{sorted({e['step'] for e in previews})}; time to first preview "
          f"s mean {fp['mean']:.4f} max {fp['max']:.4f}; images "
          f"{[round(r.finished_s, 4) for r in reqs]} s; a preview of the "
          f"final latents bit-equal to the image")

    # (g)
    buf = io.StringIO()
    runtime.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = router_mod._main(["--check-identity"])
    out = json.loads(buf.getvalue())
    counts = runtime.launch_counts()
    require(rc == 0 and out["ledger_bit_identical_across_replicas"]
            and out["images_bit_identical_across_replicas"]
            and out["policies"]["kernels"]["backend"] == "cuda"
            and counts.get("pssa_attention", 0) > 0
            and counts.get("bitslice_matmul", 0) == 0,
            f"(g) {out.get('policies')} {counts}")
    print(f"  (g) router._main(['--check-identity']): identical across 1 "
          f"and {out['replicas']} replicas; launches {json.dumps(counts)}")

    # (h)
    argv = ["--replicas", "2", "--slots", str(s), "--requests", "4",
            "--steps", "25", "--guidance", "7.5", "--ledger", "--tiers",
            *ROUTER_BANK, "--slo-steps", str(ROUTER_DEADLINE),
            "--preview-every", str(ROUTER_PREVIEW_EVERY)]
    runtime.reset_launch_counts()
    buf = io.StringIO()
    t_cli = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve_diffusion.main(argv)
    t_cli = time.perf_counter() - t_cli
    head, _, body = buf.getvalue().partition("\n")
    print(f"  (h) {head}")
    m = json.loads(body)
    require(m["mode"] == "cluster_router" and m["replicas"] == 2
            and m["requests"] == 4 and m["dropped"] == 0
            and m["events"]["finished"] == 4,
            f"(h) {m['mode']}, {m['requests']} requests, events "
            f"{m['events']}")
    require(m["kernel_policy"]["backend"] == "cuda"
            and m["kernel_policy"]["self_attention"] == "fused"
            and m["kernel_policy"]["ffn"] == "reference",
            f"(h) kernel policy {m['kernel_policy']}")
    per = m["energy"]["per_policy"]
    require(len(per) == len(ROUTER_BANK) and all(
        e["images"] > 0 and math.isfinite(e["mj_per_iter_with_ema"])
        for e in per), f"(h) per-policy energy {per}")
    require(m["slo"]["met"] == 4 and m["preview"]["decodes"] > 0,
            f"(h) slo {m['slo']}, preview {m['preview']}")
    _hold_launches(runtime.launch_counts(), m["engine_steps"] + 1,
                   FLOAT_ROUTE_PER_STEP, "(h) CLI (warm-up step included)")
    _latency_line("(h) CLI", m, m["mean_occupancy"])
    _router_line("(h) CLI", m)
    print(f"  (h) CLI: mj_per_iter_with_ema per tier "
          f"{[e['mj_per_iter_with_ema'] for e in per]!r}, images per tier "
          f"{[e['images'] for e in per]}, {m['preview']['decodes']} "
          f"previews, compile_s {m['compile_s']:.2f}, the call {t_cli:.2f} s")


# ---------------------------------------------------------------------------
AUTOTUNE_SLOTS = 4          # (c): the slot_step whose geometries the table
#                             covers


@contextlib.contextmanager
def _recorded_lookups():
    """Every (op, geometry, hit) ``dispatch._blocks`` asks the autotune
    table for inside the block, in order of first use."""
    from repro_torch.kernels import autotune
    seen = {}
    real = autotune.lookup

    def spy(op, geom, **kw):
        won = real(op, geom, **kw)
        seen.setdefault((op, tuple(geom)), won is not None)
        return won
    autotune.lookup = spy
    try:
        yield seen
    finally:
        autotune.lookup = real


@phase("autotune")
def autotune_phase(torch, eng):
    """The compiled-path kernel policy (``kernels.autotune``, the launch
    knobs, ``ffn_quant=int8``) at full width.

    (a) The committed table validates (every knob one its kernel takes),
        names a card and covers ``DEFAULT_GEOMS``.
    (b) At each table geometry, every candidate of its knob bit-equal to
        the launch rule on the probe's inputs (outputs and counters); the
        table's winner and the rule timed (``runtime.min_ms``: the best of
        three rounds, the stream held, inputs rotated past the L2).
    (c) ``autotuned`` with DBSC against ``fused()`` with DBSC: a BK-SDM
        generate (the slice's weights) and a DiT-S/2 generate bit-equal,
        225 / 225 / 450 and 300 / 300 / 600 launches on both, the ledger
        headline key for key; then a BK-SDM generate under temporal reuse
        and a 4-slot ``slot_step``: every geometry these four runs look up
        is in the table.
    (d) ``ffn=dbsc,ffn_quant=int8`` against ``ffn=dbsc`` on the BK-SDM
        generate: images bit-equal, the headline key for key, no
        ``bitslice_matmul`` launch (its products go to ``torch._int_mm``).
    (e) ``serve_diffusion.main`` in this process at full width, 4 requests
        on 4 slots over 25 steps, on ``--kernels autotuned`` and on
        ``--kernels ffn=dbsc,ffn_quant=int8``: the cuda backend with the
        spec's ``tuned`` / ``ffn_quant``, every request served, a finite
        ``mj_per_iter_with_ema``, the launches a step (9 / 9 / 0 and
        0 / 0 / 0, the warm-up's step included), every table lookup of
        the autotuned run a hit, and two ``torch._int_mm`` products on the
        card for each of the 18 DBSC matmuls a step of the int8 run.
    """
    import io

    from repro_torch.configs import bk_sdm, dit_s
    from repro_torch.core.reuse import ReusePolicy
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import energy_report
    from repro_torch.kernels import autotune, runtime
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.launch import serve_diffusion

    # (a)
    autotune.clear_cache()
    table = autotune.load_table()
    entries = table["entries"]
    print(f"(a) table: {len(entries)} entries, generated on "
          f"{json.dumps(table.get('generated_on'))}")
    require(all(k.startswith("cuda/") for k in entries),
            "(a) the table holds a key off the cuda backend")
    missing = [autotune.make_key("cuda", op, g)
               for op, gs in autotune.DEFAULT_GEOMS.items() for g in gs
               if autotune.make_key("cuda", op, g) not in entries]
    require(not missing, f"(a) DEFAULT_GEOMS not in the table: {missing}")
    require(bool((table.get("generated_on") or {}).get("device")),
            "(a) the table names no card")

    # (b)
    def outputs(mod, geom, blocks):
        fn, sets = mod.autotune_probe(geom, blocks, device="cuda")
        return fn(*sets[0])

    print("(b) op geometry: candidates bit-equal to the rule; winner ms "
          "against the rule's ms")
    for key, won in entries.items():
        _, op, geom = autotune.parse_key(key)
        mod = autotune._op_module(op)
        rule = {name: None for name in autotune.OP_KNOBS[op]}
        want = outputs(mod, geom, rule)
        cands = mod.autotune_candidates(geom)
        for blocks in cands:
            got = outputs(mod, geom, blocks)
            require(all(same_bits(torch, a, b) if a.dtype == torch.float32
                        else torch.equal(a, b) for a, b in zip(got, want)),
                    f"(b) {key} {blocks} differs from the launch rule")
        del want
        t = {}
        for name, blocks in (("winner", won), ("rule", rule)):
            fn, sets = mod.autotune_probe(geom, blocks, device="cuda")
            t[name] = runtime.min_ms(fn, sets)
            del fn, sets
        print(f"  {key}: {len(cands)} bit-equal; winner {json.dumps(won)} "
              f"{t['winner']:.4f} ms, rule {t['rule']:.4f} ms "
              f"({t['winner'] / t['rule']:.3f}x)")

    # (c), (d)
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}
    slice_pol = dataclasses.replace(KernelPolicy.fused(), ffn="dbsc")
    tuned_pol = dataclasses.replace(slice_pol, tuned=True)
    int8_pol = dataclasses.replace(slice_pol, ffn_quant="int8")

    def run(e, toks, un, lat):
        runtime.reset_launch_counts()
        out = e.generate(toks, uncond_tokens=un, latents=lat.clone())
        counts = runtime.launch_counts()
        return (out.images, counts,
                energy_report(e.cfg, out.stats).summary(), e.last_wall_s)

    def hold_pair(label, base, other, per_step, steps, bitslice):
        img, counts, summary, wall = base
        img_o, counts_o, summary_o, wall_o = other
        want = {k: v * steps for k, v in per_step.items()}
        want["bitslice_matmul"] = bitslice
        got = {k: counts_o.get(k, 0) for k in want}
        print(f"  {label}: launches {json.dumps(got)}; bit-equal "
              f"{torch.equal(img_o, img)}; s/image {wall_o:.4f} against "
              f"{wall:.4f}")
        require(got == want, f"{label}: launches {got} != {want}")
        require(torch.equal(img_o, img), f"{label}: images differ")
        require(summary_o == summary, f"{label}: ledger headline "
                f"{summary_o} != {summary}")

    bcfg = bk_sdm.CONFIG
    toks, un = _tokens(torch, bcfg, 7)
    lat = eng.init_latents(1, torch.Generator(device="cuda").manual_seed(8))
    e_base = DiffusionEngine(bk_sdm.with_kernel_policy(bcfg, slice_pol),
                             params=params)
    e_tuned = DiffusionEngine(bk_sdm.with_kernel_policy(bcfg, tuned_pol),
                              params=params)
    per_step = {"pssa_attention": 9, "cross_attention_tips": 9}
    base = run(e_base, toks, un, lat)
    with _recorded_lookups() as seen:
        tuned = run(e_tuned, toks, un, lat)
    print("(c) autotuned + DBSC against fused + DBSC")
    hold_pair("BK-SDM", base, tuned, per_step, 25, 450)

    dcfg = dit_s.CONFIG
    d_base = DiffusionEngine(dit_s.with_kernel_policy(dcfg, slice_pol),
                             generator=torch.Generator(
                                 device="cuda").manual_seed(20))
    dparams = {"text": d_base.text_params, "unet": d_base.unet_params,
               "vae": d_base.vae_params}
    d_tuned = DiffusionEngine(dit_s.with_kernel_policy(dcfg, tuned_pol),
                              params=dparams)
    dtoks, dun = _tokens(torch, dcfg, 27)
    dlat = d_base.init_latents(1, torch.Generator(device="cuda")
                               .manual_seed(28))
    d_base.generate(dtoks, uncond_tokens=dun, latents=dlat.clone())  # warm
    dbase = run(d_base, dtoks, dun, dlat)
    with _recorded_lookups() as dseen:
        dtuned = run(d_tuned, dtoks, dun, dlat)
    hold_pair("DiT-S/2", dbase, dtuned, {k: 12 for k in per_step}, 25, 600)
    del d_base, d_tuned

    e_reuse = DiffusionEngine(bk_sdm.with_kernel_policy(
        _with_reuse(bcfg, ReusePolicy.temporal(REUSE_THRESHOLD)), tuned_pol),
        params=params)
    with _recorded_lookups() as rseen:
        e_reuse.generate(toks, uncond_tokens=un, latents=lat.clone())
        state = e_tuned.init_slots(AUTOTUNE_SLOTS)
        for s in range(AUTOTUNE_SLOTS):
            t_s, u_s, l_s = _slot_request(torch, e_tuned, 60 + 2 * s)
            state = e_tuned.admit(state, s, t_s, uncond_tokens=u_s,
                                  latents=l_s)
        e_tuned.slot_step(state)
    torch.cuda.synchronize()
    looked = {**seen, **dseen, **rseen}
    for (op, geom), hit in sorted(looked.items()):
        print(f"  looked up {autotune.make_key('cuda', op, geom)}: "
              f"{'hit' if hit else 'MISS'}")
    misses = [k for k, hit in looked.items() if not hit]
    require(not misses, f"(c) geometries not in the table: {misses}")
    del e_reuse, state

    print("(d) ffn_quant=int8 against ffn=dbsc")
    e_int8 = DiffusionEngine(bk_sdm.with_kernel_policy(bcfg, int8_pol),
                             params=params)
    hold_pair("BK-SDM int8", base, run(e_int8, toks, un, lat), per_step, 25,
              0)
    del e_base, e_tuned, e_int8

    print("(e) serve_diffusion.main on the compiled specs")
    no_kernel = {k: 0 for k in FLOAT_ROUTE_PER_STEP}
    int8_per_step = 2 * SLICE_ROUTE_PER_STEP["bitslice_matmul"]
    for spec, launches, products in (
            ("autotuned", FLOAT_ROUTE_PER_STEP, 0),
            ("ffn=dbsc,ffn_quant=int8", no_kernel, int8_per_step)):
        argv = ["--continuous", "--slots", str(AUTOTUNE_SLOTS), "--requests",
                str(AUTOTUNE_SLOTS), "--steps", str(CLI_STEPS),
                "--guidance", "7.5",
                "--ledger", "--kernels", spec]
        devices = []
        real = torch._int_mm

        def spy(a, b):
            devices.append(a.device.type)
            return real(a, b)
        torch._int_mm = spy
        runtime.reset_launch_counts()
        buf = io.StringIO()
        t_cli = time.perf_counter()
        try:
            with _recorded_lookups() as eseen, \
                    contextlib.redirect_stdout(buf):
                serve_diffusion.main(argv)
        finally:
            torch._int_mm = real
        t_cli = time.perf_counter() - t_cli
        counts = runtime.launch_counts()
        head, _, body = buf.getvalue().partition("\n")
        print(f"  (e) {head}")
        m = json.loads(body)
        pol = m["kernel_policy"]
        require(pol["backend"] == "cuda"
                and pol["tuned"] == (spec == "autotuned")
                and pol["ffn_quant"] == ("int8" if products else "model")
                and pol["ffn"] == ("dbsc" if products else "reference"),
                f"(e) {spec}: kernel policy {pol}")
        require(m["requests"] == AUTOTUNE_SLOTS
                and math.isfinite(m["latency_s"]["max"]),
                f"(e) {spec}: {m['requests']} requests, latency "
                f"{m['latency_s']}")
        require(math.isfinite(m["energy"]["mj_per_iter_with_ema"]),
                f"(e) {spec}: non-finite mj_per_iter_with_ema")
        steps = m["engine_steps"] + 1
        _hold_launches(counts, steps, launches,
                       f"(e) {spec} (warm-up step included)")
        require(len(devices) == products * steps
                and set(devices) <= {"cuda"},
                f"(e) {spec}: {len(devices)} torch._int_mm products on "
                f"{set(devices)}, expected {products * steps} on cuda")
        misses = [k for k, hit in eseen.items() if not hit]
        require(not misses and (bool(eseen) == (spec == "autotuned")),
                f"(e) {spec}: {len(eseen)} geometries looked up, misses "
                f"{misses}")
        _latency_line(f"(e) {spec}", m, m["mean_occupancy"])
        print(f"  (e) {spec}: {len(devices)} torch._int_mm products, "
              f"{len(eseen)} table geometries (all hits); "
              f"mj_per_iter_with_ema {m['energy']['mj_per_iter_with_ema']!r}, "
              f"iter_wall_ms {m['iter_wall_ms']:.3f}, the call {t_cli:.2f} s")


def profile_breakdown(torch, run, tag: str, top: int = 15):
    """Device time by kernel over one more ``run()`` (which returns its
    wall seconds), under torch.profiler; this run's counts and wall time
    are not the ones reported elsewhere.  "busy" is the union of the
    device intervals on the timeline, so nested or overlapping events
    count once; "summed" adds self device time over ``key_averages()``.
    Only device activity is recorded: the host's op events are not read,
    and parsing them took most of a minute per decode profile of the lm
    phase."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = run() * 1e3
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    total = sum(r[0] for r in rows)
    if total == 0:
        print(f"profile {tag}: the profiler recorded no device time (not "
              f"measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and e.time_range.end > e.time_range.start)
    busy_us, reach = 0.0, -math.inf
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    rows.sort(reverse=True)
    print(f"profile {tag}: device busy {busy_us / 1e3:.2f} ms (union of "
          f"intervals; summed {total:.2f} ms) in a {wall_ms:.2f} ms run "
          f"with the profiler on ({busy_us / 1e3 / wall_ms:.1%} busy)")
    for name in REPLACES:
        ms = sum(r[0] for r in rows if name + "_kernel" in r[2])
        print(f"profile {tag}: {name} {ms:.2f} ms ({ms / total:.1%} of "
              f"device time)")
    for ms, n, key in rows[:top]:
        print(f"profile {tag}:   {ms:9.2f} ms {n:6d}x {key[:100]}")


def _context(torch, eng, toks, un):
    """[cond | uncond] text context of the fused-CFG UNet call."""
    from repro_torch.diffusion.text_encoder import encode_text
    return (encode_text(eng.text_params, toks, eng.cfg.text),
            encode_text(eng.text_params, un, eng.cfg.text))


@phase("bitmap")
def bitmap_phase(torch, eng):
    """The PSXU entry point on real SAS slabs.

    One full-width UNet call (step 0, the slice's weights) gives the
    self-attention q/k/v of the first block at res 64, 32 and 16; the
    cond row's pruned SAS, (8 heads x T queries, T keys), is computed by
    the plain PSSA version's own operations.  The kernel must equal the
    plain version bit for bit, and each row's counts must sum to the plain
    PSSA popcount ``xor_ones`` of that row.  Then, counts at 0,
    ``dispatch.patch_bitmap`` runs once per slab: 3 launches.
    """
    from repro_torch.core import pssa
    from repro_torch.diffusion.unet import unet_forward
    from repro_torch.kernels import dispatch, runtime
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.patch_bitmap.kernel import patch_bitmap_kernel
    from repro_torch.kernels.patch_bitmap.ref import patch_bitmap_ref
    from repro_torch.kernels.pssa_attention.ref import (
        pssa_attention_stats_ref)

    toks, un = _tokens(torch, eng.cfg, 7)
    ctx, unc = _context(torch, eng, toks, un)
    lat = eng.init_latents(1, torch.Generator(device="cuda").manual_seed(8))
    captured = {}
    orig = dispatch.self_attention

    def capture(policy, q, k, v, **kw):
        res = math.isqrt(k.shape[2])
        captured.setdefault(res, (q[0].contiguous(), k[0].contiguous(),
                                  v[0].contiguous(), kw["patch"]))
        return orig(policy, q, k, v, **kw)

    dispatch.self_attention = capture
    try:
        unet_forward(eng.unet_params, lat,
                     torch.tensor([960], device="cuda"),
                     torch.cat([ctx, unc]), eng.cfg.unet,
                     tips_active=torch.tensor([True], device="cuda"),
                     stats_rows=1, cfg_dup=True)
    finally:
        dispatch.self_attention = orig
    rows, slabs = {}, []
    for res in (64, 32, 16):
        q, k, v, patch = captured[res]
        h, t, d = q.shape
        _, nnz, xor_ones = pssa_attention_stats_ref(q, k, v, THRESHOLD,
                                                    patch)
        probs = torch.softmax(torch.einsum("btd,bsd->bts", q, k)
                              / math.sqrt(float(d)), dim=-1)
        sas = pssa.prune(probs, THRESHOLD).reshape(h * t, t)
        del probs
        packed, counts = patch_bitmap_kernel(sas, patch, THRESHOLD)
        torch.cuda.synchronize()
        packed_p, counts_p = patch_bitmap_ref(sas, patch, THRESHOLD)
        require(torch.equal(packed.view(torch.int32),
                            packed_p.view(torch.int32))
                and torch.equal(counts, counts_p),
                f"patch_bitmap res{res}: not bit-exact against plain")
        row_sums = counts.sum(dim=-1, dtype=torch.int32)
        require(torch.equal(row_sums, xor_ones.reshape(-1)),
                f"patch_bitmap res{res}: row sums of the counts differ "
                f"from the PSSA xor_ones")
        print(f"  patch_bitmap res{res} ({h * t}, {t}) patch {patch}: "
              f"bit-exact; keep density "
              f"{nnz.sum().item() / (h * t * t):.4f}; row sums equal "
              f"xor_ones ({int(row_sums.sum())} ones)")
        args = [(sas, patch, THRESHOLD)]
        ms = rotating_ms(torch, patch_bitmap_kernel, args, reps=20)
        plain_ms = rotating_ms(torch, patch_bitmap_ref, args, reps=3)
        n = h * t * t
        nbytes = 4.0 * (n + n / 32 + n / patch)
        kernel_row(rows, "patch_bitmap", f"res{res}", [h * t, t, patch], ms,
                   plain_ms, bound(nbytes, float(n), FP32_FLOPS), 0.0,
                   res == 64)
        slabs.append((sas.reshape(h, t, t), patch, packed, counts))
        del packed_p, counts_p
    policy = KernelPolicy.fused()
    runtime.reset_launch_counts()
    outs = [dispatch.patch_bitmap(policy, sas, patch, THRESHOLD)
            for sas, patch, _, _ in slabs]
    torch.cuda.synchronize()
    counts = runtime.launch_counts()
    print(f"launches {json.dumps(counts)}")
    require(counts.get("patch_bitmap") == 3,
            f"dispatch.patch_bitmap launches {counts.get('patch_bitmap')}"
            f" != 3")
    for (sas, _, packed, cnt), (pk, ct) in zip(slabs, outs):
        require(torch.equal(pk.reshape(packed.shape).view(torch.int32),
                            packed.view(torch.int32))
                and torch.equal(ct.reshape(cnt.shape), cnt),
                "dispatch.patch_bitmap differs from the kernel's bits")
    return rows, counts


def _with_reuse(cfg, reuse):
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, reuse_policy=reuse))


def _reuse_counters(torch, stats):
    """(steps, layers) computed and total of the cond row, on the host."""
    comp = torch.stack([c.computed[:, 0] for c in stats.reuse], 1).cpu()
    tot = torch.stack([c.total[:, 0] for c in stats.reuse], 1).cpu()
    return comp, tot


SLICE_ROUTE = dict(self_attention="fused", cross_attention="fused",
                   ffn="dbsc", reuse="kernel")


@phase("temporal")
def temporal_phase(torch, eng):
    """The slice with temporal patch reuse, fused + DBSC + reuse kernel.

    Threshold 0: every patch is active and the result must equal the dense
    latents bit for bit (DESIGN.md §9), as far as a dense witness from the
    same latents equals the dense run.  Threshold 0.05: 225 launches of
    the patch delta beside 225/225/450; step 0 computes every patch (the
    cache is invalid); no step computes more than the grid.
    """
    from repro_torch.configs import bk_sdm
    from repro_torch.core.reuse import ReusePolicy
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import (
        aggregated_reuse_ratios_per_iter)
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy

    base = bk_sdm.with_kernel_policy(bk_sdm.CONFIG,
                                     KernelPolicy(**SLICE_ROUTE))
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}
    toks, un = _tokens(torch, base, 7)
    latents = eng.init_latents(1, torch.Generator(device="cuda")
                               .manual_seed(8))

    def run(name, reuse):
        cfg = _with_reuse(base, reuse)
        e = DiffusionEngine(cfg, params=params)
        runtime.reset_launch_counts()
        out = e.generate(toks, uncond_tokens=un, latents=latents.clone())
        counts = runtime.launch_counts()
        require(bool(torch.isfinite(out.latents).all()),
                f"{name}: non-finite latents")
        print(f"{name}: s/image {e.last_wall_s:.4f}, launches "
              f"{json.dumps(counts)}")
        return out, counts, e.last_wall_s, cfg

    dense, dense_counts, dense_s, _ = run("dense", ReusePolicy.off())
    witness, _, _, _ = run("dense witness", ReusePolicy.off())
    thr0, thr0_counts, _, _ = run("temporal threshold 0",
                                  ReusePolicy.temporal(0.0))
    require(dense_counts.get("patch_delta", 0) == 0,
            f"the dense run launched patch_delta "
            f"{dense_counts.get('patch_delta')} times")
    w_eq = torch.equal(dense.latents, witness.latents)
    t_eq = torch.equal(dense.latents, thr0.latents)
    w_d = (dense.latents - witness.latents).abs().max().item()
    t_d = (dense.latents - thr0.latents).abs().max().item()
    print(f"witness: dense against dense bit-equal {w_eq} (max|diff| "
          f"{w_d:.3e}); threshold 0 against dense bit-equal {t_eq} "
          f"(max|diff| {t_d:.3e})")
    if w_eq:
        require(t_eq, "threshold-0 reuse differs from the dense latents "
                      "though the dense path repeats bit for bit")
    else:
        require(t_d <= w_d, f"threshold-0 reuse differs from dense by "
                            f"{t_d}, more than the dense witness {w_d}")
    comp0, tot0 = _reuse_counters(torch, thr0.stats)
    require(torch.equal(comp0, tot0), "threshold 0 skipped a patch")

    temporal, counts, temporal_s, cfg = run(
        "temporal threshold 0.05", ReusePolicy.temporal(REUSE_THRESHOLD))
    want = {"pssa_attention": 225, "cross_attention_tips": 225,
            "bitslice_matmul": 450, "patch_delta": 225}
    require(all(counts.get(k) == v for k, v in want.items()),
            f"launch counts {counts} != {want}")
    comp, tot = _reuse_counters(torch, temporal.stats)
    require(torch.equal(comp[0], tot[0]),
            "step 0 reused a patch from an invalid cache")
    require(bool((comp <= tot).all()), "computed > total")
    ratios = aggregated_reuse_ratios_per_iter(cfg, [temporal.stats])
    print("reuse ratio per iteration " + json.dumps(ratios))
    print(f"computed patches per layer, summed over steps: "
          f"{comp.sum(0).tolist()} of {tot.sum(0).tolist()}")
    print(f"s/image dense {dense_s:.4f}, temporal {temporal_s:.4f} "
          f"(threshold {REUSE_THRESHOLD})")
    return counts, dense_s


@phase("edit")
def edit_phase(torch, eng, dense_s):
    """img2img replay against a recorded base, capacity 1/8.

    The base caches come from a threshold-0 temporal run with
    ``record_caches=True``.  The same latents replayed under
    ``ReusePolicy.edit(0.05, 0.125)`` compute nothing and return the base
    latents bit for bit.  Latents with the window EDIT_WINDOW re-noised
    keep every layer within the cap and run PSSA on T/8 gathered queries.
    An ``apriori_window`` replay launches no patch delta.
    """
    from repro_torch.configs import bk_sdm
    from repro_torch.core.reuse import ReusePolicy, reuse_cache_zeros
    from repro_torch.diffusion.sampler import sample_scan, sample_scan_reuse
    from repro_torch.diffusion.unet import unet_forward
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy

    base = bk_sdm.with_kernel_policy(bk_sdm.CONFIG,
                                     KernelPolicy(**SLICE_ROUTE))
    toks, un = _tokens(torch, base, 7)
    ctx, unc = _context(torch, eng, toks, un)
    latents = eng.init_latents(1, torch.Generator(device="cuda")
                               .manual_seed(8))
    y0, x0, h, w = EDIT_WINDOW
    renoised = latents.clone()
    renoised[:, y0:y0 + h, x0:x0 + w, :] = torch.randn(
        (1, h, w, latents.shape[-1]), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(9))

    def sampler(reuse, lat, **kw):
        ucfg = _with_reuse(base, reuse).unet

        def apply(l, t, c, a, **akw):
            return unet_forward(eng.unet_params, l, t, c, ucfg,
                                tips_active=a, **akw)
        runtime.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn = sample_scan if not reuse.enabled else sample_scan_reuse
        out = fn(apply, lat.clone(), ctx, unc, base.ddim, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, runtime.launch_counts()

    (lat_d, _), dense_loop_s, _ = sampler(ReusePolicy.off(), latents)
    rec = ReusePolicy.temporal(0.0)
    (lat_b, _, caches), rec_s, _ = sampler(
        rec, latents, record_caches=True,
        reuse_cache=reuse_cache_zeros(base.unet, 1, True, device="cuda"))
    nbytes = sum(x.numel() * x.element_size() for c in caches
                 for lc in c.layers for x in lc)
    print(f"base record: {len(caches)} steps, {nbytes / 1e9:.3f} GB of "
          f"caches ({nbytes / len(caches) / 1e6:.1f} MB a step); latents "
          f"equal the dense loop's {torch.equal(lat_b, lat_d)}")
    edit = ReusePolicy.edit(REUSE_THRESHOLD, EDIT_CAPACITY)
    (lat_e, st_e), same_s, same_counts = sampler(edit, latents,
                                                 base_caches=caches)
    comp, _ = _reuse_counters(torch, st_e)
    print(f"replay of the same latents: computed {int(comp.sum())}, "
          f"latents equal the base {torch.equal(lat_e, lat_b)}, launches "
          f"{json.dumps(same_counts)}")
    require(int(comp.sum()) == 0, "the same input recomputed patches")
    require(torch.equal(lat_e, lat_b), "the replay left the base latents")

    (lat_p, st_p), edit_s, counts = sampler(edit, renoised,
                                            base_caches=caches)
    comp, tot = _reuse_counters(torch, st_p)
    print(f"re-noised window {EDIT_WINDOW}: launches {json.dumps(counts)}; "
          f"computed per layer at step 0 {comp[0].tolist()}, max over "
          f"steps {comp.max(0).values.tolist()} of {tot[0].tolist()}")
    require(counts.get("pssa_attention") == 225
            and counts.get("patch_delta") == 225,
            f"edit launches {counts}")
    ucfg = base.unet
    for li, lk in enumerate(st_p.layers):
        t = lk.resolution ** 2
        patch = ucfg.patch_size(lk.resolution)
        cap = edit.cap_patches(t // patch)
        require(int(comp[:, li].max()) <= cap,
                f"{lk.name}: computed {comp[:, li].max()} > cap {cap}")
        tq = st_p.pssa[li].total / (ucfg.num_heads * t)
        require(bool((tq == t // 8).all()) and cap * patch == t // 8,
                f"{lk.name}: PSSA ran on {tq.unique().tolist()} queries, "
                f"not T/8 = {t // 8}")
    require(not torch.equal(lat_p, lat_b), "the re-noised edit left the "
                                           "base latents")
    profile_breakdown(torch, lambda: sampler(edit, renoised,
                                             base_caches=caches)[1],
                      "edit", top=10)
    win = ReusePolicy(enabled=True, threshold=REUSE_THRESHOLD,
                      capacity=EDIT_CAPACITY, apriori_window=EDIT_WINDOW)
    (_, st_w), win_s, win_counts = sampler(win, renoised,
                                           base_caches=caches)
    comp_w, _ = _reuse_counters(torch, st_w)
    print(f"a-priori window: launches {json.dumps(win_counts)}, computed "
          f"per layer {comp_w[0].tolist()}")
    require(win_counts.get("patch_delta", 0) == 0,
            f"the a-priori window launched patch_delta "
            f"{win_counts.get('patch_delta')} times")
    print(f"denoising loop s (25 steps, no text encode or VAE decode): "
          f"dense {dense_loop_s:.4f}, base record {rec_s:.4f}, edit replay "
          f"same {same_s:.4f}, edit re-noised {edit_s:.4f}, a-priori "
          f"window {win_s:.4f}; engine s/image dense {dense_s:.4f}")
    del caches


HEADLINES = ("total_ema_reduction", "ema_gb_per_iter_optimized",
             "mj_per_iter_with_ema")


def _differences(torch, ref, other, reports, heads: int = 8) -> dict:
    """Latents, ledger headlines and per-layer PSSA counters of two runs
    from the same latents: the largest latent difference, each headline's
    relative difference, and the worst layer's counter difference as a
    share of the per-layer bound (PSSA_MAX_ROW_DIFF counts on
    PSSA_MAX_ROW_FRAC of the layer's rows, past one float32 ulp of the
    counter)."""
    diff = {"latents": (ref.latents - other.latents).abs().max().item()}
    for key in HEADLINES:
        a, b = (r[key] for r in reports)
        diff[key] = abs(a - b) / max(abs(a), 1e-30)
    rs, fs = ref.stats.cpu(), other.stats.cpu()
    worst = 0.0
    for li, lk in enumerate(rs.layers):
        rows = heads * lk.resolution ** 2        # heads x queries, cond row
        allowed = PSSA_MAX_ROW_DIFF * math.ceil(PSSA_MAX_ROW_FRAC * rows)
        for field in ("nnz", "bitmap_ones_xor"):
            a = getattr(rs.pssa[li], field)
            b = getattr(fs.pssa[li], field)
            d = (a - b).abs().max().item()
            ulp = torch.finfo(torch.float32).eps * a.abs().max().item()
            worst = max(worst, max(d - ulp, 0.0) / allowed)
    diff["counters"] = worst
    print("  latents max|diff| {:.3e}; relative: {}; counters at {:.2f} of "
          "the bound".format(diff["latents"], ", ".join(
              f"{k} {diff[k]:.3e}" for k in HEADLINES), worst))
    return diff


def _hold(label, diff, latent_atol, counter_scale, headlines):
    require(diff["latents"] <= latent_atol,
            f"{label}: latents differ by {diff['latents']} > {latent_atol}")
    for key in headlines:
        require(diff[key] <= LEDGER_RTOL,
                f"{label}: {key} differs by {diff[key]} relative")
    require(diff["counters"] <= counter_scale,
            f"{label}: PSSA counters at {diff['counters']:.2f} of the "
            f"bound > {counter_scale}")


@phase("parity")
def parity_phase(torch, eng):
    """Two full-width steps from the same latents, route against route.

    1. ``reference()`` against ``fused()``: the attention kernels alone,
       the FFN on the float reference on both sides.  Latents within
       LATENT_ATOL, both ledger headlines within LEDGER_RTOL, counters
       within the per-layer bound.
    2. Reference attention + DBSC against the slice's route (fused +
       DBSC), on each of DBSC_SEEDS.  A flipped INT12 code follows any ulp
       of upstream difference, so latents are held to DBSC_LATENT_ATOL and
       counters to DBSC_COUNTER_SCALE times the bound.
       ``mj_per_iter_with_ema`` and the optimized EMA bytes are held to
       LEDGER_RTOL.  ``total_ema_reduction`` is one minus their ratio to
       the dense baseline, near zero with random weights (-0.0165), so its
       relative difference is that of the bytes divided by it; it is
       printed, and held through the bytes.
    3. A witness without any kernel difference: reference attention + DBSC
       against itself from latents one ulp apart, printed beside 2.
    4. Temporal reuse at threshold 0.05 on both routes: ``reference()``
       against ``fused()`` (patch delta through its kernel), the float
       FFN on both.  The limits of 1 hold, and the per-layer reuse
       counters must be equal but for ties (``_hold_reuse``).
    """
    from repro_torch.configs import bk_sdm
    from repro_torch.core.reuse import ReusePolicy
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import energy_report
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dispatch import KernelPolicy

    base = dataclasses.replace(bk_sdm.CONFIG, ddim=dataclasses.replace(
        bk_sdm.CONFIG.ddim, num_inference_steps=2))
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}

    def run(name, pol, seed, latents=None, reuse=ReusePolicy.off()):
        toks, un = _tokens(torch, base, seed)
        if latents is None:
            latents = eng.init_latents(1, torch.Generator(device="cuda")
                                       .manual_seed(seed + 1))
        cfg = _with_reuse(bk_sdm.with_kernel_policy(base, pol), reuse)
        e = DiffusionEngine(cfg, params=params)
        out = e.generate(toks, uncond_tokens=un, latents=latents.clone())
        rep = energy_report(cfg, out.stats).summary()
        print(f"{name}, seed {seed}: {e.last_wall_s:.3f} s, "
              f"mj_per_iter_with_ema {rep['mj_per_iter_with_ema']!r}, "
              f"total_ema_reduction {rep['total_ema_reduction']!r}")
        return out, rep, latents

    seed = DBSC_SEEDS[0]
    ref, ref_rep, _ = run("reference", KernelPolicy.reference(), seed)
    fused, fused_rep, _ = run("fused", KernelPolicy.fused(), seed)
    print("reference vs fused:")
    _hold("reference vs fused",
          _differences(torch, ref, fused, (ref_rep, fused_rep)),
          LATENT_ATOL, 1.0, HEADLINES)

    ref_dbsc = KernelPolicy(ffn="dbsc")
    slice_route = KernelPolicy(self_attention="fused",
                               cross_attention="fused", ffn="dbsc")
    for seed in DBSC_SEEDS:
        ref_d, ref_d_rep, latents = run("reference attention + dbsc",
                                        ref_dbsc, seed)
        fused_d, fused_d_rep, _ = run("fused + dbsc", slice_route, seed)
        print(f"reference attention + dbsc vs fused + dbsc, seed {seed}:")
        _hold(f"dbsc pair, seed {seed}",
              _differences(torch, ref_d, fused_d, (ref_d_rep, fused_d_rep)),
              DBSC_LATENT_ATOL, DBSC_COUNTER_SCALE,
              ("ema_gb_per_iter_optimized", "mj_per_iter_with_ema"))
    nudged = torch.nextafter(latents, torch.full_like(latents, math.inf))
    ulp_d, ulp_d_rep, _ = run("reference attention + dbsc, latents + 1 ulp",
                              ref_dbsc, seed, latents=nudged)
    print(f"witness: reference attention + dbsc against itself, latents "
          f"one ulp apart, seed {seed}:")
    _differences(torch, ref_d, ulp_d, (ref_d_rep, ulp_d_rep))

    seed = DBSC_SEEDS[0]
    reuse = ReusePolicy.temporal(REUSE_THRESHOLD)
    deltas = {}
    orig = dispatch.patch_delta

    def run_reuse(key, name, pol):
        deltas[key] = []

        def capture(policy, x, x_ref, *, patch, threshold):
            out = orig(policy, x, x_ref, patch=patch, threshold=threshold)
            deltas[key].append(out[0])
            return out

        dispatch.patch_delta = capture
        try:
            return run(name, pol, seed, reuse=reuse)
        finally:
            dispatch.patch_delta = orig

    ref_r, ref_r_rep, _ = run_reuse("reference", "reference + reuse",
                                    KernelPolicy.reference())
    fus_r, fus_r_rep, _ = run_reuse("fused", "fused + reuse kernel",
                                    KernelPolicy.fused())
    print(f"reference + reuse vs fused + reuse kernel, threshold "
          f"{REUSE_THRESHOLD}, seed {seed}:")
    _hold("reuse pair", _differences(torch, ref_r, fus_r,
                                     (ref_r_rep, fus_r_rep)),
          LATENT_ATOL, 1.0, HEADLINES)
    _hold_reuse(torch, ref_r.stats, fus_r.stats, deltas)


def _hold_reuse(torch, rs, fs, deltas):
    """Reuse counters of two routes from the same latents: equal, except
    where a patch's delta lies within REUSE_TIE_REL of the threshold on
    either route (a tie; each is printed).  Each route's cond-row counter
    must equal its own bitmap ``delta >= threshold``; step 0 runs on an
    invalid cache and computes every patch."""
    thr = REUSE_THRESHOLD
    nl = len(rs.layers)
    comp_r, tot = _reuse_counters(torch, rs)
    comp_f, _ = _reuse_counters(torch, fs)
    require(len(deltas["reference"]) == len(deltas["fused"])
            == nl * comp_r.shape[0], "patch_delta calls missing")
    require(torch.equal(comp_r[0], tot[0]) and torch.equal(comp_f[0],
                                                           tot[0]),
            "step 0 reused a patch from an invalid cache")
    ties = 0
    for i, (dr, df) in enumerate(zip(deltas["reference"], deltas["fused"])):
        step, li = divmod(i, nl)
        if step == 0:
            continue
        ar, af = dr >= thr, df >= thr
        require(int(comp_r[step, li]) == int(ar[0].sum())
                and int(comp_f[step, li]) == int(af[0].sum()),
                f"step {step} {rs.layers[li].name}: counters do not follow "
                f"the bitmaps")
        for row, patch in (ar != af).nonzero().tolist():
            a, b = dr[row, patch].item(), df[row, patch].item()
            dist = max(abs(a - thr), abs(b - thr)) / thr
            print(f"  tie: step {step} {rs.layers[li].name} row {row} "
                  f"patch {patch}: delta reference {a!r}, fused {b!r} "
                  f"({dist:.2e} of the threshold)")
            require(dist <= REUSE_TIE_REL,
                    f"a reuse bit differs {dist:.2e} of the threshold "
                    f"from it: not a tie")
            ties += 1
    cells = int((comp_r != comp_f).sum())
    print(f"  reuse counters: {cells} (step, layer) cells differ, "
          f"{ties} tie patches; computed {comp_r.sum().item()} "
          f"(reference) / {comp_f.sum().item()} (fused) of "
          f"{tot.sum().item()}")


# ---------------------------------------------------------------------------
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    pool = None
    try:
        smi = environment(torch)
        build_kernels()
        rows = kernels_phase(torch)
        # the dry-run's traces need the host alone: beside the card's phases
        pool, traces = start_dryrun_traces()
        eng, counts = slice_phase(torch)
        mesh_phase(torch, eng)
        slots_phase(torch, eng)
        slot_reuse_phase(torch, eng)
        dit_phase(torch)
        serving_phase(torch, eng)
        router_phase(torch, eng)
        autotune_phase(torch, eng)
        bitmap_rows, bitmap_counts = bitmap_phase(torch, eng)
        reuse_counts, dense_s = temporal_phase(torch, eng)
        edit_phase(torch, eng, dense_s)
        parity_phase(torch, eng)
        serve_counts = serve_phase(torch)
        lm_phase(torch)
        g_counts = train_phase(torch)
        dryrun_phase(torch, g_counts, traces.result())
        examples_phase(torch)
    except Exception as exc:                      # report, then fail
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    rows.update(bitmap_rows)
    # each kernel's launches on its own path: the slice for the three of
    # the dense path, the temporal run, the bitmap entry point and the
    # serve run's prefill
    counts = dict(counts, patch_delta=reuse_counts["patch_delta"],
                  patch_bitmap=bitmap_counts["patch_bitmap"],
                  ssd_scan=serve_counts["ssd_scan"])
    for name, row in rows.items():
        row["launches"] = counts[name]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [rows[n] for n in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
