#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as the checks run it
    python3 chip_smoke.py --skip-serve    # device, build and kernel phases
    python3 chip_smoke.py --log FILE      # every phase, the log also in FILE

The run writes Python's bytecode under build/pycache (PYTHONPYCACHEPREFIX),
so the processes it starts do not compile the installed modules again.

Phases, in order; any failure exits nonzero:

1. device  — the card's name and power limit (nvidia-smi), torch, CUDA and
             nvcc versions.
2. build   — every kernel of the port built from `src/repro_torch/
             kernels/csrc` for sm_90a, one nvcc per source, all at once;
             registers, shared memory and spills from `-Xptxas -v`, and
             any note of ptxas's that it serialized wgmma.
   probe   — the SA GEMM large tile's premise (ROADMAP F2): each k16
             step of random and planted operands (exponent spreads of
             2^±20 to 2^±60, near-total cancellation, products around
             fp32's smallest normal, signed zeros) summed from zero by
             mma.sync and by wgmma, the two equal on every output.
3. kernels — each kernel against its plain PyTorch version on the same
             inputs at the main paths' shapes: the SA GEMM and the two
             attention kernels within their stated bounds (`error_bound` of
             their modules), fp_emu and quantize bit for bit, the FP8 GEMM
             (quantize → SA GEMM) within the SA GEMM's bound; CUDA-event
             times of the kernel, the plain version and, where one exists,
             one PyTorch call that computes the same function (a yardstick
             the port never calls), beside the least time the card could
             take. The attention checks add each policy's route (prefill:
             `mma` for bf16/fp16, `simt` for fp32), the grid and cluster
             shape, registers and spills, prefill times at T = 32, 64, 128
             and 1024 and decode times at the serve shape and at
             2048-token slots with the block width and cluster size swept,
             a 12,288-token slot and bit-identical repeats. The families'
             shapes: prefill at hd 256 (16 heads over 8 KV heads; gemma3's
             T = 1024 and T = 1500 with a 1024-token window, gemma2's
             T = 4200 with a 4096-token window and cap 50) on both routes
             and with bf16 K/V, each within its bound with the planted
             mask outside it, beside SDPA; paged decode at g = 2, hd 256
             over B = 4 rings of 1024 and 4096 rows (`dense_pool_view`),
             the pool's bits; the tied lm_head (W = embed^T in place) at
             M = 4 and 1024, bit-identical to the contiguous W, beside
             bf16 torch.matmul(x, embed.t()) and its bound. The MoE
             family's GEMMs: the routers (N = 40, 128 and 8) at M = 4,
             20 and 128 within their bound on `mma`, timed at M = 4
             beside their byte bound; granite's MoE layer at decode
             (the router and 120 expert GEMMs) and one llama4 expert,
             each GEMM within its bound, then timed; the expert shapes
             and llama4's dense FFN at M = 20, 128 and 512 (a training
             expert's B·C) within their bound. The SSM family's
             projections (mamba2's in_proj 2560 x 10576 and out_proj,
             hymba's in_proj 1600 x 6482 stored with rows of 6488, and
             out_proj) on the decode, small and large tiles within their
             bound with no operand copied, timed at M = 4 beside their
             byte bound and bf16 torch.matmul; hymba's prefill (hd 64,
             g = 5, T = 2600, window 2048) and its decode over B = 4
             rings of 2048 rows, each within its bound, beside SDPA. The
             frontend families' shapes: whisper's GEMMs (d 384, d_ff
             1536, the lm_head of 53248) at the encoder's M = 6000 and
             the decoder's M = 4, within their bound with one launch and
             no operand copied, beside the bound and bf16 torch.matmul;
             prefill at whisper's g = 1, hd 64 (T = 64) and at pixtral's
             T = 384, g = 4, hd 128; paged decode at g = 1, hd 64 over
             B = 4 rings of 80 and 2048 rows, beside SDPA.
4. fold    — ROADMAP F2 and F2b at full width: every row of the path's
             GEMMs (7 layer shapes and the lm_head), bf16 x bf16 and fp32
             x fp32, bit-identical at M = 1, 4, 7, 8, 20 and 1024, and a
             slot's paged decode at B = 4 bit-identical to the same slot
             inside B = 20; then the fp32 routes' times (a layer's 7 GEMMs
             fp32 x fp32 at M = 4 and 1024, beside the plain version,
             fp32 torch.matmul and the bound); then every kernel of the
             tensor-parallel serve at a rank's shapes (paged decode over
             a rank's KV heads, padded ones included; prefill over a
             rank's padded heads; the SA GEMM's column shards and the
             row shards' fp32 chain at K / tp) against its plain
             version and, bit for bit, the whole call.
   parallel — the trainer (`python -m repro_torch.launch.train`; its
             `main` inside this script's rank program in the worlds
             that also serve) under torchrun, the
             ranks sharing the one card over gloo, 3 AdamW steps under
             `cuda` at batch 4 x 512, each mesh (data, model):
             qwen2.5-14b at full width cut to 1 layer at (1, 2) (accum
             2; 4 before PR 29, 2 before PR 30) and at (2, 2) (accum 1:
             four ranks' states fill the card), phi3-medium-14b cut to 1
             layer at (1, 4) (accum 2; 2 before PR 30; its 10 KV heads
             padded to 12), granite-moe-3b cut
             to 2 layers at (1, 2) (EP, 20 experts a rank) and (2, 2) (EP
             with DP, the load-balance loss over the global batch), in
             qwen's worlds of those shapes, its step 0 on the one-process
             reference's routing (ROADMAP R8). Step 0's loss and every
             gathered gradient leaf (`--grads-out`) against the
             one-process step on the same weights and global batch, run
             first in this process: the train phase's bounds. The
             backend on the launcher's first line, finite losses, every
             rank's SA GEMM launched forward and backward with no plain
             call; each rank's peak memory and step times. After the
             (2, 2) run, its model on one rank under nccl
             (`--model-parallel 1`): step 0's loss against the same
             reference, the same launch checks. FSDP (PR 32):
             llama4-maverick at full width cut to one superblock and 4
             of its 128 experts (LLAMA4_E4) trained 2 steps at (2, 2) in
             a world of its own, every matrix cut over data and model;
             step 0 held as above on the one-process routing, the clip
             norm the same on every rank, each rank's parameters, μ and
             ν within 5 % of a quarter of the world's; each rank's peak
             memory and step times.
             It runs right after the fold phase, while this process
             holds little of the card.
   parallel_serve — serving under tensor parallelism, the ranks sharing
             the card over gloo, each set of serve runs in the torchrun
             world of a parallel run after its steps (this script's
             rank program, `--serve-ranks SPEC`: the trainer's `main`,
             then `launch.serve.main` a run, the first drawing the
             rank's shards): qwen2.5-14b at full width cut to 4 layers
             (12 before the data axis's serves came in, full depth
             before that) at (data 1, model 2) on the serve stream,
             paged; granite cut to
             16 layers and llama4-maverick cut to one superblock at
             (1, 2) on the moe phase's granite stream, paged (EP: a rank
             20 and 64 experts; each prompt's prefill routing recorded);
             the serve stream on one nccl rank (`--model-parallel 1`);
             phi3-medium-14b at full width cut to 2 layers at (1, 4)
             (its 10 KV heads padded to 12), paged, `--kv ring` and
             `--disagg`. Every rank one digest, phi3's three runs one
             digest, no plain call, the serve driver's mesh lines; each
             rank's launches and peak memory, ITL and TTFT. After the
             serve phase each run is held to the one-process stream by
             ROADMAP R1's rule (prefill logits within 2^-5 max|logit|,
             tokens equal up to the first position whose one-process
             top-two margin is below twice that bound; the equal tokens
             counted), the nccl rank's digest and launches equal to the
             serve phase's; qwen's and phi3's one-process streams are
             served there at the same depth, each rank's launches equal
             to them (the same GEMMs on shards); granite's and llama4's
             are held in the moe phase. The first (2, 2) world serves
             over `data` too: qwen at 4 layers paged, ring
             and disagg and granite on its stream, each data rank its
             two slots and its range of pages, each digest the (1, 2)
             world's bit for bit; and the batch-1 ring (a 2048-token
             prompt, a 4096-row ring whose rows split over `data`, 16
             new tokens) against a one-process batch-1 serve by R1's
             rule (`data_serve_check`); each rank's ITL, TTFT, peak
             memory, SA GEMMs a decode step and its shard's pages. The
             kernel phase holds the decode kernel's log-sum-exp output
             against its twin and the fold of two halves against the
             whole (`check_decode_lse`). The
             kernel phase holds each kernel at a rank's shapes
             (`check_rank_shapes`; since PR 30 also granite's expert
             pieces under a model axis of 16). It measures no speed of a
             real mesh.
5. serve   — full-width, full-depth qwen2.5-14b (random weights from a
             seed) served through `repro_torch.launch.serve.main` with the
             `cuda` GEMM backend; every request must generate `max_new`
             tokens with finite logits, no page may leak, the path's three
             kernels must have launched (prefill attention on its `mma`
             route only, every SA GEMM, decode included, on `mma`: 0
             `partial`) and no plain version may have run. The same
             stream again on the same weights with a bf16 KV pool
             (`ServeEngine(cache_dtype=torch.bfloat16)`): the same checks
             and the same stream digest. Then one prompt's prefill logits
             under the `cuda` and `torch` GEMM backends, within the stated
             bound.
6. profile — four more requests served under torch.profiler: the device's
             busy and idle share of the wall and the kernels that take the
             device time; then one decode chunk alone: kernel launches a
             decode step and the decode tile's share of device time.
   tiers   — the serve stream with `--tier-mix 0.5` on the same weights
             (the bulk tier, DESIGN.md §6): approx chunks ran, each
             kernel's launches by mode (`ops.mode_counts()`) exactly as the
             run's chunks and divergence probe account for, no plain
             version, every premium request's tokens bit-identical to the
             all-premium serve's; the full-depth `[divergence]` line
             (max_ulp > 0, every value finite) and the `energy_*` keys;
             the probe's batch-1 ring decodes through the paged-decode
             kernel (its launches in the exact counts).
   ring    — the serve stream with `--kv ring` and on the paged pool, both
             under REPRO_DECODE_ATTN=gather (ROADMAP F5): both decode
             through the paged-decode kernel over dense rows, L launches a
             decode step the run's chunks and warm-up imply, and both give
             the fused serve's digest, every token equal; `generate()` on
             4 equal-length prompts (the prefill kernel at B = 4) equal to
             the ring serve of the same requests.
   disagg  — the serve stream with a 32-token system prompt before half
             the prompts (the prefix cache hit: continued prefill at
             `q_offset` 32, the prefix loaded from the pool) served
             unified, `--disagg --prefill-workers 2`, unified under
             REPRO_PREFIX_CACHE=0 and `--decode-replicas 2 --disagg`: one
             digest, prefix hits >= 1 and equal in the first two and none
             in the third, no page leaked, `disagg` with the ready queue's
             depth where asked, no plain version, every GEMM and prefill
             on `mma`; each run's wall split and ITL, the replicas'
             serial and parallel walls.
   spec    — the serve stream with `--spec-k 4` on the same weights
             (self-speculative decoding, fp32 pool, fused decode), with
             drafts of 24 and of all 48 superblocks: every request
             complete, no page leaked, no plain version, every SA GEMM
             and prefill on `mma`, each kernel's launches exactly as the
             run's iterations and timing probe imply (`_expected_spec`);
             the plain serve's digest at both depths, drafts ran, and at
             48 every draft accepted (the verify's rows at M = 20 carry
             the draft's bits at M = 4: F2 on a served path); the accept
             histogram, ITL, decode_tok_s, the probe's draft and verify
             seconds an iteration, and the device time a layer of the
             decode step, the draft and the verify by kernel class; the
             verify's 20 rows a layer beside their yardsticks (the 7
             GEMMs at M = 20 against bf16 torch.matmul and the byte bound,
             paged decode over 20 rows against SDPA on the gathered view
             and its bound).
   bucket  — 8 requests of 17, 20, 23, 40 and 47 prompt tokens on the
             same weights, with and without `--bucket-prompts`: one
             digest, 2 prefill shapes (24, 48) against 5, prefill
             attention on `mma` at every padded length, no page leaked,
             no plain version.
   autotune — the serve stream through the driver with
             `--autotune-decode` on the same weights and an empty cache
             (the script points REPRO_AUTOTUNE_CACHE at its own files from
             the start, so every other phase runs the heuristic's tiles
             and cluster sizes): each swept (M, N, K) and paged-decode
             n_split with every candidate's time, the winner and the
             heuristic's choice; the untuned serve's digest (neither the
             tile nor, since ROADMAP F9's repair, the paged decode's
             cluster size changes a bit), 0 misses
             over the decode chunks, each kernel's launches as the run
             implies, the serve phase's checks; again with `--spec-k 4`
             and a draft of all 48 superblocks (the verify's M = 20
             swept, accept rate 1.0, the tuned digest). After the engine
             is freed, the tuned serve in a second process on the same
             cache file: 0 sweeps, the same choices and digest; then a
             fresh empty cache, and a lookup gives the heuristic again.
   examples — the four port examples (`examples/*_torch.py`) as
             subprocesses under `cuda`, beside the autotune phase's
             second process (each a process of its own, with a fresh
             empty cache of their own): quickstart's loss falls,
             serve_batch finishes 12 of 12 requests, train_100m runs 30
             steps and resumes from its checkpoint for 5 more, the
             precision study prints "bit-exact: True" per format and
             section 2's cycles equal to `core.systolic`'s.
   families — gemma3-12b (12 of its 48 layers, 5:1 local:global,
             window 1024; 6 requests of 600-1500 tokens on 4 slots),
             gemma2-9b (12 of 42 layers, 1:1, window 4096, softcaps 50
             and 30; prompts of 256 and 4200 tokens) and phi3-medium-14b
             (10 of 40 layers; the serve stream) at full width, cut to
             half their depth since PR 29 and to these since PR 30, one
             model on the card at a
             time, through the driver under `cuda` with the serve phase's
             checks; paged decode launched L times a decode step; the
             window's gates off (no prefix hit); gemma3 and gemma2 again
             with `--kv ring`, the same digest; gemma2's logits within
             ±30; one prompt's prefill logits under `cuda` and `torch`;
             gemma3's stream again with `--spec-k 4` (the spec phase's
             local-window case, ROADMAP F6): local rings of 1040 rows,
             the plain serve's digest.
   moe     — granite-moe-3b-a800m at full width cut to 16 of its 32
             layers (since PR 29; its layers are all alike, and its
             host-bound decode, ~10,500 launches a step at full depth,
             is the run's largest saving; 40 experts, top-8) on the
             serve stream, paged and `--kv ring`: one digest, the serve
             phase's checks, every kernel's launches exactly as the
             dropless dispatch implies (`moe.gemm_calls`: a decode step
             2001 SA GEMMs at 16 layers, 4001 at 32, run once alone
             too), prefill logits under `cuda` and `torch`, one
             decode chunk under torch.profiler (idle share);
             llama4-maverick at full width cut to one superblock (a dense
             layer at d_ff 16384, a MoE layer of 128 experts and the
             shared expert: 37.4 GB) on granite's stream (since PR 30),
             the same launch gates, peak memory; each also holds its
             (1, 2) serve of the parallel phase by R1's rule
             (`moe_parallel_check`: the prefill logits on the mesh's
             routing, the tokens whose expert set differs counted, a
             rank's launches `gemm_calls(tp=2)` a step); granite cut to
             4 layers trained 3 AdamW steps at batch 4 x 512 (the capacity
             dispatch): step 0 under `cuda` and `torch` with the routing
             held (and the free-routing spread read out), the train
             phase's gates, finite aux losses.
   ssm     — mamba2-2.7b (8 of its 64 layers since PR 30, d 2560, 80
             SSM heads of 64, state 128, chunk 256) and hymba-1.5b (32
             layers, d 1600, 25 heads over 5 KV heads at hd 64, window
             2048, global layers 0 and 16, state 16) at full width
             (hymba at full depth) through the driver under `cuda`, asked
             for `--kv paged` and `--kv ring` on the same weights: one
             digest, the serve phase's checks, each kernel's launches
             exactly as the forwards imply (`model.gemm_calls`: 17 and
             289 SA GEMMs a decode step at these depths, mamba2's 129 at
             full depth; paged decode 0 and 32 a step, prefill attention
             0 and 32 a prefill), one decode step alone with no operand
             copied
             (hymba's ragged in_proj read in place), the layout the
             engine took (mamba2 on rows whatever was asked) and its
             prefix cache, disagg, bucketing and spec off, prefill then
             decode equal to a full forward on the card within
             2^-3·max|logit| (the backends check's bound; a decode from
             a zeroed state at least twice as far), prefill logits
             under `cuda` and `torch`,
             peak memory; mamba2's decode chunk under torch.profiler and
             `generate()` on 4 prompts; mamba2 cut to 4 layers trained 3
             AdamW steps at batch 4 x 512 (step 0 under `cuda` and
             `torch`, the train phase's route gates).
   frontend — whisper-tiny (4 encoder and 4 decoder layers, d 384, 6
             heads of 64 at g = 1, layernorm, GELU MLP, 1500 stub frames)
             and pixtral-12b (6 of its 40 layers since PR 30, d 5120,
             32 heads over 8 at hd 128, 256 stub patch rows) at full
             width, one at a time, through the driver's static
             waves (2 waves of 4 requests, 16 new tokens; whisper's
             prompts 32 and 64 tokens, pixtral's 64 and 128): requests
             complete, finite logits, no plain version, GEMMs and prefill
             on `mma`, each kernel's launches exactly as the forwards
             imply (73 and 43 SA GEMMs a forward, paged decode 4 and 6
             a decode step, prefill attention 4 and 6 a prefill),
             `serve()` refused, prefill then decode equal to a full
             forward within 2^-5·max|logit| with a planted fault outside
             (whisper's frames redrawn; pixtral's patch rows hidden from
             decode), prefill logits under `cuda` and `torch`, peak
             memory; whisper's `generate()` on 4 more prompts and one
             decode chunk under torch.profiler (the encoder's share);
             whisper trained at full depth (batch 4 x 256 over 1500
             frames) and pixtral cut to 4 layers (4 x 512 after 256
             patch rows), 3 AdamW steps each with step 0 under `cuda`
             and `torch` and the train phase's route gates.
7. emulate — qwen2.5-14b served under `REPRO_GEMM_BACKEND=emulate`:
             every GEMM through the fp_emu kernel (the SA GEMM never
             launches), attention through the two attention kernels, no
             plain version; its two requests again under torch.profiler
             (prefill_s, decode ITL, idle share, fp_emu's share of device
             time); then one prompt's prefill logits under `emulate` and
             `cuda`, within the same bound; then the two requests as bulk
             (`--tier-mix 1.0`): every chunk approx, fp_emu's launches by
             mode as accounted, and fp_emu's device time a decode step in
             each mode.
8. study   — `repro_torch.launch.precision_study.main` at full width: the
             skewed and baseline chains bit-exact per format, the cycle and
             energy model equal to the JAX package's numbers, and the
             precision ladder ordered; its FP8 rows through the quantize
             kernel, whose plain version never runs.
9. train   — qwen2.5-14b at full width cut to 4 layers (fp32 masters and
             AdamW moments: 16 B a parameter), batch 4 x 512 in two
             strided microbatches. Step 0's loss and gradients under the
             `cuda` and `torch` GEMM backends on the same parameters and
             batch, every leaf within the stated bound, and two planted
             backward faults outside it; then six steps through
             `repro_torch.launch.train.run` under `cuda`: finite losses and
             gradient norms, the SA GEMM's forward and backward launched
             (every forward GEMM on its `mma` route, every backward GEMM on
             `split3`, each tile's launches equal to what `mma_plan` gives
             the run's shapes: q, o, gate, up, down and the lm_head on the
             large tile, wk and wv on the small one), its plain version
             never run; peak memory and time per step.

The kernel phase holds fp_emu bit for bit to its plain version and to
chained_fma in four formats and both modes, at decode's and prefill's
shapes and at one (M, N) for each launch geometry its plan picks (the
producer/consumer kernel, and rows a thread x warps a block of the
other); it prints the SASS a PE step (the K loop, its dependent path, the
chain probe's), the chain's cycles a step, the decode wk GEMM's times
beside its issue bound (the fewest SASS a PE step of any geometry) and
its chain-latency bound (K x this design's chain cycles), the larger
named as its bound, wk at M = 1-33, and a layer's 7 GEMMs and the lm_head
at M = 2 and 32.

The kernel phase also holds the SA GEMM at the training shapes (M = 1024
tokens): the forward on the tensor cores (`mma`), its raw output, and the
backward GEMMs (dA = dY·Wᵀ, dW = Aᵀ·dY, fp32 x bf16) on the `split3` route,
each within its route's bound and `split_check`, which a planted backward
with dY rounded once to bf16 must fail; the split bit for bit; the times
beside bf16 and fp32 torch.matmul; the forward of a layer's 7 GEMMs and
of the lm_head at M = 1024 on the large tile (wgmma), wall and device,
beside its flop bound and its FADD bound (one add an output a k16 step);
the tile sweep (M = 1 to 256: the decode, small and large tiles, split-K
`partial` below 8 rows); and each distinct GEMM on the large and small
tiles at M = 20 to 1024 beside the tile the plan takes. At decode's
M = 4 it prints each GEMM's tile and grid and times the decode tile, wall
and device, for a layer's 7 GEMMs and for the lm_head, each beside its byte
bound and bf16 torch.matmul. The decode and prefill checks add bf16
(and fp16) KV pools and 16-bit K/V, bit-identical to fp32 under the bf16
policy.

Each phase's wall time is printed. The last lines are the kernels JSON
line (with each tiered kernel's `mode_launches`, the spec phase's launches
and per-layer times, the verify's yardsticks, the bucket phase's prefill
readings, the ring and disagg runs' launches), the nvidia-smi
line and `{"ok": true, "device": {...}}`. `--log FILE` also writes every
line this script logs to FILE.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
import types

PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s (data sheet)
PEAK_BF16 = 989e12        # dense bf16 tensor-core flop/s (data sheet)
PEAK_FP32 = 67e12         # fp32 flop/s outside the tensor cores (data sheet)
ISSUE_LANES = 128         # thread-instructions issued per SM per clock

ARCH = "qwen2.5-14b"
SERVE_ARGS = ["--arch", ARCH, "--batch", "4", "--requests", "8",
              "--prompt-lens", "32,64,128", "--max-new", "16", "--rate", "0",
              "--seed", "0"]
BATCH, MAX_NEW, PROMPT_LENS = 4, 16, (32, 64, 128)
PAGE = 16
# the served stream's per-request capacity: longest prompt + max_new
CACHE_LEN = max(PROMPT_LENS) + MAX_NEW
# the emulate serve: every GEMM walks K serially through the PE chain
EMU_ARGS = ["--arch", ARCH, "--batch", "2", "--requests", "2",
            "--prompt-lens", "16,32", "--max-new", "4", "--rate", "0",
            "--seed", "0"]
EMU_REQUESTS, EMU_MAX_NEW = 2, 4
D_MODEL, D_FF = 5120, 13824
# the train phase: full width, depth cut to 4 of 48 layers (2.674 B
# parameters, 42.8 GB of fp32 masters, gradients, mu and nu)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4, 4, 512, 2, 6
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ // TRAIN_ACCUM     # tokens a microbatch
# step-0 gradients, kernel vs plain GEMM: every cotangent that reaches a
# master is rounded to bf16, so a last-bit fp32 difference between the two
# GEMMs' sums flips a bf16 rounding (2^-8) that the backward carries
# through the layers; each leaf within 2^-5 of its norm, the loss within
# 2^-10 (the CPU parity tests' tolerances, tests/test_torch_train.py)
TRAIN_GRAD_REL, TRAIN_LOSS_REL = 2.0 ** -5, 2.0 ** -10

# The JAX package's section-2 numbers of the precision study (its
# `systolic.gemm_latency` and `energy.network_totals`), which
# tests/test_torch_study.py holds equal to the JAX package: (M, K, N,
# baseline cycles, skewed cycles) and each network's savings.
STUDY_GEMMS = [(49, 1024, 1024, 27840, 19712), (12544, 27, 32, 12657, 12631),
               (4096, 5120, 5120, 7168128, 6964928)]
STUDY_NETWORKS = {"mobilenet": (0.1707624630822332, 0.09389819165630042),
                  "resnet50": (0.21931369204186524, 0.13947224394832314)}


# the SA GEMM's large tile (csrc/sa_matmul.cu TileLarge), for the kernels
# line
LARGE_TILE_DESIGN = ("wgmma m64n128k16, scale-d 0 each k16 step, its sum "
                     "added to the fp32 accumulator (FADD, round to "
                     "nearest); 128 x 128 blocks of two consumer "
                     "warpgroups and a TMA producer, 6 stages 64 deep in "
                     "the 128-byte swizzle, blocks in column-strip order")

# `--log FILE`: every logged line also goes to FILE (set in main)
LOG_FILE = None


def log(msg=""):
    print(msg, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(msg + "\n")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound_ms(nbytes: float, flops: float, peak: float):
    t_b, t_o = nbytes / PEAK_BYTES, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def peak_flops(policy) -> float:
    """The card's peak rate for the type a policy feeds the products: bf16
    or fp16 operands with fp32 accumulation run on the tensor cores."""
    return PEAK_FP32 if policy.input_format == "fp32" else PEAK_BF16


def device_kernels(torch, prof):
    """{kernel name: (total ms, launches)} of the CUDA kernels a profile
    recorded; empty if the profiler saw no device activity."""
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


class Timer:
    """Two times of one call, each taken with a cold L2.

    Before every call a 256 MB read-modify-write (`bitwise_not_`, a kernel
    no timed call launches) evicts the 50 MB L2: the serving path streams
    28 GB of weights per step, so it finds the cache cold.
    `wall`: CUDA events around each of `reps` calls, averaged. The host
    enqueues a call while the flush runs, so its launch overhead shows only
    where it exceeds the flush (~0.16 ms at the byte rate).
    `device`: the summed durations of the CUDA kernels one call launched,
    from torch.profiler, the flush's excluded, each kernel at its mean over
    the records kept (None when the profiler records no device time)."""

    FLUSH_KERNEL = "bitwise_not"

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32,
                                 device="cuda")

    def wall(self, fn, reps=20):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            self.flush.bitwise_not_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in events) / reps

    def device(self, fn, reps=5, tries=3):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        ks = {}
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.bitwise_not_()
                    fn()
                torch.cuda.synchronize()
            got = {name: v for name, v in device_kernels(torch, prof).items()
                   if self.FLUSH_KERNEL not in name}
            ks = got or ks
            # the profiler sometimes keeps only part of a short window's
            # records: profile again until every kernel has all of its own
            if got and all(n >= reps for _, n in got.values()):
                break
        if not ks:
            return None
        short = {name[:40]: n for name, (_, n) in ks.items() if n < reps}
        if short:
            log(f"  (the profiler kept {short} records of {reps} calls)")
        # each kernel a call launches at its mean duration over the records
        # kept
        return sum(ms / n * max(1, round(n / reps)) for ms, n in ks.values())


# ---------------------------------------------------------------------------
# the k16 probe: wgmma's step sum against mma.sync's (ROADMAP F2)
# ---------------------------------------------------------------------------

def probe(torch):
    """Each k16 step of the probe's operands (`gemm_cases.
    k16_probe_operands`: random, exponent spreads of 2^±20 to 2^±60,
    near-total cancellation, products around fp32's smallest normal,
    signed zeros) summed from zero by mma.sync (C = 0) and by wgmma
    (scale-d = 0): the two must agree in value on every output (the sign
    of a zero step sum aside: an accumulator started at +0 cannot see it),
    or the large tile would give a row other bits than the other tiles.
    Also how many outputs each category moves off the fp64 sum (the
    tensor cores' truncation at work: the probe is not vacuous)."""
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import (k16_mismatches,
                                                k16_probe_operands)

    out, bad = {}, []
    for name, (a, b) in k16_probe_operands(0).items():
        got_mma, got_wg = mm.k16_probe(a.cuda(), b.cuda())
        torch.cuda.synchronize()
        diff = k16_mismatches(got_mma, got_wg)
        off = k16_mismatches(got_mma, mm.k16_probe_ref(a, b).cuda())
        out[name] = dict(diff, outputs=got_mma.numel(),
                         off_fp64=off["values"])
        log(f"[probe] {name:7s} {got_mma.numel()} step sums: wgmma vs "
            f"mma.sync {diff['values']} values differ ({diff['bits']} "
            f"bits), worst {diff['worst']}; {off['values']} differ from "
            f"the fp64 sum")
        if diff["values"]:
            bad.append(name)
    if bad:
        raise AssertionError(f"probe: wgmma's k16 sum from zero differs "
                             f"from mma.sync's in {bad} (ROADMAP F6)")
    return out


def forward_times(torch, timer, g):
    """A layer's 7 forward GEMMs (with their bias and activation) and the
    lm_head at the training M (1024) through `sa_matmul_cuda`, wall and
    device, beside bf16 torch.matmul (fp32 accumulation) and the plain
    version (`sa_matmul_ref`): the `large` tile wherever its blocks fill
    the card (tools/chip_ab.py times both checkouts with it)."""
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import LAYER_GEMMS, LM_HEAD

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    m = TRAIN_M
    out = {"layer": {"ms": 0.0, "device_ms": 0.0, "library_ms": 0.0,
                     "plain_ms": 0.0}}
    for name, k, n, has_bias, act in LAYER_GEMMS + [LM_HEAD]:
        a = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        bias = (torch.randn((n,), generator=g, device="cuda") * 0.1
                if has_bias else None)
        row = {"ms": timer.wall(lambda: mm.sa_matmul_cuda(a, w, bias,
                                                          act=act), reps=5),
               "device_ms": timer.device(lambda: mm.sa_matmul_cuda(
                   a, w, bias, act=act), reps=3),
               "library_ms": timer.wall(lambda: torch.matmul(a, w), reps=5),
               "plain_ms": timer.wall(lambda: mm.sa_matmul_ref(
                   a, w, bias, act=act), reps=3)}
        if name == "lm_head":
            out["lm_head"] = row
        else:
            lay = out["layer"]
            for key, v in row.items():
                lay[key] = None if v is None or lay[key] is None \
                    else lay[key] + v
        del a, w, bias
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_gemm(torch, timer):
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm

    d, hd, H, KVH, ff = 5120, 128, 40, 8, 13824
    vocab = 153600
    # (name, K, N, bias, act) of every GEMM on the path
    shapes = [("wq", d, H * hd, True, "none"), ("wk", d, KVH * hd, True,
                                                 "none"),
              ("wv", d, KVH * hd, True, "none"),
              ("wo", H * hd, d, False, "none"),
              ("wg", d, ff, False, "silu"), ("wu", d, ff, False, "none"),
              ("wd", ff, d, False, "none"),
              ("lm_head", d, vocab, False, "none")]
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, K, N, bias, act, mode, scale, A's type): fp32 A is the fp32
    # policy's decode, the only pair left on `partial` (split3 at M=128)
    extra = [("wk+gelu+approx+scale", d, KVH * hd, True, "gelu", "approx",
              0.5, bf16),
             ("wg+silu+approx", d, ff, True, "silu", "approx", None, bf16),
             ("wq+relu", d, H * hd, True, "relu", "exact", None, bf16),
             ("ragged", 1000, 999, True, "silu", "approx", None, bf16),
             ("wk fp32 A", d, KVH * hd, True, "none", "exact", None, f32),
             ("wg+silu+approx fp32 A", d, ff, False, "silu", "approx", 0.5,
              f32)]
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    max_err = 0.0
    step = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "library_fp32_ms": 0.0, "bytes": 0.0,
            "flops": 0.0}
    # the bf16 yardstick accumulates in fp32 throughout, as the kernel does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"{'gemm':24s} {'M':>4s} {'K':>6s} {'N':>7s} {'max_err':>10s} "
        f"{'err/bound':>9s} {'ms':>8s} {'plain_ms':>9s} {'bf16_lib':>8s} "
        f"{'f32_lib':>8s} {'bound_ms':>8s} route tile grid")
    cases = [(n, k, nn, b, act, "exact", None, bf16)
             for n, k, nn, b, act in shapes]
    cases += extra
    log(f"[sa_matmul] build: {ptxas_summary('sa_matmul')}")
    routes_seen = set()
    for m in (BATCH, 128):
        for name, k, n, has_bias, act, mode, scale, a_dt in cases:
            a = torch.randn((m, k), generator=g, device="cuda").to(a_dt)
            w = (torch.randn((k, n), generator=g, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            bias = (torch.randn((n,), generator=g, device="cuda") * 0.1
                    if has_bias else None)
            ops.reset_counts()
            y = ops.sa_matmul(a, w, bias=bias, act=act, scale=scale,
                              mode=mode)
            route = [r for r, c in ops.route_counts()["sa_matmul"].items()
                     if c][0]
            if (route != mm.gemm_route(m, a.dtype, w.dtype)
                    or (m == BATCH and route != ("partial" if a_dt == f32
                                                 else "mma"))):
                raise AssertionError(f"sa_matmul {name} M={m}: route "
                                     f"{route}")
            routes_seen.add(route)
            if route == "partial":
                where = (f"{route} "
                         f"{mm.fp32_k_plan(n, k)['slices']} K slices")
            else:
                plan = mm.mma_plan(m, n, route)
                where = f"{route} {plan['tile']} {plan['grid']}"
            ref = mm.sa_matmul_ref(a, w, bias, scale, act=act, mode=mode)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            bnd = mm.error_bound(a, w, scale, mode, y=ref)
            ratio = float((err / bnd).max())
            if not torch.isfinite(y).all() or ratio > 1.0:
                raise AssertionError(
                    f"sa_matmul {name} M={m}: max err {float(err.max()):.3e}"
                    f" exceeds its bound (ratio {ratio:.3f})")
            worst = max(worst, ratio)
            max_err = max(max_err, float(err.max()))
            timed = m == BATCH and name in [s[0] for s in shapes]
            line = (f"{name:24s} {m:4d} {k:6d} {n:7d} "
                    f"{float(err.max()):10.3e} {ratio:9.4f}")
            if timed:
                a32, w32 = a.float(), w.float()
                t_k = timer.wall(lambda: ops.sa_matmul(a, w, bias=bias,
                                                       act=act))
                d_k = timer.device(lambda: ops.sa_matmul(a, w, bias=bias,
                                                         act=act))
                t_p = timer.wall(lambda: mm.sa_matmul_ref(a, w, bias,
                                                          act=act))
                t_l = timer.wall(lambda: torch.matmul(a, w))
                t_l32 = timer.wall(lambda: torch.matmul(a32, w32))
                nbytes = 2 * (m * k + k * n) + 4 * m * n + (
                    4 * n if has_bias else 0)
                flops = 2.0 * m * n * k
                b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
                line += (f" {t_k:8.4f} {t_p:9.4f} {t_l:8.4f} {t_l32:8.4f} "
                         f"{b_ms:8.4f} {where} device_ms={d_k}")
                if name == "lm_head":
                    lm_head = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p,
                               "library_ms": t_l, "library_fp32_ms": t_l32,
                               "bound_ms": b_ms, "bound_by": b_by,
                               "tile": plan["tile"], "grid": plan["grid"]}
                else:
                    step["ms"] += t_k
                    step["device_ms"] = (None if d_k is None
                                         or step["device_ms"] is None
                                         else step["device_ms"] + d_k)
                    step["plain_ms"] += t_p
                    step["library_ms"] += t_l
                    step["library_fp32_ms"] += t_l32
                    step["bytes"] += nbytes
                    step["flops"] += flops
            else:
                line += f" {where}"
            log(line)
    if routes_seen != {"partial", "mma", "split3"}:
        raise AssertionError(f"sa_matmul checks ran the routes "
                             f"{sorted(routes_seen)}")
    b_ms, by = bound_ms(step["bytes"], step["flops"], PEAK_BF16)
    log(f"gemm max err/bound over all cases (routes "
        f"{sorted(routes_seen)}): {worst:.4f}; one layer's 7 "
        f"decode GEMMs (M={BATCH}) {step['ms']:.4f} ms wall, "
        f"{step['device_ms']} ms device, bf16 torch.matmul "
        f"{step['library_ms']:.4f} ms, fp32 {step['library_fp32_ms']:.4f} "
        f"ms, bound {b_ms:.4f} ms ({by}: {100 * b_ms / step['ms']:.1f} % of "
        f"it); lm_head (M={BATCH}) {lm_head['ms']:.4f} ms wall, "
        f"{lm_head['device_ms']} ms device, bf16 torch.matmul "
        f"{lm_head['library_ms']:.4f} ms, bound {lm_head['bound_ms']:.4f} "
        f"ms ({100 * lm_head['bound_ms'] / lm_head['ms']:.1f} % of it)")
    return {"name": "sa_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sa_matmul.cu",
            "replaces": "src/repro/kernels/sa_matmul.py:101",
            "max_abs_err": max_err, "err_over_bound": worst,
            "ms": step["ms"], "device_ms": step["device_ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": step["library_ms"],
            "library_fp32_ms": step["library_fp32_ms"],
            "readings": {"lm_head_M4": lm_head},
            "timed": "one decoder layer's 7 decode GEMMs at M=4 "
                     "(wq,wk,wv,wo,wg,wu,wd), summed, on the decode tile; "
                     "library: bf16 torch.matmul (fp32 accumulation), fp32 "
                     "beside it; the lm_head at M=4 in readings"}


# values the split must reconstruct bit for bit: ties of each piece's
# rounding, powers of two, the smallest normal, 2^-110 (the exact range's
# edge), the largest floats (hi taken toward zero) and non-finite values
SPLIT_PLANTED = [0.0, -0.0, 1.0, -2.0, 2.0 ** -126, 2.0 ** -110, 2.0 ** 127,
                 3.4028234663852886e38, -3.4028234663852886e38,
                 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -8 + 2 ** -16,
                 1.0 + 2 ** -23, float("inf"), -float("inf"), float("nan")]


def check_split(torch, mm, dus):
    """The split3 route's pre-pass on a backward's dus and on the planted
    values: bit for bit `split3_ref`, and hi + mid + lo == x exactly (in
    fp64, which holds the three pieces) wherever x is finite."""
    x = torch.tensor(SPLIT_PLANTED, device="cuda")
    ok = True
    for t in (dus, x[None]):
        got = mm.split3_cuda(t)
        same = torch.equal(got.view(torch.int16),
                           mm.split3_ref(t).view(torch.int16))
        fin = torch.isfinite(t)
        exact = bool(((got.double().sum(0) == t.double()) | ~fin).all())
        ok = ok and same and exact
        del got
    return ok


def sweep_routes(torch, timer, g):
    """The tile and route crossover: a layer's 7 forward GEMMs at M = 1 to
    256 on each tensor-core tile (`decode` up to M = 32, `small`, `large`,
    forced through `tile`), on the split-K `partial` kernel below
    TILED_MIN_M (fed the fp32 upcast of A: bf16 x bf16 no longer has a
    `partial` kernel, and W's bytes, which bound decode, are the same),
    beside bf16 torch.matmul."""
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import LAYER_GEMMS

    out = {}
    for mr in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        ops_in = []
        for _, k, n, _, _ in LAYER_GEMMS:
            a = torch.randn((mr, k), generator=g, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=g, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            ops_in.append((a, w))
        t = {}
        tiles = ("decode", "small", "large") if mr <= 32 else ("small",
                                                               "large")
        for tile in tiles:
            t[tile] = sum(timer.wall(lambda: mm._launch(
                a, w, None, None, "none", "exact", False, tile=tile),
                reps=5) for a, w in ops_in)
        if mr < mm.TILED_MIN_M:
            t["partial"] = sum(timer.wall(
                lambda: mm.sa_matmul_cuda(a32, w), reps=5)
                for a32, w in ((a.float(), w) for a, w in ops_in))
        t["bf16_library"] = sum(timer.wall(lambda: torch.matmul(a, w),
                                           reps=5) for a, w in ops_in)
        out[mr] = t
        route = mm.gemm_route(mr, torch.bfloat16, torch.bfloat16)
        tile = mm.mma_plan(mr, D_MODEL, route)["tile"]
        log(f"sa_matmul tile sweep M={mr:3d}: a layer's 7 forward GEMMs "
            + ", ".join(f"{k_} {v:.4f} ms" for k_, v in t.items())
            + f"; the wrapper takes {route} on the {tile} tile")
    return out


def crossover_times(torch, timer, g):
    """Each distinct GEMM of the path (a layer's N = 1024, 5120 at K =
    5120 and 13824, 13824, and the lm_head) on the `large` and `small`
    tiles, forced, at M = 20 (the verify) to 1024, wall: where `mma_plan`'s
    small-to-large crossover stands against the tiles' times. Returns
    {M: {name: {tile: ms, "plan": tile}}}."""
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import LAYER_GEMMS, LM_HEAD

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gemms = {name: (k, n) for name, k, n, _, _ in LAYER_GEMMS + [LM_HEAD]
             if name in ("wq", "wk", "wg", "wd", "lm_head")}
    out = {}
    for m in (20, 64, 128, 256, 512, 1024):
        row = {}
        for name, (k, n) in gemms.items():
            a = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=g, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            row[name] = {tile: timer.wall(lambda: mm._launch(
                a, w, None, None, "none", "exact", False, tile=tile), reps=5)
                for tile in ("large", "small")}
            row[name]["plan"] = mm.mma_plan(m, n, "mma", sms)["tile"]
            del a, w
        out[m] = row
        log(f"sa_matmul crossover M={m:4d}: " + ", ".join(
            f"{nm} N={gemms[nm][1]} large {r['large']:.4f} small "
            f"{r['small']:.4f} plan {r['plan']}" for nm, r in row.items()))
    torch.cuda.empty_cache()
    return out


def check_gemm_train(torch, timer):
    """The SA GEMM at the training shapes (M = 1024 tokens a microbatch):
    the forward (`mma` route) and, for wg+silu, its raw accumulator; the
    backward GEMMs dA = dY·Wᵀ (fp32 x bf16ᵀ) and dW = Aᵀ·dY (bf16ᵀ x fp32)
    (`split3` route) of every projection and the lm_head, each within
    `error_bound` of the plain version and within `split_check`, which a
    planted backward with dus rounded once to bf16 (no split) must fail;
    the split itself bit for bit. Times: one layer's seven forward GEMMs
    beside bf16 and fp32 torch.matmul and the flop bound, its seven
    backward pairs beside fp32 torch.matmul (TF32 off), the split3 bound
    (3 bf16 products per product at the bf16 peak) and the fp32 SIMT
    bound; then the route threshold's sweep."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import LAYER_GEMMS, LM_HEAD

    # the yardsticks: full fp32 (TF32 would keep 10 mantissa bits) and
    # bf16 accumulated in fp32 throughout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    m = TRAIN_M
    g = torch.Generator(device="cuda").manual_seed(6)
    worst = max_err = 0.0
    dev_ms = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "flops": 0.0, "fwd_ms": 0.0, "fwd_bf16_ms": 0.0,
           "fwd_fp32_ms": 0.0, "fwd_flops": 0.0}
    faults, split_ok = {}, True
    for name, k, n, has_bias, act in LAYER_GEMMS + [LM_HEAD]:
        a = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        bias = (torch.randn((n,), generator=g, device="cuda") * 0.1
                if has_bias else None)
        dus = torch.randn((m, n), generator=g, device="cuda") * n ** -0.5
        ops.reset_counts()
        y, raw = mm.sa_matmul_cuda(a, w, bias, act=act, save_raw=True)
        ref, raw_ref = mm.sa_matmul_ref(a, w, bias, act=act, save_raw=True)
        torch.cuda.synchronize()
        ratios = {"fwd": float(((y - ref).abs()
                                / mm.error_bound(a, w, y=ref)).max())}
        if act != "none":
            ratios["raw"] = float(((raw - raw_ref).abs()
                                   / mm.error_bound(a, w)).max())
        ratios["fwd_split_check"] = mm.split_check(a, w, raw)
        del y, ref, raw, raw_ref
        errs = [0.0]
        got = dict(zip(("dA", "dW"), mm.backward_gemms(a, w, dus)))
        want = dict(zip(("dA", "dW"), mm.backward_gemms_ref(a, w, dus)))
        torch.cuda.synchronize()
        routes = ops.route_counts()["sa_matmul"]
        if routes != {"partial": 0, "mma": 1, "split3": 2, "simt": 0}:
            raise AssertionError(f"sa_matmul {name}: routes {routes}")
        operands = {"dA": (dus, w.t()), "dW": (a.t(), dus)}
        for which, (x, z) in operands.items():
            diff = (got[which] - want[which]).abs()
            errs.append(float(diff.max()))
            if not bool(torch.isfinite(got[which]).all()):
                raise AssertionError(f"sa_matmul_bwd {name} {which}: "
                                     f"non-finite outputs")
            ratios[which] = float((diff / mm.error_bound(x, z)).max())
            ratios[f"{which}_split_check"] = mm.split_check(x, z, got[which])
            del diff
        del got, want
        # planted faults in the kernel's input: dus rounded once to bf16
        # (its split is (hi, 0, 0): a kernel without the split) must fail
        # the split check; the lo piece dropped is reported
        bad = dict(zip(("dA", "dW"), mm.backward_gemms(
            a, w, dus.to(torch.bfloat16).float())))
        planes, _ = mm._split3_planes(dus, n)
        planes[2].zero_()
        no_lo = dict(zip(("dA", "dW"), mm.backward_gemms(a, w, dus,
                                                         planes=planes)))
        del planes
        for which, (x, z) in operands.items():
            faults[f"{name} {which} no split"] = mm.split_check(
                x, z, bad[which])
            faults[f"{name} {which} lo dropped"] = mm.split_check(
                x, z, no_lo[which])
        del bad, no_lo
        split_ok = split_ok and check_split(torch, mm, dus)
        for what, r in ratios.items():
            if not r <= 1.0:
                raise AssertionError(f"sa_matmul {name} M={m} {what}: "
                                     f"err/bound {r:.3f}")
        for which in operands:
            if not faults[f"{name} {which} no split"] > 1.0:
                raise AssertionError(f"split_check passes a backward "
                                     f"without the split ({name} {which})")
        worst = max([worst] + [ratios["dA"], ratios["dW"]])
        max_err = max([max_err] + errs)
        reps = 3
        t_f = timer.wall(lambda: mm.sa_matmul_cuda(a, w, bias, act=act),
                         reps=reps)
        t_fb = timer.wall(lambda: torch.matmul(a, w), reps=reps)
        a32, w32 = a.float(), w.float()
        t_f32 = timer.wall(lambda: torch.matmul(a32, w32), reps=reps)
        t_k = timer.wall(lambda: mm.backward_gemms(a, w, dus), reps=reps)
        d_k = timer.device(lambda: mm.backward_gemms(a, w, dus), reps=reps)
        t_p = timer.wall(lambda: mm.backward_gemms_ref(a, w, dus), reps=reps)
        t_l = timer.wall(lambda: (torch.matmul(dus, w32.t()),
                                  torch.matmul(a32.t(), dus)), reps=reps)
        del a32, w32
        # dA reads dY and W, writes (M, K); dW reads A and dY, writes (K, N)
        nbytes = (4 * m * n + 2 * k * n + 4 * m * k) + (
            2 * m * k + 4 * m * n + 4 * k * n)
        flops = 2 * 2.0 * m * n * k
        b3, _ = bound_ms(nbytes, 3 * flops, PEAK_BF16)
        b32, _ = bound_ms(nbytes, flops, PEAK_FP32)
        f_fl = 2.0 * m * n * k
        log(f"sa_matmul train {name:8s} M={m} K={k:5d} N={n:6d}: err/bound "
            + " ".join(f"{w_}={r:.4f}" for w_, r in ratios.items())
            + f"; fwd {t_f:.3f} ms ({f_fl / t_f / 1e9:.1f} TFLOP/s, bf16 "
            f"torch.matmul {t_fb:.3f}, fp32 {t_f32:.3f}); bwd dA+dW "
            f"{t_k:.3f} ms (device {d_k}; {3 * flops / t_k / 1e9:.1f} bf16 "
            f"TFLOP/s), plain "
            f"{t_p:.3f} ms, fp32 torch.matmul {t_l:.3f} ms, split3 bound "
            f"{b3:.3f} ms, fp32 SIMT bound {b32:.3f} ms")
        if name != "lm_head":
            dev_ms = (None if d_k is None or dev_ms is None
                      else dev_ms + d_k)
            for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                           ("bytes", nbytes), ("flops", flops),
                           ("fwd_ms", t_f), ("fwd_bf16_ms", t_fb),
                           ("fwd_fp32_ms", t_f32), ("fwd_flops", f_fl)):
                tot[key] += v
        else:
            lm = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p,
                  "library_ms": t_l,
                  "bound_split3_ms": b3, "bound_simt_ms": b32,
                  "fwd_ms": t_f, "fwd_bf16_ms": t_fb, "fwd_fp32_ms": t_f32}
        del a, w, bias, dus
        gc.collect()
        torch.cuda.empty_cache()
    log("split_check planted faults (> 1 rejects): " + ", ".join(
        f"{k_} {v:.3f}" for k_, v in faults.items()))
    if not split_ok:
        raise AssertionError("the kernel's split is not split3_ref's, or "
                             "does not reconstruct dus")
    log("split3 pre-pass: bit for bit split3_ref on every dus and the "
        "planted values, hi + mid + lo == x exactly")
    sweep = sweep_routes(torch, timer, g)
    crossover = crossover_times(torch, timer, g)
    b_ms, by = bound_ms(tot["bytes"], 3 * tot["flops"], PEAK_BF16)
    b32, _ = bound_ms(tot["bytes"], tot["flops"], PEAK_FP32)
    f_ms, _ = bound_ms(0, tot["fwd_flops"], PEAK_BF16)
    # the forward again through forward_times (wall and device, the
    # lm_head too), beside both of the large tile's bounds: the tensor
    # cores' flops, and the step sums' adds (one FADD an output a k16
    # step) at the card's issue rate
    fwd = forward_times(torch, timer, g)
    lay, lmf = fwd["layer"], fwd["lm_head"]
    rate = issue_rate(torch)
    fadd_ms = tot["fwd_flops"] / 2 / 16 / rate * 1e3
    _, lk, ln, _, _ = LM_HEAD
    lm_fl = 2.0 * m * ln * lk
    lm_b, lm_by = bound_ms(2 * (m * lk + lk * ln) + 4 * m * ln, lm_fl,
                           PEAK_BF16)
    lm_fadd = lm_fl / 2 / 16 / rate * 1e3
    log(f"sa_matmul forward at M={m} (the large tile on wgmma where it "
        f"fills the card): one layer's 7 GEMMs {lay['ms']:.4f} ms wall, "
        f"{lay['device_ms']} ms device (flop bound {f_ms:.4f} ms, FADD "
        f"bound {fadd_ms:.4f} ms; bf16 torch.matmul {lay['library_ms']:.4f}"
        f" ms; plain {lay['plain_ms']:.4f} ms); lm_head {lmf['ms']:.4f} ms "
        f"wall, {lmf['device_ms']} ms device (bound {lm_b:.4f} ms by "
        f"{lm_by}, FADD bound {lm_fadd:.4f} ms; bf16 torch.matmul "
        f"{lmf['library_ms']:.4f} ms; plain {lmf['plain_ms']:.4f} ms)")
    log(f"sa_matmul train: one layer's 7 GEMMs at M={m}: forward "
        f"{tot['fwd_ms']:.3f} ms ({tot['fwd_flops'] / tot['fwd_ms'] / 1e9:.1f}"
        f" TFLOP/s, {100 * f_ms / tot['fwd_ms']:.1f} % of its {f_ms:.3f} ms "
        f"flop bound; bf16 torch.matmul {tot['fwd_bf16_ms']:.3f} ms, fp32 "
        f"{tot['fwd_fp32_ms']:.3f} ms), backward {tot['ms']:.3f} ms "
        f"(device {dev_ms} ms; split3 "
        f"bound {b_ms:.3f} ms, fp32 SIMT bound {b32:.3f} ms; fp32 "
        f"torch.matmul {tot['library_ms']:.3f} ms); lm_head pair "
        f"{lm['ms']:.3f} ms (fp32 torch.matmul {lm['library_ms']:.3f}); "
        f"backward max err/bound {worst:.4f}")
    readings = {"forward_M1024": {
        "ms": lay["ms"], "device_ms": lay["device_ms"],
        "library_ms": lay["library_ms"],
        "library_fp32_ms": tot["fwd_fp32_ms"], "bound_ms": f_ms,
        "bound_by": "operations", "fadd_bound_ms": fadd_ms},
        "lm_head_fwd_M1024": dict(lmf, bound_ms=lm_b, bound_by=lm_by,
                                  fadd_bound_ms=lm_fadd,
                                  library_fp32_ms=lm["fwd_fp32_ms"]),
        "lm_head_pair": lm,
        "bound_simt_ms": b32, "split_check_faults": faults,
        "route_sweep_ms": sweep, "tile_crossover_ms": crossover}
    return {"name": "sa_matmul_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sa_matmul.cu",
            "replaces": "src/repro/kernels/sa_matmul.py:244",
            "max_abs_err": max_err, "err_over_bound": worst,
            "ms": tot["ms"], "device_ms": dev_ms, "plain_ms": tot["plain_ms"],
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": tot["library_ms"], "readings": readings,
            "timed": f"one decoder layer's 7 backward GEMM pairs (dA + dW) "
                     f"at M={m}, summed, split3 route; bound: 3 bf16 "
                     f"products per product at the bf16 peak (fp32 SIMT "
                     f"bound in readings); library: fp32 torch.matmul"}


FOLD_M = (1, 4, 7, 8, 20, 1024)


def _fold_where(mm, m, n, k, dt):
    """Where a GEMM of m rows runs: the `mma` tile, or the fp32 route with
    its K slices and parts (the same at every m)."""
    route = mm.gemm_route(m, dt, dt)
    if route == "mma":
        return mm.mma_plan(m, n, route)["tile"]
    p = mm.fp32_launch(m, n, k, route)
    return f"{route} {p['slices']}x{p['slice']}/{p['parts']}"


def check_fold(torch, timer):
    """ROADMAP F2 and F2b at full width: each row of a GEMM of the path
    (the 7 layer shapes with their bias and activation, one with approx and
    a scale on the card, and the lm_head) is bit-identical at M = 1, 4, 7,
    8, 20 and 1024, raw accumulator included: bf16 x bf16 on the decode,
    small and large tiles, fp32 x fp32 on `partial` (M < 8) and `simt`
    (the fp32 policy); a slot's paged decode is bit-identical at B = 4 and
    inside B = 20 with the same block-table width (serve shape on an fp32
    and a bf16 pool, 2048-token slots). Any mismatch raises. Returns paged
    decode's times above the serve's batch (`batch_fold_ms`)."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import sa_decode_attention as da
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import LAYER_GEMMS, LM_HEAD

    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [(n, k, nn, b, act, "exact", None) for n, k, nn, b, act in
             LAYER_GEMMS + [LM_HEAD]]
    cases.append(("wk+gelu+approx+dev scale", D_MODEL, 8 * 128, True, "gelu",
                  "approx", "dev"))
    for dt in (torch.bfloat16, torch.float32):
        for name, k, n, has_bias, act, mode, scale in cases:
            a = torch.randn((max(FOLD_M), k), generator=g, device="cuda").to(
                dt)
            w = (torch.randn((k, n), generator=g, device="cuda")
                 * k ** -0.5).to(dt)
            bias = (torch.randn((n,), generator=g, device="cuda") * 0.1
                    if has_bias else None)
            if scale == "dev":
                scale = torch.tensor(0.5, device="cuda")
            full, full_raw = mm.sa_matmul_cuda(a, w, bias, scale, act=act,
                                               mode=mode, save_raw=True)
            where = {}
            for m in FOLD_M[:-1]:
                y, raw = mm.sa_matmul_cuda(a[:m], w, bias, scale, act=act,
                                           mode=mode, save_raw=True)
                same = (torch.equal(y.view(torch.int32),
                                    full[:m].view(torch.int32))
                        and torch.equal(raw.view(torch.int32),
                                        full_raw[:m].view(torch.int32)))
                where[m] = _fold_where(mm, m, n, k, dt)
                if not same:
                    raise AssertionError(
                        f"fold: sa_matmul {name} ({dt}) rows at M={m} differ "
                        f"from the same rows at M={max(FOLD_M)}")
            where[max(FOLD_M)] = _fold_where(mm, max(FOLD_M), n, k, dt)
            log(f"[fold] sa_matmul {str(dt)[6:]:8s} {name:26s} K={k:5d} "
                f"N={n:6d}: rows bit-identical at M={FOLD_M} ({where})")
            del a, w, full, full_raw
            torch.cuda.empty_cache()
    KVH, grp, hd, psz = 8, 5, 128, PAGE
    for slot, pool in ((CACHE_LEN, torch.float32), (CACHE_LEN, torch.bfloat16),
                       (2048, torch.float32)):
        P = -(-slot // psz)
        lens = [slot, 100, 40, 0] + [(37 * i) % slot + 1 for i in range(16)]
        q, k, v, pp, bt, pos = _paged_workload(torch, g, 20, KVH, grp, hd,
                                               psz, P, 20 * P + 1, lens)
        k, v = k.to(pool), v.to(pool)
        y20 = da.paged_decode_cuda(q, k, v, pp, bt, pos)
        y4 = da.paged_decode_cuda(q[:4], k, v, pp, bt[:4], pos[:4])
        torch.cuda.synchronize()
        plan4 = da.launch_plan(q[:4], k, v, bt[:4])
        if (not torch.equal(y4.view(torch.int32), y20[:4].view(torch.int32))
                or plan4 != da.launch_plan(q, k, v, bt)):
            raise AssertionError(f"fold: paged decode slots at B=4 differ "
                                 f"from the same slots at B=20 ({slot}-token "
                                 f"slots, {pool} pool)")
        log(f"[fold] paged decode {slot}-token slots, {pool} pool: B=4 "
            f"bit-identical to the same slots inside B=20 ({plan4.n_split} "
            f"blocks a cluster at both)")
        del q, k, v, pp, bt, pos, y4, y20
    # what the slot-only cluster costs above the serve's batch, against the
    # earlier batch-sized plan (two blocks an SM over the B·KVH clusters:
    # 2 blocks at B = 20, 1 at B = 64), full slots, fp32 pool
    H = KVH * grp
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {}
    for slot in (CACHE_LEN, 2048):
        P = -(-slot // psz)
        for B in (BATCH, 20, 64):
            q, k, v, pp, bt, pos = _paged_workload(
                torch, g, B, KVH, grp, hd, psz, P, B * P + 1, [slot] * B)
            plan = da.launch_plan(q, k, v, bt)
            old = da.launch_plan(q, k, v, bt, n_split=max(1, min(
                da.PORTABLE_CLUSTER, -(-2 * sms // (B * KVH))))).n_split
            row = {"n_split": plan.n_split, "earlier_n_split": old}
            for key, n_split in (("", None), ("earlier_", old)):
                def run():
                    return da.paged_decode_cuda(q, k, v, pp, bt, pos,
                                                n_split=n_split)
                row[key + "ms"] = timer.wall(run)
                row[key + "device_ms"] = timer.device(run)
            row["bound_ms"], row["bound_by"] = _decode_bound(
                torch, bt, B, H, KVH, hd, psz, P, PrecisionPolicy())
            # the yardstick: SDPA on the gathered dense view
            row["library_ms"] = timer.wall(_sdpa_gathered(
                torch, q, k, v, pp, bt, pos, grp))
            row["plain_ms"] = timer.wall(lambda: da.paged_decode_ref(
                q, k, v, pp, bt, pos))
            times[f"B{B}_slots{slot}"] = row
            log(f"[fold] paged decode B={B}, {slot}-token slots: "
                f"{plan.n_split} blocks a cluster {row['ms']:.4f} ms wall "
                f"({row['device_ms']} device); the earlier plan's {old} "
                f"blocks {row['earlier_ms']:.4f} ms "
                f"({row['earlier_device_ms']} device); bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}); SDPA on "
                f"the gathered view {row['library_ms']:.4f} ms; plain "
                f"{row['plain_ms']:.4f} ms")
            del q, k, v, pp, bt, pos
    return times


def decode_times(torch, timer, g):
    """The paged decode's times on its own plan (`paged_decode_cuda`, no
    n_split given), full slots, g = 5, hd 128, page 16: B = 4 and 64 at
    the serve shape (144-token slots), B = 4 at 2048-token slots with an
    fp32 and a bf16 pool; ms wall and device. `tools/chip_ab.py --what
    decode` runs it against another checkout's port."""
    from repro_torch.kernels import sa_decode_attention as da

    KVH, grp, hd, psz = 8, 5, 128, PAGE
    out = {}
    for slot, B, pool in ((CACHE_LEN, BATCH, torch.float32),
                          (CACHE_LEN, 64, torch.float32),
                          (2048, BATCH, torch.float32),
                          (2048, BATCH, torch.bfloat16)):
        P = -(-slot // psz)
        q, k, v, pp, bt, pos = _paged_workload(
            torch, g, B, KVH, grp, hd, psz, P, B * P + 1, [slot] * B)
        k, v = k.to(pool), v.to(pool)

        def run():
            return da.paged_decode_cuda(q, k, v, pp, bt, pos)
        key = f"B{B}_slots{slot}_{str(pool).split('.')[-1]}"
        out[key] = {"ms": timer.wall(run), "device_ms": timer.device(run)}
        del q, k, v, pp, bt, pos
    return out


def _paged_workload(torch, g, B, KVH, grp, hd, psz, P, n_pages, lens):
    """A pool with slot b owning ceil(lens[b] / psz) pages (0 = an empty
    slot with an unmapped row), one explicit trash-page (0) entry, and
    recycled pages carrying stale positions."""
    H = KVH * grp
    q = torch.randn((B, 1, H, hd), generator=g, device="cuda")
    k = torch.randn((n_pages, psz, KVH, hd), generator=g, device="cuda")
    v = torch.randn((n_pages, psz, KVH, hd), generator=g, device="cuda")
    pp = torch.randint(0, 4 * psz, (n_pages, psz), generator=g,
                       device="cuda", dtype=torch.int32)
    bt = torch.full((B, P), -1, dtype=torch.int32, device="cuda")
    pos = torch.zeros((B,), dtype=torch.int32, device="cuda")
    nxt = 1
    for b, n in enumerate(lens):
        npg = -(-n // psz)
        for j in range(npg):
            bt[b, j] = nxt
            pp[nxt] = torch.arange(j * psz, (j + 1) * psz, device="cuda")
            nxt += 1
        pos[b] = max(n - 1, 0)
    if lens[0] > psz:
        bt[0, 1] = 0          # an explicit trash-page entry: masked
    return q, k, v, pp, bt, pos


def ptxas_summary(name: str) -> str:
    """Registers and spills of each entry function of kernel source
    `name` (every library built from it), from the build phase's
    `-Xptxas -v` report."""
    import re

    from repro_torch.kernels import build

    rep = "\n".join(r for lib, r in build.REPORTS.items()
                    if build.LIBRARIES[lib][0] == name)
    if not rep:
        return "(no ptxas report: the library was not built in this process)"
    out, entry, spills = [], None, ""
    for line in rep.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # _ZN<n>_GLOBAL__N__<hash>_<n>_<file>_cu_<8 hex><n><kernel>I<args>E
            mangled = m.group(1)
            mk = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            if mk:
                n0 = mk.end()
                kname = mangled[n0:n0 + int(mk.group(1))]
                targs = re.match(r"I(.*?)EE", mangled[n0 + len(kname):])
                entry = kname + (f"<{targs.group(1)}>" if targs else "")
            else:
                entry = mangled[:48]
            spills = ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            spills = f", spills {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append(f"{entry}: {m.group(1)} regs{spills}")
            entry = None
    return "; ".join(out)


def _sdpa_gathered(torch, q, k, v, pp, bt, pos, grp):
    """SDPA on the gathered dense view of a paged pool (the yardstick)."""
    kg, vg, pg = _gathered(torch, k, v, pp, bt)
    mask = ((pg >= 0) & (pg <= pos[:, None]))[:, None, None, :]
    qs = q.transpose(1, 2)                     # (B, H, 1, hd)
    kh = kg.transpose(1, 2).repeat_interleave(grp, 1)
    vh = vg.transpose(1, 2).repeat_interleave(grp, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qs, kh, vh, attn_mask=mask)


def _decode_bound(torch, bt, B, H, KVH, hd, psz, P, pol, pool_bytes=4,
                  min_page=1):
    mapped = int((bt >= min_page).sum())
    nbytes = (4 * B * H * hd * 2 + mapped * psz * KVH * hd * pool_bytes * 2
              + mapped * psz * 4 + 4 * B * P + 4 * B)
    flops = 4.0 * H * mapped * psz * hd     # q.k and p.v
    return bound_ms(nbytes, flops, peak_flops(pol))


def check_decode(torch, timer):
    """Paged decode against its plain version within `error_bound` under
    every policy the serve path can take, each bound rejecting two planted
    faults; the split at several cluster sizes (boundaries inside and
    between pages), bit-identical repeats, a 12,288-token slot; times at
    the serve shape and at 2048-token slots."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_decode_attention as da

    KVH, grp, hd, psz = 8, 5, 128, PAGE
    H = KVH * grp
    P = -(-CACHE_LEN // psz)
    n_pages = -(-BATCH * CACHE_LEN // psz) + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    lens = [CACHE_LEN, 100, 40, 0]            # slot 3: all masked
    cases = [("default", {}, PrecisionPolicy()),
             ("softcap+window", {"cap": 50.0, "window": 64},
              PrecisionPolicy()),
             ("approx", {}, PrecisionPolicy(mode="approx")),
             ("fp32", {}, PrecisionPolicy(input_format="fp32")),
             ("fp16", {}, PrecisionPolicy(input_format="fp16")),
             # 16-bit pools (ServeEngine(cache_dtype=)): a bf16 pool under
             # the bf16 policy must give the fp32 pool's output bit for bit
             ("bf16 pool", {}, PrecisionPolicy()),
             ("fp16 pool", {}, PrecisionPolicy(input_format="fp16")),
             ("bf16 pool approx", {"cap": 50.0, "window": 64},
              PrecisionPolicy(mode="approx"))]
    pools = {"bf16 pool": torch.bfloat16, "fp16 pool": torch.float16,
             "bf16 pool approx": torch.bfloat16}
    worst = max_err = 0.0
    out, readings = {}, {}
    log(f"[paged decode] build: {ptxas_summary('sa_decode_attention')}")
    for name, kw, pol in cases:
        q, k, v, pp, bt, pos = _paged_workload(torch, g, BATCH, KVH, grp, hd,
                                               psz, P, n_pages, lens)
        same = ""
        if name in pools:
            y32 = ops.paged_decode_attention(q, k, v, pp, bt, pos, policy=pol,
                                             **kw)
            k, v = k.to(pools[name]), v.to(pools[name])
        y = ops.paged_decode_attention(q, k, v, pp, bt, pos, policy=pol, **kw)
        if name in pools:
            same = torch.equal(y.view(torch.int32), y32.view(torch.int32))
            # the same bits where the pool holds the policy's own type
            cast = {"bf16": torch.bfloat16, "fp16": torch.float16}.get(
                pol.input_format)
            if (pools[name] == cast) != same:
                raise AssertionError(f"paged decode {name}: bit-identical "
                                     f"to the fp32 pool: {same}")
            same = f" bit-identical to the fp32 pool {same};"
        ref = da.paged_decode_ref(q, k, v, pp, bt, pos, policy=pol, **kw)
        torch.cuda.synchronize()
        err = (y - ref).abs()
        bnd = da.error_bound(q, k, v, pp, bt, pos, policy=pol, **kw)
        ratio = float((err / bnd).max())
        if not torch.isfinite(y).all() or ratio > 1.0:
            raise AssertionError(f"paged decode {name}: max err "
                                 f"{float(err.max()):.3e} exceeds its bound")
        if float(y[3].abs().max()) != 0.0:
            raise AssertionError("paged decode: an all-masked slot must "
                                 "give zeros")
        worst, max_err = max(worst, ratio), max(max_err, float(err.max()))
        plan = da.split_plan(grp, hd, psz, P)
        log(f"paged decode {name:16s} B={BATCH} H={H} KVH={KVH} "
            f"hd={hd} P={P} psz={psz} max_err={float(err.max()):.3e} "
            f"err/bound={ratio:.4f} median bound {float(bnd.median()):.3e};"
            f"{same} grid ({BATCH}, {KVH}, {plan.n_split}), cluster (1, 1, "
            f"{plan.n_split}), {plan.keys_per_cta} keys a block, "
            f"{plan.smem} B shared")
        # planted faults, each in the plain version: the kernel's output
        # must land outside the bound of each
        faults = {"mask_off_by_one": dict(pos=pos - 1),
                  "last_page_dropped": dict(bt=_drop_last_page(torch, bt))}
        for fault, change in faults.items():
            args = dict(q=q, k_pool=k, v_pool=v, page_positions=pp,
                        block_table=change.get("bt", bt),
                        pos=change.get("pos", pos))
            bad = da.paged_decode_ref(**args, policy=pol, **kw)
            r = float(((y - bad).abs() / bnd).max())
            log(f"  planted fault {fault}: kernel vs faulty plain, "
                f"err/bound {r:.1f}")
            if not r > 1.0:
                raise AssertionError(f"paged decode bound does not reject "
                                     f"the planted fault {fault}")
        if name != "default":
            continue
        # the split: runs of 144 and 48 keys (ends on page boundaries), 24
        # (ends inside pages) and 16 (9 blocks, a non-portable cluster);
        # each within the bound, each call bit-identical to its repeat
        for n in (1, 3, 6, 16):
            sp = da.split_plan(grp, hd, psz, P, n_split=n)
            y1 = da.paged_decode_cuda(q, k, v, pp, bt, pos, n_split=n)
            y2 = da.paged_decode_cuda(q, k, v, pp, bt, pos, n_split=n)
            torch.cuda.synchronize()
            r = float(((y1 - ref).abs() / bnd).max())
            same = torch.equal(y1.view(torch.int32), y2.view(torch.int32))
            log(f"  split n_split={n} -> {sp.n_split} blocks of "
                f"{sp.keys_per_cta} keys: err/bound {r:.4f}, repeat "
                f"bit-identical {same}")
            if not (r <= 1.0 and same):
                raise AssertionError(f"paged decode split {n}: err/bound {r}"
                                     f", bit-identical {same}")
            worst = max(worst, r)
        t_k = timer.wall(lambda: ops.paged_decode_attention(
            q, k, v, pp, bt, pos))
        d_k = timer.device(lambda: ops.paged_decode_attention(
            q, k, v, pp, bt, pos))
        t_p = timer.wall(lambda: da.paged_decode_ref(q, k, v, pp, bt, pos))
        lib = _sdpa_gathered(torch, q, k, v, pp, bt, pos, grp)
        t_l, d_l = timer.wall(lib), timer.device(lib)
        b_ms, by = _decode_bound(torch, bt, BATCH, H, KVH, hd, psz, P, pol)
        log(f"paged decode times (B={BATCH}, {CACHE_LEN}-token slots): "
            f"kernel {t_k:.4f} ms (device {d_k}), plain {t_p:.4f} ms, SDPA "
            f"on the gathered view {t_l:.4f} ms (device {d_l}), bound "
            f"{b_ms:.5f} ms ({by}, {100 * b_ms / t_k:.1f} % of it)")
        out = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p,
               "library_ms": t_l, "bound_ms": b_ms, "bound_by": by}
        readings["serve_shape_library_device_ms"] = d_l
        del q, k, v, pp, bt, pos, y, ref, bnd

    # long slots: 12,288 tokens (beyond one block's shared memory, the
    # earlier kernel's limit) against the plain version, then the 2048-token
    # reading at B = 4 where the bytes bound the call
    pol = PrecisionPolicy()
    for slot, lens_l in ((12288, [12288, 5000, 0, 2049]),
                         (2048, [2048] * BATCH)):
        Pl = -(-slot // psz)
        q, k, v, pp, bt, pos = _paged_workload(
            torch, g, BATCH, KVH, grp, hd, psz, Pl, BATCH * Pl + 1, lens_l)
        sp = da.split_plan(grp, hd, psz, Pl)
        y = ops.paged_decode_attention(q, k, v, pp, bt, pos)
        y2 = ops.paged_decode_attention(q, k, v, pp, bt, pos)
        ref = da.paged_decode_ref(q, k, v, pp, bt, pos)
        torch.cuda.synchronize()
        bnd = da.error_bound(q, k, v, pp, bt, pos)
        r = float(((y - ref).abs() / bnd).max())
        same = torch.equal(y.view(torch.int32), y2.view(torch.int32))
        line = (f"paged decode {slot}-token slots (lens {lens_l}): err/bound "
                f"{r:.4f}, repeat bit-identical {same}; grid ({BATCH}, {KVH},"
                f" {sp.n_split}), cluster (1, 1, {sp.n_split}), "
                f"{sp.keys_per_cta} keys a block, {sp.smem} B shared")
        if not (r <= 1.0 and same and bool(torch.isfinite(y).all())):
            raise AssertionError(line)
        worst = max(worst, r)
        del ref, bnd, y2
        if slot == 2048:
            t_k = timer.wall(lambda: ops.paged_decode_attention(
                q, k, v, pp, bt, pos))
            d_k = timer.device(lambda: ops.paged_decode_attention(
                q, k, v, pp, bt, pos))
            # the cluster size: the plan's against others
            sweep = {n: timer.wall(lambda: da.paged_decode_cuda(
                q, k, v, pp, bt, pos, n_split=n)) for n in (4, 8, 12, 16)}
            log("paged decode 2048-token slots by cluster size: " + ", ".join(
                f"n_split {n} {ms:.4f} ms" for n, ms in sweep.items()))
            t_l = timer.wall(_sdpa_gathered(torch, q, k, v, pp, bt, pos, grp))
            b_ms, by = _decode_bound(torch, bt, BATCH, H, KVH, hd, psz, Pl,
                                     pol)
            line += (f"; kernel {t_k:.4f} ms (device {d_k}), SDPA on the "
                     f"gathered view {t_l:.4f} ms, bound {b_ms:.5f} ms "
                     f"({by}): {100 * b_ms / t_k:.1f} % of the bound")
            readings["slots_2048"] = {"ms": t_k, "device_ms": d_k,
                                      "library_ms": t_l, "bound_ms": b_ms,
                                      "bound_by": by, "n_split_ms": sweep}
            # the same slots in a bf16 pool: half the bytes, the same bits
            k16, v16 = k.to(torch.bfloat16), v.to(torch.bfloat16)
            y16 = ops.paged_decode_attention(q, k16, v16, pp, bt, pos)
            same16 = torch.equal(y16.view(torch.int32), y.view(torch.int32))
            if not same16:
                raise AssertionError("paged decode 2048-token slots: the "
                                     "bf16 pool differs from the fp32 pool")
            t_16 = timer.wall(lambda: ops.paged_decode_attention(
                q, k16, v16, pp, bt, pos))
            t_l16 = timer.wall(_sdpa_gathered(torch, q.to(torch.bfloat16),
                                              k16, v16, pp, bt, pos, grp))
            b16, by16 = _decode_bound(torch, bt, BATCH, H, KVH, hd, psz, Pl,
                                      pol, pool_bytes=2)
            line += (f"; bf16 pool: bit-identical {same16}, kernel "
                     f"{t_16:.4f} ms, SDPA (bf16) {t_l16:.4f} ms, bound "
                     f"{b16:.5f} ms ({by16}): {100 * b16 / t_16:.1f} % of "
                     f"the bound")
            readings["slots_2048_bf16_pool"] = {
                "ms": t_16, "library_ms": t_l16, "bound_ms": b16,
                "bound_by": by16}
            del k16, v16, y16
        log(line)
        del q, k, v, pp, bt, pos, y
        gc.collect()
        torch.cuda.empty_cache()
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sa_decode_attention.cu",
            "replaces": "src/repro/kernels/sa_decode_attention.py:94",
            "max_abs_err": max_err, "err_over_bound": worst, **out,
            "readings": readings,
            "timed": f"one layer's decode step, B={BATCH}, "
                     f"{CACHE_LEN}-token slots, pool fp32"}


def check_decode_lse(torch, timer):
    """The decode kernel's log-sum-exp output (the batch-1 ring whose rows
    split over `data`), held against its plain twin at the serve
    shape under the bf16 and fp32 policies and the approx mode, fp32 and
    bf16 pools: the lse within `lse_error_bound`, the output within
    `error_bound` and bit-identical to the call without the lse, the fully
    masked slot -inf and zeros; the fold of each slot's two halves of keys
    (`layers.fold_partials`) against the whole kernel within
    `error_bound(folded=True)`, a fully masked half folding to the other
    half bit for bit. Then the batch-1 ring at (2, 2) as the main path
    reads it (each data rank's 2048-row block of the 4096-row ring at
    model 2: g = 5, 4 KV heads, an fp32 ring through `dense_pool_view`,
    min_page=0): each rank's (out, lse) against its twin, their fold
    against the whole ring's decode; rank 0's timed with and without the
    lse, its plain twin, the library's SDPA with its log-sum-exp, and the
    fold of two ranks' (out, lse) (the elementwise ops; the all-gather
    beside them runs on gloo in the world and is not timed here). Returns
    the entry of the JSON line."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import sa_decode_attention as da
    from repro_torch.models.layers import fold_partials

    KVH, grp, hd, psz = 8, 5, 128, PAGE
    H = KVH * grp
    P = -(-CACHE_LEN // psz)
    n_pages = -(-BATCH * CACHE_LEN // psz) + 1
    g = torch.Generator(device="cuda").manual_seed(33)
    lens = [CACHE_LEN, 100, 40, 0]            # slot 3: all masked
    worst = max_err = 0.0
    for name, pol, pool in (
            ("bf16", PrecisionPolicy(), torch.float32),
            ("bf16 pool", PrecisionPolicy(), torch.bfloat16),
            ("approx", PrecisionPolicy(mode="approx"), torch.float32),
            ("fp32", PrecisionPolicy(input_format="fp32"), torch.float32)):
        q, k, v, pp, bt, pos = _paged_workload(torch, g, BATCH, KVH, grp, hd,
                                               psz, P, n_pages, lens)
        k, v = k.to(pool), v.to(pool)
        o, lse = da.paged_decode_cuda(q, k, v, pp, bt, pos, policy=pol,
                                      lse=True)
        plain = da.paged_decode_cuda(q, k, v, pp, bt, pos, policy=pol)
        o_ref, lse_ref = da.paged_decode_ref(q, k, v, pp, bt, pos,
                                             policy=pol, lse=True)
        torch.cuda.synchronize()
        same = torch.equal(o.view(torch.int32), plain.view(torch.int32))
        r_o = float(((o - o_ref).abs() / da.error_bound(
            q, k, v, pp, bt, pos, policy=pol)).max())
        live = torch.isfinite(lse_ref)
        lb = da.lse_error_bound(q, k, v, pp, bt, pos, policy=pol)
        d_l = (lse - lse_ref).abs()[live]
        r_l = float((d_l / lb[live]).max())
        masked = (not torch.isfinite(lse[3]).any() and not o[3].any()
                  and bool(live[:3].all()))
        # the fold of each slot's two halves of keys against the whole
        halves = []
        for part in range(2):
            t = bt.clone()
            for b in range(BATCH):
                n = int(pos[b]) // psz + 1
                if part == 0:
                    t[b, n // 2:] = -1
                else:
                    t[b, :n // 2] = -1
            halves.append(da.paged_decode_cuda(q, k, v, pp, t, pos,
                                               policy=pol, lse=True))
        folded = fold_partials(torch.stack([h[0] for h in halves]),
                               torch.stack([h[1] for h in halves]))
        r_f = float(((folded - plain).abs() / da.error_bound(
            q, k, v, pp, bt, pos, policy=pol, folded=True)).max())
        e_f = float((folded - plain).abs().max())
        empty = da.paged_decode_cuda(q, k, v, pp, torch.full_like(bt, -1),
                                     pos, policy=pol, lse=True)
        alone = fold_partials(torch.stack([empty[0], o]),
                              torch.stack([empty[1], lse]))
        alone_same = torch.equal(alone.view(torch.int32),
                                 o.view(torch.int32))
        line = (f"paged decode lse {name}: out err/bound {r_o:.4f}, the "
                f"same bits as without the lse {same}; lse max err "
                f"{float(d_l.max()):.3e}, err/bound {r_l:.4f}; masked slot "
                f"-inf and zeros {masked}; two halves folded against the "
                f"whole: max err {e_f:.3e}, err/bound (folded) {r_f:.4f}; a "
                f"fully masked half folds to the other bit for bit "
                f"{alone_same}")
        log(line)
        if not (same and masked and alone_same and max(r_o, r_l, r_f) <= 1.0
                and bool(torch.isfinite(folded).all())):
            raise AssertionError(line)
        worst = max(worst, r_o, r_l, r_f)
        max_err = max(max_err, float((o - o_ref).abs().max()),
                      float(d_l.max()), e_f)
        del q, k, v, pp, bt, pos, o, lse, plain, o_ref, lse_ref, halves
    # the batch-1 ring's decode a layer on each data rank at (2, 2), as
    # `layers._ring_decode_split` runs it: the rank's 2048-row block of the
    # 4096-row ring (g = 5, 4 KV heads at model 2, hd 128, an fp32 ring)
    # read through `dense_pool_view` with min_page=0, the query at
    # position 2063: rank 0's block full, rank 1's the 16 rows past it
    # and masked beyond; each held against its twin, their fold against
    # the whole ring's decode, rank 0's timed
    kvh1, rows, qpos = 4, 2048, 2048 + 15
    q = torch.randn((1, 1, kvh1 * grp, hd), generator=g, device="cuda")
    kr, vr = (torch.randn((1, 2 * rows, kvh1, hd), generator=g,
                          device="cuda") for _ in range(2))
    ids = torch.arange(2 * rows, dtype=torch.int32, device="cuda")
    pr = torch.where(ids <= qpos, ids, -1)[None]
    pos = torch.tensor([qpos], dtype=torch.int32, device="cuda")
    pol = PrecisionPolicy()
    views = [da.dense_pool_view(kr[:, i * rows:(i + 1) * rows].contiguous(),
                                vr[:, i * rows:(i + 1) * rows].contiguous(),
                                pr[:, i * rows:(i + 1) * rows].contiguous(),
                                psz) for i in range(2)]
    parts, errs = [], []
    for i, view in enumerate(views):
        o, lse = da.paged_decode_cuda(q, *view, pos, min_page=0, lse=True)
        o_ref, lse_ref = da.paged_decode_ref(q, *view, pos, min_page=0,
                                             lse=True)
        r_o = float(((o - o_ref).abs() / da.error_bound(
            q, *view, pos, min_page=0)).max())
        r_l = float(((lse - lse_ref).abs() / da.lse_error_bound(
            q, *view, pos, min_page=0)).max())
        line = (f"paged decode lse, data rank {i}'s block of the batch-1 "
                f"ring at (2, 2): out err/bound {r_o:.4f}, lse err/bound "
                f"{r_l:.4f}")
        log(line)
        if not (max(r_o, r_l) <= 1.0 and bool(torch.isfinite(lse).all())):
            raise AssertionError(line)
        errs += [r_o, r_l]
        max_err = max(max_err, float((o - o_ref).abs().max()),
                      float((lse - lse_ref).abs().max()))
        parts.append((o, lse))
    whole = da.dense_pool_view(kr, vr, pr, psz)
    ring = da.paged_decode_cuda(q, *whole, pos, min_page=0)
    folded = fold_partials(torch.stack([p[0] for p in parts]),
                           torch.stack([p[1] for p in parts]))
    e_f = float((folded - ring).abs().max())
    r_f = float(((folded - ring).abs() / da.error_bound(
        q, *whole, pos, min_page=0, folded=True)).max())
    line = (f"paged decode lse: the two ranks' blocks folded against the "
            f"whole 4096-row ring: max err {e_f:.3e}, err/bound (folded) "
            f"{r_f:.4f}")
    log(line)
    if not r_f <= 1.0:
        raise AssertionError(line)
    worst = max(worst, r_f, *errs)
    max_err = max(max_err, e_f)
    kp, vp, pp, bt = views[0]

    def with_lse():
        return da.paged_decode_cuda(q, kp, vp, pp, bt, pos, min_page=0,
                                    lse=True)

    def without():
        return da.paged_decode_cuda(q, kp, vp, pp, bt, pos, min_page=0)

    # the two variants in one call, alternated: without, with, with,
    # without; the device times after the wall times
    walls = [timer.wall(fn) for fn in (without, with_lse, with_lse,
                                       without)]
    t_lse, t_no = (walls[1] + walls[2]) / 2, (walls[0] + walls[3]) / 2
    d_lse, d_no = timer.device(with_lse), timer.device(without)
    t_p = timer.wall(lambda: da.paged_decode_ref(q, kp, vp, pp, bt, pos,
                                                 min_page=0, lse=True))
    o, lse = parts[0]
    os_, ls_ = torch.stack([o, o]), torch.stack([lse, lse])
    t_fold = timer.wall(lambda: fold_partials(os_, ls_))
    # the library: one call that returns attention with its log-sum-exp,
    # the memory-efficient SDPA on the block's rows with the KV heads
    # expanded (every row of rank 0's block is live: no mask)
    qs = q.transpose(1, 2)                           # (1, H, 1, hd)
    kh, vh = (x[:, :rows].transpose(1, 2).repeat_interleave(grp, 1)
              for x in (kr, vr))
    eff = torch.ops.aten._scaled_dot_product_efficient_attention

    def library():
        return eff(qs, kh, vh, None, True)

    t_l = timer.wall(library)
    lib_o, lib_lse = library()[:2]
    lib_do = float((lib_o.transpose(1, 2) - o).abs().max())
    lib_dl = float((lib_lse[..., 0].reshape(-1) - lse.reshape(-1)).abs()
                   .max())
    b_ms, by = _decode_bound(torch, bt, 1, kvh1 * grp, kvh1, hd, psz,
                             rows // psz, pol, min_page=0)
    b_ms += 4 * kvh1 * grp / PEAK_BYTES * 1e3     # the lse written
    log(f"paged decode lse, a data rank's block of the batch-1 ring (2048 "
        f"of 4096 rows, g = {grp}, {kvh1} KV heads, fp32 ring, "
        f"dense_pool_view): wall without / with / with / without the lse "
        f"{' / '.join(f'{w:.4f}' for w in walls)} ms, device with "
        f"{d_lse}, without {d_no}; plain twin {t_p:.4f} ms, bound "
        f"{b_ms:.5f} ms ({by}, {100 * b_ms / t_lse:.1f} % of it); the fold "
        f"of two ranks' (out, lse) {t_fold:.4f} ms a layer; library "
        f"(_scaled_dot_product_efficient_attention with its log-sum-exp, "
        f"fp32) {t_l:.4f} ms, its max difference from the kernel: out "
        f"{lib_do:.3e}, lse {lib_dl:.3e} (the kernel rounds to bf16)")
    return {"name": "paged_decode_attention_lse", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sa_decode_attention.cu",
            "replaces": "src/repro/kernels/sa_decode_attention.py:94",
            "max_abs_err": max_err, "err_over_bound": worst, "ms": t_lse,
            "device_ms": d_lse, "plain_ms": t_p, "bound_ms": b_ms,
            "bound_by": by, "library_ms": t_l,
            "readings": {"without_lse_ms": t_no, "without_lse_device_ms":
                         d_no, "walls_alternated_ms": walls,
                         "fold_ms_a_layer": t_fold,
                         "library_max_diff_out": lib_do,
                         "library_max_diff_lse": lib_dl},
            "timed": "one layer's decode on data rank 0's block of the "
                     "batch-1 ring: B=1, 2048 rows, g=5, 4 KV heads, hd "
                     "128, fp32 ring through dense_pool_view (min_page=0), "
                     "with the log-sum-exp output"}


def _drop_last_page(torch, bt):
    """Each slot's last mapped page unmapped."""
    bt = bt.clone()
    for b in range(bt.shape[0]):
        live = (bt[b] > 0).nonzero()
        if len(live):
            bt[b, live[-1]] = -1
    return bt


def _gathered(torch, k, v, pp, bt):
    from repro_torch.models.layers import PagedKVCache, gather_pages
    return gather_pages(PagedKVCache(k, v, pp, bt))


def _prefill_bound(T, S, H, KVH, hd, kv_bytes=4, window=0,
                   peak=PEAK_BF16):
    """(bound ms, by, byte ms, flop ms) of a causal prefill: the (query,
    key) pairs its mask keeps (a window keeps min(t + 1, window) for query
    t), at `peak` flop/s."""
    if window and S == T:
        w = min(window, T)
        pairs = w * (w + 1) / 2 + (T - w) * w
    else:
        pairs = T * (T + 1) / 2 if S == T else T * S
    nbytes = 4 * T * H * hd * 2 + kv_bytes * 2 * S * KVH * hd
    flops = 4.0 * H * pairs * hd
    b_ms, by = bound_ms(nbytes, flops, peak)
    return b_ms, by, nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3


def check_prefill(torch, timer):
    """Prefill attention against its plain version within `error_bound`
    under bf16, fp16 and fp32 (each policy's route counted), with a q view
    laid out as `attention_block` hands it over, and with a planted mask
    one key too wide outside each bound; times at every serve prompt length
    and at T = 1024."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_attention as fa

    H, KVH, hd = 40, 8, 128
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(t, t, {}) for t in PROMPT_LENS]
    cases += [(64, 128, {"q_offset": 64, "window": 48, "cap": 50.0}),
              (17, 17, {}), (200, 200, {"window": 33})]
    pols = {"bf16": PrecisionPolicy(), "fp16": PrecisionPolicy(
        input_format="fp16"), "fp32": PrecisionPolicy(input_format="fp32")}
    worst = max_err = 0.0
    out, readings = {}, {}
    log(f"[prefill attention] build: {ptxas_summary('sa_attention')}")
    for T, S, kw in cases:
        # q as attention_block makes it: a (B, T, H, hd) view of a
        # (B, H, T, hd) tensor
        q = torch.randn((1, H, T, hd), generator=g, device="cuda").transpose(
            1, 2)
        k = torch.randn((1, S, KVH, hd), generator=g, device="cuda")
        v = torch.randn((1, S, KVH, hd), generator=g, device="cuda")
        for fmt, pol in pols.items():
            ops.reset_counts()
            y = ops.sa_attention(q, k, v, policy=pol, **kw)
            routes = ops.route_counts()["prefill_attention"]
            plan = fa.launch_plan(1, T, H, hd, fmt)
            want = {"mma": 0, "simt": 0, plan["route"]: 1}
            if routes != want or plan["route"] != ("simt" if fmt == "fp32"
                                                   else "mma"):
                raise AssertionError(f"prefill {fmt}: routes {routes}")
            ref = fa.flash_attention_ref(q, k, v, policy=pol, **kw)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            bnd = fa.error_bound(q, k, v, policy=pol, **kw)
            ratio = float((err / bnd).max())
            if not torch.isfinite(y).all() or ratio > 1.0:
                raise AssertionError(f"prefill attention T={T} {fmt} {kw}: "
                                     f"max err {float(err.max()):.3e} "
                                     f"exceeds bound (ratio {ratio:.3f})")
            # planted fault in the plain version: a causal mask one key too
            # wide must land outside the bound
            bad = fa.flash_attention_ref(
                q, k, v, policy=pol,
                **{**kw, "q_offset": kw.get("q_offset", 0) + 1})
            r_bad = float(((y - bad).abs() / bnd).max())
            if not r_bad > 1.0:
                raise AssertionError("prefill bound does not reject a causal "
                                     "mask one key too wide")
            worst, max_err = max(worst, ratio), max(max_err,
                                                    float(err.max()))
            log(f"prefill attention T={T:4d} S={S:4d} {fmt} {kw} route "
                f"{plan['route']} grid {plan['grid']} {plan['warps']} warps "
                f"max_err={float(err.max()):.3e} err/bound={ratio:.4f}"
                f" median bound {float(bnd.median()):.3e}; planted fault "
                f"(mask one key too wide) err/bound {r_bad:.1f}")
    # times: every serve prompt length and T = 1024, bf16 policy (the
    # serve's), fp32 q/k/v; SDPA (causal, fp32) as the yardstick
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for T in PROMPT_LENS + (1024,):
        q = torch.randn((1, H, T, hd), generator=g, device="cuda").transpose(
            1, 2)
        k = torch.randn((1, T, KVH, hd), generator=g, device="cuda")
        v = torch.randn((1, T, KVH, hd), generator=g, device="cuda")
        if T == 1024:
            y = ops.sa_attention(q, k, v)
            ref = fa.flash_attention_ref(q, k, v)
            torch.cuda.synchronize()
            r = float(((y - ref).abs() / fa.error_bound(q, k, v)).max())
            if not r <= 1.0:
                raise AssertionError(f"prefill T=1024: err/bound {r}")
            worst = max(worst, r)
            del y, ref
        t_k = timer.wall(lambda: ops.sa_attention(q, k, v))
        d_k = timer.device(lambda: ops.sa_attention(q, k, v))
        t_p = timer.wall(lambda: fa.flash_attention_ref(q, k, v))
        qh = q.transpose(1, 2)
        kh = k.transpose(1, 2).repeat_interleave(H // KVH, 1)
        vh = v.transpose(1, 2).repeat_interleave(H // KVH, 1)
        t_l = timer.wall(lambda: sdpa(qh, kh, vh, is_causal=True))
        d_l = timer.device(lambda: sdpa(qh, kh, vh, is_causal=True))
        b_ms, by, byte_ms, flop_ms = _prefill_bound(T, T, H, KVH, hd)
        plan = fa.launch_plan(1, T, H, hd, "bf16")
        # the block width: the wrapper's MMA_WARPS against the others
        keep, sweep = fa.MMA_WARPS, {}
        try:
            for w in (1, 2, 4, 8):
                fa.MMA_WARPS = w
                sweep[w] = timer.wall(lambda: ops.sa_attention(q, k, v))
        finally:
            fa.MMA_WARPS = keep
        log(f"prefill attention T={T} block width: " + ", ".join(
            f"{w} warps {ms:.4f} ms" for w, ms in sweep.items()))
        log(f"prefill attention times (T={T}, route {plan['route']}, grid "
            f"{plan['grid']}, {plan['warps']} warps): kernel {t_k:.4f} ms "
            f"(device {d_k}), plain {t_p:.4f} ms, SDPA {t_l:.4f} ms (device "
            f"{d_l}), bound {b_ms:.5f} ms ({by}); {100 * byte_ms / t_k:.1f} % "
            f"of the byte bound, {100 * flop_ms / t_k:.1f} % of the flop "
            f"bound")
        readings[f"T{T}"] = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p,
                             "library_ms": t_l, "library_device_ms": d_l,
                             "bound_ms": b_ms, "bound_by": by,
                             "warps_ms": sweep}
        if T in (max(PROMPT_LENS), 1024):
            # K and V from a bf16 cache: read as they are, no fp32 copy;
            # under the bf16 policy the same bits out
            kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
            same = torch.equal(ops.sa_attention(q, kb, vb).view(torch.int32),
                               ops.sa_attention(q, k, v).view(torch.int32))
            if not same:
                raise AssertionError(f"prefill T={T}: bf16 K/V differ from "
                                     f"fp32 K/V under the bf16 policy")
            t_16 = timer.wall(lambda: ops.sa_attention(q, kb, vb))
            b16, by16, byte16, _ = _prefill_bound(T, T, H, KVH, hd, 2)
            log(f"prefill attention T={T} bf16 K/V: bit-identical to fp32 "
                f"K/V {same}; kernel {t_16:.4f} ms, bound {b16:.5f} ms "
                f"({by16}), {100 * byte16 / t_16:.1f} % of the byte bound")
            readings[f"T{T}_bf16_kv"] = {"ms": t_16, "bound_ms": b16,
                                         "bound_by": by16}
        if T == max(PROMPT_LENS):
            out = dict(readings[f"T{T}"])
    return {"name": "prefill_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sa_attention.cu",
            "replaces": "src/repro/kernels/sa_attention.py:27",
            "max_abs_err": max_err, "err_over_bound": worst, **out,
            "readings": readings,
            "timed": f"one layer's prefill of a {max(PROMPT_LENS)}-token "
                     f"prompt, fp32 q/k/v, bf16 policy (mma route)"}


# ---------------------------------------------------------------------------
# phase 3 (continued): the families' kernel shapes — prefill and decode at
# head dim 256 (gemma2, gemma3), the tied lm_head
# ---------------------------------------------------------------------------

# gemma2's and gemma3's attention: 16 heads over 8 KV heads at hd 256
FAMILY_ATTN = (16, 8, 256)
# (name, T, keyword arguments): gemma3's causal prefill and its local
# window, gemma2's local window with the attention softcap
HD256_PREFILL = [("gemma3_T1024", 1024, {}),
                 ("gemma3_T1500_w1024", 1500, {"window": 1024}),
                 ("gemma2_T4200_w4096_cap50", 4200,
                  {"window": 4096, "cap": 50.0})]
# (name, ring rows, window, cap): gemma3's and gemma2's local rings, B = 4
HD256_RINGS = [("gemma3_ring1024", 1024, 1024, 0.0),
               ("gemma2_ring4096", 4096, 4096, 50.0)]
# the tied heads: (d_model, padded vocabulary), W = embed^T read in place
TIED_HEADS = {"gemma2-9b": (3584, 256000), "gemma3-12b": (3840, 262144)}
# hymba-1.5b's attention: 25 heads over 5 KV heads at hd 64, a 2048-token
# window on its local layers; its longest prompt (2600 tokens) passes it,
# and its decode walks B = 4 local rings of 2048 rows
HYMBA_ATTN = (25, 5, 64)
HD64_PREFILL = [("hymba_T2600_w2048", 2600, {"window": 2048})]
HD64_RINGS = [("hymba_ring2048", 2048, 2048, 0.0)]


def _window_mask(torch, T, S, window, q_offset=0):
    """(T, S) bool: causal and, with a window, within it."""
    qp = q_offset + torch.arange(T, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    ok = qp >= kp
    return ok & (qp - kp < window) if window else ok


def check_prefill_hd256(torch, timer, attn=FAMILY_ATTN,
                        shapes=HD256_PREFILL, tag="hd256", seed=256):
    """Prefill at gemma's shapes (hd 256; or `attn` and `shapes`, hymba's
    hd 64): the `mma` route (fp32 and bf16 K/V) and the `simt` route
    against the plain version within `error_bound`, a causal mask one key
    too wide outside it, bf16 K/V bit-identical to fp32 K/V; times beside
    the bound and SDPA with the same mask (without the softcap, which SDPA
    lacks: gemma2's yardstick then computes another function)."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_attention as fa

    H, KVH, hd = attn
    g = torch.Generator(device="cuda").manual_seed(seed)
    pols = {"bf16": PrecisionPolicy(),
            "fp32": PrecisionPolicy(input_format="fp32")}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    readings, worst, max_err = {}, 0.0, 0.0
    for name, T, kw in shapes:
        q = torch.randn((1, H, T, hd), generator=g, device="cuda").transpose(
            1, 2)
        k = torch.randn((1, T, KVH, hd), generator=g, device="cuda")
        v = torch.randn((1, T, KVH, hd), generator=g, device="cuda")
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        # the fp32 policy (simt) is checked at gemma3's lengths only: its
        # plain version and bound at T = 4200 hold tens of GB of fp64
        cases = [("bf16", k, v), ("bf16_kv16", kb, vb)]
        if T <= 1500:
            cases.append(("fp32", k, v))
        rd = {}
        for case, kk, vv in cases:
            pol = pols[case.split("_")[0]]
            call = (lambda kk=kk, vv=vv, pol=pol:
                    ops.sa_attention(q, kk, vv, policy=pol, **kw))
            ops.reset_counts()
            y = call()
            route = fa.launch_plan(1, T, H, hd, pol.input_format,
                                   kk.dtype == torch.bfloat16)
            got = ops.route_counts()["prefill_attention"]
            if got[route["route"]] != 1 or sum(got.values()) != 1:
                raise AssertionError(f"prefill {tag} {name} {case}: routes "
                                     f"{got}, plan {route['route']}")
            ref = fa.flash_attention_ref(q, kk, vv, policy=pol, **kw)
            bnd = fa.error_bound(q, kk, vv, policy=pol, **kw)
            err = (y - ref).abs()
            ratio = float((err / bnd).max())
            del ref
            bad = fa.flash_attention_ref(
                q, kk, vv, policy=pol,
                **{**kw, "q_offset": kw.get("q_offset", 0) + 1})
            r_bad = float(((y - bad).abs() / bnd).max())
            del bad, bnd
            if not torch.isfinite(y).all() or not ratio <= 1.0:
                raise AssertionError(f"prefill {tag} {name} {case}: "
                                     f"err/bound {ratio:.3f}")
            if not r_bad > 1.0:
                raise AssertionError(f"prefill {tag} {name} {case}: the "
                                     f"bound does not reject a mask one "
                                     f"key too wide ({r_bad:.3f})")
            worst, max_err = max(worst, ratio), max(max_err,
                                                    float(err.max()))
            if case == "bf16_kv16":
                y32 = ops.sa_attention(q, k, v, policy=pol, **kw)
                if not torch.equal(y.view(torch.int32),
                                   y32.view(torch.int32)):
                    raise AssertionError(f"prefill {tag} {name}: bf16 K/V "
                                         f"differ from fp32 K/V")
                del y32
            del y, err
            t_k = timer.wall(call, reps=10)
            d_k = timer.device(call)
            kv_bytes = 2 if case == "bf16_kv16" else 4
            b_ms, by, byte_ms, flop_ms = _prefill_bound(
                T, T, H, KVH, hd, kv_bytes, window=kw.get("window", 0),
                peak=peak_flops(pol))
            rd[case] = {"route": route["route"], "ms": t_k,
                        "device_ms": d_k, "bound_ms": b_ms,
                        "bound_by": by, "err_over_bound": ratio,
                        "planted_err_over_bound": r_bad,
                        "smem": route["smem"]}
            log(f"prefill attention {tag} {name} {case}: route "
                f"{route['route']} grid {route['grid']} smem "
                f"{route['smem']} B; err/bound {ratio:.4f}, planted mask "
                f"{r_bad:.1f}; kernel {t_k:.4f} ms wall (device {d_k}), "
                f"bound {b_ms:.5f} ms ({by}): {100 * b_ms / t_k:.1f} % of "
                f"it ({100 * byte_ms / t_k:.1f} % bytes, "
                f"{100 * flop_ms / t_k:.1f} % flops)")
        plain = timer.wall(lambda: fa.flash_attention_ref(q, k, v, **kw),
                           reps=3)
        qh = q.transpose(1, 2)
        kh = k.transpose(1, 2).repeat_interleave(H // KVH, 1)
        vh = v.transpose(1, 2).repeat_interleave(H // KVH, 1)
        if kw.get("window"):
            mask = _window_mask(torch, T, T, kw["window"])
            lib = (lambda: sdpa(qh, kh, vh, attn_mask=mask))
        else:
            lib = (lambda: sdpa(qh, kh, vh, is_causal=True))
        t_l, d_l = timer.wall(lib, reps=10), timer.device(lib)
        rd.update(plain_ms=plain, library_ms=t_l, library_device_ms=d_l,
                  library_note=("SDPA without the softcap" if kw.get("cap")
                                else "SDPA, the same mask"))
        log(f"prefill attention {tag} {name}: plain {plain:.4f} ms, SDPA "
            f"{t_l:.4f} ms (device {d_l}; {rd['library_note']})")
        readings[name] = rd
        del q, k, v, kb, vb, qh, kh, vh
        torch.cuda.empty_cache()
    return readings, worst, max_err


def check_decode_rings(torch, timer, attn=FAMILY_ATTN, rings=HD256_RINGS,
                       plan_slots=(1024, 4096, 4352), seed=4):
    """Paged decode at gemma's shapes (g = 2, hd 256; or `attn` and
    `rings`, hymba's g = 5, hd 64) over B = 4 local rings of 1024 and 4096
    rows presented by `dense_pool_view` (`min_page=0`), the rings full and
    wrapped: within `error_bound` of the plain version, the same bits as
    the kernel over the rows copied into a pool; times beside the byte
    bound and SDPA on the dense rows. Logs the split plan at these rings
    and at gemma2's global slot (4352 tokens; `plan_slots`)."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_decode_attention as da

    H, KVH, hd = attn
    grp, B, psz = H // KVH, BATCH, PAGE
    g = torch.Generator(device="cuda").manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    readings, worst = {}, 0.0
    for name, rows, window, cap in rings:
        q = torch.randn((B, 1, H, hd), generator=g, device="cuda")
        k = torch.randn((B, rows, KVH, hd), generator=g, device="cuda")
        v = torch.randn((B, rows, KVH, hd), generator=g, device="cuda")
        pos = torch.tensor([rows + 37, 2 * rows - 1, 3 * rows + 5, rows // 2],
                           dtype=torch.int32, device="cuda")
        i = torch.arange(rows, device="cuda")
        p = pos[:, None] - ((pos[:, None] - i[None]) % rows)
        pp = torch.where(p >= 0, p, -1).to(torch.int32)
        kp, vp, ppv, table = da.dense_pool_view(k, v, pp, psz)
        kw = {"window": window, "cap": cap}
        call = (lambda: ops.paged_decode_attention(q, kp, vp, ppv, table,
                                                   pos, min_page=0, **kw))
        y = call()
        pool = (torch.cat([torch.zeros_like(kp[:1]), kp]),
                torch.cat([torch.zeros_like(vp[:1]), vp]),
                torch.cat([torch.full_like(ppv[:1], -1), ppv]), table + 1)
        want = da.paged_decode_cuda(q, *pool, pos, **kw)
        same = torch.equal(y.view(torch.int32), want.view(torch.int32))
        ref = da.paged_decode_ref(q, *pool, pos, **kw)
        bnd = da.error_bound(q, *pool, pos, **kw)
        ratio = float(((y - ref).abs() / bnd).max())
        if not same or not ratio <= 1.0:
            raise AssertionError(f"decode {name}: same bits as the pool "
                                 f"{same}, err/bound {ratio:.3f}")
        worst = max(worst, ratio)
        t_k, d_k = timer.wall(call), timer.device(call)
        t_p = timer.wall(lambda: da.paged_decode_ref(
            q, kp, vp, ppv, table, pos, min_page=0, **kw), reps=5)
        mask = ((pp >= 0) & (pp <= pos[:, None]) & (pp > pos[:, None]
                                                     - window))
        mask = mask[:, None, None, :]
        qs, kh, vh = (q.transpose(1, 2),
                      k.transpose(1, 2).repeat_interleave(grp, 1),
                      v.transpose(1, 2).repeat_interleave(grp, 1))
        t_l = timer.wall(lambda: sdpa(qs, kh, vh, attn_mask=mask))
        P = rows // psz
        b_ms, by = _decode_bound(torch, table + 1, B, H, KVH, hd, psz, P,
                                 PrecisionPolicy())
        plan = da.split_plan(grp, hd, psz, P)
        readings[name] = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p,
                          "library_ms": t_l, "bound_ms": b_ms,
                          "bound_by": by, "err_over_bound": ratio,
                          "split": list(plan)}
        log(f"paged decode {name} (B={B}, g={grp}, hd={hd}, window "
            f"{window}, cap {cap}, dense view): split {tuple(plan)}; "
            f"err/bound {ratio:.4f}, bits equal to the pool's {same}; "
            f"kernel {t_k:.4f} ms wall (device {d_k}), plain {t_p:.4f}, "
            f"SDPA on the rows {t_l:.4f}, bound {b_ms:.5f} ms ({by}): "
            f"{100 * b_ms / t_k:.1f} % of it")
        del q, k, v, kp, vp, ppv, pool, ref, bnd, kh, vh
        torch.cuda.empty_cache()
    for P in (n // psz for n in plan_slots):
        plan = da.split_plan(grp, hd, psz, P)
        log(f"paged decode split plan g={grp} hd={hd}: {P * psz}-token slot "
            f"-> {plan.n_split} blocks of {plan.keys_per_cta} keys, "
            f"{plan.smem} B of shared memory a block")
    return readings, worst


def tied_head_times(torch, timer):
    """The tied lm_head: W = embed^T, K contiguous, read in place by the SA
    GEMM, against the same matrix made contiguous: the same bits at M = 4
    (decode tile) and M = 1024 (large tile), within the plain version's
    bound at M = 4; times beside bf16 torch.matmul(x, embed.t()) and the
    bound (bytes at M = 4, flops at M = 1024)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm

    g = torch.Generator(device="cuda").manual_seed(5)
    readings = {}
    for arch, (d, vocab) in TIED_HEADS.items():
        embed = (torch.randn((vocab, d), generator=g, device="cuda")
                 * 0.02).to(torch.bfloat16)
        view = embed.t()
        cont = view.contiguous()
        for m in (BATCH, TRAIN_M):
            a = torch.randn((m, d), generator=g, device="cuda").to(
                torch.bfloat16)
            y = ops.sa_matmul(a, view)
            same = torch.equal(y.view(torch.int32),
                               ops.sa_matmul(a, cont).view(torch.int32))
            ratio = None
            if m == BATCH:
                ref = mm.sa_matmul_ref(a, view)
                ratio = float(((y - ref).abs()
                               / mm.error_bound(a, view, y=ref)).max())
                del ref
            if not same or (ratio is not None and not ratio <= 1.0):
                raise AssertionError(f"tied lm_head {arch} M={m}: bits equal"
                                     f" to the contiguous W {same}, "
                                     f"err/bound {ratio}")
            del y
            tile = mm.mma_plan(m, vocab, "mma")["tile"]
            t_v = timer.wall(lambda: ops.sa_matmul(a, view), reps=10)
            d_v = timer.device(lambda: ops.sa_matmul(a, view))
            t_c = timer.wall(lambda: ops.sa_matmul(a, cont), reps=10)
            t_l = timer.wall(lambda: torch.matmul(a, view), reps=10)
            t_p = (timer.wall(lambda: mm.sa_matmul_ref(a, view), reps=3)
                   if m == BATCH else None)
            b_ms, by = bound_ms(2 * (vocab * d + m * d) + 4 * m * vocab,
                                2.0 * m * d * vocab, PEAK_BF16)
            readings[f"{arch}_M{m}"] = {
                "tile": tile, "ms": t_v, "device_ms": d_v,
                "contiguous_ms": t_c, "plain_ms": t_p, "library_ms": t_l,
                "bound_ms": b_ms, "bound_by": by, "err_over_bound": ratio,
                "bits_equal_contiguous": same}
            log(f"tied lm_head {arch} M={m} (K {d}, N {vocab}, {tile} tile, "
                f"W = embed^T in place): bits equal to the contiguous W "
                f"{same}, err/bound {ratio}; kernel {t_v:.4f} ms wall "
                f"(device {d_v}), contiguous W {t_c:.4f} ms, plain {t_p}, "
                f"bf16 torch.matmul(x, embed.t()) {t_l:.4f} ms, bound "
                f"{b_ms:.4f} ms ({by}): {100 * b_ms / t_v:.1f} % of it")
            del a
        del embed, view, cont
        torch.cuda.empty_cache()
    return readings


# ---------------------------------------------------------------------------
# phase 3 (continued): the paper's datapath — fp_emu and quantize
# ---------------------------------------------------------------------------

def issue_rate(torch) -> float:
    """Thread-instructions the card can issue per second: SMs x 128 x the
    maximum SM clock that nvidia-smi reports."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES * mhz * 1e6


def fp_emu_sass():
    """The SASS of the fp_emu library (`cuobjdump -sass`)."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise AssertionError(f"fp_emu: no cuobjdump beside nvcc ({tool}): "
                             f"the SASS counts cannot be taken")
    return subprocess.run([tool, "-sass", str(build._target("fp_emu"))],
                          capture_output=True, text=True, check=True).stdout


def _sass_function(sass: str, kernel: str):
    """(instructions [(address, text)], labels {name: address}) of the
    first function whose mangled name holds `kernel`."""
    import re

    inst_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
    func, insts, labels, pending = None, [], {}, []
    for line in sass.splitlines():
        if "Function :" in line:
            if insts:
                break
            func = line.split("Function :")[1].strip()
            continue
        if func is None or kernel not in func:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = inst_re.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            insts.append((addr, m.group(2)))
    return insts, labels


_NO_DEST = ("ST", "BRA", "BAR", "EXIT", "RET", "BSYNC", "BSSY", "WARPSYNC",
            "NOP", "YIELD", "DEPBAR", "MEMBAR", "CALL", "RED", "CCTL")


def _regs(text: str):
    """(registers written, registers read) of one SASS instruction."""
    import re

    def expand(tok):
        out = []
        for name, num, wide in re.findall(r"\b(U?R|P)(\d+)(\.64)?\b", tok):
            out.append(f"{name}{num}")
            if wide:
                out.append(f"{name}{int(num) + 1}")
        return out

    guard = re.match(r"@!?(U?P\d+)\s+", text)
    srcs = [guard.group(1)] if guard else []
    text = text[guard.end():] if guard else text
    op, _, rest = text.partition(" ")
    ops = [o.strip() for o in rest.split(",")] if rest else []
    if op.startswith(_NO_DEST) or not ops:
        return [], srcs + [r for o in ops for r in expand(o)]
    ndst = 2 if ("SETP" in op or op.startswith("PLOP3")) else 1
    dst = [r for o in ops[:ndst] for r in expand(o) if r.startswith(("R", "P"))
           or r.startswith("UR")]
    if ndst == 1 and dst:
        width = 4 if ".128" in op else 2 if (".64" in op or "WIDE" in op) \
            else 1
        base = dst[0]
        if width > 1 and base[0] == "R":
            dst = [f"R{int(base[1:]) + i}" for i in range(width)]
    # a predicated write keeps the old value where the guard is false
    return dst, srcs + (dst if guard else []) + [
        r for o in ops[ndst:] for r in expand(o)]


def _dependent_per_pass(body, passes=6):
    """The loop-carried dependent path of a loop body, in instructions a
    pass: the longest chain of instructions each reading the one before
    (register and predicate dataflow, every instruction one unit), run
    over `passes` passes of the body, its growth per pass in the last."""
    depth = {}
    tops = []
    parsed = [_regs(t) for t in body]
    for _ in range(passes):
        for dst, src in parsed:
            d = 1 + max((depth.get(r, 0) for r in src), default=0)
            for r in dst:
                depth[r] = d
        tops.append(max(depth.values(), default=0))
    return tops[-1] - tops[-2]


def sass_loop(sass: str, kernel: str, min_steps: int = 2):
    """The PE-step loop of `kernel` in the library's SASS: the backward
    branch whose body holds at least `min_steps` LZAs (FLO, one a PE step)
    at the fewest instructions a step. Returns {"steps", "instructions",
    "per_step", "dependent_per_step"}; raises where no such loop is
    found (a new layout the count does not know: fix the count, do not
    guess)."""
    import re

    insts, labels = _sass_function(sass, kernel)
    if not insts:
        raise AssertionError(f"fp_emu SASS: no function {kernel}")
    best = None
    for addr, text in insts:
        m = re.search(r"\bBRA\b[^`0-9]*(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))",
                      text)
        if not m:
            continue
        dest = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if dest is None or dest >= addr:
            continue
        body = [t for a, t in insts if dest <= a <= addr]
        flo = sum(1 for t in body if re.search(r"\bFLO\b", t))
        if flo >= min_steps and (best is None
                                 or len(body) / flo < best["per_step"]):
            best = {"steps": flo, "instructions": len(body),
                    "per_step": len(body) / flo, "body": body}
    if best is None:
        raise AssertionError(f"fp_emu SASS: {kernel} has no loop with "
                             f"{min_steps} or more FLO (PE steps)")
    body = best.pop("body")
    best["dependent_per_step"] = _dependent_per_pass(body) / best["steps"]
    return best


def sass_kernel_name(tw: str, plan: dict, approx: bool = False) -> str:
    """The mangled-name fragment of the kernel a launch plan runs:
    fp_emu_pc_kernel<TW, approx> or fp_emu_kernel<TW, rows, approx>."""
    t = {"bf16": "13__nv_bfloat16", "fp16": "6__half", "fp32": "f"}[tw]
    if plan["kernel"] == "pc":
        return f"fp_emu_pc_kernelI{t}Lb{int(approx)}ELi2E"
    return f"fp_emu_kernelI{t}Li{plan['rows']}ELb{int(approx)}E"


def sass_plan(sass: str, plan: dict, tw: str = "bf16") -> dict:
    """The SASS a PE step of the kernel a plan runs: the chain's loop
    (`sass_loop`), and for the producer/consumer kernel also the producer's
    chunk loop (the backward branch whose body arrives on a named barrier,
    BAR.ARV, one STS.64 a step), whose instructions a step add to the
    consumer's in `per_step`."""
    import re

    name = sass_kernel_name(tw, plan)
    out = sass_loop(sass, name, min_steps=2 * plan["rows"])
    out["chain_per_step"] = out["per_step"]
    if plan["kernel"] != "pc":
        return out
    insts, labels = _sass_function(sass, name)
    prod = None
    for addr, text in insts:
        m = re.search(r"\bBRA\b[^`0-9]*(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))",
                      text)
        if not m:
            continue
        dest = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if dest is None or dest >= addr:
            continue
        body = [t for a, t in insts if dest <= a <= addr]
        steps = sum(1 for t in body if t.startswith("STS.64"))
        if any("BAR.ARV" in t for t in body) and steps:
            prod = len(body) / steps
    if prod is None:
        raise AssertionError(f"fp_emu SASS: {name} has no producer loop "
                             f"(BAR.ARV and STS.64)")
    out["producer_per_step"] = prod
    out["per_step"] = out["chain_per_step"] + prod
    return out


# the path's GEMM widths (N) at which the launch plan is surveyed for its
# geometries, and the depth of the geometry checks (five 32-deep chunks and
# a ragged tail)
EMU_NS = (1024, D_MODEL, D_FF, 153600)
EMU_GEOMETRY_K = 165


def fp_emu_geometries():
    """{(kernel, rows, warps): (M, N)}: each launch geometry the plan picks
    for the path's N at M = 1 to 64, with the first (M, N) that picks it, M
    = 1 and M = 16-33 first."""
    from repro_torch.kernels import fp_emu as fe

    out = {}
    for m in [1] + list(range(16, 34)) + list(range(2, 16)) + list(
            range(34, 65)):
        for n in EMU_NS:
            p = fe.launch_plan(m, n)
            out.setdefault((p["kernel"], p["rows"], p["warps"]), (m, n))
    return out


def check_fp_emu(torch, timer):
    """fp_emu against its plain version and chained_fma, bit for bit, in
    the four formats and both modes: the decode and prefill GEMMs at full
    K, and one (M, N) per launch geometry at K = EMU_GEOMETRY_K. Then its
    times: the decode wk GEMM (wall, device, cycles a PE step), wk at M =
    1-33, a layer's 7 GEMMs and the lm_head at M = 2 and 32; the SASS of
    the K loop (instructions a PE step, the dependent path a step) and the
    chain probe's cycles a step; the issue bound and the chain-latency
    bound."""
    import numpy as np

    from repro_torch.core import chained_fma as cf
    from repro_torch.kernels import fp_emu as fe
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm_cases import (LAYER_GEMMS, LM_HEAD,
                                                emu_operands)

    g = torch.Generator(device="cuda").manual_seed(4)
    geos = fp_emu_geometries()
    # (name, M, K, N, columns held against the plain version): a decode
    # GEMM whole, a prefill GEMM on a slice of its columns, then each
    # launch geometry on 64 columns
    shapes = [("decode wk", BATCH // 2, D_MODEL, 1024, 1024),
              ("prefill wg", 16, D_MODEL, D_FF, 256)]
    shapes += [(f"geo {kern} r{r}w{y}", m, EMU_GEOMETRY_K, n, 64)
               for (kern, r, y), (m, n) in sorted(geos.items())]
    log(f"fp_emu launch geometries (kernel, rows a thread, warps a block) "
        f"the plan picks at M = 1-64, N = {EMU_NS}: "
        + ", ".join(f"{kern} {r}x{y} at M={m} N={n}"
                    for (kern, r, y), (m, n) in sorted(geos.items())))
    compared = mism = cf_compared = 0
    for fmt in ("bf16", "fp16", "fp8_e4m3", "fp8_e5m2"):
        for mode in ("exact", "approx"):
            for name, M, K, N, cols in shapes:
                a, w = emu_operands(g, M, K, N, fmt)
                plan = fe.launch_plan(M, N)
                y = ops.skewed_datapath_matmul(a, w, fmt, mode)
                ref = fe.fma_emu_matmul_ref(a, w[:, :cols], fmt, mode)
                torch.cuda.synchronize()
                got = y[:, :cols].contiguous()
                bad = int((got.view(torch.int32)
                           != ref.view(torch.int32)).sum())
                line = (f"fp_emu {fmt:8s} {mode:6s} {name:14s} M={M:2d} "
                        f"K={K} N={N} ({plan['kernel']}, rows "
                        f"{plan['rows']}, warps {plan['warps']}; plain on "
                        f"{cols} cols): {bad} of {ref.numel()} outputs "
                        f"differ")
                if not bool(torch.isfinite(y).all()):
                    raise AssertionError(f"fp_emu {fmt} {mode} {name}: "
                                         f"non-finite outputs")
                compared += ref.numel()
                mism += bad
                if name.startswith(("decode", "geo")):
                    # four columns against the numpy chained_fma copy
                    pipe = "approx" if mode == "approx" else "skewed"
                    c = cf.matmul_emulated(a.float().cpu().numpy(),
                                           w[:, :4].float().cpu().numpy(),
                                           fmt, pipe)
                    cb = int((c.view(np.uint32) != got[:, :4].cpu().numpy()
                              .view(np.uint32)).sum())
                    line += f"; chained_fma on 4 cols: {cb} differ"
                    mism += cb
                    cf_compared += c.size
                log(line)
    if mism:
        raise AssertionError(f"fp_emu: {mism} outputs differ from the plain "
                             f"version or chained_fma")
    mhz = float(smi("clocks.max.sm").split()[0])
    times = fp_emu_times(torch, timer, g)
    # the decode wk GEMM (M = 2), bf16 exact: its plain version's time
    M, K, N = BATCH // 2, D_MODEL, 1024
    t_k, d_k = times["wk"][M]["ms"], times["wk"][M]["device_ms"]
    a, w = emu_operands(g, M, K, N, "bf16")
    t_p = timer.wall(lambda: fe.fma_emu_matmul_ref(a, w), reps=1)
    cyc = (d_k or t_k) * 1e-3 * mhz * 1e6 / K
    # the SASS a PE step of every geometry the plan picks, and of the
    # chain probe
    sass = fp_emu_sass()
    per_geo = {}
    for geo in sorted(geos):
        per_geo[geo] = sass_plan(sass, dict(zip(("kernel", "rows", "warps"),
                                                geo)))
        log(f"fp_emu SASS {geo}: {per_geo[geo]['per_step']:.2f} "
            f"instructions a PE step ({per_geo[geo]['chain_per_step']:.2f} "
            f"in the chain's loop, {per_geo[geo]['dependent_per_step']:.2f} "
            f"of them on its dependent path)")
    plan = fe.launch_plan(M, N)
    loop = per_geo[(plan["kernel"], plan["rows"], plan["warps"])]
    least = min(per_geo.values(), key=lambda v: v["per_step"])
    least_geo = min(per_geo, key=lambda geo: per_geo[geo]["per_step"])
    probe = sass_loop(sass, "fp_emu_chain_probe", min_steps=1)
    chain = fe.chain_cycles()
    log(f"fp_emu SASS: the decode plan ({plan['kernel']}, bf16, exact) "
        f"{loop['per_step']:.2f} instructions a PE step, the chain's loop "
        f"{loop['chain_per_step']:.2f} ({loop['instructions']} for "
        f"{loop['steps']} steps), {loop['dependent_per_step']:.2f} of them "
        f"a step on the loop-carried dependent path; the fewest of any "
        f"geometry {least['per_step']:.2f} ({least_geo}); the chain probe's "
        f"loop {probe['per_step']:.2f} instructions a step, "
        f"{probe['dependent_per_step']:.2f} dependent (the source: "
        f"{fe.OPS_PER_STEP} operations a step); the chain takes "
        f"{chain:.2f} cycles a step (chain probe, one thread), "
        f"{chain / max(probe['dependent_per_step'], 1):.2f} a dependent "
        f"instruction")
    # bounds. Issue: the fewest SASS instructions any geometry of the
    # library spends on a PE step, each taking an issue slot (4 schedulers
    # x 32 lanes per SM per clock; moves and adds also issue to the FMA
    # pipe as IMAD, so not 64 int32 lanes), with the bytes beside them.
    # Chain latency: each output's K steps are serial, K x this design's
    # chain (the probe's cycles a step) at the max SM clock. The bound is
    # the larger.
    rate = issue_rate(torch)

    def bounds(m, k, n):
        """(issue ms, chain ms) of an (m, k) @ (k, n) GEMM."""
        nbytes = 2 * (m * k + k * n) + 4 * m * n
        return (bound_ms(nbytes, float(m * n * k * least["per_step"]),
                         rate)[0], k * chain / (mhz * 1e6) * 1e3)

    issue_ms, chain_ms = bounds(M, K, N)
    b_ms = max(issue_ms, chain_ms)
    by = bound_ms(2 * (M * K + K * N) + 4 * M * N,
                  float(M * N * K * least["per_step"]), rate)[1]
    kind = ("chain latency" if chain_ms > issue_ms
            else "issue" if by == "operations" else "bytes")
    log(f"fp_emu times (decode wk, M={M} K={K} N={N}, {plan['kernel']}, "
        f"grid {plan['grid']}): kernel {t_k:.4f} ms "
        f"(device {d_k}; {cyc:.1f} cycles a PE step at {mhz:.0f} MHz), "
        f"plain {t_p:.4f} ms; issue bound {issue_ms:.5f} ms "
        f"({least['per_step']:.2f} SASS a step over {rate:.4e} issue "
        f"slots/s); chain-latency bound {chain_ms:.5f} ms (K x "
        f"{chain:.2f} cycles); the bound is the larger, the {kind}")
    for m, row in times["wk"].items():
        p = fe.launch_plan(m, N)
        row.update(kernel=p["kernel"], rows=p["rows"], warps=p["warps"],
                   cycles_a_step=(row["device_ms"] or row["ms"]) * 1e-3
                   * mhz * 1e6 / K)
        log(f"fp_emu wk M={m:2d}: wall {row['ms']:.4f} ms, device "
            f"{row['device_ms']} ms, {row['cycles_a_step']:.1f} cycles a PE "
            f"step ({p['kernel']}, rows {p['rows']}, warps {p['warps']}, "
            f"grid {p['grid']})")
    # a layer's GEMMs run one after another: its bound sums each GEMM's
    layers = {}
    for m, row in times["layer"].items():
        tot = issue = lat = bound = 0.0
        parts = []
        for name, k, n, _, _ in LAYER_GEMMS + [LM_HEAD]:
            p = fe.launch_plan(m, n)
            parts.append(f"{name} {row[name]:.3f} ({p['kernel']} rows "
                         f"{p['rows']})")
            if name == LM_HEAD[0]:
                layers[f"lm_head_M{m}_ms"] = row[name]
                continue
            i_ms, c_ms = bounds(m, k, n)
            tot += row[name]
            issue += i_ms
            lat += c_ms
            bound += max(i_ms, c_ms)
        layers.update({f"layer_M{m}_ms": tot,
                       f"layer_M{m}_issue_bound_ms": issue,
                       f"layer_M{m}_chain_bound_ms": lat,
                       f"layer_M{m}_bound_ms": bound})
        log(f"fp_emu M={m}: one layer's 7 GEMMs {tot:.3f} ms; bound "
            f"{bound:.3f} ms (each GEMM's larger: issue {issue:.3f} ms, "
            f"chain latency {lat:.3f} ms summed) ("
            + ", ".join(parts) + " ms)")
    return {"name": "fp_emu", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fp_emu.cu",
            "replaces": "src/repro/kernels/fp_emu.py:72",
            "max_abs_err": 0.0, "err_over_bound": 0.0,
            "ms": t_k, "device_ms": d_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": "bytes" if kind == "bytes"
            else "operations", "library_ms": None,
            "outputs_compared": compared + cf_compared,
            "readings": {"bound_kind": kind, "issue_bound_ms": issue_ms,
                         "chain_bound_ms": chain_ms,
                         "chain_cycles_a_step": chain,
                         "cycles_a_step": cyc, "sm_mhz": mhz,
                         "sass_a_step": loop["per_step"],
                         "sass_fewest_a_step": least["per_step"],
                         "sass_chain_loop_a_step": loop["chain_per_step"],
                         "sass_dependent_a_step":
                             loop["dependent_per_step"],
                         "chain_sass_a_step": probe["per_step"],
                         "chain_dependent_a_step":
                             probe["dependent_per_step"],
                         "wk_by_m": times["wk"], **layers},
            "timed": f"the decode wk GEMM, M={M} K={K} N={N}, bf16 exact; "
                     f"bound_ms: the larger of the issue bound (the fewest "
                     f"SASS a PE step of any geometry) and the chain-latency "
                     f"bound (K x this design's chain), here the {kind}"}


def fp_emu_times(torch, timer, g):
    """The skewed datapath's times on the path's shapes, bf16 exact, through
    `ops.skewed_datapath_matmul` alone (tools/chip_ab.py runs them against
    another checkout's port): {"wk": {M: {"ms", "device_ms"}}} for the wk
    GEMM at M = 1-33 (each launch plan the decode and prefill rows pick),
    and {"layer": {M: {name: ms}}} for a layer's seven GEMMs and the
    lm_head at M = 2 (decode) and 32 (a prefill), wall."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm_cases import (LAYER_GEMMS, LM_HEAD,
                                                emu_operands)

    out = {"wk": {}, "layer": {}}
    for m in (1, 2, 4, 8, 16, 17, 24, 32, 33):
        a, w = emu_operands(g, m, D_MODEL, 1024, "bf16")
        out["wk"][m] = {
            "ms": timer.wall(lambda: ops.skewed_datapath_matmul(a, w)),
            "device_ms": timer.device(
                lambda: ops.skewed_datapath_matmul(a, w))}
    for m in (BATCH // 2, 32):
        row = out["layer"][m] = {}
        for name, k, n, _, _ in LAYER_GEMMS + [LM_HEAD]:
            a, w = emu_operands(g, m, k, n, "bf16")
            row[name] = timer.wall(lambda: ops.skewed_datapath_matmul(a, w),
                                   reps=3)
            del a, w
    return out


def fp32_gemm_times(torch, timer, g):
    """The SA GEMM's fp32 routes (the fp32 policy), through `sa_matmul_cuda`
    alone (tools/chip_ab.py runs them against another checkout's port):
    each of a layer's 7 GEMMs fp32 x fp32 at M = 4 (`partial`) and M = 1024
    (`simt`), ms wall and device, their sums, and wk with fp32 A and bf16 W
    at M = 4 (`partial`). Beside each layer sum, on the same inputs: the
    plain version's wall time (`sa_matmul_ref`), fp32 `torch.matmul`'s
    (the library yardstick) and the bound (each operand read once, the
    output written once, at the byte rate; 2·M·N·K flops at the fp32
    peak; the larger)."""
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import LAYER_GEMMS

    out = {}
    for m in (BATCH, 1024):
        wall, dev, plain, lib, nbytes, flops = 0.0, 0.0, 0.0, 0.0, 0, 0
        for name, k, n, _, _ in LAYER_GEMMS:
            a = torch.randn((m, k), generator=g, device="cuda")
            w = torch.randn((k, n), generator=g, device="cuda") / k ** .5
            t = timer.wall(lambda: mm.sa_matmul_cuda(a, w), reps=5)
            d = timer.device(lambda: mm.sa_matmul_cuda(a, w), reps=3)
            plain += timer.wall(lambda: mm.sa_matmul_ref(a, w), reps=5)
            lib += timer.wall(lambda: torch.matmul(a, w), reps=5)
            nbytes += 4 * (m * k + k * n + m * n)
            flops += 2 * m * n * k
            out[f"{name} M={m} ms"] = t
            wall += t
            dev = None if d is None or dev is None else dev + d
            del a, w
        out[f"layer M={m} ms"] = wall
        out[f"layer M={m} device_ms"] = dev
        out[f"layer M={m} plain_ms"] = plain
        out[f"layer M={m} library_ms"] = lib
        out[f"layer M={m} bound_ms"], out[f"layer M={m} bound_by"] = \
            bound_ms(nbytes, flops, PEAK_FP32)
    a = torch.randn((BATCH, D_MODEL), generator=g, device="cuda")
    w = (torch.randn((D_MODEL, 1024), generator=g, device="cuda")
         / D_MODEL ** .5).to(torch.bfloat16)
    out[f"wk fp32 A M={BATCH} ms"] = timer.wall(
        lambda: mm.sa_matmul_cuda(a, w))
    out[f"wk fp32 A M={BATCH} device_ms"] = timer.device(
        lambda: mm.sa_matmul_cuda(a, w))
    return out


def _same_bits(torch, x, y) -> int:
    """Positions where two fp32 tensors differ: NaN where the other is not,
    or unequal bit patterns elsewhere (NaN payloads may differ)."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    diff = (x.view(torch.int32) != y.view(torch.int32)) & ~nx
    return int((nx != ny).sum() + diff.sum())


def planted_ties(np, fmt_name, scales):
    """{scale: inputs x} where x/s rounds (fp32) onto an FP8 rounding tie
    but x·fl(1/s) does not round to the same FP8 value: there the kernel's
    multiply by the reciprocal and a division part."""
    import torch

    from repro_torch.core.fpformats import get_format, round_fp8

    fmt = get_format(fmt_name)
    mb = fmt.man_bits
    mants = 1 + (2 * np.arange(2 ** mb) + 1) / 2.0 ** (mb + 1)
    exps = np.arange(fmt.emin, fmt.emax)
    ties = (mants[None] * 2.0 ** exps[:, None]).ravel().astype(np.float32)
    ties = np.concatenate([ties, -ties])

    def rnd(v):
        return round_fp8(torch.from_numpy(v), fmt).numpy()

    out = {}
    for s in scales:
        s = np.float32(s)
        x = (ties * s).astype(np.float32)
        on_tie = (x / s).astype(np.float32) == ties
        mul = (x * (np.float32(1) / s)).astype(np.float32)
        part = on_tie & (rnd(mul).view(np.uint32) != rnd(ties).view(np.uint32))
        out[float(s)] = (x[part], ties[part])
    return out


def check_quantize(torch, timer):
    import numpy as np

    from repro_torch.core.fpformats import round_fp8
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import sa_matmul as mm

    g = torch.Generator(device="cuda").manual_seed(5)
    n = 2 ** 24
    specials = torch.tensor(
        [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-40,
         -1e-40, 448.0, 449.0, 464.0, 57344.0, 61440.0, 1e38, -3.4e38,
         2.0 ** -6, 2.0 ** -7, 2.0 ** -14, 2.0 ** -15], device="cuda")
    x = torch.randn((n,), generator=g, device="cuda") * 300.0
    x[:specials.numel()] = specials
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (4096,), generator=g,
                         device="cuda", dtype=torch.int32)
    x[-4096:] = bits.view(torch.float32)        # every bit pattern class
    mism = compared = 0
    for fmt in qz.FORMATS:
        amax = qz.amax_scale(x[64:-4096], fmt)     # the randn part
        for sname, scale in (("amax", amax), ("1", 1.0), ("0.37", 0.37)):
            for cname, xin in (("fp32", x), ("bf16", x.to(torch.bfloat16)),
                               ("fp32 unaligned", x[1:])):
                y = ops.quantize_fp8(xin, scale, fmt)
                ref = qz.quantize_fp8_ref(xin, scale, fmt)
                torch.cuda.synchronize()
                bad = _same_bits(torch, y, ref)
                mism += bad
                compared += y.numel()
                log(f"quantize {fmt} scale={sname:4s} {cname:14s} "
                    f"n={y.numel()}: {bad} differ")
        # planted ties: the kernel multiplies by the reciprocal, as the TPU
        # kernel does; dividing would round these differently
        scales = np.random.default_rng(0).uniform(0.01, 100.0, 64)
        ties = planted_ties(np, fmt, scales.astype(np.float32))
        planted = 0
        for s, (xs, ts) in ties.items():
            if not len(xs):
                continue
            xd = torch.from_numpy(xs).cuda()
            y = ops.quantize_fp8(xd, s, fmt)
            ref = qz.quantize_fp8_ref(xd, s, fmt)
            div = round_fp8(torch.from_numpy(ts), fmt).numpy()
            bad = _same_bits(torch, y, ref)
            same_as_div = int((y.cpu().numpy().view(np.uint32)
                               == div.view(np.uint32)).sum())
            mism += bad + same_as_div
            planted += len(xs)
        log(f"quantize {fmt} planted ties: {planted} inputs over "
            f"{sum(len(v[0]) > 0 for v in ties.values())} scales, kernel "
            f"equals the plain version and differs from x/s at each")
        if planted < 20:
            raise AssertionError(f"quantize {fmt}: only {planted} planted "
                                 f"ties found")
    if mism:
        raise AssertionError(f"quantize: {mism} outputs differ")
    # the FP8 GEMM: both operands quantized with per-tensor scales on the
    # card, then the SA GEMM with the descale in its epilogue
    M, K, N = 128, D_MODEL, D_FF
    a = torch.randn((M, K), generator=g, device="cuda")
    w = (torch.randn((K, N), generator=g, device="cuda") * K ** -0.5).to(
        torch.bfloat16)
    fp8_ratio = 0.0
    for fmt in qz.FORMATS:
        y = ops.sa_matmul_fp8(a, w, fmt)
        sa_, sw = qz.amax_scale(a, fmt), qz.amax_scale(w, fmt)
        aq = qz.quantize_fp8_ref(a, sa_, fmt).to(torch.bfloat16)
        wq = qz.quantize_fp8_ref(w, sw, fmt).to(torch.bfloat16)
        ref = mm.sa_matmul_ref(aq, wq, scale=sa_ * sw)
        torch.cuda.synchronize()
        bnd = mm.error_bound(aq, wq, sa_ * sw, y=ref)
        ratio = float(((y - ref).abs() / bnd).max())
        if not bool(torch.isfinite(y).all()) or ratio > 1.0:
            raise AssertionError(f"sa_matmul_fp8 {fmt}: err/bound {ratio}")
        fp8_ratio = max(fp8_ratio, ratio)
        t_f = timer.wall(lambda: ops.sa_matmul_fp8(a, w, fmt))
        log(f"sa_matmul_fp8 {fmt} M={M} K={K} N={N}: max_err "
            f"{float((y - ref).abs().max()):.3e} err/bound {ratio:.4f}, "
            f"{t_f:.4f} ms (amax x2, quantize x2, SA GEMM)")
    # times: 2^24 fp32 elements, E4M3, scale from amax on the card
    xs = torch.randn((n,), generator=g, device="cuda") * 300.0
    sc = qz.amax_scale(xs, "fp8_e4m3")
    t_k = timer.wall(lambda: ops.quantize_fp8(xs, sc, "fp8_e4m3"))
    d_k = timer.device(lambda: ops.quantize_fp8(xs, sc, "fp8_e4m3"))
    t_p = timer.wall(lambda: qz.quantize_fp8_ref(xs, sc, "fp8_e4m3"))
    b_ms, by = bound_ms(8.0 * n, 0.0, 1.0)
    log(f"quantize times (n=2^24 fp32, E4M3): kernel {t_k:.4f} ms (device "
        f"{d_k}), plain {t_p:.4f} ms, bound {b_ms:.5f} ms ({by})")
    return {"name": "quantize_fp8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:38",
            "max_abs_err": 0.0, "err_over_bound": 0.0,
            "ms": t_k, "device_ms": d_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "outputs_compared": compared,
            "fp8_gemm_err_over_bound": fp8_ratio,
            "timed": "2^24 fp32 elements, E4M3, amax scale on the card"}


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

# the kernels each serve path must launch (every other kernel may not run
# its plain version either)
PATH_KERNELS = {"cuda": ("sa_matmul", "paged_decode", "prefill_attention"),
                "emulate": ("fp_emu", "paged_decode", "prefill_attention")}


def _serve_backend(torch, backend, args, n_req, max_new):
    """Serve `args` through `launch/serve.main` under
    REPRO_GEMM_BACKEND=`backend` and check the run: every request
    complete, no page leaked, finite logits, the path's kernels launched,
    no plain version run; under `emulate` the SA GEMM must not launch."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    os.environ["REPRO_GEMM_BACKEND"] = backend
    ops.reset_counts()
    t0 = time.monotonic()
    summary, sched, engine = drv.main(args, return_state=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.counts()
    log(f"[serve {backend}] wall {wall:.2f} s (init + serve); counts "
        f"{counts}; routes {ops.route_counts()}")
    done = sched.finished
    problems = []
    if len(done) != n_req or any(r.n_generated != max_new for r in done):
        problems.append(f"requests incomplete: "
                        f"{[(r.rid, r.n_generated) for r in done]}")
    if summary.get("pages_leaked") != 0:
        problems.append(f"pages_leaked={summary.get('pages_leaked')}")
    if summary.get("nonfinite_logits") != 0:
        problems.append(f"nonfinite logits: {summary.get('nonfinite_logits')}")
    for name in PATH_KERNELS[backend]:
        if counts[name]["launches"] <= 0:
            problems.append(f"kernel {name} never launched on the path")
    # the serve's policy casts in to bf16: prefill takes the tensor cores
    routes = ops.route_counts()["prefill_attention"]
    if routes["mma"] != counts["prefill_attention"]["launches"]:
        problems.append(f"prefill attention routes {routes}: the bf16 "
                        f"serve must run the mma route only")
    if backend == "emulate" and counts["sa_matmul"]["launches"] != 0:
        problems.append("the SA GEMM launched under the emulate backend")
    # the bf16 policy's decode GEMMs take the tensor cores' decode tile
    gemm_routes = ops.route_counts()["sa_matmul"]
    if backend == "cuda" and (gemm_routes["partial"] or gemm_routes["mma"]
                              != counts["sa_matmul"]["launches"]):
        problems.append(f"sa_matmul routes {gemm_routes}: every bf16 GEMM, "
                        f"decode included, must run the mma route (0 "
                        f"partial)")
    for name, c in counts.items():
        if c["plain_calls"] != 0:
            problems.append(f"plain version of {name} ran on the path "
                            f"({c['plain_calls']} calls)")
    if problems:
        raise AssertionError(f"serve {backend} phase failed: "
                             + "; ".join(problems))
    launches = {name: c["launches"] for name, c in counts.items()}
    return summary, launches, engine, sched


def serve(torch):
    return _serve_backend(torch, "cuda", SERVE_ARGS, 8, MAX_NEW)


def serve_bf16_pool(torch, engine, summary):
    """The `cuda` serve's stream again, on the same weights, through a
    ServeEngine whose KV pool is bf16 (`cache_dtype`): every request
    complete, no page leaked, the decode kernel launched on the 16-bit
    pool, prefill on the `mma` route, no plain version, and the stream
    digest equal to the fp32-pool run's (under the bf16 policy a bf16
    pool holds exactly what cast_in makes of the fp32 one, and the
    kernel's order of sums does not depend on the pool type)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    args = drv.parse_args(SERVE_ARGS)
    plens = [int(x) for x in args.prompt_lens.split(",")]
    eng = ServeEngine(engine.cfg, engine.params, args.batch, CACHE_LEN,
                      eos_id=args.eos_id, sync_every=args.sync_every,
                      page_size=args.page_size, cache_dtype=torch.bfloat16)
    sched = SlotScheduler(args.batch, eos_id=args.eos_id)
    drv.build_requests(sched, eng.cfg, args.requests, args.rate, plens,
                       args.max_new, args.seed)
    ops.reset_counts()
    got = eng.serve(sched, greedy=True)
    torch.cuda.synchronize()
    digest = drv.stream_digest(sched.finished)
    counts, routes = ops.counts(), ops.route_counts()
    log(f"[serve bf16 pool] digest {digest} (fp32 pool "
        f"{summary['stream_digest']}); pages_leaked {got['pages_leaked']}; "
        f"prefill_s {got['prefill_s']} decode_s {got['decode_s']} itl_p50 "
        f"{drv.itl_p50_ms(sched.finished)} ms; counts {counts}; routes "
        f"{routes}")
    problems = []
    if digest != summary["stream_digest"]:
        problems.append("stream digest differs from the fp32 pool's")
    if (len(sched.finished) != args.requests
            or any(r.n_generated != args.max_new for r in sched.finished)):
        problems.append("requests incomplete")
    if got["pages_leaked"] != 0 or got["nonfinite_logits"] != 0:
        problems.append(f"pages_leaked {got['pages_leaked']}, nonfinite "
                        f"{got['nonfinite_logits']}")
    for name in PATH_KERNELS["cuda"]:
        if counts[name]["launches"] <= 0:
            problems.append(f"kernel {name} never launched")
    if any(c["plain_calls"] for c in counts.values()):
        problems.append("a plain version ran")
    if routes["prefill_attention"]["simt"]:
        problems.append("prefill took the simt route")
    if routes["sa_matmul"]["partial"]:
        problems.append("a bf16 GEMM took the partial route")
    if problems:
        raise AssertionError("serve bf16 pool: " + "; ".join(problems))
    return digest


def serve_emulate(torch):
    return _serve_backend(torch, "emulate", EMU_ARGS, EMU_REQUESTS,
                          EMU_MAX_NEW)


# ---------------------------------------------------------------------------
# phase 5: tiers and ring — the bulk quality tier and the ring KV layout
# ---------------------------------------------------------------------------

def _expected_modes(cfg, summary, sync_every, probe_steps, prefills):
    """Each kernel's launches by mode that a tiered run of the driver must
    show, counted from the run's own record: a forward launches 7 GEMMs a
    layer and the lm_head's (prefill computes the last row's logits
    only) and a decode step a paged decode a layer; the engine's warm-up
    chunk (`sync_every` steps) and every exact chunk run exact, approx
    chunks approx; the divergence probe prefills once (exact) and decodes
    `probe_steps` exact and `probe_steps` approx steps on a batch-1 dense
    ring, which on the card decodes through the paged-decode kernel over
    the ring's rows (ROADMAP F5)."""
    L = cfg.num_layers
    gemms = 7 * L + 1
    exact_steps = sync_every * (1 + summary.get("chunks_exact", 0))
    approx_steps = sync_every * summary.get("chunks_approx", 0)
    return {
        "gemm": {"exact": gemms * (prefills + exact_steps + 1 + probe_steps),
                 "approx": gemms * (approx_steps + probe_steps)},
        "paged_decode": {"exact": L * (exact_steps + probe_steps),
                         "approx": L * (approx_steps + probe_steps)},
        "prefill_attention": {"exact": L * (prefills + 1), "approx": 0}}


def _tier_checks(summary, sched, max_new, n_req):
    problems = []
    done = sched.finished
    if len(done) != n_req or any(r.n_generated != max_new for r in done):
        problems.append(f"requests incomplete: "
                        f"{[(r.rid, r.n_generated) for r in done]}")
    if summary.get("pages_leaked") != 0 or summary.get("nonfinite_logits"):
        problems.append(f"pages_leaked {summary.get('pages_leaked')}, "
                        f"nonfinite {summary.get('nonfinite_logits')}")
    tmt = summary.get("tier_mode_tokens", {})
    if not summary.get("chunks_approx") or not tmt.get("bulk/approx"):
        problems.append(f"no approx chunk ran: chunks_approx "
                        f"{summary.get('chunks_approx')}, {tmt}")
    if "premium/approx" in tmt:
        problems.append(f"a premium token decoded approx: {tmt}")
    probe = {k: summary.get(f"divergence_{k}")
             for k in ("steps", "max_ulp", "kl_mean", "max_abs_diff")}
    if not (probe["max_ulp"] and probe["max_ulp"] > 0
            and all(v is not None and math.isfinite(v)
                    for v in probe.values())):
        problems.append(f"divergence probe {probe}: want max_ulp > 0 and "
                        f"every value finite")
    if not all(k in summary for k in ("energy_energy_uj",
                                      "energy_energy_saving")):
        problems.append("no energy_* keys in the summary")
    return problems


def tiers(torch, engine, serve_sched):
    """The serve phase's stream with `--tier-mix 0.5` (the same prompts:
    the tier is drawn after each prompt) on the serve phase's weights,
    through the driver: every request complete, finite logits, no page
    leaked, approx chunks ran (bulk/approx tokens, no premium/approx),
    each kernel's launches by mode exactly as the run's chunks and the
    probe account for (`_expected_modes`: the SA GEMM's and paged
    decode's approx launches > 0, prefill attention exact only), no plain
    version, the full-depth divergence probe with max_ulp > 0 and every
    value finite, and every premium request's tokens equal to the same
    request's in the serve phase's all-premium stream, bit for bit.
    Returns the launches by mode."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    allprem = {r.rid: r.tokens for r in serve_sched.finished}
    ops.reset_counts()
    t0 = time.monotonic()
    summary, sched, eng = drv.main(SERVE_ARGS + ["--tier-mix", "0.5"],
                                   return_state=True, params=engine.params)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    modes, counts = ops.mode_counts(), ops.counts()
    problems = _tier_checks(summary, sched, MAX_NEW, 8)
    want = _expected_modes(eng.cfg, summary, eng.sync_every,
                           summary.get("divergence_steps", 0), 8)
    got = {"gemm": modes["sa_matmul"], "paged_decode": modes["paged_decode"],
           "prefill_attention": modes["prefill_attention"]}
    if got != want:
        problems.append(f"launches by mode {got}, want {want}")
    if any(c["plain_calls"] for c in counts.values()):
        problems.append(f"a plain version ran: {counts}")
    prem = [r for r in sched.finished if r.tier == "premium"]
    bulk = [r for r in sched.finished if r.tier == "bulk"]
    differ = [r.rid for r in prem if r.tokens != allprem[r.rid]]
    if not prem or not bulk or differ:
        problems.append(f"premium requests {[r.rid for r in prem]}, bulk "
                        f"{[r.rid for r in bulk]}; premium tokens differing "
                        f"from the all-premium stream: {differ}")
    agree = sum(a == b for r in bulk for a, b in zip(r.tokens,
                                                      allprem[r.rid]))
    log(f"[tiers cuda] wall {wall:.2f} s (serve + probe); chunks exact "
        f"{summary.get('chunks_exact')} approx {summary.get('chunks_approx')}"
        f"; tier_mode_tokens {summary.get('tier_mode_tokens')}; "
        f"tier_affine_picks {summary.get('tier_affine_picks')}; launches by "
        f"mode {modes}")
    log(f"[tiers cuda] premium rids {[r.rid for r in prem]} bit-identical "
        f"to the all-premium stream; bulk tokens agreeing with it "
        f"{agree}/{sum(len(r.tokens) for r in bulk)}; prefill_s "
        f"{summary['prefill_s']} decode_s {summary['decode_s']} itl_p50 "
        f"{summary.get('decode_itl_p50_ms')} ms; digest "
        f"{summary['stream_digest']}")
    log("[tiers cuda] " + " ".join(f"{k}={v}" for k, v in summary.items()
                                   if k.startswith(("energy_",
                                                    "divergence_"))))
    if problems:
        raise AssertionError("tiers phase failed: " + "; ".join(problems))
    return modes


def emulate_step_ms(torch, engine, steps=2):
    """fp_emu's device time a decode step, exact and approx: a `steps`-step
    chunk of each mode on a fresh pool (its writes land on the trash
    page), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.precision import PrecisionPolicy, use_policy

    out = {}
    with use_policy(PrecisionPolicy(backend="emulate")):
        for mode in ("exact", "approx"):
            run = engine._chunk_fn(steps, True, mode)
            state = (torch.zeros((engine.batch,), dtype=torch.int32,
                                 device="cuda"), engine.new_pool(),
                     torch.zeros((engine.batch,), dtype=torch.int32,
                                 device="cuda"))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(engine.params, *state, None, None)
                torch.cuda.synchronize()
            ks = device_kernels(torch, prof)
            emu = sum(ms for name, (ms, _) in ks.items() if "fp_emu" in name)
            out[mode] = emu / steps if ks else None
    return out


def tiers_emulate(torch, engine, exact):
    """The emulate phase's two requests with `--tier-mix 1.0` (both bulk)
    through the driver on the emulate phase's weights: every decode chunk
    approx, fp_emu's launches by mode exactly as the run's chunks and the
    probe account for (its exact launches the prefills', the warm-up
    chunk's and the probe's exact pass; approx > 0) and paged decode's
    likewise (the probe's ring included), the SA GEMM never launched, no
    plain version. Prints prefill_s, ITL and fp_emu's device
    time a decode step beside the exact emulate serve's (`exact`)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    ops.reset_counts()
    summary, sched, eng = drv.main(EMU_ARGS + ["--tier-mix", "1.0"],
                                   return_state=True, params=engine.params)
    torch.cuda.synchronize()
    modes, counts = ops.mode_counts(), ops.counts()
    problems = _tier_checks(summary, sched, EMU_MAX_NEW, EMU_REQUESTS)
    if summary.get("chunks_exact") != 0:
        problems.append(f"chunks_exact {summary.get('chunks_exact')}: every "
                        f"chunk of an all-bulk stream must run approx")
    want = _expected_modes(eng.cfg, summary, eng.sync_every,
                           summary.get("divergence_steps", 0), EMU_REQUESTS)
    if modes["fp_emu"] != want["gemm"] or modes["fp_emu"]["approx"] <= 0:
        problems.append(f"fp_emu launches by mode {modes['fp_emu']}, want "
                        f"{want['gemm']}")
    if modes["paged_decode"] != want["paged_decode"]:
        problems.append(f"paged decode launches by mode "
                        f"{modes['paged_decode']}, want "
                        f"{want['paged_decode']}")
    if counts["sa_matmul"]["launches"] != 0:
        problems.append("the SA GEMM launched under the emulate backend")
    if any(c["plain_calls"] for c in counts.values()):
        problems.append(f"a plain version ran: {counts}")
    step = emulate_step_ms(torch, eng)
    log(f"[tiers emulate] chunks approx {summary.get('chunks_approx')} exact "
        f"{summary.get('chunks_exact')}; launches by mode {modes}; prefill_s "
        f"{summary['prefill_s']} (exact serve {exact['prefill_s']}); itl_p50 "
        f"{summary.get('decode_itl_p50_ms')} ms (exact serve "
        f"{exact['itl']} ms); fp_emu device ms a decode step (B="
        f"{eng.batch}, one call): exact {step['exact']} approx "
        f"{step['approx']}; divergence max_ulp "
        f"{summary.get('divergence_max_ulp')} kl_mean "
        f"{summary.get('divergence_kl_mean')} max_abs_diff "
        f"{summary.get('divergence_max_abs_diff')}")
    if problems:
        raise AssertionError("tiers emulate phase failed: "
                             + "; ".join(problems))
    return modes, step


def _decode_steps(eng, sched) -> int:
    """The decode steps a plain (non-speculative) serve ran, from its own
    record: the warm-up chunk and one chunk a scheduler observation, each
    `sync_every` steps."""
    return eng.sync_every * (1 + len(sched.depth_samples))


def ring(torch, engine, serve_summary, serve_sched):
    """The ring KV layout at full width on the serve phase's weights, and
    ROADMAP F5: the serve stream with `--kv ring` and on the paged pool
    under REPRO_DECODE_ATTN=gather. On the card both decode through the
    paged-decode kernel over dense rows (`dense_pool_view`: the ring's
    rows, and the pool's gathered view), so each must launch it exactly L
    times a decode step that the run's chunks and warm-up imply, and both
    must give the fused serve's digest (the serve phase's), every token
    equal; then `generate()` on 4 equal-length prompts (one batched
    prefill, B = 4, through the prefill kernel) must equal the ring serve
    of the same 4 requests. Returns the ring and gather runs' launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    problems = []
    out, launches = {}, {}
    os.environ["REPRO_DECODE_ATTN"] = "gather"
    try:
        for layout in ("ring", "paged"):
            ops.reset_counts()
            summary, sched, eng = drv.main(SERVE_ARGS + ["--kv", layout],
                                           return_state=True,
                                           params=engine.params)
            torch.cuda.synchronize()
            counts = ops.counts()
            out[layout] = (summary, {r.rid: r.tokens for r in sched.finished})
            if (len(sched.finished) != 8 or summary["nonfinite_logits"]
                    or any(r.n_generated != MAX_NEW for r in sched.finished)):
                problems.append(f"{layout} gather serve incomplete or "
                                f"non-finite")
            if any(c["plain_calls"] for c in counts.values()):
                problems.append(f"a plain version ran ({layout}): {counts}")
            want = eng.cfg.num_layers * _decode_steps(eng, sched)
            got = counts["paged_decode"]["launches"]
            launches[layout] = got
            if got != want:
                problems.append(f"paged decode launched {got} times under "
                                f"gather ({layout}), want {want}: L x the "
                                f"run's decode steps")
            del eng, sched
    finally:
        del os.environ["REPRO_DECODE_ATTN"]
    d_ring = out["ring"][0]["stream_digest"]
    d_paged = out["paged"][0]["stream_digest"]
    d_fused = serve_summary["stream_digest"]
    fused = {r.rid: r.tokens for r in serve_sched.finished}
    agree = {layout: sum(a == b for rid, toks in out[layout][1].items()
                         for a, b in zip(toks, fused[rid]))
             for layout in out}
    if not d_ring == d_paged == d_fused:
        problems.append(f"digests ring (gather) {d_ring}, paged (gather) "
                        f"{d_paged}, fused serve {d_fused}: want one (F5)")
    for layout, n in agree.items():
        if n != 8 * MAX_NEW:
            problems.append(f"{layout} (gather) tokens equal to the fused "
                            f"serve's {n}/{8 * MAX_NEW}")
    log(f"[ring] digest ring (gather) {d_ring}, paged (gather) {d_paged}, "
        f"paged (fused kernel, serve phase) {d_fused}; tokens equal to the "
        f"fused serve's: ring {agree['ring']}/{8 * MAX_NEW}, gather "
        f"{agree['paged']}/{8 * MAX_NEW}; paged decode launches ring "
        f"{launches['ring']}, gather {launches['paged']}; ring prefill_s "
        f"{out['ring'][0]['prefill_s']} decode_s {out['ring'][0]['decode_s']}"
        f" itl_p50 {out['ring'][0].get('decode_itl_p50_ms')} ms; gather "
        f"itl_p50 {out['paged'][0].get('decode_itl_p50_ms')} ms")

    eng = ServeEngine(engine.cfg, engine.params, BATCH, CACHE_LEN,
                      eos_id=-1, kv_layout="ring", device="cuda")
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, eng.cfg.vocab_size, (BATCH, 64), generator=g)
    ops.reset_counts()
    t0 = time.monotonic()
    got = eng.generate(prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts, stats = ops.counts(), dict(eng.last_stats)
    if counts["prefill_attention"]["launches"] != eng.cfg.num_layers:
        problems.append(f"generate's batched prefill launched the prefill "
                        f"kernel {counts['prefill_attention']['launches']} "
                        f"times, want one a layer")
    if any(c["plain_calls"] for c in counts.values()):
        problems.append(f"a plain version ran in generate: {counts}")
    if stats["nonfinite_logits"] or tuple(got.shape) != (BATCH, MAX_NEW):
        problems.append(f"generate: shape {tuple(got.shape)}, nonfinite "
                        f"{stats['nonfinite_logits']}")
    sched = SlotScheduler(BATCH, eos_id=-1)
    for p in prompts.tolist():
        sched.submit(p, max_new_tokens=MAX_NEW)
    eng.serve(sched)
    served = {r.rid: r.tokens for r in sched.finished}
    differ = [rid for rid in range(BATCH) if got[rid].tolist() != served[rid]]
    if differ:
        problems.append(f"generate differs from the ring serve in rows "
                        f"{differ}")
    log(f"[ring] generate B={BATCH} T=64 x {MAX_NEW} tokens: wall {wall:.2f}"
        f" s, prefill_s {stats['prefill_s']:.4f} decode_s "
        f"{stats['decode_s']:.4f}; rows equal to the ring serve "
        f"{BATCH - len(differ)}/{BATCH}")
    if problems:
        raise AssertionError("ring phase failed: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# disagg: disaggregated serving, replicas and the prefix cache
# ---------------------------------------------------------------------------

# the serve stream with one 32-token system prompt (two whole pages) before
# half the prompts: seed 0 gives it to rids 0, 1, 3, 5, 6 and 7
PREFIX_ARGS = SERVE_ARGS + ["--prefix-mix", "0.5", "--prefix-len", "32"]
DISAGG_RUNS = {"unified": ([], {}),
               "disagg": (["--disagg", "--prefill-workers", "2"], {}),
               "no_prefix_cache": ([], {"REPRO_PREFIX_CACHE": "0"}),
               "replicas": (["--decode-replicas", "2", "--disagg"], {})}


def disagg(torch, engine):
    """Disaggregated serving, replicas and the prefix cache at full width
    and depth on the serve phase's weights: the prefix stream
    (`PREFIX_ARGS`) served (a) unified, (b) `--disagg --prefill-workers
    2`, (c) unified under REPRO_PREFIX_CACHE=0 and (d) `--decode-replicas
    2 --disagg`. The shared prompt's pages are hit (continued prefill with
    `q_offset` into the prefill kernel, the prefix loaded from the pool,
    the copy-on-write tail). Gates: one stream digest across the four (a
    prefix hit gives a row the bits of a full prefill); 8 requests of 16
    tokens in each; prefix hits >= 1 in (a) and as many in (b), none in
    (c) (no `prefix_hits` key); no page leaked; `disagg` True with
    `ready_depth_p50` in (b) and (d); finite logits; no plain version; the
    path's kernels launched, every SA GEMM and prefill on `mma`. Prints
    each run's wall split, ITL and the replicas' serial and parallel
    walls. Returns the readings."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    problems, out = [], {}
    for name, (flags, env) in DISAGG_RUNS.items():
        os.environ.update(env)
        ops.reset_counts()
        t0 = time.monotonic()
        try:
            state = drv.main(PREFIX_ARGS + flags, return_state=True,
                             params=engine.params)
        finally:
            for key in env:
                del os.environ[key]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        summary = state[0]
        scheds = state[1] if name == "replicas" else [state[1]]
        finished = [r for sc in scheds for r in sc.finished]
        counts, routes = ops.counts(), ops.route_counts()
        # the replicas' requests are checked as one scheduler's
        problems += [f"{name}: {p}" for p in _path_checks(
            summary, types.SimpleNamespace(finished=finished), counts,
            routes, 8, MAX_NEW)]
        for kern in PATH_KERNELS["cuda"]:
            if counts[kern]["launches"] <= 0:
                problems.append(f"{name}: kernel {kern} never launched")
        keys = ("stream_digest", "prefix_hits", "prefix_tokens_saved",
                "cow_forks", "pages_leaked", "disagg", "ready_depth_p50",
                "prefill_busy_s", "decode_busy_s", "handoff_s",
                "decode_stall_s", "decode_itl_p50_ms", "prefill_compiles",
                "wall_s", "wall_s_serial", "wall_s_parallel")
        r = {k: summary[k] for k in keys if k in summary}
        r["launches"] = {k: counts[k]["launches"] for k in PATH_KERNELS["cuda"]}
        out[name] = r
        log(f"[disagg {name}] wall {wall:.2f} s; " + " ".join(
            f"{k}={v}" for k, v in r.items()))
        del state, scheds, finished
    digests = {name: r["stream_digest"] for name, r in out.items()}
    if len(set(digests.values())) != 1:
        problems.append(f"stream digests {digests}: want one")
    hits = out["unified"].get("prefix_hits")
    if not hits or out["disagg"].get("prefix_hits") != hits:
        problems.append(f"prefix hits unified {hits}, disagg "
                        f"{out['disagg'].get('prefix_hits')}: want >= 1 and "
                        f"equal")
    if "prefix_hits" in out["no_prefix_cache"]:
        problems.append("REPRO_PREFIX_CACHE=0 reported prefix hits")
    for name in ("disagg", "replicas"):
        if out[name].get("disagg") is not True or out[name].get(
                "ready_depth_p50") is None:
            problems.append(f"{name}: disagg {out[name].get('disagg')}, "
                            f"ready_depth_p50 "
                            f"{out[name].get('ready_depth_p50')}")
    log("[disagg] " + "; ".join(
        f"{name}: prefill_busy {out[name].get('prefill_busy_s')} s "
        f"decode_busy {out[name].get('decode_busy_s')} s handoff "
        f"{out[name].get('handoff_s')} s decode_stall "
        f"{out[name].get('decode_stall_s')} s itl_p50 "
        f"{out[name].get('decode_itl_p50_ms')} ms"
        for name in ("unified", "disagg"))
        + f"; replicas wall_s_serial {out['replicas'].get('wall_s_serial')}"
        f" wall_s_parallel {out['replicas'].get('wall_s_parallel')}")
    if problems:
        raise AssertionError("disagg phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# spec and bucket: self-speculative decoding and prompt-length bucketing
# ---------------------------------------------------------------------------

SPEC_K = 4
# the driver's spec_timing_probe runs the drafts and the verify once to
# warm up and 3 times timed
PROBE_RUNS = 4
# prompt lengths that `_bucket_len` maps to two buckets, 24 and 48
BUCKET_LENS = (17, 20, 23, 40, 47)
BUCKET_ARGS = ["--arch", ARCH, "--batch", str(BATCH), "--requests", "8",
               "--prompt-lens", ",".join(map(str, BUCKET_LENS)),
               "--max-new", str(MAX_NEW), "--rate", "0", "--seed", "0"]
# the path's GEMMs by output width (a layer's wq, wk, wv, wo, wg, wu, wd,
# then the lm_head)
PATH_NS = {"wq": D_MODEL, "wk": 1024, "wv": 1024, "wo": D_MODEL,
           "wg": D_FF, "wu": D_FF, "wd": D_MODEL, "lm_head": 153600}


def _expected_spec(cfg, summary, iters_per_chunk, draft_layers, k, prefills,
                   probe_runs):
    """Each kernel's launches that a spec serve through the driver must
    show, counted from the run's own record: a forward launches 7 GEMMs a
    layer and the lm_head's and a paged decode a layer; prefill computes
    the last row's logits only; a spec iteration is k draft steps of
    `draft_layers` layers and one full-depth verify; the engine's warm-up
    chunk runs `iters_per_chunk` iterations on top of the summary's
    `spec_iters`, and the driver's timing probe runs the k drafts and the
    verify `probe_runs` times each (a warm-up and its repetitions)."""
    L, E = cfg.num_layers, draft_layers * cfg.stack_period
    iters = summary["spec_iters"] + iters_per_chunk + probe_runs
    return {"gemm": (7 * L + 1) * prefills
            + iters * (k * (7 * E + 1) + 7 * L + 1),
            "paged_decode": iters * (k * E + L),
            "prefill_attention": L * prefills}


def _path_checks(summary, sched, counts, routes, n_req, max_new):
    problems = []
    done = sched.finished
    if len(done) != n_req or any(r.n_generated != max_new for r in done):
        problems.append(f"requests incomplete: "
                        f"{[(r.rid, r.n_generated) for r in done]}")
    if summary.get("pages_leaked") != 0 or summary.get("nonfinite_logits"):
        problems.append(f"pages_leaked {summary.get('pages_leaked')}, "
                        f"nonfinite {summary.get('nonfinite_logits')}")
    if any(c["plain_calls"] for c in counts.values()):
        problems.append(f"a plain version ran: {counts}")
    mm = routes["sa_matmul"]
    if mm["partial"] or mm["mma"] != counts["sa_matmul"]["launches"]:
        problems.append(f"sa_matmul routes {mm}: every GEMM must run mma")
    pre = routes["prefill_attention"]
    if pre["simt"] or pre["mma"] != counts["prefill_attention"]["launches"]:
        problems.append(f"prefill attention routes {pre}: mma only")
    return problems


def spec_layer_ms(torch, eng, slot_len=144):
    """Device time a layer of the decode step (B rows), the draft step and
    the verify (B·(k+1) rows folded), by kernel class, from torch.profiler
    on a pool whose B slots map `slot_len` tokens each (144: the serve
    stream's CACHE_LEN); the GEMMs' tile at each M from `mma_plan`."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import sa_matmul as MM
    from repro_torch.train.step import (make_draft_step, make_serve_step,
                                        make_verify_step)

    B, k, L = eng.batch, eng.spec_k, eng.cfg.num_layers
    cache = eng.new_pool()
    npg = slot_len // PAGE
    for c in cache:
        kv = c["kv"]
        for b in range(B):
            pages = torch.arange(1 + npg * b, 1 + npg * (b + 1),
                                 device=eng.device)
            kv.block_table[:, b, :npg] = pages.to(torch.int32)
            kv.positions[:, pages] = torch.arange(
                slot_len, dtype=torch.int32, device=eng.device).reshape(
                    npg, PAGE)
    pos = torch.full((B,), slot_len - k - 1, dtype=torch.int32,
                     device=eng.device)
    g = torch.Generator().manual_seed(6)
    tok = torch.randint(0, eng.cfg.vocab_size, (B, k + 1), generator=g,
                        dtype=torch.int32).to(eng.device)
    E = eng.spec_draft_layers * eng.cfg.stack_period
    steps = {
        "decode": (lambda: make_serve_step(eng.cfg)(
            eng.params, tok[:, :1], cache, pos), L, B),
        "draft": (lambda: make_draft_step(eng.cfg, eng.spec_draft_layers)(
            eng.params, tok[:, :1], cache, pos), E, B),
        "verify": (lambda: make_verify_step(eng.cfg)(
            eng.params, tok, cache, pos), L, B * (k + 1))}
    out = {}
    for name, (fn, layers, m) in steps.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = device_kernels(torch, prof)
        if not ks:
            out[name] = None
            continue
        gemm = sum(ms for n, (ms, _) in ks.items() if "sa_gemm" in n)
        attn = sum(ms for n, (ms, _) in ks.items() if "paged_decode" in n)
        total = sum(ms for ms, _ in ks.values())
        out[name] = {
            "rows": m, "layers": layers,
            "gemm_ms_a_layer": round(gemm / layers, 5),
            "paged_decode_ms_a_layer": round(attn / layers, 5),
            "device_ms": round(total, 4),
            "tiles": {g_: MM.mma_plan(m, n, "mma")["tile"]
                      for g_, n in PATH_NS.items()}}
    return out


def verify_yardsticks(torch, slot_len=144):
    """The spec verify's work a layer beside its yardsticks, at the verify's
    B·(k+1) = 20 rows: the 7 layer GEMMs at M = 20 (the kernel's wall and
    device times, bf16 `torch.matmul`, the byte bound of A, W, the bias
    and the fp32 output) and paged decode over 20 rows (4 slots of
    `slot_len` tokens, each slot's block-table row repeated for its 5
    rows: the kernel, SDPA on the gathered view, and the bound with each
    slot's pages read once and each row's q and output)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_decode_attention as da
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import LAYER_GEMMS

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(11)
    T = SPEC_K + 1
    m = BATCH * T
    gemm = {"ms": 0.0, "device_ms": 0.0, "library_ms": 0.0, "plain_ms": 0.0}
    nbytes = flops = 0.0
    for _, k, n, has_bias, act in LAYER_GEMMS:
        a = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        bias = (torch.randn((n,), generator=g, device="cuda") * 0.1
                if has_bias else None)

        def run():
            return ops.sa_matmul(a, w, bias=bias, act=act)
        gemm["ms"] += timer.wall(run)
        d = timer.device(run)
        gemm["device_ms"] = (None if d is None or gemm["device_ms"] is None
                             else gemm["device_ms"] + d)
        gemm["library_ms"] += timer.wall(lambda: torch.matmul(a, w))
        gemm["plain_ms"] += timer.wall(lambda: mm.sa_matmul_ref(
            a, w, bias, act=act))
        nbytes += 2 * (m * k + k * n) + 4 * m * n + (4 * n if has_bias
                                                       else 0)
        flops += 2.0 * m * n * k
    gemm["bound_ms"], gemm["bound_by"] = bound_ms(nbytes, flops, PEAK_BF16)
    del a, w, bias

    KVH, grp, hd, psz = 8, 5, 128, PAGE
    H, P = KVH * grp, -(-slot_len // psz)
    _, k, v, pp, bt, pos4 = _paged_workload(
        torch, g, BATCH, KVH, grp, hd, psz, P, BATCH * P + 1,
        [slot_len] * BATCH)
    q = torch.randn((m, 1, H, hd), generator=g, device="cuda")
    rows = torch.repeat_interleave(bt, T, dim=0)
    pos = (pos4[:, None] - SPEC_K + torch.arange(T, device="cuda")
           ).reshape(m).to(torch.int32)

    def run():
        return ops.paged_decode_attention(q, k, v, pp, rows, pos)
    mapped, mapped_rows = int((bt > 0).sum()), int((rows > 0).sum())
    b_ms, by = bound_ms(
        4 * m * H * hd * 2 + mapped * psz * (KVH * hd * 4 * 2 + 4)
        + 4 * m * P + 4 * m, 4.0 * H * hd * psz * mapped_rows, PEAK_BF16)
    decode = {"ms": timer.wall(run), "device_ms": timer.device(run),
              "library_ms": timer.wall(_sdpa_gathered(
                  torch, q, k, v, pp, rows, pos, grp)),
              "plain_ms": timer.wall(lambda: da.paged_decode_ref(
                  q, k, v, pp, rows, pos)),
              "bound_ms": b_ms, "bound_by": by}
    del timer, q, k, v, pp, bt, rows
    gc.collect()
    torch.cuda.empty_cache()
    out = {"rows": m, "gemm_layer": gemm, "paged_decode": decode}
    log(f"[spec] the verify's {m} rows, a layer: 7 GEMMs {gemm['ms']:.4f} "
        f"ms wall ({gemm['device_ms']} device), bf16 torch.matmul "
        f"{gemm['library_ms']:.4f} ms, plain {gemm['plain_ms']:.4f} ms, "
        f"bound {gemm['bound_ms']:.4f} ms ({gemm['bound_by']}); paged "
        f"decode {decode['ms']:.4f} ms wall ({decode['device_ms']} "
        f"device), SDPA on the gathered view {decode['library_ms']:.4f} ms, "
        f"plain {decode['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({by})")
    return out


def spec(torch, engine, serve_summary):
    """Self-speculative decoding at full width and depth: the serve
    stream through the driver with `--spec-k 4` on the serve phase's
    weights (fp32 pool, fused decode), once with a 24-superblock draft
    and once with all 48. Gates: requests complete, no page leaked, no
    plain version, every SA GEMM on `mma` and prefill on `mma`, each
    kernel's launches exactly as the run's iterations imply
    (`_expected_spec`); at 24 the stream digest equals the plain serve's
    and drafts ran; at 48 every draft is accepted (the draft is the plain
    decode step at M = 4, the verify the same rows folded at M = 20: F2 on
    a served path). Prints the accept rate and histogram, ITL,
    decode_tok_s, the probe's draft and verify seconds an iteration and
    the per-layer device times of the decode step, the draft and the
    verify. Returns the readings."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    L = engine.cfg.num_layers
    problems, out = [], {}
    for E in (L // 2, L):
        ops.reset_counts()
        t0 = time.monotonic()
        summary, sched, eng = drv.main(
            SERVE_ARGS + ["--spec-k", str(SPEC_K), "--spec-draft-layers",
                          str(E)], return_state=True, params=engine.params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, routes = ops.counts(), ops.route_counts()
        problems += [f"E={E}: {p}" for p in _path_checks(
            summary, sched, counts, routes, 8, MAX_NEW)]
        per_chunk = -(-eng.sync_every // (SPEC_K + 1))
        want = _expected_spec(eng.cfg, summary, per_chunk, E, SPEC_K, 8,
                              PROBE_RUNS)
        got = {"gemm": counts["sa_matmul"]["launches"],
               "paged_decode": counts["paged_decode"]["launches"],
               "prefill_attention": counts["prefill_attention"]["launches"]}
        if got != want:
            problems.append(f"E={E}: launches {got}, want {want}")
        iters = summary["spec_iters"]
        # the verify-shaped launches inside the held totals: every
        # iteration's verify (the warm-up chunk's and the probe's too) runs
        # 7 GEMMs a layer at M = B·(k+1) plus the lm_head, and a paged
        # decode a layer over B·(k+1) rows
        n_verify = iters + per_chunk + PROBE_RUNS
        verify = {"gemm_rows": BATCH * (SPEC_K + 1),
                  "gemm": n_verify * (7 * L + 1),
                  "paged_decode": n_verify * L}
        r = {"digest": summary["stream_digest"],
             "spec_accept_rate": summary["spec_accept_rate"],
             "spec_accept_hist": summary["spec_accept_hist"],
             "spec_iters": iters, "spec_drafted": summary["spec_drafted"],
             "decode_itl_p50_ms": summary.get("decode_itl_p50_ms"),
             "decode_tok_s": summary.get("decode_tok_s"),
             "prefill_s": summary["prefill_s"],
             "decode_s": summary["decode_s"],
             "draft_s_an_iter": round(summary["spec_draft_s"] / iters, 5),
             "verify_s_an_iter": round(summary["spec_verify_s"] / iters, 5),
             "launches": got, "verify_launches": verify,
             "routes": routes["sa_matmul"]}
        out[E] = r
        log(f"[spec E={E}/{L}] wall {wall:.2f} s; " + " ".join(
            f"{k_}={v}" for k_, v in r.items()))
        if E == L:
            out["layer_ms"] = spec_layer_ms(torch, eng)
            out["verify_yardsticks"] = verify_yardsticks(torch)
        del eng, sched
    half, full = out[L // 2], out[L]
    if half["digest"] != serve_summary["stream_digest"]:
        problems.append(f"spec digest {half['digest']} (draft {L // 2}) != "
                        f"the plain serve's {serve_summary['stream_digest']}")
    if not half["spec_drafted"]:
        problems.append("no draft ran")
    if full["spec_accept_rate"] != 1.0:
        problems.append(f"draft of the whole stack: accept rate "
                        f"{full['spec_accept_rate']}, want 1.0 "
                        f"({full['spec_accept_hist']})")
    if full["digest"] != serve_summary["stream_digest"]:
        problems.append(f"spec digest {full['digest']} (draft {L}) != the "
                        f"plain serve's")
    for name, v in out["layer_ms"].items():
        log(f"[spec] {name} step: {v}")
    if problems:
        raise AssertionError("spec phase failed: " + "; ".join(problems))
    return out


def bucket(torch, engine):
    """Prompt-length bucketing at full width and depth: 8 requests of
    prompt lengths 17, 20, 23, 40, 47 (buckets 24 and 48) served through
    the driver with and without `--bucket-prompts` on the serve phase's
    weights. Gates: one stream digest, `prefill_compiles` 2 bucketed
    against 5, prefill attention on its `mma` route at every padded T,
    requests complete, no page leaked, no plain version. Returns the
    readings."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    problems, out = [], {}
    for name, flag in (("plain", []), ("bucketed", ["--bucket-prompts"])):
        ops.reset_counts()
        t0 = time.monotonic()
        summary, sched, _ = drv.main(BUCKET_ARGS + flag, return_state=True,
                                     params=engine.params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, routes = ops.counts(), ops.route_counts()
        problems += [f"{name}: {p}" for p in _path_checks(
            summary, sched, counts, routes, 8, MAX_NEW)]
        n_pre = counts["prefill_attention"]["launches"]
        if n_pre != 8 * engine.cfg.num_layers:
            problems.append(f"{name}: prefill attention launched {n_pre}")
        out[name] = {"digest": summary["stream_digest"],
                     "prefill_compiles": summary["prefill_compiles"],
                     "prefill_s": summary["prefill_s"],
                     "ttft_mean_s": summary.get("ttft_mean_s"),
                     "decode_itl_p50_ms": summary.get("decode_itl_p50_ms"),
                     "prefill_launches": counts["prefill_attention"][
                         "launches"], "routes": routes}
        log(f"[bucket {name}] wall {wall:.2f} s; " + " ".join(
            f"{k_}={v}" for k_, v in out[name].items()))
    if out["plain"]["digest"] != out["bucketed"]["digest"]:
        problems.append(f"digest bucketed {out['bucketed']['digest']} != "
                        f"plain {out['plain']['digest']}")
    if (out["plain"]["prefill_compiles"], out["bucketed"]["prefill_compiles"]
            ) != (5, 2):
        problems.append(f"prefill_compiles plain "
                        f"{out['plain']['prefill_compiles']}, bucketed "
                        f"{out['bucketed']['prefill_compiles']}: want 5, 2")
    if problems:
        raise AssertionError("bucket phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 5 (continued): the autotuner and the examples
# ---------------------------------------------------------------------------

# the autotuner's cache files live here for the whole run (main sets it):
# no phase reads a cache left by an earlier run
TUNE_DIR = None


def fresh_tune_cache(tag: str) -> str:
    """Point the autotuner at a new empty cache file and forget what it
    holds in memory: lookups give the heuristic again."""
    from repro_torch.kernels import autotune

    path = os.path.join(TUNE_DIR, f"{tag}.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": {}}, f)
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    os.environ.pop("REPRO_AUTOTUNE", None)
    autotune.reset()
    return path


def _plain_launches(cfg, eng, sched, prefills=8):
    """A plain serve's launches from its own record: 7 GEMMs a layer and
    the lm_head a forward, a paged decode a layer a decode step, a
    prefill attention a layer a prefill."""
    L, steps = cfg.num_layers, _decode_steps(eng, sched)
    return {"gemm": (7 * L + 1) * (prefills + steps),
            "paged_decode": L * steps, "prefill_attention": L * prefills}


def _launches_of(counts):
    return {"gemm": counts["sa_matmul"]["launches"],
            "paged_decode": counts["paged_decode"]["launches"],
            "prefill_attention": counts["prefill_attention"]["launches"]}


def _sweep_rows(sweeps):
    """The sweeps as JSON-ready rows: the key, each candidate's µs, the
    winner and the heuristic's choice."""
    rows = []
    for r in sweeps:
        # the key: (m, n, k) or (g, hd, page, pages), then the dtype
        n = 3 if r["kind"] == "gemm" else 4
        rows.append({"kind": r["kind"],
                     "key": "x".join(map(str, r["key"][:n])),
                     "dtype": r["key"][n],
                     "us": {str(c): round(us, 3) for c, us in r["us"].items()},
                     "winner": r["winner"], "heuristic": r["heuristic"]})
    return rows


def autotune_serve(torch, engine, serve_summary):
    """The serve stream through the driver with `--autotune-decode` on the
    serve phase's weights and an empty cache: the sweep's every (M, N, K)
    and n_split with each candidate's time, the winner and the heuristic's
    choice; then with `--spec-k 4` and a draft of all 48 superblocks
    (seeds the verify's M = 20; M = 4 and the cluster size come from the
    cache). Gates: the untuned serve's digest (neither the tile nor the
    cluster size changes a bit: ROADMAP F9), 0 autotune misses over
    the decode chunks, each kernel's launches as the run implies (the
    sweep's own launches are not counted), the serve phase's checks;
    spec's digest and accept rate 1.0. Returns the readings (the cache
    file stays for the second process)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    fresh_tune_cache("tuned")
    untuned = serve_summary["stream_digest"]
    L = engine.cfg.num_layers
    problems, out = [], {}
    for tag, extra in (("plain", []), ("spec", [
            "--spec-k", str(SPEC_K), "--spec-draft-layers", str(L)])):
        n0 = len(autotune.SWEPT)
        ops.reset_counts()
        t0 = time.monotonic()
        summary, sched, eng = drv.main(SERVE_ARGS + ["--autotune-decode"]
                                       + extra, return_state=True,
                                       params=engine.params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, routes = ops.counts(), ops.route_counts()
        problems += [f"{tag}: {p}" for p in _path_checks(
            summary, sched, counts, routes, 8, MAX_NEW)]
        got = _launches_of(counts)
        if tag == "plain":
            want = _plain_launches(eng.cfg, eng, sched)
        else:
            want = _expected_spec(eng.cfg, summary,
                                  -(-eng.sync_every // (SPEC_K + 1)), L,
                                  SPEC_K, 8, PROBE_RUNS)
        if got != want:
            problems.append(f"{tag}: launches {got}, want {want}")
        sweeps = autotune.SWEPT[n0:]
        r = {"digest": summary["stream_digest"],
             "sweeps": _sweep_rows(sweeps),
             "tiles": summary["autotune_tiles"],
             "n_split": summary["autotune_n_split"],
             "decode_misses": summary["autotune_decode_misses"],
             "decode_itl_p50_ms": summary.get("decode_itl_p50_ms"),
             "prefill_s": summary["prefill_s"],
             "decode_s": summary["decode_s"], "wall_s": round(wall, 2),
             "launches": got, "tile_launches": ops.tile_counts()}
        if summary["autotune_decode_misses"] != 0:
            problems.append(f"{tag}: {summary['autotune_decode_misses']} "
                            f"autotune misses in the decode chunks")
        for s in r["sweeps"]:
            log(f"[autotune {tag}] {s['kind']} {s['key']} {s['dtype']}: "
                + " ".join(f"{c} {us:.3f} us" for c, us in s["us"].items())
                + f" -> {s['winner']} (heuristic {s['heuristic']})")
        # the (M, N, K) the summary reports as chosen
        shapes = [t.split(":")[0] for t in r["tiles"].split(",")]
        if tag == "plain":
            # each distinct (N, K) of the decode step once at M = 4, and
            # the cluster size
            cfg = engine.cfg
            want_keys = sorted(shapes + [
                f"{cfg.num_heads // cfg.num_kv_heads}x{cfg.hd}x{PAGE}x"
                f"{-(-CACHE_LEN // PAGE)}"])
            if sorted(s["key"] for s in r["sweeps"]) != want_keys:
                problems.append(f"plain: sweeps "
                                f"{[s['key'] for s in r['sweeps']]}, want "
                                f"{want_keys}")
            # ROADMAP F9: the paged decode sums run by run, so a tuned
            # cluster size changes no bit either
            if r["digest"] != untuned:
                problems.append(f"plain: tuned digest {r['digest']} != the "
                                f"untuned {untuned} (F9)")
        else:
            r["spec_accept_rate"] = summary["spec_accept_rate"]
            # only the verify's M = 20: M = 4 and the cluster size are
            # cached
            want_keys = sorted(k_ for k_ in shapes if k_.startswith(
                f"{BATCH * (SPEC_K + 1)}x"))
            if sorted(s["key"] for s in r["sweeps"]) != want_keys:
                problems.append(f"spec: sweeps "
                                f"{[s['key'] for s in r['sweeps']]}, want "
                                f"{want_keys}")
            if r["digest"] != out["plain"]["digest"]:
                problems.append(f"spec digest {r['digest']} != the tuned "
                                f"plain serve's {out['plain']['digest']}")
            if summary["spec_accept_rate"] != 1.0:
                problems.append(f"spec accept rate "
                                f"{summary['spec_accept_rate']}, want 1.0")
        out[tag] = r
        log(f"[autotune {tag}] wall {wall:.2f} s; digest {r['digest']} "
            f"(untuned {untuned}); tiles {r['tiles']}; n_split "
            f"{r['n_split']}; decode misses {r['decode_misses']}; launches "
            f"{got}; tiles launched {r['tile_launches']}; itl_p50 "
            f"{r['decode_itl_p50_ms']} ms (untuned "
            f"{serve_summary.get('decode_itl_p50_ms')})")
        del eng, sched
    if problems:
        raise AssertionError("autotune phase failed: " + "; ".join(problems))
    return out


def _summary_fields(line: str) -> dict:
    """key=value fields of a driver summary line whose values hold no
    spaces."""
    return dict(f.split("=", 1) for f in line.split()[1:] if "=" in f)


def autotune_second_process(torch, first, during=None):
    """The tuned serve again in a new process (`python -m
    repro_torch.launch.serve ... --autotune-decode`) on the cache file the
    first run wrote: 0 sweeps, the same tiles and cluster size, the same
    digest, 0 misses. While it runs, `during()` runs here (the examples,
    with a fresh empty cache of their own). Then the cache is reset to a
    fresh empty file and a lookup gives the heuristic's tile again.
    Returns (the readings, what `during` returned)."""
    import tempfile

    from repro_torch.kernels import autotune
    from repro_torch.kernels import sa_matmul as mm

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, REPRO_GEMM_BACKEND="cuda",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.monotonic()
    with tempfile.TemporaryFile("w+") as fo, \
            tempfile.TemporaryFile("w+") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve"] + SERVE_ARGS
            + ["--autotune-decode"], stdout=fo, stderr=fe, env=env,
            cwd=root)
        beside = None
        try:
            if during is not None:
                fresh_tune_cache("beside")
                beside = during()
            proc.wait(timeout=900)
        finally:
            if proc.poll() is None:     # `during` failed, or a timeout
                proc.kill()
                proc.wait()
        wall = time.monotonic() - t0
        fo.seek(0)
        fe.seek(0)
        res = types.SimpleNamespace(returncode=proc.returncode,
                                    stdout=fo.read(), stderr=fe.read())
    line = next((ln for ln in res.stdout.splitlines()
                 if ln.startswith("[continuous]")), "")
    got = _summary_fields(line)
    r = {"rc": res.returncode, "wall_s": round(wall, 2),
         "digest": got.get("stream_digest"),
         "n_sweeps": got.get("autotune_sweeps"),
         "tiles": got.get("autotune_tiles"),
         "n_split": got.get("autotune_n_split"),
         "decode_misses": got.get("autotune_decode_misses"),
         "decode_itl_p50_ms": got.get("decode_itl_p50_ms")}
    log(f"[autotune second process] {json.dumps(r)}")
    problems = []
    if res.returncode != 0:
        problems.append(f"exit {res.returncode}: {res.stderr[-2000:]}")
    want = first["plain"]
    if r["n_sweeps"] != "0":
        problems.append(f"{r['n_sweeps']} sweeps, want 0 (the cache)")
    for key in ("digest", "tiles", "n_split"):
        if r[key] != str(want[key]):
            problems.append(f"{key} {r[key]}, first process {want[key]}")
    if r["decode_misses"] != "0":
        problems.append(f"{r['decode_misses']} decode misses")
    fresh_tune_cache("after")
    heur = mm.mma_plan(BATCH, D_MODEL, "mma")["tile"]
    if autotune.lookup(BATCH, D_MODEL, D_MODEL) != heur or \
            autotune.MISSES != 1:
        problems.append("after reset a lookup did not give the heuristic")
    autotune.reset()
    if problems:
        raise AssertionError("autotune second process failed: "
                             + "; ".join(problems))
    return r, beside


EXAMPLE_TIMEOUT = 600


def examples(torch):
    """The four port examples on the card as subprocesses under the
    `cuda` GEMM backend, each with its documented arguments:
    quickstart's loss falls over its 40 steps; serve_batch finishes 12 of
    12 requests (216 tokens, no page leaked, finite logits);
    train_100m runs its 30 steps into a temporary checkpoint directory,
    then resumes from step 30 there and runs 5 more; the precision study
    prints "bit-exact: True" for every format and section 2's cycle
    counts equal to `core.systolic`'s. Returns each one's wall and
    readings."""
    import shutil
    import tempfile

    from repro_torch.core.systolic import (BASELINE, SKEWED, SAConfig,
                                           gemm_latency)

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, REPRO_GEMM_BACKEND="cuda",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    problems, out = [], {}
    # the examples' output files, and train_100m's checkpoints under ckpt/
    work = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    ckpt = os.path.join(work, "ckpt")

    def start(name, *args):
        """Start an example, its output to files (no pipe fills up while
        another one is read)."""
        base = os.path.join(work, f"{name}{len(args)}")
        with open(base + ".out", "w") as fo, open(base + ".err", "w") as fe:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(root, "examples",
                                              f"{name}.py"), *args],
                stdout=fo, stderr=fe, env=env, cwd=root)
        proc.base = base
        return proc

    def finish(tag, proc, t0):
        try:
            proc.wait(timeout=EXAMPLE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        with open(proc.base + ".out") as fo, open(proc.base + ".err") as fe:
            stdout, stderr = fo.read(), fe.read()
        out[tag] = {"rc": proc.returncode,
                    "wall_s": round(time.monotonic() - t0, 2)}
        if proc.returncode != 0:
            problems.append(f"{tag}: exit {proc.returncode}: "
                            f"{stderr[-1500:]}")
        return stdout

    # the four run side by side on the card (each is small); the resumed
    # train_100m run follows its first
    t0 = time.monotonic()
    procs = {"quickstart": start("quickstart_torch"),
             "serve_batch": start("serve_batch_torch"),
             "train_100m": start("train_100m_torch", "--ckpt-dir", ckpt),
             "study": start("sa_precision_study_torch")}
    try:
        text = finish("train_100m", procs.pop("train_100m"), t0)
        steps = [ln for ln in text.splitlines() if ln.startswith("step ")]
        losses = [float(ln.split("loss=")[1].split()[0]) for ln in steps]
        out["train_100m"] |= {"steps": len(steps), "losses": losses[::10]
                              + losses[-1:]}
        if len(steps) != 30 or "done: 30 steps" not in text:
            problems.append(f"train_100m ran {len(steps)} steps, want 30")
        t1 = time.monotonic()
        text = finish("train_100m_resume", start(
            "train_100m_torch", "--ckpt-dir", ckpt, "--steps", "35"), t1)
        steps = [ln for ln in text.splitlines() if ln.startswith("step ")]
        out["train_100m_resume"]["steps"] = len(steps)
        if "resumed from step 30" not in text or len(steps) != 5:
            problems.append(f"train_100m resume: {len(steps)} steps, "
                            f"'resumed from step 30' "
                            f"{'resumed from step 30' in text}")

        text = finish("quickstart", procs.pop("quickstart"), t0)
        last = [ln for ln in text.splitlines() if ln.startswith("loss:")]
        if last:
            first, final = (float(x) for x in
                            last[0].split()[1:4:2])
            out["quickstart"] |= {"first_loss": first, "last_loss": final}
            if not final < first:
                problems.append(f"quickstart loss {first} -> {final}")
        else:
            problems.append("quickstart printed no loss line")

        text = finish("serve_batch", procs.pop("serve_batch"), t0)
        reqs = [ln for ln in text.splitlines() if ln.startswith("req ")]
        summ = _summary_fields("- " + (text.strip().splitlines() or [""])[-1])
        out["serve_batch"] |= {
            key: summ.get(key) for key in (
                "requests", "generated_tokens", "pages_leaked",
                "nonfinite_logits", "decode_tok_s", "ttft_mean_s")}
        if (len(reqs) != 12 or summ.get("requests") != "12"
                or summ.get("generated_tokens") != "216"
                or summ.get("pages_leaked") != "0"
                or summ.get("nonfinite_logits") != "0"):
            problems.append(f"serve_batch: {len(reqs)} request lines, "
                            f"summary {out['serve_batch']}")

        text = finish("study", procs.pop("study"), t0)
        exact = [ln for ln in text.splitlines() if "bit-exact:" in ln]
        cycles = []
        for ln in text.splitlines():
            if " cycles (" in ln:
                shape, rest = ln.split(":")[0].split()[-1], ln.split(":")[1]
                m, k, n = (int(x) for x in shape.split("x"))
                cb, cs = (int(x) for x in rest.split()[0:3:2])
                cycles.append((m, k, n, cb, cs))
        want = [(m, k, n, gemm_latency(m, k, n, SAConfig(pipeline=BASELINE)),
                 gemm_latency(m, k, n, SAConfig(pipeline=SKEWED)))
                for m, k, n, _, _ in STUDY_GEMMS]
        out["study"] |= {"bit_exact_lines": len(exact), "cycles": cycles}
        if len(exact) != 3 or not all(ln.endswith("True") for ln in exact):
            problems.append(f"study bit-exact lines {exact}")
        if cycles != want or cycles != [tuple(x) for x in STUDY_GEMMS]:
            problems.append(f"study cycles {cycles}, core.systolic {want}")
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = round(time.monotonic() - t0, 2)
    log(f"[examples] {json.dumps(out)}")
    if problems:
        raise AssertionError("examples phase failed: " + "; ".join(problems))
    return out


DECODE_TILE = "TcTile<16, "    # the decode tile's kernels, by name


def _is_decode_tile(name: str) -> bool:
    return "sa_gemm_mma" in name and DECODE_TILE in name


def profile_serve(torch, engine, tag="profile", requests=True):
    """Where the time goes: four requests (the three prompt lengths and
    one more of the longest, 16 new tokens each) served again under
    torch.profiler (CUDA activity only); device-busy share of the wall and
    the kernels that take the device time. Then one decode chunk alone
    (`sync_every` steps on a fresh pool, as the engine's warm-up runs it):
    its kernel launches and device time per decode step, the decode
    tile's share of its device time, and its idle share under the
    profiler. Without `requests`, the chunk alone. Returns those readings
    (None if the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.precision import PrecisionPolicy, use_policy

    out = {}
    if requests:
        out = _profile_requests(torch, engine, tag)
        if out is None:
            return None
    steps = engine.sync_every
    run = engine._chunk_fn(steps, True)
    state = (torch.zeros((BATCH,), dtype=torch.int32, device="cuda"),
             engine.new_pool(),
             torch.zeros((BATCH,), dtype=torch.int32, device="cuda"))
    with use_policy(PrecisionPolicy(backend="cuda")):
        run(engine.params, *state, None, None)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(engine.params, *state, None, None)
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    ks = device_kernels(torch, prof)
    if not ks:
        log(f"[{tag}] the profiler recorded no device time")
        return None
    busy = sum(ms for ms, _ in ks.values())
    launches = sum(n for _, n in ks.values())
    tile = [(ms, n) for name, (ms, n) in ks.items() if _is_decode_tile(name)]
    partial = sum(n for name, (_, n) in ks.items() if "sa_gemm_partial" in name)
    out.update(step_launches=launches / steps, step_device_ms=busy / steps,
               chunk_wall_s=wall, chunk_idle_share=1 - busy / 1e3 / wall)
    log(f"[{tag}] one decode chunk ({steps} steps, B={BATCH}): "
        f"{launches / steps:.1f} kernel launches a decode step, device "
        f"{busy / steps:.4f} ms a step; the decode tile "
        f"{sum(n for _, n in tile) / steps:.1f} launches and "
        f"{100 * sum(ms for ms, _ in tile) / busy:.1f} % of device time; "
        f"sa_gemm_partial {partial} launches; wall {wall:.3f} s under the "
        f"profiler, idle share {out['chunk_idle_share']:.3f}")
    if partial:
        raise AssertionError("the bf16 decode step launched sa_gemm_partial")
    return out


def _profile_requests(torch, engine, tag):
    """`profile_serve`'s four requests under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.precision import PrecisionPolicy, use_policy
    from repro_torch.launch.serve import itl_p50_ms
    from repro_torch.serve.scheduler import SlotScheduler

    g = torch.Generator().manual_seed(5)
    sched = SlotScheduler(BATCH, eos_id=-1)
    for n in PROMPT_LENS + (max(PROMPT_LENS),):
        sched.submit(torch.randint(0, engine.cfg.vocab_size, (n,),
                                   generator=g).tolist(), MAX_NEW)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with use_policy(PrecisionPolicy(backend="cuda")):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            summary = engine.serve(sched)
            torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ks = device_kernels(torch, prof)
    busy = sum(ms for ms, _ in ks.values()) / 1e3
    if not ks:
        log(f"[{tag}] the profiler recorded no device time")
        return None
    tile_ms = sum(ms for name, (ms, _) in ks.items() if _is_decode_tile(name))
    out = {"wall_s": wall, "device_busy_s": busy,
           "idle_share": 1 - busy / wall,
           "decode_tile_share": tile_ms / 1e3 / busy,
           "prefill_s": summary["prefill_s"], "decode_s": summary["decode_s"],
           "itl_p50_ms": itl_p50_ms(sched.finished)}
    log(f"[{tag}] wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{out['idle_share']:.3f}; prefill_s {summary['prefill_s']} "
        f"decode_s {summary['decode_s']} itl_p50 {out['itl_p50_ms']} ms; "
        f"the decode tile {100 * out['decode_tile_share']:.1f} % of device "
        f"time")
    for name, (ms, n) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[{tag}]   {ms / 1e3:8.4f} s {100 * ms / 1e3 / busy:5.1f}% "
            f"{n:7d} launches  {name[:90]}")
    return out


def profile_emulate(torch, engine):
    """The `emulate` serve's time under torch.profiler: its two requests
    (the EMU_ARGS prompt lengths, EMU_MAX_NEW new tokens each) served again
    on the same engine; prefill_s, decode ITL, the device's idle share and
    fp_emu's share of device time. Returns those readings."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.precision import PrecisionPolicy, use_policy
    from repro_torch.launch.serve import itl_p50_ms
    from repro_torch.serve.scheduler import SlotScheduler

    g = torch.Generator().manual_seed(6)
    sched = SlotScheduler(EMU_REQUESTS, eos_id=-1)
    for n in (16, 32):
        sched.submit(torch.randint(0, engine.cfg.vocab_size, (n,),
                                   generator=g).tolist(), EMU_MAX_NEW)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with use_policy(PrecisionPolicy(backend="emulate")):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            summary = engine.serve(sched)
            torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ks = device_kernels(torch, prof)
    busy = sum(ms for ms, _ in ks.values()) / 1e3
    emu = sum(ms for name, (ms, _) in ks.items() if "fp_emu" in name) / 1e3
    out = {"wall_s": wall, "prefill_s": summary["prefill_s"],
           "decode_s": summary["decode_s"],
           "decode_itl_p50_ms": itl_p50_ms(sched.finished),
           "device_busy_s": busy,
           "idle_share": 1 - busy / wall if ks else None,
           "fp_emu_share": emu / busy if busy else None}
    log(f"[profile emulate] {out}")
    for name, (ms, n) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:5]:
        log(f"[profile emulate]   {ms / 1e3:8.4f} s {n:7d} launches  "
            f"{name[:90]}")
    return out


def backend_logits(torch, engine, prompt, backends=("cuda", "torch"),
                   frontend=None):
    """One prompt's prefill logits under two GEMM backends (same weights,
    same policy otherwise); `frontend` (1, S, d) feeds a frontend arch (a
    VLM's fragment then holds its S patch rows too)."""
    from repro_torch.core.precision import PrecisionPolicy, use_policy
    from repro_torch.train.step import make_prefill_step

    tokens = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
    step = make_prefill_step(engine.cfg)
    rows = len(prompt) + (frontend.shape[1] if frontend is not None
                          and engine.cfg.family == "vlm" else 0)
    out = {}
    for backend in backends:
        with use_policy(PrecisionPolicy(backend=backend)):
            frag = engine.new_frag(rows)
            logits, _ = step(engine.params, tokens, frag, frontend)
        out[backend] = logits[0, -1, :engine.cfg.vocab_size].float()
    torch.cuda.synchronize()
    a, b = (out[k] for k in backends)
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite prefill logits")
    diff = float((a - b).abs().max())
    scale = float(b.abs().max())
    # stated bound: 48 layers of a bf16 residual stream; a one-ulp flip of
    # a bf16 rounding (2^-8 relative) may propagate, so the logits agree to
    # 2^-3 of their largest magnitude, and the argmax agrees wherever the
    # top-2 gap exceeds twice the observed difference
    bound = 2.0 ** -3 * scale
    top2 = torch.topk(b, 2).values
    gap = float(top2[0] - top2[1])
    log(f"[backends] prefill logits {backends[0]} vs {backends[1]} "
        f"({len(prompt)} tokens): max|diff| {diff:.4e}, max|logit| "
        f"{scale:.4e}, bound {bound:.4e}, top-2 gap {gap:.4e}, argmax "
        f"{int(a.argmax())} vs {int(b.argmax())}")
    if diff > bound:
        raise AssertionError("prefill logits differ beyond the bound")
    if gap > 2 * diff and int(a.argmax()) != int(b.argmax()):
        raise AssertionError("argmax differs with a top-2 gap above 2x diff")
    return diff, bound


def study(torch):
    """The precision study at full width; returns the quantize kernel's
    launches in it."""
    from repro_torch.kernels import ops
    from repro_torch.launch import precision_study as ps

    ops.reset_counts()
    res = ps.main(["--arch", ARCH, "--seed", "0"])
    torch.cuda.synchronize()
    counts = ops.counts()
    log(f"[study] counts {counts}")
    problems = []
    if not all(res["bit_exact"].values()):
        problems.append(f"skewed vs baseline not bit-exact: "
                        f"{res['bit_exact']}")
    if [tuple(x) for x in res["gemms"]] != STUDY_GEMMS:
        problems.append(f"GEMM cycles {res['gemms']} != {STUDY_GEMMS}")
    for net, (lat, en) in STUDY_NETWORKS.items():
        t = res["networks"][net]
        if (t["latency_saving"], t["energy_saving"]) != (lat, en):
            problems.append(f"{net}: savings {t['latency_saving']}, "
                            f"{t['energy_saving']} != {lat}, {en}")
    lad = res["ladder"]
    devs = {f: r["max_rel_dev"] for f, r in lad.items()}
    if not all(math.isfinite(d) for d in devs.values()) or not (
            0 < devs["bf16"] < devs["fp8_e4m3"]):
        problems.append(f"precision ladder out of order: {devs}")
    if counts["quantize"]["launches"] <= 0:
        problems.append("the quantize kernel never launched")
    if counts["quantize"]["plain_calls"] != 0:
        problems.append("the quantize kernel's plain version ran")
    if problems:
        raise AssertionError("study phase failed: " + "; ".join(problems))
    return counts["quantize"]["launches"]


# ---------------------------------------------------------------------------
# families: gemma3-12b, gemma2-9b and phi3-medium-14b at full width and depth
# ---------------------------------------------------------------------------

# each family's stream through the driver: gemma3's prompts of 1100 and
# 1500 tokens pass its 1024-token window in prefill, and its rings wrap in
# decode; gemma2's 4200-token prompt passes its 4096-token window; phi3
# takes the qwen serve's stream
# each at full width cut to a quarter of its depth or so (half since PR
# 29, a quarter since PR 30, for the whole run's time limit): gemma3 12 of
# 48 layers (2 superblocks of 5 local + 1 global), gemma2 12 of 42, phi3
# 10 of 40
FAMILY_RUNS = {
    "gemma3-12b": ["--batch", "4", "--requests", "6", "--prompt-lens",
                   "600,1100,1500", "--max-new", "16", "--max-seq-len",
                   "1552", "--rate", "0", "--seed", "0", "--layers", "12"],
    "gemma2-9b": ["--batch", "2", "--requests", "2", "--prompt-lens",
                  "256,4200", "--max-new", "16", "--max-seq-len", "4352",
                  "--rate", "0", "--seed", "0", "--layers", "12"],
    "phi3-medium-14b": ["--batch", "4", "--requests", "8", "--prompt-lens",
                        "32,64,128", "--max-new", "16", "--rate", "0",
                        "--seed", "0", "--layers", "10"],
}


class _LogitRange:
    """Within the block, the largest |logit| over the real vocabulary that
    any ServeEngine saw (prefill, decode and verify), kept on the device
    beside the engine's own non-finite count."""

    def __init__(self, torch):
        self.torch, self.max = torch, None

    def __enter__(self):
        from repro_torch.serve.engine import ServeEngine

        self.orig = orig = ServeEngine._note_logits
        box = self

        def note(eng, logits):
            orig(eng, logits)
            m = logits[..., :eng.cfg.vocab_size].abs().amax()
            box.max = m if box.max is None else box.torch.maximum(box.max, m)

        ServeEngine._note_logits = note
        return self

    def __exit__(self, *exc):
        from repro_torch.serve.engine import ServeEngine

        ServeEngine._note_logits = self.orig


# the spec phase's local-window case (ROADMAP F6): gemma3's stream again
# with `--spec-k 4` on the families phase's weights
SPEC_LOCAL_ARCH = "gemma3-12b"


def spec_local(torch, args, engine, plain, n_req):
    """Self-speculative decoding over local-window rings (ROADMAP F6):
    `args`' stream served again with `--spec-k SPEC_K` on the same
    weights. Every local ring then has window + k rows rounded up to a
    page (1040 for gemma3's 1024) and the global layers keep their pools;
    the stream digest must equal the plain serve's (`plain`), drafts must
    run, with the path's checks (requests complete, no page leaked, no
    plain version, GEMMs and prefill on `mma`). Returns (record,
    problems)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    ops.reset_counts()
    t0 = time.monotonic()
    summary, sched, eng = drv.main(args + ["--spec-k", str(SPEC_K)],
                                   return_state=True, params=engine.params)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts, routes = ops.counts(), ops.route_counts()
    problems = _path_checks(summary, sched, counts, routes, n_req, MAX_NEW)
    window = eng.cfg.window
    rows = eng._local_rows()
    want_rows = -(-(window + SPEC_K) // eng.page_size) * eng.page_size
    rec = {"digest": summary["stream_digest"],
           "plain_digest": plain["stream_digest"], "local_rows": rows,
           "spec_accept_rate": summary.get("spec_accept_rate"),
           "spec_iters": summary.get("spec_iters"),
           "spec_drafted": summary.get("spec_drafted"),
           "decode_itl_p50_ms": summary.get("decode_itl_p50_ms"),
           "launches": {k: counts[k]["launches"] for k in (
               "sa_matmul", "paged_decode", "prefill_attention")},
           "wall_s": wall}
    log(f"[spec {SPEC_LOCAL_ARCH}] k={SPEC_K}, draft "
        f"{eng.spec_draft_layers} of {eng.cfg.num_layers // eng.cfg.stack_period}"
        f" superblocks, local rings {rows} rows (window {window}): " + " ".join(
            f"{k}={v}" for k, v in rec.items()))
    if rows != want_rows or not eng.spec_decoding_on():
        problems.append(f"spec off or local rings of {rows} rows, want "
                        f"{want_rows}")
    if not summary.get("spec_drafted"):
        problems.append("no draft ran")
    if summary["stream_digest"] != plain["stream_digest"]:
        problems.append(f"spec digest {summary['stream_digest']} != the "
                        f"plain serve's {plain['stream_digest']}")
    del eng, sched
    return rec, [f"spec: {p}" for p in problems]


def families(torch):
    """Each family served through the driver under `cuda` with
    `_serve_backend`'s checks (requests complete, no page leaked, finite
    logits, the three kernels launched, no plain version, prefill on `mma`
    only, every GEMM on `mma`); paged decode launched exactly L times a
    decode step the run's chunks imply; where the stack has local windows,
    prefix caching, disagg and bucketing off (no prefix hit), and the same
    stream with `--kv ring` (both layouts decode through the paged-decode
    kernel, F5) giving the same digest with the same launch count;
    gemma2's logits within its final softcap (±30); one prompt's prefill
    logits under `cuda` and `torch` within 2^-3·max|logit|; gemma3's
    stream with spec decoding over rings of window + k rows (`spec_local`,
    the spec phase's local-window case) giving the plain serve's digest.
    One model on the card at a time."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    out = {}
    for arch, rest in FAMILY_RUNS.items():
        args = ["--arch", arch] + rest
        n_req = int(rest[rest.index("--requests") + 1])
        with _LogitRange(torch) as rng:
            summary, launches, engine, sched = _serve_backend(
                torch, "cuda", args, n_req, MAX_NEW)
            max_logit = float(rng.max)
        cfg = engine.cfg
        L = cfg.num_layers
        problems = []
        want = L * _decode_steps(engine, sched)
        if launches["paged_decode"] != want:
            problems.append(f"paged decode launched "
                            f"{launches['paged_decode']} times, want {want}")
        if launches["prefill_attention"] != L * n_req:
            problems.append(f"prefill attention launched "
                            f"{launches['prefill_attention']} times, want "
                            f"{L * n_req}")
        local = engine._frag_floor > 1
        gates = {g: bool(getattr(engine, g)()) for g in (
            "prefix_caching_on", "disagg_on", "bucketing_on")}
        if local and (any(gates.values()) or summary.get("prefix_hits")):
            problems.append(f"the window leaves gates on: {gates}, "
                            f"prefix hits {summary.get('prefix_hits')}")
        if cfg.final_softcap and max_logit > cfg.final_softcap:
            problems.append(f"max |logit| {max_logit} above the final "
                            f"softcap {cfg.final_softcap}")
        rec = {"layers": L, "frag_floor": engine._frag_floor,
               "gates": gates, "prefix_hits": summary.get("prefix_hits", 0),
               "launches": launches, "max_abs_logit": max_logit,
               "stream_digest": summary["stream_digest"]}
        rec.update({key: summary.get(key) for key in (
            "decode_itl_p50_ms", "ttft_mean_s", "prefill_s", "decode_s",
            "decode_tok_s", "wall_s", "pages_peak_in_use")})
        log(f"[families {arch}] {L} layers, window floor "
            f"{engine._frag_floor}, gates {gates}, prefix hits "
            f"{rec['prefix_hits']}; digest {rec['stream_digest']}; "
            f"launches {launches}; paged decode want {want}; max |logit| "
            f"{max_logit:.4f}; itl_p50 {rec['decode_itl_p50_ms']} ms, "
            f"ttft_mean {rec['ttft_mean_s']} s, prefill_s "
            f"{rec['prefill_s']}, decode_tok_s {rec['decode_tok_s']}")
        if local:
            ops.reset_counts()
            r_sum, r_sched, r_eng = drv.main(args + ["--kv", "ring"],
                                             return_state=True,
                                             params=engine.params)
            torch.cuda.synchronize()
            counts = ops.counts()
            r_want = L * _decode_steps(r_eng, r_sched)
            r_got = counts["paged_decode"]["launches"]
            rec["ring"] = {"stream_digest": r_sum["stream_digest"],
                           "paged_decode": r_got,
                           "ring_len": r_eng.ring_len,
                           "decode_itl_p50_ms":
                               r_sum.get("decode_itl_p50_ms")}
            log(f"[families {arch}] --kv ring: digest "
                f"{r_sum['stream_digest']} (paged "
                f"{summary['stream_digest']}), ring rows {r_eng.ring_len} "
                f"global / {min(cfg.window, r_eng.ring_len)} local, paged "
                f"decode launches {r_got} (want {r_want}), itl_p50 "
                f"{r_sum.get('decode_itl_p50_ms')} ms")
            if r_sum["stream_digest"] != summary["stream_digest"]:
                problems.append("the ring serve's digest differs from the "
                                "paged serve's")
            if r_got != r_want or any(c["plain_calls"]
                                      for c in counts.values()):
                problems.append(f"ring: paged decode {r_got} (want "
                                f"{r_want}), counts {counts}")
            if (r_sum["nonfinite_logits"] or len(r_sched.finished) != n_req
                    or any(r.n_generated != MAX_NEW
                           for r in r_sched.finished)):
                problems.append("ring serve incomplete or non-finite")
            del r_eng, r_sched
        if arch == SPEC_LOCAL_ARCH:
            rec["spec"], spec_problems = spec_local(
                torch, args, engine, summary, n_req)
            problems += spec_problems
        prompt = min(sched.finished, key=lambda r: r.rid).prompt
        diff, bound = backend_logits(torch, engine, prompt)
        rec["backend_logits"] = {"max_abs_diff": diff, "bound": bound}
        out[arch] = rec
        del engine, sched
        gc.collect()
        torch.cuda.empty_cache()
        if problems:
            raise AssertionError(f"families phase {arch} failed: "
                                 + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# moe: granite-moe-3b at full width cut in depth, llama4-maverick at full
# width cut to one superblock, and granite training cut in depth
# ---------------------------------------------------------------------------

GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"
# granite served at full width cut to 16 of its 32 layers (since PR 29):
# its layers are all alike (no path runs only past layer 16), and its
# host-bound decode step (~10,500 launches at full depth) made the full
# depth cost ~50 s of the whole run's 1200 s limit
GRANITE_LAYERS = 16
# granite's stream is the qwen serve's: every prompt fits one dropless
# chunk (moe.DROPLESS_CHUNK_T = 128 tokens)
GRANITE_ARGS = ["--arch", GRANITE, "--batch", "4", "--requests", "8",
                "--prompt-lens", "32,64,128", "--max-new", "16", "--rate",
                "0", "--seed", "0", "--layers", str(GRANITE_LAYERS)]
# llama4 cut to one superblock (a dense layer at d_ff 16384 and a MoE layer
# of 128 experts and the shared expert: 18.7 B parameters, 37.4 GB bf16),
# since PR 30 on granite's stream (its (1, 2) serve is held to it)
LLAMA4_LAYERS = 2
LLAMA4_ARGS = ["--arch", LLAMA4] + GRANITE_ARGS[2:-2] + [
    "--layers", str(LLAMA4_LAYERS)]
LLAMA4_REQUESTS, LLAMA4_MAX_NEW, LLAMA4_PROMPTS = 8, MAX_NEW, PROMPT_LENS
# granite's training run: 4 of 32 layers, batch 4 x 512 (C = 128 tokens an
# expert and batch row), no accumulation
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 3


def check_moe_gemms(torch, timer):
    """The MoE family's SA GEMMs: each router (N = 40, 128 and a narrow 8,
    narrower than any other served N: a partial 64-column tile) at M = 4,
    20 and 128 against the plain version within `error_bound`, on `mma`,
    its tile and grid, and at M = 4 its time beside its byte bound, the
    plain version and bf16 torch.matmul; then granite's MoE layer at
    decode (the router and 40 experts' three GEMMs at M = 4, as the
    dropless dispatch launches them) and one llama4 expert's three, each
    GEMM held to its plain version, then timed wall and device beside
    their byte bound and the same calls of bf16 torch.matmul; then each
    expert shape and llama4's dense FFN (d_ff 16384) at the M the
    dispatch gives them beyond decode (20, 128 and 512, a training
    expert's B·C), held to the plain version. Returns (readings, max
    err/bound, max abs err)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import (DENSE_FFN_GEMMS,
                                                EXPERT_GEMMS, ROUTER_GEMMS)

    g = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16

    def weight(k, n):
        return (torch.randn((k, n), generator=g, device="cuda")
                * k ** -0.5).to(bf16)

    def rows(m, k):
        return torch.randn((m, k), generator=g, device="cuda").to(bf16)

    out, worst, max_err = {}, 0.0, 0.0

    def checked(what, a, w, act="none"):
        """One kernel call held to its plain version on the same inputs:
        on `mma`, finite, within `error_bound`. Returns err/bound."""
        nonlocal worst, max_err
        ops.reset_counts()
        y = ops.sa_matmul(a, w, act=act)
        ref = mm.sa_matmul_ref(a, w, act=act)
        torch.cuda.synchronize()
        routes = ops.route_counts()["sa_matmul"]
        err = (y - ref).abs()
        ratio = float((err / mm.error_bound(a, w, y=ref)).max())
        if (routes["mma"] != 1 or not bool(torch.isfinite(y).all())
                or not ratio <= 1.0):
            raise AssertionError(f"{what}: routes {routes}, err/bound "
                                 f"{ratio}")
        worst, max_err = max(worst, ratio), max(max_err, float(err.max()))
        return ratio

    for name, k, n in ROUTER_GEMMS:
        w = weight(k, n)
        for m in (BATCH, 20, 128):
            a = rows(m, k)
            ratio = checked(f"{name} M={m}", a, w)
            plan = mm.mma_plan(m, n, "mma")
            rec = {"tile": plan["tile"], "grid": plan["grid"],
                   "err_over_bound": ratio}
            if m == BATCH:
                rec.update(
                    ms=timer.wall(lambda: ops.sa_matmul(a, w)),
                    device_ms=timer.device(lambda: ops.sa_matmul(a, w)),
                    plain_ms=timer.wall(lambda: mm.sa_matmul_ref(a, w),
                                        reps=5),
                    library_ms=timer.wall(lambda: torch.matmul(a, w)))
                rec["bound_ms"], rec["bound_by"] = bound_ms(
                    2 * (m * k + k * n) + 4 * m * n, 2.0 * m * n * k,
                    PEAK_BF16)
            out[f"{name} M={m}"] = rec
            log(f"[moe gemm] {name} M={m} (K {k}, N {n}): {plan['tile']} "
                f"tile, grid {plan['grid']}, err/bound {ratio:.4f}"
                + (f"; kernel {rec['ms']:.4f} ms wall (device "
                   f"{rec['device_ms']}), plain {rec['plain_ms']:.4f}, bf16 "
                   f"torch.matmul {rec['library_ms']:.4f}, bound "
                   f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})"
                   if m == BATCH else ""))
            del a
        del w

    def dispatch(arch, experts, router):
        """One token batch (M = 4) through `experts` experts' three GEMMs
        (and the router), the activation in wg's epilogue, as
        `moe_ffn_dropless` launches them: each GEMM held to its plain
        version, then the whole timed."""
        shapes = EXPERT_GEMMS[arch]
        d, f = shapes[0][1], shapes[0][2]
        ws = [[weight(k, n) for _, k, n, _ in shapes]
              for _ in range(experts)]
        wr = weight(d, router) if router else None
        x, h = rows(BATCH, d), rows(BATCH, f)
        ratio = 0.0
        if wr is not None:
            ratio = checked(f"{arch} router M={BATCH}", x, wr)
        for e, (wg, wu, wd) in enumerate(ws):
            for (name, _, _, act), a, w in zip(shapes, (x, x, h),
                                               (wg, wu, wd)):
                ratio = max(ratio, checked(f"{arch} expert {e} {name} "
                                           f"M={BATCH}", a, w, act))

        def kernel():
            if wr is not None:
                ops.sa_matmul(x, wr)
            for wg, wu, wd in ws:
                ops.sa_matmul(x, wg, act="silu")
                ops.sa_matmul(x, wu)
                ops.sa_matmul(h, wd)

        def library():
            if wr is not None:
                torch.matmul(x, wr)
            for wg, wu, wd in ws:
                torch.matmul(x, wg)
                torch.matmul(x, wu)
                torch.matmul(h, wd)

        nbytes = 2 * sum(w.numel() for e in ws for w in e) + (
            2 * wr.numel() if wr is not None else 0)
        flops = 2.0 * BATCH * nbytes / 2
        b_ms, by = bound_ms(nbytes, flops, PEAK_BF16)
        # a device reading under the byte bound is impossible (the
        # profiler lost a kernel's records): read again, else keep none
        dev = None
        for _ in range(3):
            dev = timer.device(kernel, reps=3)
            if dev is not None and dev >= b_ms:
                break
            log(f"  (device reading {dev} ms under the bound {b_ms:.5f} "
                f"ms: discarded)")
            dev = None
        rec = {"gemms": 3 * experts + bool(router), "err_over_bound": ratio,
               "ms": timer.wall(kernel, reps=10), "device_ms": dev,
               "library_ms": timer.wall(library, reps=10),
               "bound_ms": b_ms, "bound_by": by,
               "tile": mm.mma_plan(BATCH, f, "mma")["tile"]}
        del ws, wr
        torch.cuda.empty_cache()
        return rec

    out["granite_layer_M4"] = dispatch("granite", 40, 40)
    out["llama4_expert_M4"] = dispatch("llama4", 1, 0)
    for key in ("granite_layer_M4", "llama4_expert_M4"):
        r = out[key]
        log(f"[moe gemm] {key}: {r['gemms']} GEMMs on the {r['tile']} tile, "
            f"err/bound {r['err_over_bound']:.4f}; {r['ms']:.4f} ms wall "
            f"(device {r['device_ms']}), bf16 torch.matmul "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    # the expert and dense-FFN shapes beyond decode: a prefill chunk's
    # rows (<= 128 a request) and a training expert's B·C = 512
    for what, shapes in (("granite expert", EXPERT_GEMMS["granite"]),
                         ("llama4 expert", EXPERT_GEMMS["llama4"]),
                         ("llama4 dense ffn", DENSE_FFN_GEMMS["llama4"])):
        for name, k, n, act in shapes:
            w = weight(k, n)
            got = {}
            for m in (BATCH, 20, 128, 512):
                if m == BATCH and what != "llama4 dense ffn":
                    continue        # checked in the dispatch above
                got[m] = checked(f"{what} {name} M={m}", rows(m, k), w, act)
            out[f"{what} {name}"] = {"K": k, "N": n, "act": act,
                                     "err_over_bound": got}
            log(f"[moe gemm] {what} {name} (K {k}, N {n}, {act}): "
                f"err/bound by M " + ", ".join(f"{m} {r:.4f}"
                                               for m, r in got.items()))
            del w
    torch.cuda.empty_cache()
    return out, worst, max_err


class _RoutingReplay:
    """Records every routing decision of one run (`moe._top_k`: each
    token's top k experts, each expert's top C tokens) and replays its
    indices in later runs, each value read again from that run's own
    scores. Routing is discontinuous: a token whose top-k gap or capacity
    gate sits within two GEMMs' last-bit difference can route another
    way (ROADMAP R8), which moves the expert leaves' gradients by far more
    than the GEMMs' arithmetic does. With the routing held, two backends'
    step-0 gradients differ by their arithmetic alone. A replay past the
    recorded calls routes freely. On a mesh (a sharded step replaying one
    process's routing) each recorded index tensor is cut to the call's
    piece: this data rank's batch rows, and this model rank's experts
    where the call ranks only its own (the capacity dispatch under EP).
    A recording also keeps each call's scores (the router's probabilities
    in a served forward), for the routing gate of `_r1_hold`. With `free`
    a list, a replay records the calls past the replayed ones there, as
    (indices, scores) (a training run's free steps after step 0)."""

    def __init__(self):
        self.idx, self.scores, self.mode, self.pos = [], [], None, 0
        self.free = None

    def start(self, mode):
        if mode == "record":
            self.idx, self.scores = [], []
        self.mode, self.pos = mode, 0

    def __enter__(self):
        from repro_torch.models import moe

        self.orig = orig = moe._top_k
        box = self

        def top_k(x, k):
            if box.mode == "replay" and box.pos < len(box.idx):
                i = _rank_piece(box.idx[box.pos].to(x.device), x)
                box.pos += 1
                return x.gather(-1, i), i
            v, i = orig(x, k)
            if box.mode == "record":
                box.idx.append(i)
                box.scores.append(x.detach().float())
            elif box.mode == "replay" and box.free is not None:
                box.free.append((i, x.detach().float()))
            return v, i

        moe._top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._top_k = self.orig


def _rank_piece(i, x):
    """The piece of a recorded (B, X, K) routing index tensor that a call
    on `x` (b, x, ·) under the active mesh takes: its data rank's b rows
    and, where x holds fewer columns than recorded, its model rank's."""
    from repro_torch.parallel import sharding as S

    if i.shape[0] != x.shape[0]:
        b = x.shape[0]
        i = i[S.axis_index("data") * b:(S.axis_index("data") + 1) * b]
    if i.shape[1] != x.shape[1]:
        n = x.shape[1]
        i = i[:, S.axis_index("model") * n:(S.axis_index("model") + 1) * n]
    return i.contiguous()


def moe_parallel_check(torch, engine, sched, key, ps):
    """The parallel phase's (1, 2) serve of `key` (granite or llama4, EP:
    each rank its half of the experts) against a one-process serve at the
    same depth on the same stream (`engine`, `sched`) by R1's rule (the
    prefill logits on the mesh's routing, replayed; on one process's own
    where the routing did not part), with each prompt's prefill routing
    against the one-process routing (the first MoE layer where a token's
    expert set differs, how many tokens there, and `_routing_gate`); each
    rank's launches what the dispatch on its experts implies
    (`moe.gemm_calls(tp=2)` a forward: its SA GEMMs a decode step), paged
    decode L a decode step and prefill L a request. Returns (readings,
    problems)."""
    from repro_torch.launch import serve as drv
    from repro_torch.models import moe

    got = ps[key]
    cfg, tp = engine.cfg, 2
    tag = f"[parallel_serve {key} 1x{tp}]"
    ref = [(list(map(int, r.prompt)), list(map(int, r.tokens)))
           for r in sorted(sched.finished, key=lambda r: r.rid)]
    eq, n, worst, problems, routes = _r1_hold(
        torch, engine, ref, tag, got["ranks"], got["prefill"], "paged",
        routing=got["routing"])
    per_step = moe.gemm_calls(cfg, tp=tp)
    L = cfg.num_layers
    for r, rank in enumerate(got["ranks"]):
        run = rank["paged"]
        steps = run["decode_steps"]
        want = {"sa_matmul": sum(moe.gemm_calls(cfg, len(p), tp)
                                 for p in run["prompts"])
                + steps * per_step,
                "paged_decode": L * steps,
                "prefill_attention": L * len(run["prompts"])}
        mine = {k: run["launches"][k] for k in want}
        if mine != want:
            problems.append(f"{tag} rank {r} launches {mine}, the dispatch "
                            f"on its experts implies {want}")
    s0 = got["ranks"][0]["paged"]["summary"]
    rec = {"equal_tokens": f"{eq}/{n}", "prefill_err_over_bound": worst,
           "routing_parted": routes["parted"],
           "routing_gate": [g and [round(g["spread_over_bound"], 4),
                                   round(g["margin_over_2spread"], 4)]
                            for g in routes["gate"]],
           "free_prefill_err_over_bound": routes[
               "free_prefill_err_over_bound"],
           "gemms_a_decode_step": per_step,
           "one_process_gemms_a_decode_step": moe.gemm_calls(cfg),
           "digest": s0["stream_digest"],
           "one_process_digest": drv.stream_digest(sched.finished)} | {
        k: [rk["paged"]["summary"][k] for rk in got["ranks"]]
        for k in ("decode_itl_p50_ms", "ttft_mean_s", "prefill_s")} | {
        "peak_gib": [rk["paged"]["peak_gib"] for rk in got["ranks"]],
        "launches": [rk["paged"]["launches"] for rk in got["ranks"]]}
    log(f"{tag} paged against the one-process stream: {eq} of "
        f"{n} tokens equal, prefill logits {worst:.4f} of the bound on the "
        f"mesh's routing (R1; on one process's own routing, the prompts "
        f"that did not part: {rec['free_prefill_err_over_bound']:.4f}); "
        f"routing of each prompt's prefill (first MoE layer where a token's"
        f" expert set differs, tokens there): {rec['routing_parted']}; "
        f"there, the spread of the router's probabilities over R1's bound "
        f"and the parted tokens' top-k margin over twice the spread: "
        f"{rec['routing_gate']}; a rank's SA "
        f"GEMMs a decode step {per_step} (one process "
        f"{rec['one_process_gemms_a_decode_step']}); per rank ITL p50 "
        f"{rec['decode_itl_p50_ms']} ms, TTFT mean {rec['ttft_mean_s']} s, "
        f"peak {rec['peak_gib']} GiB, launches {rec['launches']}")
    return rec, problems


def moe_granite(torch, ps=None):
    """granite-moe-3b at full width and depth through `launch/serve.main`
    under `cuda` with `_serve_backend`'s checks, its launches held to what the
    dropless dispatch implies (`moe.gemm_calls`: 125 SA GEMMs a layer
    and the lm_head a decode step, 4001; a prefill of <= 128 tokens the
    same), one decode step alone launching exactly that, paged decode L
    a decode step and prefill attention L a request; then `--kv ring`:
    the same digest and counts; then one prompt's prefill logits under
    `cuda` and `torch`; then `profile_serve`'s decode chunk: a decode
    step's device time and launches, the chunk's idle share under the
    profiler, and the idle share the step's device time leaves in the
    serve's unprofiled ITL."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv
    from repro_torch.models import model as M
    from repro_torch.models import moe

    n_req = 8
    torch.cuda.reset_peak_memory_stats()
    summary, launches, engine, sched = _serve_backend(
        torch, "cuda", GRANITE_ARGS, n_req, MAX_NEW)
    peak = torch.cuda.max_memory_allocated()
    cfg = engine.cfg
    L = cfg.num_layers
    per_step = moe.gemm_calls(cfg)

    def want(eng, sch):
        steps = _decode_steps(eng, sch)
        return {"sa_matmul": sum(moe.gemm_calls(cfg, len(r.prompt))
                                 for r in sch.finished) + steps * per_step,
                "paged_decode": L * steps, "prefill_attention": L * n_req}

    problems = []
    expect = want(engine, sched)
    for name, n in expect.items():
        if launches[name] != n:
            problems.append(f"{name} launched {launches[name]} times, the "
                            f"dispatch implies {n}")
    # one decode step alone, on a fresh ring
    cache = engine.new_cache()
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((BATCH,), dtype=torch.int32, device="cuda")
    ops.reset_counts()
    engine._serve_step(engine.params, tok, cache, pos)
    torch.cuda.synchronize()
    step_gemms = ops.counts()["sa_matmul"]["launches"]
    del cache
    if step_gemms != per_step:
        problems.append(f"a decode step launched {step_gemms} SA GEMMs, "
                        f"want {per_step}")
    rec = {"layers": L, "params_b": sum(
        t.numel() for t in M.tree_leaves(engine.params)) / 1e9,
        "launches": launches, "want": expect,
        "decode_step_gemms": step_gemms,
        "stream_digest": summary["stream_digest"],
        "peak_gib": peak / 2 ** 30}
    rec.update({key: summary.get(key) for key in (
        "decode_itl_p50_ms", "ttft_mean_s", "prefill_s", "decode_s",
        "decode_tok_s", "wall_s")})
    log(f"[moe granite] {L} layers, {rec['params_b']:.3f} B parameters; "
        f"digest {rec['stream_digest']}; launches {launches} (want "
        f"{expect}); a decode step {step_gemms} SA GEMMs (want {per_step});"
        f" itl_p50 {rec['decode_itl_p50_ms']} ms, ttft_mean "
        f"{rec['ttft_mean_s']} s, prefill_s {rec['prefill_s']}, "
        f"decode_tok_s {rec['decode_tok_s']}; peak {rec['peak_gib']:.2f} "
        f"GiB")
    ops.reset_counts()
    r_sum, r_sched, r_eng = drv.main(GRANITE_ARGS + ["--kv", "ring"],
                                     return_state=True, params=engine.params)
    torch.cuda.synchronize()
    counts = ops.counts()
    r_got = {name: counts[name]["launches"] for name in expect}
    r_want = want(r_eng, r_sched)
    rec["ring"] = {"stream_digest": r_sum["stream_digest"],
                   "launches": r_got,
                   "decode_itl_p50_ms": r_sum.get("decode_itl_p50_ms")}
    log(f"[moe granite] --kv ring: digest {r_sum['stream_digest']} (paged "
        f"{summary['stream_digest']}), launches {r_got} (want {r_want}), "
        f"itl_p50 {r_sum.get('decode_itl_p50_ms')} ms")
    if r_sum["stream_digest"] != summary["stream_digest"]:
        problems.append("the ring serve's digest differs from the paged "
                        "serve's")
    if r_got != r_want or any(c["plain_calls"] for c in counts.values()):
        problems.append(f"ring: launches {r_got} (want {r_want}), counts "
                        f"{counts}")
    if (r_sum["nonfinite_logits"] or len(r_sched.finished) != n_req
            or any(r.n_generated != MAX_NEW for r in r_sched.finished)):
        problems.append("ring serve incomplete or non-finite")
    del r_eng, r_sched
    prompt = min(sched.finished, key=lambda r: r.rid).prompt
    diff, bound = backend_logits(torch, engine, prompt)
    rec["backend_logits"] = {"max_abs_diff": diff, "bound": bound}
    rec["profile"] = profile_serve(torch, engine, "moe granite profile",
                                   requests=False)
    if rec["profile"]:
        # the step's device time against the unprofiled serve's ITL
        rec["profile"]["itl_idle_share"] = 1 - (
            rec["profile"]["step_device_ms"] / rec["decode_itl_p50_ms"])
    if ps is not None:
        rec["parallel"], p = moe_parallel_check(torch, engine, sched,
                                                "granite", ps)
        problems += p
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("moe granite failed: " + "; ".join(problems))
    return rec


def moe_llama4(torch, ps=None):
    """llama4-maverick at full width cut to one superblock
    (`dataclasses.replace(get_config(...), num_layers=2)`: its dense layer
    at d_ff 16384 and its MoE layer of 128 experts and the shared expert),
    granite's stream (LLAMA4_REQUESTS requests of 32-128 tokens, since PR
    30) through the engine under
    `cuda`: every request complete, finite logits, no page leaked, no
    plain version, every GEMM on `mma`, prefill on `mma`, each kernel's
    launches as the dispatch implies; the peak memory; then one prompt's
    prefill logits under `cuda` and `torch`."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    cfg = dataclasses.replace(get_config(LLAMA4), num_layers=LLAMA4_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    eng = ServeEngine(cfg, params, BATCH, max(LLAMA4_PROMPTS)
                      + LLAMA4_MAX_NEW, eos_id=-1, sync_every=8,
                      page_size=PAGE)
    sched = SlotScheduler(BATCH, eos_id=-1)
    drv.build_requests(sched, cfg, LLAMA4_REQUESTS, 0.0,
                       list(LLAMA4_PROMPTS), LLAMA4_MAX_NEW, 0)
    ops.reset_counts()
    t0 = time.monotonic()
    got = eng.serve(sched, greedy=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts, routes = ops.counts(), ops.route_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    steps = _decode_steps(eng, sched)
    want = {"sa_matmul": sum(moe.gemm_calls(cfg, len(r.prompt))
                             for r in sched.finished)
            + steps * moe.gemm_calls(cfg),
            "paged_decode": L * steps,
            "prefill_attention": L * LLAMA4_REQUESTS}
    launches = {name: counts[name]["launches"] for name in want}
    problems = _path_checks(got, sched, counts, routes, LLAMA4_REQUESTS,
                            LLAMA4_MAX_NEW)
    if launches != want:
        problems.append(f"launches {launches}, the dispatch implies {want}")
    rec = {"layers": L, "params_b": n_params / 1e9, "init_s": init_s,
           "launches": launches, "want": want,
           "stream_digest": drv.stream_digest(sched.finished),
           "itl_p50_ms": drv.itl_p50_ms(sched.finished),
           "peak_gib": peak / 2 ** 30, "wall_s": wall}
    rec.update({key: got.get(key) for key in (
        "prefill_s", "decode_s", "decode_tok_s")})
    log(f"[moe llama4] {L} layers (one superblock), {rec['params_b']:.3f} B "
        f"parameters drawn in {init_s:.1f} s; {LLAMA4_REQUESTS} requests: "
        f"digest {rec['stream_digest']}, launches {launches} (want {want}), "
        f"itl_p50 {rec['itl_p50_ms']} ms, prefill_s {rec['prefill_s']}, "
        f"decode_s {rec['decode_s']}, decode_tok_s {rec['decode_tok_s']}, "
        f"wall {wall:.2f} s; peak memory {rec['peak_gib']:.2f} GiB")
    prompt = min(sched.finished, key=lambda r: r.rid).prompt
    diff, bound = backend_logits(torch, eng, prompt)
    rec["backend_logits"] = {"max_abs_diff": diff, "bound": bound}
    if ps is not None:
        rec["parallel"], p = moe_parallel_check(torch, eng, sched, "llama4",
                                                ps)
        problems += p
    del eng, sched, params
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("moe llama4 failed: " + "; ".join(problems))
    return rec


def moe_train(torch):
    """granite at full width cut to MOE_TRAIN_LAYERS layers, batch 4 x 512
    (the capacity dispatch: C = 128), under `cuda`. Step 0 with free
    routing under `cuda` and `torch`: the loss within TRAIN_LOSS_REL, and
    the gradients' spread read out; then `train_step0` with the routing
    held (`_RoutingReplay`): the loss and every leaf within their bounds,
    the planted faults outside; then MOE_TRAIN_STEPS AdamW steps through
    `launch.train.run`: finite losses, grad norms and aux losses (loss −
    nll = 0.01·(load_balance + router_z) > 0), every forward GEMM on
    `mma`, every backward GEMM on `split3`, no plain version; peak memory
    and time per step."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy, use_policy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train as drv
    from repro_torch.models import model as M
    from repro_torch.train.step import make_grad_fn

    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    cfg = dataclasses.replace(get_config(GRANITE),
                              num_layers=MOE_TRAIN_LAYERS)
    params = M.init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    for p in M.tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=1).batch_at(0).items()}
    free = {}
    for backend in ("torch", "cuda"):
        with use_policy(PrecisionPolicy(backend=backend)):
            loss, nll, grads = make_grad_fn(cfg)(params, batch)
        free[backend] = (float(loss), float(nll), {
            k: v.clone() for k, v in _grad_leaves(torch, grads).items()})
    rel = _leaf_rel(torch, free["cuda"][2], free["torch"][2])
    l_rel = abs(free["cuda"][0] - free["torch"][0]) / abs(free["torch"][0])
    worst = max(rel, key=rel.get)
    log(f"[moe train step0, free routing] loss torch {free['torch'][0]:.6f}"
        f" cuda {free['cuda'][0]:.6f} (rel {l_rel:.3e}, bound "
        f"{TRAIN_LOSS_REL:.3e}); nll {free['torch'][1]:.6f}, "
        f"{free['cuda'][1]:.6f}; grad leaves max rel {rel[worst]:.3e} at "
        f"{worst}, median {sorted(rel.values())[len(rel) // 2]:.3e}")
    problems = []
    if not l_rel <= TRAIN_LOSS_REL:
        problems.append("free-routing loss beyond its bound")
    del params, grads, free, batch
    gc.collect()
    torch.cuda.empty_cache()
    with _RoutingReplay() as routing:
        step0 = train_step0(torch, cfg, accum=1,
                            jac_leaf="/layers/0/moe/wg", routing=routing)
    step0.update(free_loss_rel=l_rel, free_grad_rel_max=rel[worst],
                 free_grad_rel_worst=worst)
    gc.collect()
    torch.cuda.empty_cache()

    args = drv.parse_args(["--arch", GRANITE, "--batch", str(TRAIN_BATCH),
                           "--seq", str(TRAIN_SEQ), "--accum", "1",
                           "--steps", str(MOE_TRAIN_STEPS), "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.monotonic()
    state, hist = drv.run(cfg, args)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.counts()
    routes = ops.route_counts()["sa_matmul"]
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in M.tree_leaves(state.params))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    aux = [(h["loss"] - h["nll"]) / 0.01 for h in hist]
    steps = [h["wall_s"] for h in hist]
    later = steps[1:] or steps
    rec = {"layers": MOE_TRAIN_LAYERS, "params_b": n_params / 1e9,
           "step_s": steps, "mean_step_s": sum(later) / len(later),
           "losses": [h["loss"] for h in hist], "aux": aux,
           "peak_gib": peak / 2 ** 30, "counts": counts, "routes": routes,
           "step0": step0, "wall_s": wall}
    log(f"[moe train] granite full width, {MOE_TRAIN_LAYERS} layers, "
        f"{rec['params_b']:.3f} B parameters, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} (C = 128): {len(hist)} steps in {wall:.2f} s, step "
        f"wall s {steps}, mean of steps 2-{len(steps)} "
        f"{rec['mean_step_s']:.4f} s; losses {rec['losses']}; aux "
        f"(load_balance + router_z) {aux}; grad norms "
        f"{[h['grad_norm'] for h in hist]}; counts {counts}; routes "
        f"{routes}; peak memory {rec['peak_gib']:.2f} GiB")
    if len(hist) != MOE_TRAIN_STEPS:
        problems.append(f"{len(hist)} of {MOE_TRAIN_STEPS} steps")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               and math.isfinite(a) and a > 0 for h, a in zip(hist, aux)):
        problems.append("non-finite loss, grad norm or aux loss")
    for key in ("sa_matmul", "sa_matmul_bwd"):
        if counts[key]["launches"] <= 0 or counts[key]["plain_calls"]:
            problems.append(f"{key}: {counts[key]}")
    if (routes["mma"] != counts["sa_matmul"]["launches"]
            or routes["split3"] != counts["sa_matmul_bwd"]["launches"]
            or routes["simt"] or routes["partial"]):
        problems.append(f"SA GEMM routes {routes}: the forward must run "
                        f"mma only and the backward split3 only")
    if problems:
        raise AssertionError("moe train failed: " + "; ".join(problems))
    return rec


def moe(torch, ps=None, runs=("granite", "llama4", "train")):
    """The MoE family on the card: granite served at full width cut to
    GRANITE_LAYERS, llama4 served at full width cut to one superblock,
    both on granite's stream, granite trained cut to MOE_TRAIN_LAYERS
    layers; `runs` of them, in order. One model on the card at a time.
    With `ps` (the parallel phase's serve results) each one-process serve
    also holds its (1, 2) serve (`moe_parallel_check`; granite's is held
    in the parallel lane)."""
    fns = {"granite": moe_granite, "llama4": moe_llama4, "train": moe_train}
    out = {}
    for name in runs:
        t = time.monotonic()
        out[name] = fns[name](torch, ps) if name != "train" else \
            fns[name](torch)
        log(f"[moe] {name} {time.monotonic() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# ssm: mamba2-2.7b and hymba-1.5b at full width and depth, mamba2 training
# cut in depth
# ---------------------------------------------------------------------------

MAMBA2, HYMBA = "mamba2-2.7b", "hymba-1.5b"
# both served at full width; mamba2 cut to 8 of its 64 layers (32 since
# PR 29, 8 since PR 30, for the whole run's time limit), hymba at full
# depth (two
# superblocks: global layers 0 and 16)
# mamba2's stream: prompts of 200-1100 tokens, 1 to 5 SSD chunks of 256
# (each with a zero-padded tail), on 4 slots
MAMBA2_ARGS = ["--arch", MAMBA2, "--batch", "4", "--requests", "8",
               "--prompt-lens", "200,500,800,1100", "--max-new", "16",
               "--rate", "0", "--seed", "0", "--layers", "8"]
# hymba's: 6 prompts of 1500-2600 tokens, past its 2048-token window, so
# the local rings wrap in prefill and in decode
HYMBA_ARGS = ["--arch", HYMBA, "--batch", "4", "--requests", "6",
              "--prompt-lens", "1500,1900,2300,2600", "--max-new", "16",
              "--rate", "0", "--seed", "0"]
SSM_RUNS = {MAMBA2: (MAMBA2_ARGS, 8), HYMBA: (HYMBA_ARGS, 6)}
# mamba2 trained cut to 4 of 64 layers at batch 4 x 512 (2 SSD chunks)
SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS = 4, 3
# prefill then decode against a full forward on the card: the last
# SSM_DECODE_STEPS tokens of a prompt decoded (tests/test_decode.py's
# contract). The residual stream is bf16, so a last-bit fp32 difference
# between the chunked scan and the recurrent step flips bf16 roundings
# that 64 random layers carry to the logits, as a change of GEMM backend
# does (`backend_logits`): the same bound as there, 2^-3 of the largest
# |logit|, the argmax equal wherever the top-2 gap exceeds twice the
# difference. A decode from a lost state (zeroed after the prefill) must
# land at least SSM_LOST_STATE times as far from the full forward: the
# check sees a state that did not survive. (hymba's attention half keeps
# such a decode inside 2^-3: its state moves the logits by less.)
SSM_DECODE_STEPS, SSM_DECODE_REL, SSM_LOST_STATE = 3, 2.0 ** -3, 2.0


def check_ssm_gemms(torch, timer):
    """The SSM family's SA GEMMs (`gemm_cases.SSM_GEMMS`), each weight
    stored as the model stores it (`model.matrix_storage`: hymba's in_proj
    a (1600, 6482) view of rows of 6488): at M = 4, 128 and 1024 on the
    decode, small and large tiles, each within `error_bound` of the plain
    version with no operand copied (the ragged output's rows are 6482 fp32
    words apart); at M = 4 on the plan's tile, its time, wall and device,
    beside the byte bound, the plain version and bf16 torch.matmul.
    Returns (readings, max err/bound, max abs err)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import SSM_GEMMS
    from repro_torch.models.model import matrix_storage

    g = torch.Generator(device="cuda").manual_seed(12)
    out, worst, max_err = {}, 0.0, 0.0
    for name, k, n in SSM_GEMMS:
        w = matrix_storage((k, n), torch.bfloat16, "cuda")
        w.copy_(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5)
        rec = {"K": k, "N": n, "ld": w.stride(0), "err_over_bound": {}}
        for m, tile in ((BATCH, "decode"), (128, "small"), (TRAIN_M, "large")):
            a = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            ops.reset_counts()
            y, _ = mm._launch(a, w, None, None, "none", "exact", False,
                              tile=tile)
            ref = mm.sa_matmul_ref(a, w)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            ratio = float((err / mm.error_bound(a, w, y=ref)).max())
            copies = ops.operand_copies()
            if (copies or not bool(torch.isfinite(y).all())
                    or not ratio <= 1.0):
                raise AssertionError(f"ssm gemm {name} M={m} {tile} tile: "
                                     f"err/bound {ratio}, operand copies "
                                     f"{copies}")
            worst, max_err = max(worst, ratio), max(max_err,
                                                    float(err.max()))
            rec["err_over_bound"][tile] = ratio
            del y, ref, err
            if m != BATCH:
                continue
            plan = mm.mma_plan(m, n, "mma")
            rec.update(
                tile=plan["tile"], grid=plan["grid"],
                ms=timer.wall(lambda: ops.sa_matmul(a, w)),
                device_ms=timer.device(lambda: ops.sa_matmul(a, w)),
                plain_ms=timer.wall(lambda: mm.sa_matmul_ref(a, w), reps=5),
                library_ms=timer.wall(lambda: torch.matmul(a, w)))
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                2 * (m * k + k * n) + 4 * m * n, 2.0 * m * n * k, PEAK_BF16)
            del a
        out[name] = rec
        log(f"[ssm gemm] {name} (K {k}, N {n}, W rows {rec['ld']} apart): "
            f"err/bound " + ", ".join(f"{t} {r:.4f}" for t, r in
                                      rec["err_over_bound"].items())
            + f", no operand copied; M={BATCH} on the {rec['tile']} tile, "
            f"grid {rec['grid']}: kernel {rec['ms']:.4f} ms wall (device "
            f"{rec['device_ms']}), plain {rec['plain_ms']:.4f}, bf16 "
            f"torch.matmul {rec['library_ms']:.4f}, bound "
            f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}): "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of it")
        del w
    torch.cuda.empty_cache()
    return out, worst, max_err


def _prefill_then_decode(torch, engine, prompt):
    """On the card, with the kernels: a full forward over `prompt` (the
    prefill kernel and the chunked scan over every token, on a fresh
    batch-1 ring) against a prefill of all but its last SSM_DECODE_STEPS
    tokens followed by that many decode steps (the recurrent step, paged
    decode over the rings), and the same decode steps from the prefill's
    cache with its SSM states zeroed (a planted fault: the state lost at
    the splice). Returns {max_abs_diff, max_abs_logit, bound,
    planted_abs_diff, argmax_ok}."""
    from repro_torch.models import model as M

    cfg, n = engine.cfg, SSM_DECODE_STEPS
    toks = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
    T = toks.shape[1]
    full, _, _ = M.forward(engine.params, cfg, toks,
                           cache=engine.new_cache(batch=1),
                           page_size=engine.page_size)
    want = full[0, T - n - 1:, :cfg.vocab_size].float()
    del full
    cache = engine.new_cache(batch=1)
    logits, cache = engine._prefill_for(0)(engine.params, toks[:, :T - n],
                                           cache)
    first = logits[0, -1, :cfg.vocab_size].float()
    lost = M.tree_map(torch.clone, cache)
    for c in lost:
        c["ssm"][0].zero_()

    def decode(cache):
        rows = [first]
        for t in range(T - n, T):
            logits, cache = engine._serve_step(
                engine.params, toks[:, t:t + 1], cache,
                torch.tensor([t], dtype=torch.int32, device="cuda"))
            rows.append(logits[0, -1, :cfg.vocab_size].float())
        return torch.stack(rows)

    got, bad = decode(cache), decode(lost)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite logits in the prefill/decode check")
    diff = (got - want).abs().amax(-1)                   # a row each
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
    argmax_ok = bool((got.argmax(-1) == want.argmax(-1))[decided].all())
    scale = float(want.abs().max())
    return {"max_abs_diff": float(diff.max()), "max_abs_logit": scale,
            "bound": SSM_DECODE_REL * scale,
            "planted_abs_diff": float((bad - want).abs().max()),
            "argmax_ok": argmax_ok,
            "rel_rows": (diff / scale).tolist()}


def _ssm_checks(summary, sched, counts, routes, n_req):
    # a serve on rows (mamba2's ring layout) has no pages to leak
    return _path_checks(dict(summary, pages_leaked=summary.get(
        "pages_leaked", 0)), sched, counts, routes, n_req, MAX_NEW)


def ssm_serve(torch, arch):
    """One family at full width and depth through `launch/serve.main`
    under `cuda`, asked for `--kv paged` and then `--kv ring` on the same
    weights: every request complete, finite logits, no page leaked, no
    plain version, every GEMM and prefill on `mma`, one digest; each
    kernel's launches exactly as the forwards imply (`model.gemm_calls`
    SA GEMMs a forward: 129 for mamba2, 289 for hymba; paged decode and
    prefill attention once a layer with attention a decode step and a
    prefill: 0 for mamba2, 32 for hymba); the layout the engine took
    (mamba2: rows, whatever was asked) and its prefix cache, disagg,
    bucketing and spec gates off; one decode step alone: its launches and
    no operand copied (hymba's ragged in_proj read in place); prefill then
    decode against a full forward; prefill logits under `cuda` and
    `torch`; peak memory. Returns (record, engine, scheduler)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv
    from repro_torch.models import model as M

    args, n_req = SSM_RUNS[arch]
    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.monotonic()
    summary, sched, engine = drv.main(args + ["--kv", "paged"],
                                      return_state=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    counts, routes = ops.counts(), ops.route_counts()
    copies = ops.operand_copies()
    cfg = engine.cfg
    L = cfg.num_layers
    attn_layers = 0 if cfg.family == "ssm" else L
    per_step = M.gemm_calls(cfg)
    names = ("sa_matmul", "paged_decode", "prefill_attention")

    def want(eng, sch):
        steps = _decode_steps(eng, sch)
        return {"sa_matmul": sum(M.gemm_calls(cfg, len(r.prompt))
                                 for r in sch.finished) + steps * per_step,
                "paged_decode": attn_layers * steps,
                "prefill_attention": attn_layers * n_req}

    problems = _ssm_checks(summary, sched, counts, routes, n_req)
    launches = {name: counts[name]["launches"] for name in names}
    expect = want(engine, sched)
    if launches != expect:
        problems.append(f"launches {launches}, the forwards imply {expect}")
    if copies:
        problems.append(f"the SA GEMM copied {copies} operands")
    layout = "ring" if cfg.family == "ssm" else "paged"
    gates = {g: bool(getattr(engine, g)()) for g in (
        "prefix_caching_on", "disagg_on", "bucketing_on",
        "spec_decoding_on")}
    if (engine.kv_layout != layout or summary.get("kv_layout") != layout
            or any(gates.values()) or "prefix_hits" in summary):
        problems.append(f"layout {engine.kv_layout} (want {layout}), "
                        f"gates {gates}")
    # one decode step alone, on a fresh ring
    cache = engine.new_cache()
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((BATCH,), dtype=torch.int32, device="cuda")
    ops.reset_counts()
    engine._serve_step(engine.params, tok, cache, pos)
    torch.cuda.synchronize()
    c = ops.counts()
    step = {"sa_matmul": c["sa_matmul"]["launches"],
            "paged_decode": c["paged_decode"]["launches"],
            "operand_copies": ops.operand_copies()}
    del cache
    step_want = {"sa_matmul": per_step, "paged_decode": attn_layers,
                 "operand_copies": 0}
    if step != step_want:
        problems.append(f"a decode step: {step}, want {step_want}")
    rec = {"layers": L, "params_b": sum(
        t.numel() for t in M.tree_leaves(engine.params)) / 1e9,
        "kv_layout": engine.kv_layout, "gates": gates,
        "launches": launches, "want": expect, "decode_step": step,
        "stream_digest": summary["stream_digest"],
        "peak_gib": peak / 2 ** 30, "wall_s": wall}
    rec.update({key: summary.get(key) for key in (
        "decode_itl_p50_ms", "ttft_mean_s", "prefill_s", "decode_s",
        "decode_tok_s")})
    log(f"[ssm {arch}] {L} layers, {rec['params_b']:.3f} B parameters; "
        f"layout {engine.kv_layout} (asked paged), gates {gates}; digest "
        f"{rec['stream_digest']}; launches {launches} (want {expect}); a "
        f"decode step {step}; itl_p50 {rec['decode_itl_p50_ms']} ms, "
        f"ttft_mean {rec['ttft_mean_s']} s, prefill_s {rec['prefill_s']}, "
        f"decode_tok_s {rec['decode_tok_s']}; wall {wall:.2f} s (init + "
        f"serve); peak {rec['peak_gib']:.2f} GiB")
    ops.reset_counts()
    r_sum, r_sched, r_eng = drv.main(args + ["--kv", "ring"],
                                     return_state=True, params=engine.params)
    torch.cuda.synchronize()
    counts, routes = ops.counts(), ops.route_counts()
    r_got = {name: counts[name]["launches"] for name in names}
    r_want = want(r_eng, r_sched)
    rec["ring"] = {"stream_digest": r_sum["stream_digest"],
                   "launches": r_got, "kv_layout": r_eng.kv_layout,
                   "decode_itl_p50_ms": r_sum.get("decode_itl_p50_ms")}
    log(f"[ssm {arch}] --kv ring: digest {r_sum['stream_digest']} (paged "
        f"{summary['stream_digest']}), layout {r_eng.kv_layout}, launches "
        f"{r_got} (want {r_want}), itl_p50 "
        f"{r_sum.get('decode_itl_p50_ms')} ms")
    if r_sum["stream_digest"] != summary["stream_digest"]:
        problems.append("the ring serve's digest differs from the paged "
                        "serve's")
    if r_got != r_want or r_eng.kv_layout != "ring":
        problems.append(f"ring: launches {r_got} (want {r_want}), layout "
                        f"{r_eng.kv_layout}")
    problems += [f"ring: {p}" for p in _ssm_checks(r_sum, r_sched, counts,
                                                   routes, n_req)]
    del r_eng, r_sched
    # the request whose prompt spans several SSD chunks (mamba2: 500
    # tokens; hymba: 2300, past the window)
    prompt = sorted(sched.finished, key=lambda r: r.rid)[
        2 if cfg.hybrid else 1].prompt
    pd = _prefill_then_decode(torch, engine, prompt)
    rec["prefill_decode"] = dict(pd, tokens=len(prompt))
    log(f"[ssm {arch}] prefill {len(prompt) - SSM_DECODE_STEPS} tokens then "
        f"{SSM_DECODE_STEPS} decode steps against a full forward over "
        f"{len(prompt)}: max|diff| {pd['max_abs_diff']:.4e} (a row over "
        f"max|logit|: {[round(r, 5) for r in pd['rel_rows']]}), max|logit| "
        f"{pd['max_abs_logit']:.4e}, bound {pd['bound']:.4e}, argmax where "
        f"decided {pd['argmax_ok']}; from a zeroed state "
        f"{pd['planted_abs_diff']:.4e}")
    if not (pd["max_abs_diff"] <= pd["bound"] and pd["argmax_ok"]):
        problems.append("prefill then decode differs from the full forward")
    if not pd["planted_abs_diff"] > SSM_LOST_STATE * pd["max_abs_diff"]:
        problems.append("a decode from a zeroed state is not told apart "
                        "from the real decode")
    first = min(sched.finished, key=lambda r: r.rid).prompt
    diff, bound = backend_logits(torch, engine, first)
    rec["backend_logits"] = {"max_abs_diff": diff, "bound": bound}
    if problems:
        raise AssertionError(f"ssm {arch} failed: " + "; ".join(problems))
    return rec, engine, sched


def ssm_generate(torch, engine):
    """`generate()` on 4 prompts of 300 tokens (the chunked scan at B = 4,
    then lock-step decode): complete, finite."""
    g = torch.Generator().manual_seed(9)
    prompts = torch.randint(0, engine.cfg.vocab_size, (BATCH, 300),
                            generator=g)
    t0 = time.monotonic()
    toks = engine.generate(prompts, MAX_NEW)
    wall = time.monotonic() - t0
    st = engine.last_stats
    log(f"[ssm generate] 4 prompts of 300 tokens, {MAX_NEW} new: shape "
        f"{tuple(toks.shape)}, prefill_s {st['prefill_s']:.4f}, decode_s "
        f"{st['decode_s']:.4f}, nonfinite {st['nonfinite_logits']}, wall "
        f"{wall:.2f} s")
    if tuple(toks.shape) != (BATCH, MAX_NEW) or st["nonfinite_logits"]:
        raise AssertionError("ssm generate() incomplete or non-finite")
    return {"prefill_s": st["prefill_s"], "decode_s": st["decode_s"]}


def ssm_train(torch):
    """mamba2 at full width cut to SSM_TRAIN_LAYERS layers, batch 4 x 512
    (two SSD chunks), under `cuda`: step 0 under `cuda` and `torch` on the
    same masters and batch (`train_step0`: the loss and every leaf within
    their bounds, a planted dW fault outside them), then SSM_TRAIN_STEPS
    AdamW steps through `launch.train.run`: finite losses and grad norms,
    every forward GEMM on `mma` and every backward GEMM on `split3`, no
    plain version; time a step and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as drv
    from repro_torch.models import model as M

    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    cfg = dataclasses.replace(get_config(MAMBA2), num_layers=SSM_TRAIN_LAYERS)
    step0 = train_step0(torch, cfg, accum=1,
                        fault_leaf="/layers/0/ssm/out_proj", jac_leaf=None)
    gc.collect()
    torch.cuda.empty_cache()
    args = drv.parse_args(["--arch", MAMBA2, "--batch", str(TRAIN_BATCH),
                           "--seq", str(TRAIN_SEQ), "--accum", "1",
                           "--steps", str(SSM_TRAIN_STEPS), "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.monotonic()
    state, hist = drv.run(cfg, args)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.counts()
    routes = ops.route_counts()["sa_matmul"]
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in M.tree_leaves(state.params))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    steps = [h["wall_s"] for h in hist]
    later = steps[1:] or steps
    rec = {"layers": SSM_TRAIN_LAYERS, "params_b": n_params / 1e9,
           "step_s": steps, "mean_step_s": sum(later) / len(later),
           "losses": [h["loss"] for h in hist],
           "peak_gib": peak / 2 ** 30, "counts": counts, "routes": routes,
           "step0": step0, "wall_s": wall}
    log(f"[ssm train] mamba2 full width, {SSM_TRAIN_LAYERS} layers, "
        f"{rec['params_b']:.3f} B parameters, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: {len(hist)} steps in {wall:.2f} s, step wall s "
        f"{steps}, mean of steps 2-{len(steps)} {rec['mean_step_s']:.4f} s; "
        f"losses {rec['losses']}; grad norms "
        f"{[h['grad_norm'] for h in hist]}; counts {counts}; routes "
        f"{routes}; peak memory {rec['peak_gib']:.2f} GiB")
    problems = []
    if len(hist) != SSM_TRAIN_STEPS:
        problems.append(f"{len(hist)} of {SSM_TRAIN_STEPS} steps")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        problems.append("non-finite loss or grad norm")
    for key in ("sa_matmul", "sa_matmul_bwd"):
        if counts[key]["launches"] <= 0 or counts[key]["plain_calls"]:
            problems.append(f"{key}: {counts[key]}")
    if (routes["mma"] != counts["sa_matmul"]["launches"]
            or routes["split3"] != counts["sa_matmul_bwd"]["launches"]
            or routes["simt"] or routes["partial"]):
        problems.append(f"SA GEMM routes {routes}: the forward must run "
                        f"mma only and the backward split3 only")
    if problems:
        raise AssertionError("ssm train failed: " + "; ".join(problems))
    return rec


def ssm(torch):
    """The SSM and hybrid families on the card: mamba2 served at full
    width and depth (with its profiled decode chunk and `generate()`),
    hymba served at full width and depth, mamba2 trained cut to
    SSM_TRAIN_LAYERS layers. One model on the card at a time."""
    out = {}
    t = time.monotonic()
    out[MAMBA2], engine, sched = ssm_serve(torch, MAMBA2)
    prof = profile_serve(torch, engine, "ssm mamba2 profile", requests=False)
    if prof:
        prof["itl_idle_share"] = 1 - (prof["step_device_ms"]
                                      / out[MAMBA2]["decode_itl_p50_ms"])
    out[MAMBA2]["profile"] = prof
    out[MAMBA2]["generate"] = ssm_generate(torch, engine)
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ssm] {MAMBA2} {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    out[HYMBA], engine, sched = ssm_serve(torch, HYMBA)
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ssm] {HYMBA} {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    out["train"] = ssm_train(torch)
    log(f"[ssm] train {time.monotonic() - t:.1f} s")
    return out


# ---------------------------------------------------------------------------
# frontend: whisper-tiny (encoder-decoder) and pixtral-12b (VLM) at full
# width and depth through `generate()` and the driver's static waves, and
# both trained
# ---------------------------------------------------------------------------

WHISPER, PIXTRAL = "whisper-tiny", "pixtral-12b"
# the driver's static waves: 8 requests in 2 waves of 4, 16 new tokens;
# pixtral cut to 6 of its 40 layers (20 since PR 29, 6 since PR 30,
# for the run's time);
# whisper's decoder prompts of 32 and 64 tokens over 1500 stub frames,
# pixtral's text prompts of 64 and 128 tokens after 256 stub patch rows
# (a prefill of 320 and 384 rows)
FRONTEND_RUNS = {
    WHISPER: ["--arch", WHISPER, "--batch", "4", "--requests", "8",
              "--prompt-lens", "32,64", "--max-new", "16", "--rate", "0",
              "--seed", "0"],
    PIXTRAL: ["--arch", PIXTRAL, "--batch", "4", "--requests", "8",
              "--prompt-lens", "64,128", "--max-new", "16", "--rate", "0",
              "--seed", "0", "--layers", "6"],
}
FRONTEND_WAVES = 2
# the attention shapes (H, KVH, hd): whisper g = 1 at hd 64, pixtral g = 4
# at hd 128; prefill at whisper's longest decoder prompt and at pixtral's
# longest prefill (256 patch rows + 128 tokens); whisper's decode over the
# served ring (64 + 16 tokens: 80 rows) and over 2048-row rings
WHISPER_ATTN, PIXTRAL_ATTN = (6, 6, 64), (32, 8, 128)
WHISPER_PREFILL = [("whisper_T64", 64, {})]
PIXTRAL_PREFILL = [("pixtral_T384", 384, {})]
WHISPER_RINGS = [("whisper_ring80", 80, 80, 0.0),
                 ("whisper_ring2048", 2048, 2048, 0.0)]
# prefill then decode against a full forward over the same sequence on the
# card: the last FRONTEND_DECODE_STEPS tokens of a prompt decoded, each
# row within 2^-5 of the largest |logit|; a planted fault (whisper: the
# frames redrawn for the decode steps; pixtral: the patch rows' ring
# positions set to -1 before them) must move the logits past that bound
FRONTEND_DECODE_STEPS, FRONTEND_DECODE_REL = 3, 2.0 ** -5
# training: whisper at full depth, batch 4 x 256 over 1500 frames; pixtral
# cut to 4 of 40 layers, batch 4 x 512 after 256 patch rows; 3 AdamW steps
FRONTEND_TRAIN = {WHISPER: (None, 256, "/layers/0/ffn/w1"),
                  PIXTRAL: (4, 512, "/layers/0/ffn/wg")}
FRONTEND_TRAIN_STEPS = 3


def check_frontend_gemms(torch, timer):
    """whisper-tiny's SA GEMMs (`gemm_cases.WHISPER_GEMMS`) at the
    encoder's M = B·1500 = 6000 (all but the lm_head: the encoder's
    projections and MLP, the cross-attention's K and V) and the decoder's
    M = B = 4: each within `error_bound` of the plain version, one launch,
    no operand copied; its tile, wall and device times beside the byte or
    flop bound, the plain version and bf16 torch.matmul. Returns
    (readings, max err/bound, max abs err)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import WHISPER_FRAMES, WHISPER_GEMMS

    g = torch.Generator(device="cuda").manual_seed(384)
    out, worst, max_err = {}, 0.0, 0.0
    for name, k, n in WHISPER_GEMMS:
        w = (torch.randn((k, n), generator=g, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        for m in (BATCH * WHISPER_FRAMES, BATCH):
            if name == "lm_head" and m != BATCH:
                continue
            a = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            ops.reset_counts()
            y = ops.sa_matmul(a, w)
            launched = ops.counts()["sa_matmul"]
            copies = ops.operand_copies()
            ref = mm.sa_matmul_ref(a, w)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            ratio = float((err / mm.error_bound(a, w, y=ref)).max())
            if (copies or launched != {"launches": 1, "plain_calls": 0}
                    or not bool(torch.isfinite(y).all())
                    or not ratio <= 1.0):
                raise AssertionError(f"whisper gemm {name} M={m}: err/bound "
                                     f"{ratio}, counts {launched}, operand "
                                     f"copies {copies}")
            worst, max_err = max(worst, ratio), max(max_err,
                                                    float(err.max()))
            del y, ref, err
            plan = mm.mma_plan(m, n, "mma")
            rec = {"M": m, "K": k, "N": n, "tile": plan["tile"],
                   "grid": plan["grid"], "err_over_bound": ratio,
                   "ms": timer.wall(lambda: ops.sa_matmul(a, w)),
                   "device_ms": timer.device(lambda: ops.sa_matmul(a, w)),
                   "plain_ms": timer.wall(lambda: mm.sa_matmul_ref(a, w),
                                          reps=5),
                   "library_ms": timer.wall(lambda: torch.matmul(a, w))}
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                2 * (m * k + k * n) + 4 * m * n, 2.0 * m * n * k, PEAK_BF16)
            out[f"{name} M={m}"] = rec
            log(f"[whisper gemm] {name} M={m} K={k} N={n}: {rec['tile']} "
                f"tile, grid {rec['grid']}; err/bound {ratio:.4f}; kernel "
                f"{rec['ms']:.4f} ms wall (device {rec['device_ms']}), plain "
                f"{rec['plain_ms']:.4f}, bf16 torch.matmul "
                f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.5f} ms "
                f"({rec['bound_by']}): {100 * rec['bound_ms'] / rec['ms']:.1f}"
                f" % of it")
            del a
        del w
    torch.cuda.empty_cache()
    return out, worst, max_err


def _frontend(torch, cfg, batch, seed):
    """Stub frontend embeddings (batch, frontend_tokens, d_model), fp32 on
    the card, from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                       generator=g).cuda()


def _frontend_prefill_decode(torch, engine, prompt, fe):
    """On the card, batch 1: a full forward over the sequence ([patches ‖
    prompt] for pixtral; the prompt over the encoded frames for whisper)
    into a fresh ring, so its attention runs the prefill kernel, against
    a prefill of all but the prompt's last FRONTEND_DECODE_STEPS tokens
    followed by that many decode steps (`generate()`'s steps: whisper
    re-encodes the frames at each, pixtral decodes from position 256 + t
    without them), and the same decode steps with the planted fault
    (whisper: redrawn frames; pixtral: the patch rows' ring positions set
    to -1 after the prefill, hiding the image from decode). Returns
    {max_abs_diff, max_abs_logit, bound, planted_abs_diff, argmax_ok,
    rel_rows}."""
    from repro_torch.models import model as M

    cfg, n = engine.cfg, FRONTEND_DECODE_STEPS
    vlm = cfg.family == "vlm"
    off = cfg.frontend_tokens if vlm else 0
    toks = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
    T = toks.shape[1]
    rows = -(-(off + T) // PAGE) * PAGE

    def ring():
        return M.init_cache(cfg, 1, max(rows, engine.ring_len),
                            dtype=engine.cache_dtype, device="cuda")

    full, _, _ = M.forward(engine.params, cfg, toks, cache=ring(),
                           frontend_embeds=fe, page_size=engine.page_size)
    want = full[0, off + T - n - 1:, :cfg.vocab_size].float()
    del full
    cache = ring()
    logits, cache = engine._prefill_for(0)(engine.params, toks[:, :T - n],
                                           cache, fe)
    first = logits[0, -1, :cfg.vocab_size].float()
    planted = M.tree_map(torch.clone, cache)
    if vlm:
        for c in planted:
            c["kv"].positions[:, :, :off] = -1
        step_fe = planted_fe = None
    else:
        step_fe = fe
        planted_fe = torch.randn(fe.shape, generator=torch.Generator(
            ).manual_seed(99)).cuda()

    def decode(cache, frontend):
        out = [first]
        for t in range(T - n, T):
            logits, cache = engine._serve_step(
                engine.params, toks[:, t:t + 1], cache,
                torch.tensor([off + t], dtype=torch.int32, device="cuda"),
                frontend)
            out.append(logits[0, -1, :cfg.vocab_size].float())
        return torch.stack(out)

    got = decode(cache, step_fe)
    bad = decode(planted, planted_fe)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite logits in the prefill/decode check")
    diff = (got - want).abs().amax(-1)
    scale = float(want.abs().max())
    bound = FRONTEND_DECODE_REL * scale
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * bound
    argmax_ok = bool((got.argmax(-1) == want.argmax(-1))[decided].all())
    return {"max_abs_diff": float(diff.max()), "max_abs_logit": scale,
            "bound": bound, "argmax_ok": argmax_ok,
            "planted_abs_diff": float((bad[1:] - want[1:]).abs().max()),
            "rel_rows": (diff / scale).tolist()}


def profile_frontend_chunk(torch, engine, fe, T=64):
    """One decode chunk of whisper's `generate()` (`sync_every` steps, B =
    4, after a T-token prefill) under torch.profiler: kernel launches and
    device ms a step, the idle share of the chunk's wall, and the
    encoder's share of the step's device time (`encode` over the same
    frames profiled alone)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    cfg, steps = engine.cfg, engine.sync_every
    g = torch.Generator().manual_seed(8)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, T), generator=g,
                            dtype=torch.int32).cuda()
    cache = engine.new_cache()
    logits, cache = engine._prefill_for(0)(engine.params, prompts, cache, fe)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    pos = torch.full((BATCH,), T, dtype=torch.int32, device="cuda")
    run = engine._chunk_fn(steps, True)
    tok, cache, pos, _, _ = run(engine.params, tok, cache, pos, fe, None)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(engine.params, tok, cache, pos, fe, None)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ks = device_kernels(torch, prof)
    fe16 = fe.to(torch.bfloat16)
    M.encode(engine.params, cfg, fe16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        M.encode(engine.params, cfg, fe16)
        torch.cuda.synchronize()
    enc = device_kernels(torch, prof)
    if not ks or not enc:
        log("[frontend whisper profile] the profiler recorded no device "
            "time")
        return None
    busy = sum(ms for ms, _ in ks.values())
    enc_ms = sum(ms for ms, _ in enc.values())
    out = {"steps": steps,
           "step_launches": sum(n for _, n in ks.values()) / steps,
           "step_device_ms": busy / steps, "chunk_wall_s": wall,
           "chunk_idle_share": 1 - busy / 1e3 / wall,
           "encoder_device_ms": enc_ms,
           "encoder_launches": sum(n for _, n in enc.values()),
           "encoder_share": enc_ms / (busy / steps)}
    log(f"[frontend whisper profile] one decode chunk ({steps} steps, "
        f"B={BATCH}, frames re-encoded each step): "
        f"{out['step_launches']:.1f} launches and "
        f"{out['step_device_ms']:.4f} ms of device a step; chunk wall "
        f"{wall:.3f} s under the profiler, idle share "
        f"{out['chunk_idle_share']:.3f}; encode alone "
        f"{enc_ms:.4f} ms device ({out['encoder_launches']} launches), "
        f"{100 * out['encoder_share']:.1f} % of a step's device time")
    for name, (ms, n) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[frontend whisper profile]   {ms / steps:8.4f} ms a step "
            f"{100 * ms / busy:5.1f}% {n / steps:6.1f} launches  "
            f"{name[:90]}")
    return out


def frontend_serve(torch, arch):
    """One frontend arch at full width and depth through
    `launch/serve.main` under `cuda` (the static waves: `generate()` on
    batches of 4 with seeded frontends): every request complete, finite
    logits, no plain version, every GEMM and prefill on `mma`; each
    kernel's launches exactly as the forwards imply (a wave is a prefill
    and 15 decode steps, each a forward of `model.gemm_calls` SA GEMMs:
    73 for whisper, 281 for pixtral; paged decode a layer a decode step,
    prefill attention a layer a prefill); `serve()` refused; prefill
    then decode against a full forward with the planted fault outside the
    bound; prefill logits under `cuda` and `torch`; peak memory. whisper
    also runs `generate()` on 4 more prompts and a profiled decode chunk.
    Returns the record."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import SlotScheduler

    args = FRONTEND_RUNS[arch]
    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.monotonic()
    summary, outs, engine = drv.main(args, return_state=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    counts, routes = ops.counts(), ops.route_counts()
    cfg = engine.cfg
    L = cfg.num_layers
    forwards = FRONTEND_WAVES * MAX_NEW
    want = {"sa_matmul": M.gemm_calls(cfg) * forwards,
            "paged_decode": L * FRONTEND_WAVES * (MAX_NEW - 1),
            "prefill_attention": L * FRONTEND_WAVES}
    launches = {k: counts[k]["launches"] for k in want}
    problems = []
    if (summary["requests"] != 8 or summary["generated_tokens"] != 8 * MAX_NEW
            or summary["waves"] != FRONTEND_WAVES
            or summary["nonfinite_logits"]
            or any(o.shape != (BATCH, MAX_NEW) for o in outs)):
        problems.append(f"incomplete or non-finite: {summary}")
    if launches != want:
        problems.append(f"launches {launches}, the forwards imply {want}")
    if any(c["plain_calls"] for c in counts.values()):
        problems.append(f"a plain version ran: {counts}")
    mm_r, pre_r = routes["sa_matmul"], routes["prefill_attention"]
    if mm_r["mma"] != launches["sa_matmul"] or pre_r["mma"] != launches[
            "prefill_attention"]:
        problems.append(f"routes {routes}: every GEMM and prefill on mma")
    sched = SlotScheduler(BATCH)
    sched.submit([1, 2, 3], max_new_tokens=2)
    try:
        engine.serve(sched)
        problems.append("serve() did not refuse a frontend arch")
    except ValueError as e:
        if "text-only" not in str(e):
            raise
    ttft = summary["prefill_s"] / FRONTEND_WAVES
    itl = 1e3 * summary["decode_s"] / (FRONTEND_WAVES * (MAX_NEW - 1))
    rec = {"layers": L, "encoder_layers": cfg.encoder_layers,
           "params_b": sum(t.numel() for t in M.tree_leaves(
               engine.params)) / 1e9,
           "launches": launches, "want": want, "gemm_calls": M.gemm_calls(
               cfg), "ttft_s": ttft, "itl_ms": itl,
           "prefill_s": summary["prefill_s"], "decode_s": summary["decode_s"],
           "decode_tok_s": summary["decode_tok_s"],
           "peak_gib": peak / 2 ** 30, "wall_s": wall,
           "tokens_digest": hashlib.sha1(json.dumps(
               [o.tolist() for o in outs]).encode()).hexdigest()[:16]}
    log(f"[frontend {arch}] {L} decoder layers, {cfg.encoder_layers} "
        f"encoder layers, {rec['params_b']:.3f} B parameters; static waves "
        f"{summary}; launches {launches} (want {want}); ttft {ttft:.4f} s "
        f"a wave, itl {itl:.3f} ms; wall {wall:.2f} s (init + serve); peak "
        f"{rec['peak_gib']:.2f} GiB")
    fe = _frontend(torch, cfg, 1, 21)
    g = torch.Generator().manual_seed(22)
    plen = 64 if arch == WHISPER else 128
    prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=g).tolist()
    pd = _frontend_prefill_decode(torch, engine, prompt, fe)
    rec["prefill_decode"] = pd
    log(f"[frontend {arch}] prefill {plen - FRONTEND_DECODE_STEPS} tokens "
        f"then {FRONTEND_DECODE_STEPS} decode steps against a full forward: "
        f"max|diff| {pd['max_abs_diff']:.4e} (a row over max|logit|: "
        f"{[round(r, 5) for r in pd['rel_rows']]}), max|logit| "
        f"{pd['max_abs_logit']:.4e}, bound {pd['bound']:.4e}, argmax where "
        f"decided {pd['argmax_ok']}; planted fault "
        f"({'redrawn frames' if arch == WHISPER else 'patch rows hidden'}) "
        f"{pd['planted_abs_diff']:.4e}")
    if not pd["argmax_ok"]:
        problems.append("prefill then decode: argmax differs where decided")
    if not pd["max_abs_diff"] <= pd["bound"]:
        problems.append("prefill then decode differs from the full forward "
                        "beyond 2^-5 of max|logit|")
    if not pd["planted_abs_diff"] > max(pd["bound"], 2 * pd["max_abs_diff"]):
        problems.append("the planted fault is not told apart from the real "
                        "decode")
    diff, bound = backend_logits(torch, engine, prompt, frontend=fe)
    rec["backend_logits"] = {"max_abs_diff": diff, "bound": bound}
    if arch == WHISPER:
        fe4 = _frontend(torch, cfg, BATCH, 23)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, 48), generator=g,
                                dtype=torch.int32)
        ops.reset_counts()
        toks = engine.generate(prompts, MAX_NEW, frontend=fe4)
        st = engine.last_stats
        got = ops.counts()["sa_matmul"]["launches"]
        rec["generate"] = {"prefill_s": st["prefill_s"],
                           "decode_s": st["decode_s"],
                           "itl_ms": 1e3 * st["decode_s"] / (MAX_NEW - 1)}
        log(f"[frontend {arch}] generate() on 4 prompts of 48 tokens: shape "
            f"{tuple(toks.shape)}, prefill_s {st['prefill_s']:.4f}, "
            f"decode_s {st['decode_s']:.4f}, SA GEMM launches {got} (want "
            f"{M.gemm_calls(cfg) * MAX_NEW}), nonfinite "
            f"{st['nonfinite_logits']}")
        if (tuple(toks.shape) != (BATCH, MAX_NEW) or st["nonfinite_logits"]
                or got != M.gemm_calls(cfg) * MAX_NEW):
            problems.append("generate() incomplete, non-finite or off count")
        prof = profile_frontend_chunk(torch, engine, fe4)
        if prof:
            prof["itl_idle_share"] = 1 - prof["step_device_ms"] / itl
        rec["profile"] = prof
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"frontend {arch} failed: " + "; ".join(problems))
    return rec


def frontend_train(torch, arch):
    """Training with a frontend under `cuda`: whisper at full depth over
    1500 frames, pixtral cut to 4 of 40 layers after 256 patch rows
    (FRONTEND_TRAIN), batch 4. Step 0 under `cuda` and `torch`
    (`train_step0`: the loss within 2^-10, every leaf within 2^-5, the
    planted faults outside), then FRONTEND_TRAIN_STEPS AdamW steps:
    finite losses and grad norms, every forward GEMM on `mma` and every
    backward GEMM on `split3`, no plain version; time a step and peak
    memory."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import init_state

    layers, seq, jac = FRONTEND_TRAIN[arch]
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    step0 = train_step0(torch, cfg, accum=1, jac_leaf=jac, seq=seq,
                        frontend=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    opt = AdamW(schedule=warmup_cosine(3e-4, 1, FRONTEND_TRAIN_STEPS))
    step = make_train_step(cfg, opt)
    state = init_state(cfg, opt, seed=0, device="cuda")
    data = SyntheticLM(cfg.vocab_size, seq, TRAIN_BATCH, seed=0)
    hist = []
    for i in range(FRONTEND_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch_at(i).items()}
        batch["frontend"] = _frontend(torch, cfg, TRAIN_BATCH, 30 + i)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        hist.append(dict(m, wall_s=time.monotonic() - t0))
    counts = ops.counts()
    routes = ops.route_counts()["sa_matmul"]
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in M.tree_leaves(state.params))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    steps = [h["wall_s"] for h in hist]
    later = steps[1:]
    rec = {"layers": cfg.num_layers, "params_b": n_params / 1e9,
           "batch": [TRAIN_BATCH, seq, cfg.frontend_tokens],
           "step_s": steps, "mean_step_s": sum(later) / len(later),
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "peak_gib": peak / 2 ** 30, "counts": counts, "routes": routes,
           "step0": step0}
    log(f"[frontend train {arch}] {cfg.num_layers} layers, "
        f"{rec['params_b']:.3f} B parameters, batch {TRAIN_BATCH} x {seq} "
        f"with {cfg.frontend_tokens} frontend rows: step wall s {steps}, "
        f"mean of steps 2-{len(steps)} {rec['mean_step_s']:.4f} s; losses "
        f"{rec['losses']}; grad norms {rec['grad_norms']}; counts {counts}; "
        f"routes {routes}; peak memory {rec['peak_gib']:.2f} GiB")
    problems = []
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        problems.append("non-finite loss or grad norm")
    for key in ("sa_matmul", "sa_matmul_bwd"):
        if counts[key]["launches"] <= 0 or counts[key]["plain_calls"]:
            problems.append(f"{key}: {counts[key]}")
    if (routes["mma"] != counts["sa_matmul"]["launches"]
            or routes["split3"] != counts["sa_matmul_bwd"]["launches"]
            or routes["simt"] or routes["partial"]):
        problems.append(f"SA GEMM routes {routes}: the forward must run "
                        f"mma only and the backward split3 only")
    if problems:
        raise AssertionError(f"frontend train {arch} failed: "
                             + "; ".join(problems))
    return rec


FRONTEND_ORDER = ((WHISPER, "serve"), (WHISPER, "train"),
                  (PIXTRAL, "serve"), (PIXTRAL, "train"))


def frontend(torch, runs=FRONTEND_ORDER):
    """The frontend families on the card, one model at a time: whisper-tiny
    served (static waves, `generate()`, a profiled decode chunk) and
    trained at full depth, pixtral-12b served at full width cut to 6
    layers and trained cut to 4 layers; `runs` of them, in order."""
    out = {}
    for arch, kind in runs:
        t = time.monotonic()
        if kind == "serve":
            out[arch] = frontend_serve(torch, arch)
        else:
            out[f"{arch}_train"] = frontend_train(torch, arch)
        log(f"[frontend] {arch} {kind} {time.monotonic() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: train
# ---------------------------------------------------------------------------

def _grad_leaves(torch, grads, prefix=""):
    if isinstance(grads, dict):
        return {p: t for k, v in grads.items()
                for p, t in _grad_leaves(torch, v, f"{prefix}/{k}").items()}
    if isinstance(grads, (tuple, list)):
        return {p: t for i, v in enumerate(grads)
                for p, t in _grad_leaves(torch, v, f"{prefix}/{i}").items()}
    return {prefix: grads}


def _leaf_rel(torch, got, want):
    return {p: float(torch.linalg.vector_norm(got[p] - want[p])
                     / torch.linalg.vector_norm(want[p]).clamp_min(1e-30))
            for p in want}


def train_step0(torch, cfg, accum=TRAIN_ACCUM, jac_leaf="/layers/0/ffn/wg",
                routing=None, fault_leaf="/layers/0/attn/wo", seq=TRAIN_SEQ,
                frontend=False):
    """Step 0's loss and gradients (`accum` microbatches) under the `cuda`
    and `torch` GEMM backends on the same fp32 masters and batch: the loss
    within TRAIN_LOSS_REL, every leaf within TRAIN_GRAD_REL of its norm.
    Two planted faults must land outside: the kernel's dW of `fault_leaf`
    transposed (`wo`: a square weight, so the shapes still fit; a
    non-square one has its rows reversed instead), and a backward through
    the kernel that drops the activation jacobian (du = dy) at `jac_leaf`
    (None: a stack whose GEMMs fuse no activation, mamba2's, skips it).
    `routing` (a `_RoutingReplay`, MoE stacks) records the `torch` run's
    routing decisions and replays them in the later runs. `seq` is the
    batch's token length; with `frontend` the batch also carries seeded
    frontend embeddings (TRAIN_BATCH, frontend_tokens, d_model)."""
    from repro_torch.core.precision import PrecisionPolicy, use_policy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.models import model as M
    from repro_torch.train.step import make_grad_fn

    params = M.init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    for p in M.tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg.vocab_size, seq, TRAIN_BATCH, seed=1).batch_at(0).items()}
    if frontend:
        batch["frontend"] = _frontend(torch, cfg, TRAIN_BATCH, 1)
    grad_fn = make_grad_fn(cfg, accum)
    out = {}
    for backend in ("torch", "cuda"):
        if routing is not None:
            routing.start("record" if backend == "torch" else "replay")
        with use_policy(PrecisionPolicy(backend=backend)):
            t0 = time.monotonic()
            loss, _, grads = grad_fn(params, batch)
            torch.cuda.synchronize()
        # grad_fn releases .grad on its next call; these references stay
        out[backend] = (float(loss), _grad_leaves(torch, grads),
                        time.monotonic() - t0)
    (l_t, g_t, s_t), (l_c, g_c, s_c) = out["torch"], out["cuda"]
    rel = _leaf_rel(torch, g_c, g_t)
    worst = max(rel, key=rel.get)
    log(f"[train step0] loss torch {l_t:.6f} cuda {l_c:.6f} (rel "
        f"{abs(l_c - l_t) / abs(l_t):.3e}, bound {TRAIN_LOSS_REL:.3e}); "
        f"grad leaves {len(rel)}, max rel {rel[worst]:.3e} at {worst}, "
        f"median {sorted(rel.values())[len(rel) // 2]:.3e} (bound "
        f"{TRAIN_GRAD_REL:.3e}); grad pass {s_t:.2f} s torch, {s_c:.2f} s "
        f"cuda")
    problems = []
    if not (abs(l_c - l_t) <= TRAIN_LOSS_REL * abs(l_t)):
        problems.append("loss beyond its bound")
    if not rel[worst] <= TRAIN_GRAD_REL:
        problems.append(f"leaf {worst} beyond its bound")
    # planted fault 1: the transposed dW of a square weight (rows reversed
    # for another)
    wo = fault_leaf
    square = g_c[wo].shape[-1] == g_c[wo].shape[-2]
    bad = g_c[wo].transpose(-1, -2) if square else g_c[wo].flip(-2)
    r_t = _leaf_rel(torch, {wo: bad}, {wo: g_t[wo]})[wo]
    # planted fault 2: the kernel's backward without the activation
    # jacobian (every FFN gate's du = dy)
    backward = mm.SAMatmulFn.backward

    class NoJacobian(mm.SAMatmulFn):
        @staticmethod
        def backward(ctx, dy):
            ctx.act = "none"
            return backward(ctx, dy)

    r_j = None
    if jac_leaf is not None:
        mm.SAMatmulFn = NoJacobian
        if routing is not None:
            routing.start("replay")
        try:
            with use_policy(PrecisionPolicy(backend="cuda")):
                _, _, grads = grad_fn(params, batch)
        finally:
            mm.SAMatmulFn = NoJacobian.__base__
        r_j = _leaf_rel(torch, _grad_leaves(torch, grads), g_t)[jac_leaf]
    log(f"[train step0] planted faults: "
        f"{'transposed' if square else 'row-reversed'} dW of {wo} rel "
        f"{r_t:.3e}, dropped activation jacobian at "
        f"{jac_leaf} rel {r_j} (bound {TRAIN_GRAD_REL:.3e})")
    if not (r_t > TRAIN_GRAD_REL
            and (r_j is None or r_j > TRAIN_GRAD_REL)):
        problems.append("the gradient bound does not reject a planted fault")
    if problems:
        raise AssertionError("train step 0: " + "; ".join(problems))
    return {"loss_rel": abs(l_c - l_t) / abs(l_t), "grad_rel_max": rel[worst],
            "fault_transposed": r_t, "fault_jacobian": r_j}


def profile_train_step(torch, cfg, args, state, hold=None):
    """Where a training step's time goes: one more step (the seventh
    batch) under torch.profiler, CUDA activity only: the device's busy
    and idle share of the wall and the kernels that take the time.
    `hold(run, step_args)`, where given, runs that step (the dryrun
    phase's hold of the train cell, `_dry_hold`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step

    opt = AdamW(schedule=warmup_cosine(args.lr, max(2, args.steps // 10),
                                       args.steps))
    step = make_train_step(cfg, opt, accum_steps=args.accum)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg.vocab_size, args.seq, args.batch, seed=args.seed).batch_at(
            args.steps).items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if hold is None:
            step(state, batch)
        else:
            hold(lambda: step(state, batch), (state, batch))
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ks = device_kernels(torch, prof)
    if not ks:
        log("[train profile] the profiler recorded no device time")
        return
    busy = sum(ms for ms, _ in ks.values()) / 1e3
    log(f"[train profile] one step: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s, idle share {1 - busy / wall:.3f}")
    for name, (ms, n) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[train profile]   {ms / 1e3:8.4f} s {100 * ms / 1e3 / busy:5.1f}"
            f"% {n:7d} launches  {name[:90]}")


def train(torch, card):
    """Six AdamW steps through `launch.train.run` under the `cuda` GEMM
    backend; returns the SA GEMM backward's launches in them."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as drv

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    t = time.monotonic()
    step0 = train_step0(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train step0] {time.monotonic() - t:.1f} s")

    args = drv.parse_args(["--arch", ARCH, "--batch", str(TRAIN_BATCH),
                           "--seq", str(TRAIN_SEQ), "--accum",
                           str(TRAIN_ACCUM), "--steps", str(TRAIN_STEPS),
                           "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.monotonic()
    state, hist = drv.run(cfg, args)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.counts()
    routes = ops.route_counts()["sa_matmul"]
    tiles = ops.tile_counts()
    want_tiles = _expected_train_tiles(torch, counts["sa_matmul_bwd"][
        "launches"])
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in _grad_leaves(torch, state.params)
                   .values())
    # the dryrun phase's train cell: the dry run of this phase's step (the
    # same config, batch and accum), held against its seventh step
    from repro_torch.models.config import ShapeCfg
    rec = _dry_count(cfg, ShapeCfg("train_4x512", TRAIN_SEQ, TRAIN_BATCH,
                                   "train"), accum=TRAIN_ACCUM)
    dry, dry_problems = {}, []
    profile_train_step(torch, cfg, args, state, lambda run, a: dry.update(
        _dry_hold(torch, "train", rec, run, a, card, dry_problems)))
    if dry_problems:
        raise AssertionError("dryrun phase: " + "; ".join(dry_problems))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    steps = [h["wall_s"] for h in hist]
    later = steps[1:] or steps
    log(f"[train] {card}: qwen2.5-14b full width, {TRAIN_LAYERS} layers, "
        f"{n_params / 1e9:.3f} B parameters, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, accum {TRAIN_ACCUM}: {len(hist)} steps in "
        f"{wall:.2f} s (with init), step wall s {steps}, mean of steps "
        f"2-{len(steps)} {sum(later) / len(later):.4f} s "
        f"({TRAIN_BATCH * TRAIN_SEQ * len(later) / sum(later):.1f} tok/s); "
        f"peak memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    log(f"[train] losses {[round(h['loss'], 4) for h in hist]} grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}; counts {counts}; SA "
        f"GEMM routes {routes}; tiles {tiles} (the plan's: {want_tiles})")
    problems = []
    if len(hist) != TRAIN_STEPS:
        problems.append(f"{len(hist)} of {TRAIN_STEPS} steps")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        problems.append("non-finite loss or grad norm")
    if counts["sa_matmul"]["launches"] <= 0:
        problems.append("the SA GEMM's forward never launched")
    if counts["sa_matmul_bwd"]["launches"] <= 0:
        problems.append("the SA GEMM's backward never launched")
    for key in ("sa_matmul", "sa_matmul_bwd"):
        if counts[key]["plain_calls"] != 0:
            problems.append(f"the plain GEMM ran ({key}: "
                            f"{counts[key]['plain_calls']} calls)")
    # under the bf16 policy every forward GEMM runs on the tensor cores
    # (mma) and every backward GEMM splits dus (split3)
    if (routes["mma"] != counts["sa_matmul"]["launches"]
            or routes["split3"] != counts["sa_matmul_bwd"]["launches"]
            or routes["simt"] or routes["partial"]):
        problems.append(f"SA GEMM routes {routes}: the forward must run "
                        f"mma only and the backward split3 only")
    if tiles != want_tiles:
        problems.append(f"SA GEMM tiles {tiles}, the plan implies "
                        f"{want_tiles}")
    if problems:
        raise AssertionError("train phase failed: " + "; ".join(problems))
    return counts["sa_matmul_bwd"]["launches"], step0, routes, tiles, dry


# ---------------------------------------------------------------------------
# the dryrun phase: the dry run's counts (launch/dryrun.py, a step on the
# meta device) held against the same steps run for real on the card
# ---------------------------------------------------------------------------

DRY_LAYERS = 4                   # full width, cut to 4 layers
DRY_PREFILL = (4, 1024)          # rows x tokens
DRY_DECODE = (8, 2048)           # slots x tokens of the pool, page PAGE
DRY_PEAK_FLOOR = 0.85            # predicted peak / measured, at least
DRY_PRODUCTION = ("qwen2.5-14b", "decode_32k", "pod", "paged")


def _dry_run_cell(*args, **kw):
    """`launch.dryrun.run_cell` in this process: its `fake` process group
    ended after, and the exception hook that starting a group installs
    (a rank prefix on every later traceback) put back."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D

    hook = sys.excepthook
    try:
        return D.run_cell(*args, **kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        sys.excepthook = hook


def _dry_count(cfg, shape, kv="ring", page_size=None, accum=None):
    """The dry run's record of one cell on a (1, 1) mesh (this process as
    the one rank of a `fake` group)."""
    from repro_torch.parallel.mesh import MeshSpec

    rec = _dry_run_cell(cfg.name, shape.name, "1x1", cfg=cfg, shape=shape,
                        spec=MeshSpec(("data", "model"), (1, 1)), kv=kv,
                        page_size=page_size, accum=accum)
    if rec["status"] != "ok":
        raise AssertionError(f"dry run of {cfg.name} {shape.name}: "
                             f"{rec.get('error') or rec}")
    return rec


def _dry_hold(torch, tag, rec, run, args, card, problems):
    """Run `run()` (one real step on `args`, on the card) and hold `rec`,
    the dry run's record of the same cell, to it: launches by kernel,
    route and tile equal to the ops counters' deltas, argument bytes equal
    to the real arguments', the predicted peak (arguments, outputs and
    temporaries) at least DRY_PEAK_FLOOR of the measured one (the
    arguments plus what the step allocated above them,
    `max_memory_allocated`). Returns the reading."""
    from repro_torch.kernels import ops
    from repro_torch.launch.cost import storage_bytes

    torch.cuda.synchronize()
    ops.reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    run()
    torch.cuda.synchronize()
    step_s = time.monotonic() - t
    step_bytes = torch.cuda.max_memory_allocated() - base
    real = {"counts": {k: v["launches"] for k, v in ops.counts().items()},
            "routes": ops.route_counts(), "tiles": ops.tile_counts()}
    pred = {k: rec["launches"][k] for k in ("counts", "routes", "tiles")}
    arg = storage_bytes(args)
    mem = rec["memory"]
    measured = arg + step_bytes
    ratio = mem["peak_estimate_bytes"] / measured
    out = {"launches": sum(real["counts"].values()),
           "launches_equal": pred == real,
           "argument_bytes": arg, "predicted_argument_bytes":
               mem["argument_bytes"],
           "measured_peak_bytes": measured,
           "predicted_peak_bytes": mem["peak_estimate_bytes"],
           "predicted_over_measured": ratio,
           "measured_over_predicted": measured / mem["peak_estimate_bytes"],
           "step_over_args_bytes": step_bytes,
           "predicted_output_temp_bytes": mem["output_bytes"]
           + mem["temp_peak_bytes"],
           "flops": rec["flops"], "kernel_bytes": rec["kernel_bytes"],
           "eager_bytes": rec["eager_bytes"], "host_ops": rec["host_ops"],
           "dry_seconds": rec["seconds"], "step_s": step_s}
    log(f"[dryrun] {tag}: launches {out['launches']} "
        f"{'equal' if pred == real else 'DIFFER'}; argument bytes "
        f"{arg} real, {mem['argument_bytes']} predicted; peak "
        f"{measured / 2 ** 30:.3f} GiB measured, "
        f"{mem['peak_estimate_bytes'] / 2 ** 30:.3f} GiB predicted "
        f"(predicted/measured {ratio:.4f}, measured/predicted "
        f"{1 / ratio:.4f}); {card}")
    if pred != real:
        log(f"[dryrun] {tag}: predicted {json.dumps(pred)}")
        log(f"[dryrun] {tag}: measured  {json.dumps(real)}")
        problems.append(f"{tag}: launches differ")
    if arg != mem["argument_bytes"]:
        problems.append(f"{tag}: argument bytes {arg} != "
                        f"{mem['argument_bytes']}")
    if ratio < DRY_PEAK_FLOOR:
        problems.append(f"{tag}: predicted peak {ratio:.4f} of the "
                        f"measured one")
    return out


def _dry_pool(torch, cache, B, T, psz):
    """Every slot of a paged cache mapped to its own T / psz pages (page 0
    the trash page), every row at its position: a full cache of T."""
    from repro_torch.models.layers import PagedKVCache

    P = T // psz
    table = (1 + torch.arange(B * P, dtype=torch.int32, device="cuda")
             ).reshape(B, P)
    rows = torch.arange(T, dtype=torch.int32, device="cuda").reshape(P, psz)
    for c in cache:
        kv = c.get("kv")
        if isinstance(kv, PagedKVCache):
            kv.block_table.copy_(table.expand_as(kv.block_table))
            kv.positions[:, 1:1 + B * P] = rows.repeat(B, 1)


def dryrun_serving(torch, card):
    """The dry run's prefill and decode cells against real steps: qwen at
    full width cut to DRY_LAYERS layers, a prefill of DRY_PREFILL and a
    decode step of DRY_DECODE slots over a paged pool of pages of PAGE
    (the serve stream's page); granite (dropless) and mamba2 decode steps
    at the same depth. Then a production cell's dry run on this host
    (DRY_PRODUCTION), and the 4-layer qwen decode step's host_ops beside
    the CUDA launches torch.profiler counts over the same real step."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.core.precision import PrecisionPolicy, use_policy
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCfg
    from repro_torch.parallel.mesh import MeshSpec
    from repro_torch.train.step import make_prefill_step, make_serve_step

    problems, out = [], {}
    fresh_tune_cache("dryrun")      # the heuristic's tiles, as on meta
    g = torch.Generator(device="cuda").manual_seed(7)
    pol = PrecisionPolicy(backend="cuda")
    rows, T = DRY_PREFILL
    B, S = DRY_DECODE
    cells = [("qwen_prefill", ARCH, ShapeCfg("prefill_4x1024", T, rows,
                                             "prefill"), "ring"),
             ("qwen_decode", ARCH, ShapeCfg("decode_8x2048", S, B,
                                            "decode"), "paged"),
             ("granite_decode", GRANITE, ShapeCfg("decode_8x2048", S, B,
                                                  "decode"), "paged"),
             ("mamba2_decode", MAMBA2, ShapeCfg("decode_8x2048", S, B,
                                                "decode"), "ring")]
    qwen_decode = None
    for tag, arch, shape, kv in cells:
        cfg = cut_depth(get_config(arch), DRY_LAYERS)
        rec = _dry_count(cfg, shape, kv, PAGE)
        params = M.init_params(cfg, seed=0, device="cuda",
                               dtype=torch.bfloat16)
        paged = kv == "paged" and shape.kind == "decode"
        pages = SP.pool_pages_for(MeshSpec(("data", "model"), (1, 1)),
                                  shape.global_batch, shape.seq_len,
                                  PAGE) if paged else None
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                             dtype=torch.bfloat16, device="cuda",
                             paged=(pages, PAGE) if paged else None)
        n = shape.global_batch
        if shape.kind == "prefill":
            tokens = torch.randint(0, cfg.vocab_size, (n, shape.seq_len),
                                   generator=g, device="cuda",
                                   dtype=torch.int32)
            step, args = make_prefill_step(cfg), (params, tokens, cache)
        else:
            if paged:
                _dry_pool(torch, cache, n, shape.seq_len, PAGE)
            tokens = torch.randint(0, cfg.vocab_size, (n, 1), generator=g,
                                   device="cuda", dtype=torch.int32)
            pos = torch.full((n,), shape.seq_len - 1, dtype=torch.int32,
                             device="cuda")
            step = make_serve_step(cfg, PAGE)
            args = (params, tokens, cache, pos)

        def run(step=step, args=args):
            with use_policy(pol), torch.no_grad():
                step(*args)
        out[tag] = _dry_hold(torch, tag, rec, run, args, card, problems)
        if tag == "qwen_decode":
            qwen_decode = (run, rec)
        del params, cache, args, run
        gc.collect()
        torch.cuda.empty_cache()

    # the 4-layer qwen decode step: the aten ops the dry run says would
    # launch, beside the CUDA kernels the profiler sees (no gate)
    from torch.profiler import ProfilerActivity, profile

    run, rec = qwen_decode
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ks = device_kernels(torch, prof)
    seen = sum(n for _, n in ks.values())
    n_kernels = (sum(rec["launches"]["counts"].values())
                 - rec["launches"]["counts"]["paged_decode_lse"]
                 + sum(v for k, v in rec["launches"]["other"].items()
                       if k != "operand_copy"))
    out["qwen_decode"]["profiler_launches"] = seen
    log(f"[dryrun] qwen_decode host_ops {rec['host_ops']} + kernel launches "
        f"{n_kernels} = {rec['host_ops'] + n_kernels} predicted; CUDA "
        f"launches the profiler counts over the same step: {seen}; {card}")
    del qwen_decode, run
    gc.collect()
    torch.cuda.empty_cache()

    # a production cell on this host
    t = time.monotonic()
    prod = _dry_run_cell(*DRY_PRODUCTION[:3], kv=DRY_PRODUCTION[3])
    log(f"[dryrun] production {D.summary_line(prod)} (host wall "
        f"{time.monotonic() - t:.1f} s)")
    if prod["status"] != "ok":
        problems.append(f"production cell {prod['status']}: "
                        f"{prod.get('error')}")
    out["production"] = {k: prod.get(k) for k in (
        "status", "memory", "flops", "kernel_bytes", "eager_bytes",
        "host_ops", "seconds")} | {
        "launches": sum(prod.get("launches", {}).get("counts", {}).values()),
        "collectives_mib": prod.get("collectives", {}).get("total", 0)
        / 2 ** 20}
    if problems:
        raise AssertionError("dryrun phase: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# the kernels at the shapes a rank of the parallel_serve runs gives them
# ---------------------------------------------------------------------------

# (tag, arch, model axis, rank): the rank whose slice is checked (the last
# one where phi3's padded heads sit)
RANK_CASES = (("qwen 1x2 rank 1", "qwen2.5-14b", 2, 1),
              ("qwen 1x4 rank 1", "qwen2.5-14b", 4, 1),
              ("phi3 1x4 rank 3", "phi3-medium-14b", 4, 3))


def check_rank_shapes(torch, timer):
    """Each kernel of the tensor-parallel serve at a rank's shapes, held
    against its plain version within `error_bound` and against the whole
    (one-process) call bit for bit: the paged decode over the rank's KV
    heads of the serve pool (qwen 4 and 2 of 8 at g = 5; phi3 3 of 12, its
    10 heads padded with zero K/V and zero Q heads, g = 4); the prefill
    over the rank's (padded) heads at the longest serve prompt; the SA
    GEMM's column shards (wq, wk, wv, wg, wu, the lm_head at N / tp, M =
    4) per column; the row shards' raw fp32 chain (`sa_dot_chain`, wo and
    wd at K / tp on the decode tile); then granite's expert pieces under a
    `model` axis of 16 (`expert_shards`). Returns (readings, the worst
    error over its bound of each kernel, the largest error of each)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy, sa_dot_chain
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_attention as fa
    from repro_torch.kernels import sa_decode_attention as da
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.models.layers import padded_kvh

    g = torch.Generator(device="cuda").manual_seed(29)
    pol = PrecisionPolicy()
    worst = {"decode": 0.0, "prefill": 0.0, "gemm": 0.0}
    max_err = dict.fromkeys(worst, 0.0)
    out = {}

    def hold(kind, tag, got, ref, bnd, same):
        ratio = float(((got - ref).abs() / bnd).max())
        err = float((got - ref).abs().max())
        if not torch.isfinite(got).all() or ratio > 1.0 or not same:
            raise AssertionError(f"[rank shapes] {tag}: err/bound "
                                 f"{ratio:.4f}, bits of the whole call "
                                 f"{same}")
        worst[kind] = max(worst[kind], ratio)
        max_err[kind] = max(max_err[kind], err)
        return ratio

    def bits(a, b):
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))

    P = -(-CACHE_LEN // PAGE)
    n_pages = -(-BATCH * CACHE_LEN // PAGE) + 1
    lens = [CACHE_LEN, 100, 40, 0]
    T = max(PROMPT_LENS)
    for tag, arch, tp, r in RANK_CASES:
        cfg = get_config(arch)
        kvh, hd = cfg.num_kv_heads, cfg.hd
        grp = cfg.num_heads // kvh
        pk = padded_kvh(kvh, tp)
        lo, hi = r * pk // tp, (r + 1) * pk // tp
        rd = {}
        # paged decode over the rank's KV heads of the (padded) pool
        q, k, v, pp, bt, pos = _paged_workload(torch, g, BATCH, pk, grp, hd,
                                               PAGE, P, n_pages, lens)
        k[:, :, kvh:] = v[:, :, kvh:] = 0.0
        q[:, :, kvh * grp:] = 0.0
        whole = ops.paged_decode_attention(q, k, v, pp, bt, pos, policy=pol)
        qs = q[:, :, lo * grp:hi * grp].contiguous()
        ks, vs = k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
        got = ops.paged_decode_attention(qs, ks, vs, pp, bt, pos, policy=pol)
        ref = da.paged_decode_ref(qs, ks, vs, pp, bt, pos, policy=pol)
        bnd = da.error_bound(qs, ks, vs, pp, bt, pos, policy=pol)
        same = bits(got, whole[:, :, lo * grp:hi * grp])
        if pk > kvh and whole[:, :, kvh * grp:].any():
            same = False          # a padded head's output must be zeros
        rd["decode"] = {
            "kv_heads": f"{lo}:{hi} of {pk}", "g": grp,
            "err_over_bound": hold("decode", f"{tag} decode", got, ref, bnd,
                                   same),
            "ms": timer.wall(lambda: ops.paged_decode_attention(
                qs, ks, vs, pp, bt, pos, policy=pol)),
            "n_split": da.split_plan(grp, hd, PAGE, P).n_split}
        # prefill over the rank's (padded) heads of the longest prompt
        qf = torch.randn((1, T, cfg.num_heads, hd), generator=g,
                         device="cuda")
        kf = torch.randn((1, T, kvh, hd), generator=g, device="cuda")
        vf = torch.randn((1, T, kvh, hd), generator=g, device="cuda")
        wf = ops.sa_attention(qf, kf, vf, policy=pol)
        pad = torch.nn.functional.pad
        extra = pk - kvh
        qp = pad(qf, (0, 0, 0, extra * grp))
        kp, vp = pad(kf, (0, 0, 0, extra)), pad(vf, (0, 0, 0, extra))
        qs = qp[:, :, lo * grp:hi * grp].contiguous()
        ks, vs = kp[:, :, lo:hi].contiguous(), vp[:, :, lo:hi].contiguous()
        got = ops.sa_attention(qs, ks, vs, policy=pol)
        ref = fa.flash_attention_ref(qs, ks, vs, policy=pol)
        bnd = fa.error_bound(qs, ks, vs, policy=pol)
        real = max(0, min(hi, kvh) - lo) * grp
        same = bits(got[:, :, :real],
                    wf[:, :, lo * grp:lo * grp + real]) and not bool(
                        got[:, :, real:].any())
        rd["prefill"] = {
            "T": T, "err_over_bound": hold("prefill", f"{tag} prefill", got,
                                           ref, bnd, same),
            "ms": timer.wall(lambda: ops.sa_attention(qs, ks, vs,
                                                      policy=pol))}
        # the column shards at M = BATCH: each column the whole GEMM's bits
        d, H, ff = cfg.d_model, cfg.num_heads, cfg.d_ff
        cols = [("wq", H * hd, cfg.qkv_bias, "none"),
                ("wk", kvh * hd, cfg.qkv_bias, "none"),
                ("wv", kvh * hd, cfg.qkv_bias, "none"),
                ("wg", ff, False, "silu"), ("wu", ff, False, "none"),
                ("lm_head", cfg.padded_vocab, False, "none")]
        a = torch.randn((BATCH, d), generator=g, device="cuda").to(
            torch.bfloat16)
        gem = {}
        for name, n, has_bias, act in cols:
            w = (torch.randn((d, n), generator=g, device="cuda")
                 * d ** -0.5).to(torch.bfloat16)
            b = (torch.randn((n,), generator=g, device="cuda") * 0.1
                 if has_bias else None)
            y = ops.sa_matmul(a, w, bias=b, act=act)
            c0, c1 = r * n // tp, (r + 1) * n // tp
            ws = w[:, c0:c1].contiguous()
            bs = None if b is None else b[c0:c1].contiguous()
            got = ops.sa_matmul(a, ws, bias=bs, act=act)
            ref = mm.sa_matmul_ref(a, ws, bs, act=act)
            bnd = mm.error_bound(a, ws, None, "exact", y=ref)
            gem[name] = {"N": c1 - c0, "err_over_bound": hold(
                "gemm", f"{tag} {name} columns {c0}:{c1}", got, ref, bnd,
                bits(got, y[:, c0:c1])), "ms": timer.wall(
                lambda: ops.sa_matmul(a, ws, bias=bs, act=act))}
            del w, ws, y
        # the row shards' partial chain at K / tp (wo, wd), N = d
        for name, k_all in (("wo", H * hd), ("wd", ff)):
            kk = k_all // tp
            a = torch.randn((BATCH, kk), generator=g, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((kk, d), generator=g, device="cuda")
                 * k_all ** -0.5).to(torch.bfloat16)
            ops.reset_counts()
            got = sa_dot_chain(a, w, PrecisionPolicy(backend="cuda"))
            launched = ops.counts()["sa_matmul"]["launches"]
            tile = mm.mma_plan(BATCH, d, "mma")["tile"]
            ref = sa_dot_chain(a, w, PrecisionPolicy(backend="torch"))
            bnd = mm.error_bound(a, w, y=ref)
            gem[f"{name}_chain"] = {"K": kk, "tile": tile, "err_over_bound":
                                    hold("gemm", f"{tag} {name} chain K "
                                         f"{kk}", got, ref, bnd,
                                         launched == 1 and got.dtype
                                         == torch.float32
                                         and tile == "decode"),
                                    "ms": timer.wall(lambda: sa_dot_chain(
                                        a, w, PrecisionPolicy(
                                            backend="cuda")))}
        rd["gemm"] = gem
        out[tag] = rd
        log(f"[rank shapes] {tag}: decode heads {rd['decode']['kv_heads']} "
            f"g {grp}: err/bound {rd['decode']['err_over_bound']:.4f}, "
            f"{rd['decode']['ms']:.4f} ms wall; prefill T {T} over "
            f"{hi - lo} KV heads: err/bound "
            f"{rd['prefill']['err_over_bound']:.4f}, "
            f"{rd['prefill']['ms']:.4f} ms; GEMMs at M {BATCH} "
            + ", ".join(f"{n_} {v_.get('N', v_.get('K'))}: "
                        f"{v_['err_over_bound']:.4f} {v_['ms']:.4f} ms"
                        for n_, v_ in gem.items())
            + "; each column shard and rank head the whole call's bits")
    out[EXPERT_SHARD_TAG] = {"gemm": expert_shards(torch, timer, g, hold,
                                                   bits)}
    out[FAMILY_SHARD_TAG] = {"gemm": family_shards(torch, timer, g, hold,
                                                   bits)}
    return out, worst, max_err


# granite's experts on the JAX production mesh's `model` axis of 16, which
# its 40 experts do not divide (tensor parallelism inside each expert):
# (d_model, d_ff, model axis), and the M the dispatch gives an expert
EXPERT_SHARD_TAG = "granite experts 1x16"
EXPERT_SHARD = (1536, 512, 16)
EXPERT_SHARD_M = (BATCH, 20, 512)


def _gemm_times(torch, timer, a, w, run, plain):
    """The three times and the bound of one SA GEMM piece (a (M, K) bf16
    @ w (K, N) bf16 to fp32): `run` (the kernel), `plain` (its plain
    version) and bf16 `torch.matmul`, each `Timer.wall`; the bound the
    larger of the bytes (A and W read once, the fp32 output written once)
    over the byte rate and 2MNK over the bf16 tensor-core peak."""
    m, k = a.shape
    n = w.shape[1]
    b_ms, by = bound_ms(2 * (m * k + k * n) + 4 * m * n, 2 * m * n * k,
                        PEAK_BF16)
    return {"ms": timer.wall(run), "plain_ms": timer.wall(plain),
            "library_ms": timer.wall(lambda: torch.matmul(a, w)),
            "bound_ms": b_ms, "bound_by": by}


# the SSM, hybrid and frontend families' rank shapes: (name, M, K, N of
# the whole call, tp, kind, act): a column piece ("cols": the rank's
# N / tp columns, its bits the whole call's) or a row chain ("rows": the
# rank's K / tp rows' unrounded fp32 chain); mamba2 at model 2 and hymba
# at model 4 at the decode batch, whisper at model 4 over the encoder's
# 4 x 1500 frames and at the decode batch
FAMILY_SHARD_TAG = "families 1x2 / 1x4"
FAMILY_SHARDS = (
    ("mamba2 in_proj", BATCH, 2560, 10576, 2, "cols", "none"),
    ("mamba2 out_proj", BATCH, 5120, 2560, 2, "rows", "none"),
    ("hymba out_proj", BATCH, 3200, 1600, 4, "rows", "none"),
    *((f"whisper {name} M={m}", m, k, n, 4, kind, act)
      for m in (4 * 1500, BATCH)
      for name, k, n, kind, act in (
          ("w1", 384, 1536, "cols", "gelu"), ("w2", 1536, 384, "rows", "none"),
          ("cross wk", 384, 384, "cols", "none"),
          ("cross wv", 384, 384, "cols", "none"))))


def family_shards(torch, timer, g, hold, bits):
    """The SA GEMM at this slice's rank shapes (FAMILY_SHARDS), the last
    rank's piece of each: a column piece within its plain version's bound
    and carrying the whole call's bits; a row chain (`sa_dot_chain`, one
    launch, fp32 out) within the plain chain's bound. Each timed beside
    its plain version, bf16 `torch.matmul` and its bound (`_gemm_times`).
    `hold` and `bits` are `check_rank_shapes`'s. Returns the readings."""
    from repro_torch.core.precision import PrecisionPolicy, sa_dot_chain
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm

    out = {}
    for name, m, k, n, tp, kind, act in FAMILY_SHARDS:
        r = tp - 1
        tag = f"[rank shapes] {name} {kind} 1x{tp} rank {r}"
        if kind == "cols":
            a = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=g, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            c = n // tp
            y = ops.sa_matmul(a, w, act=act)
            ws = w[:, r * c:].contiguous()
            got = ops.sa_matmul(a, ws, act=act)
            ref = mm.sa_matmul_ref(a, ws, act=act)
            rec = {"K": k, "N": c, "err_over_bound": hold(
                "gemm", tag, got, ref, mm.error_bound(
                    a, ws, None, "exact", y=ref), bits(got, y[:, r * c:])),
                "tile": mm.mma_plan(m, c, "mma")["tile"]}
            rec |= _gemm_times(torch, timer, a, ws,
                               lambda: ops.sa_matmul(a, ws, act=act),
                               lambda: mm.sa_matmul_ref(a, ws, act=act))
            del y, w
        else:
            c = k // tp
            a = torch.randn((m, c), generator=g, device="cuda").to(
                torch.bfloat16)
            ws = (torch.randn((c, n), generator=g, device="cuda")
                  * k ** -0.5).to(torch.bfloat16)
            ops.reset_counts()
            got = sa_dot_chain(a, ws, PrecisionPolicy(backend="cuda"))
            launched = ops.counts()["sa_matmul"]["launches"]
            ref = sa_dot_chain(a, ws, PrecisionPolicy(backend="torch"))
            rec = {"K": c, "N": n, "err_over_bound": hold(
                "gemm", tag, got, ref, mm.error_bound(a, ws, y=ref),
                launched == 1 and got.dtype == torch.float32),
                "tile": mm.mma_plan(m, n, "mma")["tile"]}
            rec |= _gemm_times(
                torch, timer, a, ws,
                lambda: sa_dot_chain(a, ws, PrecisionPolicy(backend="cuda")),
                lambda: sa_dot_chain(a, ws, PrecisionPolicy(
                    backend="torch")))
        out[name] = rec
        del a, ws, got, ref
    log(f"[rank shapes] {FAMILY_SHARD_TAG}: " + ", ".join(
        f"{name} M {m} K {v['K']} N {v['N']} on {v['tile']}: err/bound "
        f"{v['err_over_bound']:.4f}, {v['ms']:.4f} ms (plain "
        f"{v['plain_ms']:.4f}, bf16 torch.matmul {v['library_ms']:.4f}, "
        f"bound {v['bound_ms']:.3g} by {v['bound_by']})"
        for (name, m, *_), v in zip(FAMILY_SHARDS, out.values()))
        + "; each column piece the whole call's bits")
    return out


def expert_shards(torch, timer, g, hold, bits):
    """The SA GEMM at granite's expert pieces under a `model` axis of 16
    (EXPERT_SHARD): wg and wu as (1536, 32) column pieces, each within
    its plain version's bound and carrying the whole (1536, 512) call's
    bits per column; wd as the row chain (`sa_dot_chain`) over K = 32,
    two k16 steps, within the plain chain's bound; at each M of
    EXPERT_SHARD_M, one piece of each timed. `hold` and `bits` are
    `check_rank_shapes`'s. Returns the readings."""
    from repro_torch.core.precision import PrecisionPolicy, sa_dot_chain
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm

    d, f, tp = EXPERT_SHARD
    c = f // tp
    tag = f"[rank shapes] {EXPERT_SHARD_TAG}"
    out = {}
    for m in EXPERT_SHARD_M:
        a = torch.randn((m, d), generator=g, device="cuda").to(
            torch.bfloat16)
        for name, act in (("wg", "silu"), ("wu", "none")):
            w = (torch.randn((d, f), generator=g, device="cuda")
                 * d ** -0.5).to(torch.bfloat16)
            y = ops.sa_matmul(a, w, act=act)
            ratio = 0.0
            for r in range(tp):
                ws = w[:, r * c:(r + 1) * c].contiguous()
                got = ops.sa_matmul(a, ws, act=act)
                ref = mm.sa_matmul_ref(a, ws, act=act)
                bnd = mm.error_bound(a, ws, None, "exact", y=ref)
                ratio = max(ratio, hold(
                    "gemm", f"{tag} {name} M {m} columns {r * c}:"
                    f"{(r + 1) * c}", got, ref, bnd,
                    bits(got, y[:, r * c:(r + 1) * c])))
            out[f"{name} M={m}"] = {
                "N": c, "pieces": tp, "err_over_bound": ratio,
                "tile": mm.mma_plan(m, c, "mma")["tile"]} | _gemm_times(
                torch, timer, a, ws, lambda: ops.sa_matmul(a, ws, act=act),
                lambda: mm.sa_matmul_ref(a, ws, act=act))
            del w, ws, y
        h = torch.randn((m, c), generator=g, device="cuda").to(
            torch.bfloat16)
        wd = (torch.randn((c, d), generator=g, device="cuda")
              * f ** -0.5).to(torch.bfloat16)
        ops.reset_counts()
        got = sa_dot_chain(h, wd, PrecisionPolicy(backend="cuda"))
        launched = ops.counts()["sa_matmul"]["launches"]
        ref = sa_dot_chain(h, wd, PrecisionPolicy(backend="torch"))
        out[f"wd_chain M={m}"] = {
            "K": c, "tile": mm.mma_plan(m, d, "mma")["tile"],
            "err_over_bound": hold(
                "gemm", f"{tag} wd chain M {m} K {c}", got, ref,
                mm.error_bound(h, wd, y=ref),
                launched == 1 and got.dtype == torch.float32)} | _gemm_times(
            torch, timer, h, wd,
            lambda: sa_dot_chain(h, wd, PrecisionPolicy(backend="cuda")),
            lambda: sa_dot_chain(h, wd, PrecisionPolicy(backend="torch")))
    log(f"{tag}: " + ", ".join(
        f"{k} {v.get('N', v.get('K'))} on {v['tile']}: err/bound "
        f"{v['err_over_bound']:.4f}, {v['ms']:.4f} ms (plain "
        f"{v['plain_ms']:.4f}, bf16 torch.matmul {v['library_ms']:.4f}, "
        f"bound {v['bound_ms']:.3g} by {v['bound_by']})"
        for k, v in out.items())
        + "; each column piece the whole call's bits")
    return out


# ---------------------------------------------------------------------------
# phase 10: parallel — the training and serve launchers under torchrun on
# one card
# ---------------------------------------------------------------------------

# (arch, layers, (data, model), accum): full width, the depth cut so that
# every rank's fp32 state (16 B a parameter) fits the one card beside the
# others; (2, 2) takes its rows in one microbatch, since a second one's
# gradient transients (the vocabulary shards' dW and the lookup's dense
# gradient, 1.46 GiB each a rank) do not fit four ranks beside each other;
# granite (since PR 30) cut to PMOE_LAYERS of its 32 layers, EP at (1, 2)
# (20 experts a rank) and EP with DP and the global load-balance loss at
# (2, 2), in the worlds of qwen's runs of the same shape; since PR 30
# qwen at (1, 2) and phi3 at (1, 4) cut to 1 layer (2 before), for the
# whole run's time limit
PMOE_LAYERS = 2
# granite's serve on the mesh, on the moe phase's stream at the depth it
# trains at (EP runs the same dispatch at every layer)
PGRANITE_ARGS = GRANITE_ARGS[:-1] + [str(PMOE_LAYERS)]
# The SSM, hybrid and frontend families and a 6-expert granite
# (GRANITE_E6) train in the worlds of their shape, each at full width:
# pixtral cut to 2 layers and mamba2 to 2 at (1, 2); whisper at full
# depth, hymba cut to 2 (its global layer 0 and local layer 1,
# `configs.cut_depth`) and GRANITE_E6 to 2 at (1, 4); the frontend archs
# on seeded stub frames or patches (`launch.train --frontend`)
GRANITE_E6 = "granite-moe-3b-a800m-e6"
# FSDP: llama4-maverick at full width (LLAMA4_E4) cut to its first
# superblock (LLAMA4_LAYERS) and to 4 of its 128 experts (all 128 at 16 B a
# parameter of fp32 state would need ~260 GB), 3.08 B parameters or 45.8
# GiB of fp32 state (parameters, μ, ν, gradients) over the world, trained
# at (2, 2) in the (2, 2) world: every matrix cut over `data` and `model`,
# each superblock's weights gathered over `data` in the forward and
# reduce-scattered in the backward, EP over `model`, the load-balance loss
# over the global batch
LLAMA4_E4 = "llama4-maverick-400b-a17b-e4"
FSDP_RUN = 10
PARALLEL_RUNS = (("qwen2.5-14b", 1, (1, 2), TRAIN_ACCUM),
                 ("qwen2.5-14b", 1, (2, 2), 1),
                 ("phi3-medium-14b", 1, (1, 4), TRAIN_ACCUM),
                 (GRANITE, PMOE_LAYERS, (1, 2), 1),
                 (GRANITE, PMOE_LAYERS, (2, 2), 1),
                 (PIXTRAL, 2, (1, 2), 1),
                 (MAMBA2, 2, (1, 2), 1),
                 (WHISPER, 4, (1, 4), 1),
                 (HYMBA, 2, (1, 4), 1),
                 (GRANITE_E6, PMOE_LAYERS, (1, 4), 1),
                 (LLAMA4_E4, LLAMA4_LAYERS, (2, 2), 1))
PARALLEL_STEPS = 3
# runs cut to fewer steps for the script's time limit: the FSDP run's
# 2 (3 before its first full run, PR 32: ~12 s a step on four ranks'
# gloo traffic)
RUN_STEPS = {FSDP_RUN: 2}


def _run_steps(i) -> int:
    """The steps PARALLEL_RUNS[i] trains."""
    return RUN_STEPS.get(i, PARALLEL_STEPS)
# a rank's parameters, μ and ν under FSDP: within this share of the
# world's over the ranks (the norms, whole on every rank, are the rest)
FSDP_STATE_REL = 0.05
# the stand-ins the worlds and their references register under a name of
# their own (`_register_stand_ins`): granite at full width with 6 of its
# 40 experts, which a `model` axis of 4 does not divide, so each expert is
# cut by its d_ff (512 / 4), the layout tests/test_torch_moe_parallel.py
# holds on its reduced 6-expert stand-in (whose 16-wide heads are below
# the attention kernels' on the card); llama4 with 4 of its 128 experts
# (LLAMA4_E4)
STAND_INS = {GRANITE_E6: (GRANITE, {"num_experts": 6}),
             LLAMA4_E4: (LLAMA4, {"num_experts": 4})}


def _register_stand_ins():
    """Put STAND_INS in the port's config registry, so the launchers'
    `--arch` finds them."""
    from repro_torch import configs

    for name, (base, kw) in STAND_INS.items():
        configs.REGISTRY[name] = dataclasses.replace(
            configs.get_config(base), name=name, **kw)


def _is_frontend(arch) -> bool:
    return arch in (WHISPER, PIXTRAL)

# the serve runs (serving under tensor parallelism), each in the torchrun
# world of the training runs of its shape, after their steps, on weights
# of their own drawn from the serve seed (a world's start is the dearest
# part of a short run): qwen2.5-14b at full width cut to
# PSERVE_QWEN_LAYERS (since PR 30; full depth before) on the serve stream
# at (1, 2), paged; granite at full width cut to PMOE_LAYERS and
# llama4-maverick at full width cut to one superblock, each on the moe
# phase's granite stream at (1, 2), paged (since PR 30; granite held in
# the parallel lane against a one-process serve of its own, llama4 after
# the moe phase's one-process serve); the serve stream on one nccl rank at
# (1, 1) (full depth: the serve phase's digest bit for bit);
# phi3-medium-14b at full width cut to PSERVE_PHI3_LAYERS (4 before PR 30)
# at (1, 4) (its 10 KV heads padded to 12), paged, `--kv ring` and
# `--disagg`: one digest. Each: (key, driver arguments, runs). qwen's
# depth: 4 layers (12 before the (2, 2) world served too), in both
# worlds that serve it and in its one-process reference
PSERVE_QWEN_LAYERS, PSERVE_PHI3_LAYERS = 4, 2
PHI3_SERVE_ARGS = ["--arch", "phi3-medium-14b"] + SERVE_ARGS[2:]
# the batch-1 long-context serve over the `data` axis: one
# 2048-token prompt, 16 new tokens, on a 4096-row ring whose rows split
# over `data` (2048 rows, 128 pages, a data rank)
B1_ARGS = ["--arch", ARCH, "--batch", "1", "--requests", "1",
           "--prompt-lens", "2048", "--max-new", "16", "--cache-len", "4096",
           "--kv", "ring", "--rate", "0", "--seed", "0"]
# The families' serves (`family_serve_check`): pixtral cut to 2 layers on
# the frontend phase's static waves and mamba2 cut to 2 on the ssm phase's
# stream at (1, 2); whisper at full depth on its static waves, hymba cut
# to 2 (in_proj whole, 5 KV heads padded to 8, a local ring of 2048 rows
# beside the pool) on the ssm phase's stream, paged and `--kv ring`, and
# GRANITE_E6 cut to 2 on granite's stream at (1, 4)
PFAMILY_SERVES = {
    (1, 2): (("pixtral", FRONTEND_RUNS[PIXTRAL][:-1] + ["2"],
              {"static": []}),
             ("mamba2", MAMBA2_ARGS[:-1] + ["2"], {"paged": []})),
    (1, 4): (("whisper", FRONTEND_RUNS[WHISPER], {"static": []}),
             ("hymba", HYMBA_ARGS + ["--layers", "2"],
              {"paged": [], "ring": ["--kv", "ring"]}),
             ("granite_e6", ["--arch", GRANITE_E6] + PGRANITE_ARGS[2:],
              {"paged": []}))}
PSERVE_WORLDS = {
    (1, 2): (("qwen", SERVE_ARGS + ["--layers", str(PSERVE_QWEN_LAYERS),
                                    "--model-parallel", "2"],
              {"paged": []}),
             ("granite", PGRANITE_ARGS + ["--model-parallel", "2"],
              {"paged": []}),
             ("llama4", LLAMA4_ARGS + ["--model-parallel", "2"],
              {"paged": []})) + tuple(
        (key, argv + ["--model-parallel", "2"], runs)
        for key, argv, runs in PFAMILY_SERVES[(1, 2)]),
    (1, 1): (("nccl", SERVE_ARGS + ["--model-parallel", "1"],
              {"paged": []}),),
    # serving over the `data` axis, in the (2, 2) world of qwen's
    # and granite's steps: qwen on the serve stream at PSERVE_QWEN_LAYERS
    # paged, ring and disagg, granite on its stream, each data rank its two
    # slots and its range of pages (`data_serve_check`: the (1, 2)
    # world's digests bit for bit), and the batch-1 ring whose rows split
    # over `data` (R1's rule against one process)
    (2, 2): (("qwen_2x2", SERVE_ARGS + [
        "--layers", str(PSERVE_QWEN_LAYERS), "--model-parallel", "2"],
        {"paged": [], "ring": ["--kv", "ring"],
         "disagg": ["--disagg", "--prefill-workers", "2"]}),
        ("granite_2x2", PGRANITE_ARGS + ["--model-parallel", "2"],
         {"paged": []}),
        ("qwen_b1", B1_ARGS + ["--layers", str(PSERVE_QWEN_LAYERS),
                               "--model-parallel", "2"], {"ring": []})),
    (1, 4): (("phi3", PHI3_SERVE_ARGS + [
        "--layers", str(PSERVE_PHI3_LAYERS), "--model-parallel", "4"],
        {"paged": [], "ring": ["--kv", "ring"],
         "disagg": ["--disagg", "--prefill-workers", "2"]}),) + tuple(
        (key, argv + ["--model-parallel", "4"], runs)
        for key, argv, runs in PFAMILY_SERVES[(1, 4)])}
# ROADMAP R1's rule for a stream against the one-process stream: each
# request's prefill logits within 2^-5 max|logit|, its tokens equal up to
# the first position where the one-process top-two margin is below twice
# that bound (the row-parallel sums add fp32 in another order, and the
# bf16 residual stream turns that into bf16 flips)
PSERVE_REL = 2.0 ** -5
PSERVE_KEYS = ("requests", "generated_tokens", "pages_leaked",
               "nonfinite_logits", "decode_itl_p50_ms", "ttft_mean_s",
               "prefill_s", "decode_s", "wall_s", "decode_tok_s", "disagg",
               "kv_layout", "stream_digest", "pages_peak_in_use",
               "pages_peak_by_shard")
# the serves whose ranks also record each prompt's prefill logits on the
# mesh (R1's rule); the others are held by their digests
PSERVE_NO_PREFILL = ("nccl", "qwen_2x2", "granite_2x2")


def _parallel_reference(torch, cfg, accum, routing_path=None):
    """The one-process step 0 on the launcher's weights and first global
    batch (seed 0) under `cuda`: (loss, {leaf path: fp32 gradient on the
    host}); the card's memory is freed before it returns. With
    `routing_path` (a MoE model) its routing (`_RoutingReplay`) is saved
    there, for the sharded step 0 to replay (`serve_ranks`)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train.step import make_grad_fn

    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    for p in M.tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch_at(0).items()}
    if _is_frontend(cfg.name):
        batch["frontend"] = _train_frontend(torch, cfg, 0)
    with _RoutingReplay() as rec:
        rec.start("record" if routing_path else None)
        loss, _, grads = make_grad_fn(cfg, accum)(params, batch)
    if routing_path:
        # written whole, then renamed: a world waits for the file
        torch.save([i.cpu() for i in rec.idx], routing_path + ".tmp")
        os.replace(routing_path + ".tmp", routing_path)
    host = {p.strip("/").replace("/", "."): g.detach().cpu()
            for p, g in _grad_leaves(torch, grads).items()}
    loss = float(loss)
    del params, grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    return loss, host


def _train_frontend(torch, cfg, step, seed=0):
    """The stub frames or patches `launch.train --frontend` feeds a step
    (drawn on the host, seeded seed + 1 + step), on the card."""
    g = torch.Generator().manual_seed(seed + 1 + step)
    return torch.randn((TRAIN_BATCH, cfg.frontend_tokens, cfg.d_model),
                       generator=g).cuda()


# the training run whose free routing (steps 1-2, after step 0 on the
# one-process routing) is held by `_train_routing_gate`: granite at (1, 2)
TRAIN_ROUTING_RUN = 3


def _router_calls(rec, experts):
    """The router's calls among a `_RoutingReplay` recording (each token's
    top k of `experts`; the capacity dispatch's calls rank tokens): their
    (indices, probabilities) in call order."""
    return [(i, x) for i, x in zip(rec.idx, rec.scores)
            if x.shape[-1] == experts and i.shape[:-1] == x.shape[:-1]]


def _train_routing_reference(torch, cfg):
    """granite's one-process run of the launcher's PARALLEL_STEPS steps
    (its optimizer, weights, batches and backend), recording the router's
    calls of steps 1 to PARALLEL_STEPS - 1: a list a step of (indices,
    probabilities) on the host. The card's memory is freed after."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import init_state

    opt = AdamW(schedule=warmup_cosine(3e-4, max(2, PARALLEL_STEPS // 10),
                                       PARALLEL_STEPS))
    step = make_train_step(cfg, opt)
    state = init_state(cfg, opt, seed=0, device="cuda")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    out = []
    with _RoutingReplay() as rec:
        for i in range(PARALLEL_STEPS):
            rec.start("record" if i else None)
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in data.batch_at(i).items()}
            state, m = step(state, batch)
            float(m["loss"])
            if i:
                out.append([(a.cpu(), b.cpu()) for a, b in _router_calls(
                    rec, cfg.num_experts)])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_routing_gate(torch, one, mesh, k, tag):
    """The routing gate (`_routing_gate`) on a training run's free
    routing: `one` and `mesh` each a list a step of the router's calls
    (indices (B, T, k), probabilities (B, T, E)) in call order, the
    one-process run's and the mesh's. In each step, at the first call
    where a token's expert set differs, the spread of the two sides'
    probabilities must stay within R1's bound and every parted token's
    one-process top-k margin within twice it. Returns (readings a step:
    None where the step routed alike, else the call and its gate's
    readings; problems)."""
    out, problems = [], []
    for s, (a_calls, b_calls) in enumerate(zip(one, mesh)):
        if len(a_calls) != len(b_calls):
            problems.append(f"{tag} step {s + 1}: {len(b_calls)} router "
                            f"calls against {len(a_calls)}")
            out.append(None)
            continue
        got = None
        for c, ((ia, pa), (ib, pb)) in enumerate(zip(a_calls, b_calls)):
            diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
            if diff.any():
                gate, p = _routing_gate(torch, pa, pb, diff, k,
                                        f"{tag} step {s + 1} call {c}")
                problems += p
                got = {"call": c, "tokens": int(diff.sum())} | gate
                break
        out.append(got)
    if len(one) != len(mesh):
        problems.append(f"{tag}: {len(mesh)} steps recorded against "
                        f"{len(one)}")
    return out, problems


def _torchrun_env():
    root = os.path.dirname(os.path.abspath(__file__))
    # four ranks' states share the card: the caching allocator grows its
    # segments rather than strand memory between them
    return dict(os.environ, REPRO_GEMM_BACKEND="cuda",
                PYTHONPATH=os.path.join(root, "src"),
                PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")


def _routing_path(arch, layers):
    """Where a MoE reference's step-0 routing is kept for the worlds."""
    root = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(root, "build", f"parallel_routing_{arch}_{layers}.pt")


def _parallel_start(shape, runs, grads: bool, serve: bool = True):
    """Start one torchrun world of data x model ranks on the one card:
    this script's rank program (`--serve-ranks`) runs `launch.train` for
    each PARALLEL_RUNS index in `runs` (`_run_steps` steps under `cuda`,
    the first step's gradients written with `--grads-out` where `grads`;
    a MoE model's step 0 replays the one-process reference's routing),
    then (where `serve`) the serve runs PSERVE_WORLDS gives the shape.
    Returns the world's handle for `_parallel_finish` (its output goes to
    files, so worlds can run side by side)."""
    from repro_torch.configs import get_config

    dp, mp = shape
    n = dp * mp
    root = os.path.dirname(os.path.abspath(__file__))
    sdir = os.path.join(root, "build", f"pserve_{dp}x{mp}")
    shutil.rmtree(sdir, ignore_errors=True)
    os.makedirs(sdir)
    trains, outs, routing, record = [], [], [], []
    for t, i in enumerate(runs):
        arch, layers, _, accum = PARALLEL_RUNS[i]
        out = os.path.join(root, "build", f"parallel_grads_{dp}x{mp}_{t}")
        shutil.rmtree(out, ignore_errors=True)
        outs.append(out)
        routing.append(_routing_path(arch, layers)
                       if grads and get_config(arch).family == "moe"
                       else None)
        # granite's free routing of steps 1-2 at (1, 2), for the gate
        record.append(i == TRAIN_ROUTING_RUN)
        trains.append(["--arch", arch, "--layers", str(layers), "--batch",
                       str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--accum",
                       str(accum), "--steps", str(_run_steps(i)), "--seed",
                       "0", "--model-parallel", str(mp)]
                      + (["--grads-out", out] if grads else [])
                      + (["--frontend"] if _is_frontend(arch) else []))
    serves = [{"key": key, "argv": argv, "runs": sruns,
               "prefill": key not in PSERVE_NO_PREFILL}
              for key, argv, sruns in (PSERVE_WORLDS.get(shape, ())
                                       if serve else ())]
    spec = os.path.join(sdir, "spec.json")
    with open(spec, "w") as f:
        json.dump({"train": trains, "routing": routing, "record": record,
                   "serves": serves, "out": sdir}, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), os.path.abspath(__file__),
           "--serve-ranks", spec]
    with open(os.path.join(sdir, "stdout"), "w") as fo, \
            open(os.path.join(sdir, "stderr"), "w") as fe:
        proc = subprocess.Popen(cmd, stdout=fo, stderr=fe,
                                env=_torchrun_env())
    return types.SimpleNamespace(shape=shape, runs=tuple(runs), outs=outs,
                                 grads=grads, routing=routing,
                                 record=record, serves=serves, sdir=sdir,
                                 proc=proc, t0=time.monotonic())


def _train_check(torch, i, t, h, lines, ranks_lines, ref_loss, ref):
    """The world's t-th training run (PARALLEL_RUNS[i]) from its lines:
    rank 0's step lines, each rank's t-th rank line, and step 0 against
    the one-process reference (its loss alone where `ref` is None).
    Returns (readings, problems)."""
    from repro_torch.launch.train import read_grads

    arch, layers, _, accum = PARALLEL_RUNS[i]
    dp, mp = h.shape
    n = dp * mp
    out = h.outs[t]
    tag = f"[parallel {arch} {layers}L {dp}x{mp} accum {accum}]"
    problems = []
    first = sum(_run_steps(j) for j in h.runs[:t])
    n_steps = _run_steps(i)
    steps = [json.loads(ln) for ln in lines if ln.startswith("{")][
        first:first + n_steps]
    rank_lines = [mine[t] for mine in ranks_lines if len(mine) > t]
    ranks = [_summary_fields(ln) for ln in rank_lines]
    if (len(steps) != n_steps
            or not all(math.isfinite(st["loss"]) for st in steps)):
        problems.append(f"{tag} steps {steps}")
    if len(ranks) != n:
        problems.append(f"{tag} {len(ranks)} rank lines of {n}")
    for r in ranks:
        fwd, bwd = (int(x) for x in r["sa_matmul_launches"].split("+"))
        if fwd <= 0 or bwd <= 0 or int(r["plain_calls"]) != 0:
            problems.append(f"{tag} a rank launched the SA GEMM {fwd}+{bwd}"
                            f" times with {r['plain_calls']} plain calls")
    # every rank clips by one global norm, the same bits a step
    if len({r["grad_norm"] for r in ranks}) > 1:
        problems.append(f"{tag} the ranks' clip norms differ: "
                        f"{[r['grad_norm'] for r in ranks]}")
    state = _state_check(torch, i, n, ranks, tag)
    problems += state.pop("problems")
    loss0 = steps[0]["loss"] if steps else float("nan")
    if ref:
        with open(os.path.join(out, "loss.json")) as f:
            loss0 = json.load(f)["loss"]
    loss_rel = abs(loss0 - ref_loss) / abs(ref_loss)
    rel = {"loss only": 0.0}
    specs = {}
    if ref:
        from repro_torch.configs import cut_depth, get_config
        from repro_torch.parallel.mesh import MeshSpec
        from repro_torch.parallel.sharding import P, tree_map_with_path
        from repro_torch.train.train_state import param_specs

        tree_map_with_path(
            lambda p, sp: specs.__setitem__(".".join(map(str, p)), sp),
            param_specs(cut_depth(get_config(arch), layers),
                        MeshSpec(("data", "model"), h.shape)),
            is_leaf=lambda x: isinstance(x, P))
    for path, g in (ref or {}).items():
        got = torch.from_numpy(read_grads(out, path, specs[path])).cuda()
        want_g = g.cuda()
        rel[path] = float(torch.linalg.vector_norm(got - want_g)
                          / torch.linalg.vector_norm(want_g).clamp_min(
                              1e-30))
        del got, want_g
    shutil.rmtree(out, ignore_errors=True)
    # the comparison's blocks back to the card: the next worlds need it
    gc.collect()
    torch.cuda.empty_cache()
    if ref:
        del rel["loss only"]
    worst = max(rel, key=rel.get)
    if not loss_rel <= TRAIN_LOSS_REL:
        problems.append(f"{tag} step 0 loss {loss0} against {ref_loss}")
    if rel[worst] > TRAIN_GRAD_REL:
        problems.append(f"{tag} leaf {worst} rel {rel[worst]:.3e}")
    held = h.routing[t] is not None
    readings = {
        "losses": [st["loss"] for st in steps], "routing_held": held,
        "step0_loss_rel": loss_rel, "grad_rel_max": rel[worst],
        "grad_rel_worst_leaf": worst, "leaves": len(rel),
        "peak_mem_gib": [r["peak_mem_gib"] for r in ranks],
        "step_s": [r["step_s"] for r in ranks],
        "grad_norm": [r["grad_norm"] for r in ranks[:1]], **state,
        "sa_matmul_launches": [r["sa_matmul_launches"] for r in ranks]}
    log(f"{tag} losses {readings['losses']}; step 0 against the "
        f"one-process step" + (" (on its routing)" if held else "")
        + f": loss rel {loss_rel:.3e} (bound "
        f"{TRAIN_LOSS_REL:.3e}), {len(rel)} leaves, max rel "
        f"{rel[worst]:.3e} at {worst} (bound {TRAIN_GRAD_REL:.3e})")
    for r in rank_lines:
        log(f"{tag} {r}")
    if "fsdp_state_gib_want" in state:
        log(f"{tag} FSDP: a rank's parameters, μ and ν "
            f"{state['state_gib']} GiB against "
            f"{state['fsdp_state_gib_want']:.4f} (a {n}th of the world's "
            f"{state['world_state_gib']:.4f} GiB; "
            f"with its gradients {state['fsdp_with_grads_gib']:.4f}), peak "
            f"{readings['peak_mem_gib']} GiB, step"
            f"{f's 2-{n_steps}' if n_steps > 2 else ' 2'} "
            f"{[st.split(',')[1:] for st in readings['step_s']]} s")
    return readings, problems


def _state_check(torch, i, n, ranks, tag):
    """Each rank's parameters', μ's and ν's bytes (the launcher's
    `state_bytes`), in GiB, and the world's (12 B a parameter of the
    config); under FSDP (`cfg.fsdp`) a rank's must lie within
    FSDP_STATE_REL of a world's share, 1/n (no rank keeps a leaf the
    rules cut whole). Returns the readings with their `problems`."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import model as M

    arch, layers = PARALLEL_RUNS[i][:2]
    cfg = cut_depth(get_config(arch), layers)
    meta = M.init_params(cfg, device="meta", dtype=torch.float32)
    world = 12 * sum(x.numel() for x in M.tree_leaves(meta)) / 2 ** 30
    got = [int(r["state_bytes"]) / 2 ** 30 for r in ranks]
    out = {"state_gib": [round(g, 4) for g in got],
           "world_state_gib": world, "problems": []}
    if cfg.fsdp:
        want = world / n
        out |= {"fsdp_state_gib_want": want,
                "fsdp_with_grads_gib": want * 16 / 12}
        if not all(abs(g - want) <= FSDP_STATE_REL * want for g in got):
            out["problems"].append(
                f"{tag} a rank keeps {got} GiB of parameters, μ and ν, "
                f"against {want:.4f} (a {n}th of the world's)")
    return out


def _parallel_finish(torch, h, refs, train_routing=None):
    """Wait for a `_parallel_start` world and check it. Returns (readings
    by training run, the serve results by key, problems): the backend
    line, each training run's losses, each rank's peak memory, step times
    (the first's includes writing the gradients) and SA GEMM launches,
    step 0 against the one-process reference `refs[i]` (its loss alone
    without `grads`), and the free routing of steps 1-2 of the run that
    recorded it against `train_routing` (the one-process run's,
    `_train_routing_gate`); then the serve runs (`_served`)."""
    dp, mp = h.shape
    n = dp * mp
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        h.proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        h.proc.kill()
        h.proc.wait()
    wall = time.monotonic() - h.t0
    res = types.SimpleNamespace(returncode=h.proc.returncode)
    with open(os.path.join(h.sdir, "stdout")) as fo, \
            open(os.path.join(h.sdir, "stderr")) as fe:
        res.stdout, res.stderr = fo.read(), fe.read()
    lines = res.stdout.splitlines()
    tag = f"[parallel {dp}x{mp}]"
    if res.returncode != 0:
        # the first rank's error, which the others' teardown follows
        err = res.stderr.splitlines()
        i = next((j for j, ln in enumerate(err) if "Error" in ln
                  and "elastic" not in ln), len(err))
        log(res.stdout[-3000:])
        log("\n".join(err[max(0, i - 40):i + 2]))
        with open(os.path.join(root, "build", f"parallel_{dp}x{mp}.err"),
                  "w") as f:
            f.write(res.stderr)
        return {}, {}, [f"{tag} exit code {res.returncode}"]
    problems = []
    want = "nccl" if n == 1 else "gloo"
    mesh = [ln for ln in lines if ln.startswith("[mesh]")]
    n_mesh = len(h.runs) + sum(len(sv["runs"]) for sv in h.serves)
    if len(mesh) != n_mesh or any(
            not ln.startswith(f"[mesh] backend={want} world={n} data={dp} "
                              f"model={mp} device=cuda") for ln in mesh):
        problems.append(f"{tag} mesh lines {mesh} (want {n_mesh})")
    if not lines or not lines[0].startswith("[mesh]"):
        problems.append(f"{tag} first line {lines[:1]}")
    # each rank's trainer lines in order, one a training run
    ranks_lines = [[ln for ln in lines if ln.startswith(f"[rank {r}] ")
                    and " step_s=" in ln] for r in range(n)]
    readings = {}
    for t, i in enumerate(h.runs):
        ref_loss, ref = refs[i]
        r, p = _train_check(torch, i, t, h, lines, ranks_lines, ref_loss,
                            ref if h.grads else None)
        arch, layers = PARALLEL_RUNS[i][:2]
        if h.record[t]:
            from repro_torch.configs import get_config

            mesh_calls = torch.load(os.path.join(h.sdir,
                                                 f"train_routing_{t}.pt"))
            tag_t = f"[parallel {arch} {layers}L {dp}x{mp} train routing]"
            r["train_routing_gate"], p2 = _train_routing_gate(
                torch, train_routing, mesh_calls,
                get_config(arch).experts_per_token, tag_t)
            p += p2
            log(f"{tag_t} steps 1-{PARALLEL_STEPS - 1} on free routing "
                f"against the one-process steps: "
                f"{json.dumps(r['train_routing_gate'])} (None: the step "
                f"routed every token alike)")
        readings[f"{arch}_{layers}L_{dp}x{mp}"] = r | {
            "backend": want, "world_wall_s": round(wall, 2)}
        problems += p
    log(f"{tag} backend {want}, wall {wall:.1f} s (start, init, "
        f"{len(h.runs)} training runs of "
        f"{'/'.join(str(_run_steps(i)) for i in h.runs)} steps"
        + (", then the serve runs" if h.serves else "") + ")")
    served = {}
    for sv in h.serves:
        served[sv["key"]], p = _served(torch, sv["key"], h.shape,
                                       sv["runs"], h.sdir, lines, wall,
                                       sv["argv"])
        problems += p
    shutil.rmtree(h.sdir, ignore_errors=True)
    return readings, served, problems


def serve_ranks(spec_path: str) -> int:
    """The rank program of a parallel world (`chip_smoke.py --serve-ranks
    SPEC` under torchrun): `launch.train.main` on each of the spec's
    `train` argument lists (step 0 replaying the routing file its
    `routing` entry names, where it names one), its state freed after
    each, then for each of
    the spec's `serves` `launch.serve.main` once a run on this world's
    mesh, the first drawing this rank's shards from the serve seed and the
    others serving the same shards (freed before the next serve); each
    run's summary, streams, prompts, decode steps, launches (`ops.counts()`
    from 0 just before it) and peak memory to `rank<r>_<key>.json`, and
    (where the serve asks) the first run's prefill logits of each prompt
    to `prefill_<key>.pt` and, for a MoE model, each prefill's routing
    (each MoE layer's top-k experts of every token, and the router's
    probabilities they were taken from) to `routing_<key>.pt`
    (rank 0)."""
    import torch
    import torch.distributed as dist

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv
    from repro_torch.launch import train as trn
    from repro_torch.parallel import sharding as S

    with open(spec_path) as f:
        spec = json.load(f)
    cuda = torch.cuda.is_available()    # the CPU: a rehearsal
    _register_stand_ins()

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    for t, (argv, routing, record) in enumerate(zip(
            spec["train"], spec["routing"], spec["record"])):
        # a MoE step 0 on the one-process reference's routing (ROADMAP
        # R8: a near-tied token routed otherwise moves the router's and
        # an expert's gradients by far more than the arithmetic does);
        # the later steps route freely
        with _RoutingReplay() as rec:
            if routing:
                # the reference may still be computing it beside the world
                t0 = time.monotonic()
                while (not os.path.exists(routing)
                       and time.monotonic() - t0 < 600):
                    time.sleep(1)
                rec.idx = torch.load(routing)
                rec.start("replay")
            if record:
                rec.free = []
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            trn.main(argv)
        if record and dist.get_rank() == 0:
            # the router's calls of the free steps, a list a step
            from repro_torch.configs import get_config, reduced_config
            a = trn.parse_args(argv)
            experts = (reduced_config(a.arch) if a.reduced
                       else get_config(a.arch)).num_experts
            n = len(rec.free) // (PARALLEL_STEPS - 1)
            steps = [rec.free[j * n:(j + 1) * n]
                     for j in range(PARALLEL_STEPS - 1)]
            torch.save([[(i.cpu(), x.cpu()) for i, x in call_list
                         if x.shape[-1] == experts
                         and i.shape[:-1] == x.shape[:-1]]
                        for call_list in steps],
                       os.path.join(spec["out"], f"train_routing_{t}.pt"))
        free()
    for sv in spec["serves"]:
        params, out = None, {}
        for i, (name, extra) in enumerate(sv["runs"].items()):
            ops.reset_counts()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            summary, sched, engine = drv.main(sv["argv"] + extra,
                                              return_state=True,
                                              params=params)
            if cuda:
                torch.cuda.synchronize()
            wall = time.monotonic() - t0
            params = engine.params
            c = ops.counts()
            out[name] = {
                "wall_s": wall, "summary": {k: summary.get(k)
                                            for k in PSERVE_KEYS},
                "launches": {k: v["launches"] for k, v in c.items()},
                "plain_calls": sum(v["plain_calls"] for v in c.values()),
                "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else None)}
            if isinstance(sched, list):
                # a frontend arch's static waves: their token arrays, and
                # each wave's last prompt row's logits on the mesh
                out[name]["streams"] = [w.tolist() for w in sched]
                if i == 0 and dist.get_rank() == 0:
                    torch.save(_static_prefill_logits(
                        torch, engine, sv["argv"]), os.path.join(
                            spec["out"], f"prefill_{sv['key']}.pt"))
                elif i == 0:
                    _static_prefill_logits(torch, engine, sv["argv"])
                del engine, sched
                free()
                continue
            done = sorted(sched.finished, key=lambda r: r.rid)
            out[name] |= {
                "decode_steps": _decode_steps(engine, sched),
                "streams": [list(map(int, r.tokens)) for r in done],
                "prompts": [list(map(int, r.prompt)) for r in done]}
            if i == 0 and sv["prefill"]:
                rows, routes, scores = [], [], []
                with S.using_mesh(engine.mesh), _RoutingReplay() as rec:
                    for p in out[name]["prompts"]:
                        toks = torch.tensor([p], dtype=torch.int32,
                                            device=engine.device)
                        rec.start("record")
                        logits, _ = engine._prefill_for(0)(
                            engine.params, toks, engine.new_frag(len(p)))
                        rows.append(logits[0, -1].float().cpu())
                        routes.append([x.cpu() for x in rec.idx])
                        scores.append([x.cpu() for x in rec.scores])
                if dist.get_rank() == 0:
                    torch.save(torch.stack(rows), os.path.join(
                        spec["out"], f"prefill_{sv['key']}.pt"))
                    if engine.cfg.family == "moe":
                        torch.save({"idx": routes, "scores": scores},
                                   os.path.join(spec["out"],
                                                f"routing_{sv['key']}.pt"))
            del engine, sched
            free()
        with open(os.path.join(spec["out"], f"rank{dist.get_rank()}_"
                                            f"{sv['key']}.json"), "w") as f:
            json.dump(out, f)
        del params
        free()
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _static_prefill_logits(torch, engine, argv):
    """A static serve's (`launch.serve.serve_static`) prefill logits: each
    wave's prompts and frontend (`static_wave`) through a full forward,
    the last prompt row's logits over the real vocabulary, (waves x
    batch, vocab) on the host; under the engine's mesh the vocabulary
    columns gathered (every rank of the mesh must call it)."""
    from repro_torch.launch import serve as drv
    from repro_torch.models import model as M
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as S

    args = drv.parse_args(argv)
    cfg, dev = engine.cfg, engine.device
    plens = [int(x) for x in args.prompt_lens.split(",")]
    rows = []
    with S.using_mesh(engine.mesh), torch.no_grad():
        for w in range(-(-args.requests // args.batch)):
            prompts, fe = drv.static_wave(cfg, args.batch,
                                          plens[w % len(plens)], args.seed,
                                          w)
            logits, _, _ = M.forward(engine.params, cfg, prompts.to(dev),
                                     frontend_embeds=fe.to(dev),
                                     last_only=True)
            if logits.shape[-1] != cfg.padded_vocab:
                logits = C.all_gather(logits, -1, S.axis_group("model"))
            rows.append(logits[:, -1, :cfg.vocab_size].float().cpu())
    return torch.cat(rows)


def _served_kernels(cfg):
    """The kernels a serve of `cfg` launches (the SSM family has no
    attention)."""
    return ("sa_matmul",) if cfg.family == "ssm" else (
        "sa_matmul", "paged_decode", "prefill_attention")


def _served(torch, key, shape, runs, sdir, lines, wall, argv):
    """A world's serve runs of `key` from its ranks' files and lines:
    every rank one digest a run, the runs one digest, no plain call, each
    kernel launched (the decode kernel's log-sum-exp variant where the
    rings split over `data`), and on one nccl rank the serve driver's
    summary and rank line. Returns (the results, problems); the streams
    are held to the one-process ones after the serve phase
    (`parallel_serve_check`), the moe phase (`moe_parallel_check`) and
    the (1, 2) world's (`data_serve_check`)."""
    n = shape[0] * shape[1]
    ranks = []
    for r in range(n):
        with open(os.path.join(sdir, f"rank{r}_{key}.json")) as f:
            ranks.append(json.load(f))

    def load(name):
        path = os.path.join(sdir, f"{name}_{key}.pt")
        return torch.load(path) if os.path.exists(path) else None

    prefill, routing = load("prefill"), load("routing")
    tag = f"[parallel_serve {key} {shape[0]}x{shape[1]}]"
    problems = []
    from repro_torch.launch import serve as drv

    a = drv.parse_args(argv)
    kernels = _served_kernels(drv.config_of(a))
    if shape[0] > 1 and a.batch % shape[0]:
        kernels += ("paged_decode_lse",)
    tokens = a.requests * a.max_new
    for run in runs:
        digests = {r[run]["summary"]["stream_digest"] for r in ranks}
        if len(digests) != 1:
            problems.append(f"{tag} {run}: the ranks' digests {digests}")
        for r, got in enumerate(ranks):
            c = got[run]
            if c["plain_calls"] or any(c["launches"][k] <= 0
                                       for k in kernels):
                problems.append(f"{tag} {run} rank {r}: launches "
                                f"{c['launches']}, plain calls "
                                f"{c['plain_calls']}")
        s = ranks[0][run]["summary"]
        if (s["pages_leaked"] not in (0, None) or s["nonfinite_logits"]
                or s["generated_tokens"] != tokens):
            problems.append(f"{tag} {run}: {s}")
        log(f"{tag} {run}: digest {digests}, wall "
            f"{ranks[0][run]['wall_s']:.1f} s (init + serve), ITL p50 "
            f"{s['decode_itl_p50_ms']} ms, TTFT mean {s['ttft_mean_s']} s, "
            f"prefill_s {s['prefill_s']}, decode_tok_s "
            f"{s['decode_tok_s']}; per rank: ITL p50 "
            f"{[r[run]['summary']['decode_itl_p50_ms'] for r in ranks]} ms, "
            f"TTFT mean {[r[run]['summary']['ttft_mean_s'] for r in ranks]}"
            f" s, peak "
            f"{[r[run]['peak_gib'] and round(r[run]['peak_gib'], 3) for r in ranks]} GiB, "
            f"launches {[r[run]['launches'] for r in ranks]}")
    d = {run: ranks[0][run]["summary"]["stream_digest"] for run in runs}
    if len(set(d.values())) != 1:
        problems.append(f"{tag} the runs' digests {d}")
    out = {"ranks": ranks, "prefill": prefill, "routing": routing,
           "wall_s": wall}
    if key == "nccl":
        # the serve driver's own lines on one rank
        summ = [_summary_fields(ln) for ln in lines
                if ln.startswith("[continuous] ")]
        rank = [_summary_fields(ln) for ln in lines
                if ln.startswith("[rank ") and " stream_digest=" in ln]
        if len(summ) != 1 or len(rank) != 1:
            problems.append(f"{tag} {len(summ)} summary and {len(rank)} "
                            f"rank lines")
        else:
            log(f"{tag} digest {summ[0]['stream_digest']}, ITL p50 "
                f"{summ[0].get('decode_itl_p50_ms')} ms; {rank[0]}")
            out |= {"summary": summ[0], "rank": rank[0]}
    return out, problems


# the parallel lane (`--lane-parallel`): its marks, output and result
LANE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "lane")
GO_2X2, DONE_2X2, DONE_1X2 = "go_2x2", "done_2x2", "done_1x2"


def parallel_lane(result: str) -> int:
    """`chip_smoke.py --lane-parallel RESULT`, which the main process starts
    after the kernel phase and runs beside its own phases: the parallel
    phase (`parallel`), then the checks that need only its worlds and a
    one-process serve of their own (qwen's and phi3's streams,
    `parallel_serve_check`; granite's, against a one-process serve at
    PMOE_LAYERS on its stream, `moe_parallel_check`). Writes
    {"readings", "served", "held", "granite", "wall_s"} (or {"error"}) to RESULT with `torch.save`; exit code 0 when every
    check held."""
    import traceback

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    t0 = time.monotonic()
    try:
        card = smi("name,power.limit")
        _register_stand_ins()
        readings, served = parallel(torch, card)
        t = time.monotonic()
        held = parallel_serve_check(torch, served)
        log(f"[parallel_lane] the one-process references of qwen and phi3 "
            f"{time.monotonic() - t:.1f} s")
        t = time.monotonic()
        _, _, engine, sched = _serve_backend(
            torch, "cuda", PGRANITE_ARGS, 8, MAX_NEW)
        granite, problems = moe_parallel_check(torch, engine, sched,
                                               "granite", served)
        del engine, sched
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[parallel_lane] granite's one-process reference "
            f"{time.monotonic() - t:.1f} s")
        if problems:
            raise AssertionError("moe granite parallel check failed: "
                                 + "; ".join(problems))
        t = time.monotonic()
        families = family_serve_check(torch, served)
        log(f"[parallel_lane] the families' one-process references "
            f"{time.monotonic() - t:.1f} s; {card}")
        t = time.monotonic()
        data = data_serve_check(torch, served)
        log(f"[parallel_lane] the data axis's batch-1 one-process "
            f"reference {time.monotonic() - t:.1f} s; {card}")
        torch.save({"readings": readings, "served": served, "held": held,
                    "granite": granite, "families": families,
                    "data": data, "wall_s": time.monotonic() - t0}, result)
        return 0
    except BaseException:
        text = traceback.format_exc()
        log(text)
        torch.save({"error": text[-4000:]}, result)
        return 1


def _signal(name: str):
    """Mark `name` reached, for the other process of the run (the parallel
    lane and this script's main process hand the card's memory to each
    other by these marks)."""
    path = os.path.join(LANE_DIR, name)
    with open(path + ".tmp", "w") as f:
        f.write(str(time.monotonic()))
    os.replace(path + ".tmp", path)


def _wait_signal(name: str, alive, timeout: float = 900.0) -> float:
    """Wait until `_signal(name)` or until `alive()` turns false (the other
    process ended; `_signal` may have come first). Returns the seconds
    waited; raises after `timeout`."""
    t0 = time.monotonic()
    path = os.path.join(LANE_DIR, name)
    while not os.path.exists(path):
        if not alive():
            break
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"no {name} after {timeout:.0f} s")
        time.sleep(0.5)
    return time.monotonic() - t0


def parallel(torch, card):
    """The parallel phase: each PARALLEL_RUNS entry's one-process step 0
    in this process (its memory freed after), then the launcher under
    torchrun on the mesh, the ranks sharing the card over gloo, the runs
    of one shape in one world; after the (2, 2) and (1, 2) worlds, qwen's
    1-layer model on one rank under nccl (`--model-parallel 1`, step 0's
    loss against the same reference), then the (1, 4) world. The worlds
    PSERVE_WORLDS names serve after their steps: the (1, 2), (1, 1) and
    (1, 4) worlds on the `model` axis, the first (2, 2) world over `data`
    and `model` (each data rank its own slots and pages, and the batch-1
    ring whose rows split over `data`; the FSDP world serves nothing).
    The phase runs in a lane
    of its own (`parallel_lane`) beside the main process's phases: the
    (2, 2) world (61 GiB) starts once the main process signals GO_2X2,
    the FSDP world (LLAMA4_E4 at (2, 2), 4 x 13.0 GiB) after it, and
    DONE_2X2 is signalled when that has ended; the worlds after it hold
    at most 35 GiB, one at a time, the (1, 2) world (35 GiB) signalling
    DONE_1X2 when it has ended. Returns (the training readings, the serve
    results by key); raises on any problem."""
    from repro_torch.configs import cut_depth, get_config

    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    out, served, problems = {}, {}, []
    gib = 2 ** 30
    log(f"[parallel] this process holds "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB "
        f"({torch.cuda.memory_reserved() / gib:.2f} reserved) of the card")
    refs, by_cfg = {}, {}

    def reference(i):
        arch, layers, _, accum = PARALLEL_RUNS[i]
        key = (arch, layers, accum)
        if key not in by_cfg:
            cfg = cut_depth(get_config(arch), layers)
            t = time.monotonic()
            by_cfg[key] = _parallel_reference(
                torch, cfg, accum, _routing_path(arch, layers)
                if cfg.family == "moe" else None)
            log(f"[parallel {arch} {layers}L] one-process step 0: loss "
                f"{by_cfg[key][0]:.6f} in {time.monotonic() - t:.1f} s")
        refs[i] = by_cfg[key]

    def finish(h, train_routing=None):
        r, s, p = _parallel_finish(torch, h, refs, train_routing)
        out.update(r)
        served.update(s)
        problems.extend(p)

    # the card holds, beside the main process's phases: the references
    # (at most ~23 GiB, LLAMA4_E4's, in this process); the (2, 2) world
    # (4 x 15.3 GiB), then the FSDP world (4 x 13.0 GiB), while the main
    # process holds at most ~10 GiB; then the (1, 2) world
    # (2 x 17.1 GiB training, then llama4's superblock, 2 x 17.6 GiB), the
    # nccl rank (30.5 GiB) and the (1, 4) world (4 x 6.4 GiB), one at a
    # time, while the main process serves qwen (~30 GiB)
    for i in (3, 4, 9, FSDP_RUN):      # no routing of an earlier run
        arch, layers = PARALLEL_RUNS[i][:2]
        if os.path.exists(_routing_path(arch, layers)):
            os.remove(_routing_path(arch, layers))
    for i in (3, 0, 1, 2, 5, 6, 7, 8, 9, FSDP_RUN):
        reference(i)
    refs[4] = refs[3]
    t = time.monotonic()
    arch, layers = PARALLEL_RUNS[TRAIN_ROUTING_RUN][:2]
    train_routing = _train_routing_reference(
        torch, cut_depth(get_config(arch), layers))
    log(f"[parallel {arch} {layers}L] one-process steps 0-"
        f"{PARALLEL_STEPS - 1}, routing of steps 1-{PARALLEL_STEPS - 1} "
        f"recorded, in {time.monotonic() - t:.1f} s")
    parent = os.getppid()
    waited = _wait_signal(GO_2X2, lambda: os.getppid() == parent)
    if os.getppid() != parent:
        raise AssertionError("the main process ended")
    log(f"[parallel] the (2, 2) world waited {waited:.1f} s for the main "
        f"process's low-memory phases")
    def drop_grads(i):
        # the host copy of a reference's gradients that no later world
        # reads (the nccl rank reads qwen's loss alone)
        arch, layers, _, accum = PARALLEL_RUNS[i]
        refs[i] = by_cfg[(arch, layers, accum)] = (refs[i][0], None)
        gc.collect()

    finish(_parallel_start((2, 2), (1, 4), grads=True))
    drop_grads(1)
    # FSDP in a (2, 2) world of its own: its gradients' files (12.3 GB)
    # never on the host beside the other runs'
    finish(_parallel_start((2, 2), (FSDP_RUN,), grads=True, serve=False))
    drop_grads(FSDP_RUN)
    _signal(DONE_2X2)
    finish(_parallel_start((1, 2), (0, 3, 5, 6), grads=True),
           train_routing)
    _signal(DONE_1X2)
    finish(_parallel_start((1, 1), (1,), grads=False))
    finish(_parallel_start((1, 4), (2, 7, 8, 9), grads=True))
    refs.clear()
    by_cfg.clear()
    gc.collect()
    log(f"[parallel] {card}")
    if problems:
        raise AssertionError("parallel phase failed: " + "; ".join(problems))
    return out, served


def _r1_hold(torch, engine, ref, tag, ranks, prefill, run, routing=None):
    """A tensor-parallel run's streams and prefill logits against the
    one-process `engine` and its streams `ref` (rid order) on the same
    prompts by R1's rule
    (`PSERVE_REL`); returns (tokens equal, tokens, the worst prefill
    error over its bound, problems, routing). A stream that parts from the
    one-process one must part at or after a position whose one-process
    top-two margin (a full forward over the prompt and the one-process
    tokens) is below twice the bound. With `routing` (a MoE model: each
    prompt's prefill routing on the mesh, {"idx": a (1, T, k) tensor a
    MoE layer, "scores": the router's (1, T, E) probabilities}), the
    one-process prefill's own routing is recorded and its logits are held
    on the mesh's routing (replayed); a prompt whose routing did not part
    is also held on one process's own routing, and where it parted, the
    first layer where a token's expert set differs is held by the routing
    analogue of R1's near-tie rule (`_routing_gate`). The last value
    returned is {"parted": a prompt, (that layer, the tokens whose set
    differs there) or None, "gate": a prompt, that layer's readings or
    None, "free_prefill_err_over_bound": the prefill logits on one
    process's own routing where it did not part}."""
    from repro_torch.models import model as M

    got = ranks[0][run]
    equal = total = 0
    worst = free_worst = 0.0
    problems, parted, gates = [], [], []
    for i, (prompt, toks) in enumerate(zip(got["prompts"], got["streams"])):
        if prompt != ref[i][0]:
            problems.append(f"{tag} {run} request {i}: another prompt")
            continue
        ref_toks = ref[i][1]
        t = torch.tensor([prompt], dtype=torch.int32, device=engine.device)
        tp = prefill[i][:engine.cfg.vocab_size].to(engine.device)

        def prefill_logits(mode, idx=()):
            with _RoutingReplay() as rec:
                rec.idx = list(idx)
                rec.start(mode)
                logits, _ = engine._prefill_for(0)(
                    engine.params, t, engine.new_frag(len(prompt)))
            return (logits[0, -1, :engine.cfg.vocab_size].float(), rec.idx,
                    rec.scores)

        one, free_idx, free_scores = prefill_logits(
            "record" if routing else None)
        bound = PSERVE_REL * float(one.abs().max())
        if routing is not None:
            first, gate = None, None
            for layer, (a, b) in enumerate(zip(free_idx, routing["idx"][i])):
                diff = (a.sort(-1).values.cpu() != b.sort(-1).values).any(-1)
                if diff.any():
                    first = (layer, int(diff.sum()))
                    gate, p = _routing_gate(
                        torch, free_scores[layer].cpu(),
                        routing["scores"][i][layer], diff, a.shape[-1],
                        f"{tag} {run} request {i} layer {layer}")
                    problems += p
                    break
            parted.append(first)
            gates.append(gate)
            if first is None:
                # one routing on both sides: the free logits are held too
                free_worst = max(free_worst,
                                 float((tp - one).abs().max()) / bound)
            # the logits held on the mesh's own routing: a token routed
            # otherwise at a near tie (R8) moves them past any arithmetic
            # bound
            one, _, _ = prefill_logits("replay", routing["idx"][i])
        worst = max(worst, float((tp - one).abs().max()) / bound)
        same = [a == b for a, b in zip(toks, ref_toks)]
        equal += sum(same)
        total += len(ref_toks)
        if all(same) and len(toks) == len(ref_toks):
            continue
        j = same.index(False) if False in same else len(same)
        seq = torch.tensor([prompt + ref_toks[:-1]], dtype=torch.int32,
                           device=engine.device)
        full, _, _ = M.forward(engine.params, engine.cfg, seq)
        rows = full[0, len(prompt) - 1:, :engine.cfg.vocab_size].float()
        top2 = rows.topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        if min(margins[:j + 1]) >= 2 * bound:
            problems.append(f"{tag} {run} request {i} parts at token {j} "
                            f"with every margin up to it above "
                            f"{2 * bound:.4f}: {margins[:j + 1]}")
        del full
    if worst > 1.0 or free_worst > 1.0:
        problems.append(f"{tag} {run} prefill logits {worst:.3f} of the "
                        f"bound on the mesh's routing, {free_worst:.3f} on "
                        f"one process's own where it did not part")
    routes = {"parted": parted, "gate": gates,
              "free_prefill_err_over_bound": free_worst}
    return equal, total, worst, problems, routes if routing else None


def _routing_gate(torch, one, mesh, diff, k, tag):
    """The routing analogue of R1's near-tie rule at the first MoE layer
    where a prompt's routing parts from one process. Every layer before
    it routed alike, so the two sides' router probabilities there (`one`,
    `mesh`: (1, T, E)) differ by arithmetic alone: their largest
    difference, the spread, must stay within R1's bound (PSERVE_REL of
    the largest probability), and every token whose expert set differs
    (`diff`) must sit at a one-process top-k margin (its k-th probability
    less its (k+1)-th) of at most twice the spread, the most by which two
    probabilities can trade places through arithmetic. A token routed
    otherwise past that margin is a fault of the dispatch, not a near
    tie. Returns (readings, problems)."""
    spread = float((one - mesh).abs().max())
    bound = PSERVE_REL * float(one.abs().max())
    top = one.sort(-1, descending=True).values
    margin = (top[..., k - 1] - top[..., k])[diff]
    worst = float(margin.max())
    out = {"tokens": int(diff.sum()), "spread": spread,
           "spread_over_bound": spread / bound,
           "margin_max": worst, "margin_over_2spread":
               worst / (2 * spread) if spread else math.inf}
    problems = []
    if spread > bound:
        problems.append(f"{tag}: the router's probabilities part by "
                        f"{spread:.3e}, above R1's {bound:.3e}")
    if worst > 2 * spread:
        problems.append(f"{tag}: a token routed otherwise at a top-{k} "
                        f"margin of {worst:.3e}, above twice the spread "
                        f"{spread:.3e}")
    return out, problems


def nccl_serve_check(serve_summary, serve_launches, ps):
    """The nccl rank's serve (full depth, one rank) against the serve
    phase's: the digest and launches equal bit for bit. Raises on any
    problem."""
    problems = []
    nccl = ps["nccl"]
    if nccl["summary"]["stream_digest"] != serve_summary["stream_digest"]:
        problems.append(f"[parallel_serve nccl] digest "
                        f"{nccl['summary']['stream_digest']} against "
                        f"{serve_summary['stream_digest']}")
    mine = {"sa_matmul": int(nccl["rank"]["sa_matmul_launches"]),
            "paged_decode": int(nccl["rank"]["decode_attn_launches"]),
            "prefill_attention": int(nccl["rank"]["prefill_attn_launches"])}
    if mine != {k: serve_launches[k] for k in mine} or int(
            nccl["rank"]["plain_calls"]):
        problems.append(f"[parallel_serve nccl] launches {nccl['rank']} "
                        f"against {serve_launches}")
    log(f"[parallel_serve qwen 1x1 nccl] digest "
        f"{nccl['summary']['stream_digest']}, the serve phase's "
        f"{serve_summary['stream_digest']}")
    if problems:
        raise AssertionError("parallel_serve check failed: "
                             + "; ".join(problems))


def parallel_serve_check(torch, ps):
    """The parallel worlds' dense serve runs against the one-process
    streams: qwen's at (1, 2) (cut to PSERVE_QWEN_LAYERS) and phi3's
    three at (1, 4) (cut to PSERVE_PHI3_LAYERS) each against its
    one-process stream at the same depth, served here, by R1's rule, the
    paged run's launches on each rank equal to that run's (the same GEMMs
    on shards). Returns the readings; raises on any problem."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    problems, out = [], {}
    for key, args, layers, mesh in (
            ("qwen", SERVE_ARGS, PSERVE_QWEN_LAYERS, "1x2"),
            ("phi3", PHI3_SERVE_ARGS, PSERVE_PHI3_LAYERS, "1x4")):
        tag = f"[parallel_serve {key} {layers}L {mesh}]"
        ops.reset_counts()
        summary, sched, eng = drv.main(args + ["--layers", str(layers)],
                                       return_state=True)
        one = {k: v["launches"] for k, v in ops.counts().items()}
        got = ps[key]
        for r, rank in enumerate(got["ranks"]):
            mine = {k: rank["paged"]["launches"][k] for k in (
                "sa_matmul", "paged_decode", "prefill_attention")}
            if mine != {k: one[k] for k in mine}:
                problems.append(f"{tag} rank {r} launches {mine} against "
                                f"the one-process {one}")
        ref = [(list(map(int, r.prompt)), list(map(int, r.tokens)))
               for r in sorted(sched.finished, key=lambda r: r.rid)]
        for run in got["ranks"][0]:
            eq, n, worst, p, _ = _r1_hold(torch, eng, ref, tag,
                                          got["ranks"], got["prefill"], run)
            problems += p
            out[f"{key}_{run}"] = {
                "equal_tokens": f"{eq}/{n}",
                "prefill_err_over_bound": worst,
                "one_process_digest": summary["stream_digest"]}
            log(f"{tag} {run} against its one-process stream (digest "
                f"{summary['stream_digest']}, ITL p50 "
                f"{summary.get('decode_itl_p50_ms')} ms): {eq} of {n} "
                f"tokens equal, prefill logits {worst:.4f} of the bound "
                f"(R1)")
        del eng, sched
        gc.collect()
        torch.cuda.empty_cache()
    if problems:
        raise AssertionError("parallel_serve check failed: "
                             + "; ".join(problems))
    return out


def data_serve_check(torch, ps):
    """The (2, 2) world's serves over the `data` axis (PSERVE_WORLDS): each
    qwen run's digest (paged, ring, disagg) the (1, 2) world's qwen digest
    at the same depth bit for bit, and granite's its (1, 2) digest (the
    data axis changes no row's arithmetic); the batch-1 ring against a
    one-process batch-1 serve by R1's rule (`_r1_hold`). Readings a rank:
    ITL p50, TTFT mean, peak memory, the SA GEMM launches a decode step
    (a dense run's launches less its prefills' over its decode steps; a
    rank prefills its own slots' requests only) against `gemm_calls(tp=)`,
    and the pages its shard used. Returns the readings; raises on any
    problem."""
    from repro_torch.launch import serve as drv
    from repro_torch.models import model as M

    problems, out = [], {}
    for key, ref_key in (("qwen_2x2", "qwen"), ("granite_2x2", "granite")):
        want = ps[ref_key]["ranks"][0]["paged"]["summary"]["stream_digest"]
        argv = dict((k, v) for k, v, _ in PSERVE_WORLDS[(2, 2)])[key]
        cfg = drv.config_of(drv.parse_args(argv))
        tag = f"[parallel_serve {key}]"
        for run in ps[key]["ranks"][0]:
            got = ps[key]["ranks"][0][run]["summary"]["stream_digest"]
            if got != want:
                problems.append(f"{tag} {run}: digest {got}, the (1, 2) "
                                f"world's {want}")
            ranks = []
            for r, rank in enumerate(ps[key]["ranks"]):
                rr, summ = rank[run], rank[run]["summary"]
                per_step = None
                if cfg.family == "dense":
                    prefills = (rr["launches"]["prefill_attention"]
                                // cfg.num_layers)
                    per_step = ((rr["launches"]["sa_matmul"] - prefills
                                 * M.gemm_calls(cfg, 1, 2))
                                / rr["decode_steps"])
                shard = summ.get("pages_peak_by_shard")
                ranks.append({
                    "itl_p50_ms": summ["decode_itl_p50_ms"],
                    "ttft_mean_s": summ["ttft_mean_s"],
                    "peak_gib": rr["peak_gib"] and round(rr["peak_gib"], 3),
                    "sa_matmul_launches": rr["launches"]["sa_matmul"],
                    "decode_steps": rr["decode_steps"],
                    "sa_matmul_a_decode_step": per_step,
                    "pages_peak_of_its_shard":
                        shard[r // 2] if shard else None})
                if per_step is not None and per_step != M.gemm_calls(
                        cfg, 1, 2):
                    problems.append(f"{tag} {run} rank {r}: {per_step} SA "
                                    f"GEMMs a decode step, gemm_calls "
                                    f"{M.gemm_calls(cfg, 1, 2)}")
            out[f"{key}_{run}"] = {"digest": got, "digest_1x2": want,
                                   "ranks": ranks,
                                   "pages_peak_by_shard": ps[key]["ranks"][
                                       0][run]["summary"].get(
                                           "pages_peak_by_shard")}
            log(f"{tag} {run}: digest {got} (the (1, 2) world's {want}); "
                f"a rank: {json.dumps(ranks)}")
    key = "qwen_b1"
    tag = f"[parallel_serve {key} {PSERVE_QWEN_LAYERS}L 2x2]"
    summary, sched, eng = drv.main(
        B1_ARGS + ["--layers", str(PSERVE_QWEN_LAYERS)], return_state=True)
    ref = [(list(map(int, r.prompt)), list(map(int, r.tokens)))
           for r in sorted(sched.finished, key=lambda r: r.rid)]
    got = ps[key]
    eq, n, worst, p, _ = _r1_hold(torch, eng, ref, tag, got["ranks"],
                                  got["prefill"], "ring")
    problems += p
    ranks = [{"itl_p50_ms": rank["ring"]["summary"]["decode_itl_p50_ms"],
              "ttft_mean_s": rank["ring"]["summary"]["ttft_mean_s"],
              "peak_gib": rank["ring"]["peak_gib"]
              and round(rank["ring"]["peak_gib"], 3),
              "launches": rank["ring"]["launches"]}
             for rank in got["ranks"]]
    out[key] = {"equal_tokens": f"{eq}/{n}", "prefill_err_over_bound": worst,
                "digest": got["ranks"][0]["ring"]["summary"][
                    "stream_digest"],
                "one_process_digest": summary["stream_digest"],
                "one_process_itl_p50_ms": summary.get("decode_itl_p50_ms"),
                "ranks": ranks}
    log(f"{tag} against its one-process stream (digest "
        f"{summary['stream_digest']}, ITL p50 "
        f"{summary.get('decode_itl_p50_ms')} ms): {eq} of {n} tokens equal, "
        f"prefill logits {worst:.4f} of the bound (R1); a rank: "
        f"{json.dumps(ranks)}")
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("data_serve check failed: "
                             + "; ".join(problems))
    return out


def _static_hold(torch, eng, argv, outs, prefill, streams, tag):
    """A static serve (`argv`) on the mesh against the one-process `eng`
    and its waves' tokens `outs` by R1's rule: the mesh's prefill logits
    (`prefill`, `_static_prefill_logits`) within PSERVE_REL of each row's
    largest one-process |logit|, each row of the mesh's waves (`streams`)
    equal to one process up to the first position where the one-process
    top-two margin (a full forward over the prompt and the one-process
    tokens with the row's frontend) is below twice that bound. Returns
    (tokens equal, tokens, the worst prefill error over its bound,
    problems)."""
    from repro_torch.launch import serve as drv
    from repro_torch.models import model as M

    cfg = eng.cfg
    one = _static_prefill_logits(torch, eng, argv)
    bound = PSERVE_REL * one.abs().amax(-1)
    worst = float(((prefill - one).abs().amax(-1) / bound).max())
    problems = [] if worst <= 1.0 else [
        f"{tag} prefill logits {worst:.3f} of R1's bound"]
    a = drv.parse_args(argv)
    plens = [int(x) for x in a.prompt_lens.split(",")]
    off = cfg.frontend_tokens if cfg.family == "vlm" else 0
    equal = total = 0
    for w, (mine, ref) in enumerate(zip(streams, outs)):
        prompts, fe = drv.static_wave(cfg, a.batch, plens[w % len(plens)],
                                      a.seed, w)
        for b, (toks, want) in enumerate(zip(mine, ref.tolist())):
            same = [x == y for x, y in zip(toks, want)]
            equal += sum(same)
            total += len(want)
            if all(same):
                continue
            j = same.index(False)
            seq = torch.cat([prompts[b], torch.tensor(want[:-1],
                                                      dtype=torch.int32)])
            with torch.no_grad():
                full, _, _ = M.forward(eng.params, cfg, seq[None].cuda(),
                                       frontend_embeds=fe[b:b + 1].cuda())
            rows = full[0, off + prompts.shape[1] - 1:,
                        :cfg.vocab_size].float()
            top2 = rows.topk(2, dim=-1).values
            margins = (top2[:, 0] - top2[:, 1]).tolist()
            bnd = float(bound[w * a.batch + b])
            if min(margins[:j + 1]) >= 2 * bnd:
                problems.append(f"{tag} wave {w} row {b} parts at token {j}"
                                f" with every margin up to it above "
                                f"{2 * bnd:.4f}")
    return equal, total, worst, problems


def family_serve_check(torch, ps):
    """The worlds' serves of the SSM, hybrid and frontend families and of
    GRANITE_E6 (PFAMILY_SERVES) against one-process serves at the same
    depth on the same streams, served here, by R1's rule (`_r1_hold`; the
    static waves by `_static_hold`; GRANITE_E6's prefill routing by
    `_routing_gate`); each rank's launches the one-process run's (the same
    GEMMs on the rank's pieces), and its SA GEMMs what `model.gemm_calls(
    tp=)` implies: a static wave's MAX_NEW forwards, or each request's
    prefill and each decode step. Returns the readings; raises on any
    problem."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv
    from repro_torch.models import model as M

    problems, out = [], {}
    for shape, serves in PFAMILY_SERVES.items():
        tp = shape[1]
        for key, argv, runs in serves:
            tag = f"[parallel_family {key} 1x{tp}]"
            got = ps[key]
            ops.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t = time.monotonic()
            summary, sched, eng = drv.main(argv, return_state=True)
            torch.cuda.synchronize()
            wall = time.monotonic() - t
            one = {k: v["launches"] for k, v in ops.counts().items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            cfg = eng.cfg
            names = _served_kernels(cfg)
            rec = {"one_process_digest": summary["stream_digest"],
                   "one_process_launches": {k: one[k] for k in names},
                   "one_process_peak_gib": peak, "one_process_wall_s": wall}
            for run in runs:
                ranks = [r[run] for r in got["ranks"]]
                a = drv.parse_args(argv)
                for r, rank in enumerate(ranks):
                    if isinstance(sched, list):
                        forwards = -(-a.requests // a.batch) * a.max_new
                    else:
                        forwards = None
                        steps = rank["decode_steps"]
                    want = (M.gemm_calls(cfg, tp=tp) * forwards
                            if forwards else
                            sum(M.gemm_calls(cfg, len(p), tp)
                                for p in rank["prompts"])
                            + steps * M.gemm_calls(cfg, tp=tp))
                    mine = {k: rank["launches"][k] for k in names}
                    if mine["sa_matmul"] != want or (
                            run == next(iter(runs))
                            and mine != rec["one_process_launches"]):
                        problems.append(
                            f"{tag} {run} rank {r} launches {mine}: the "
                            f"one-process run's {rec['one_process_launches']}"
                            f", gemm_calls(tp={tp}) implies {want} SA GEMMs")
                if isinstance(sched, list):
                    eq, n, worst, p = _static_hold(
                        torch, eng, argv, sched, got["prefill"],
                        ranks[0]["streams"], tag)
                    routes = None
                else:
                    ref = [(list(map(int, r_.prompt)),
                            list(map(int, r_.tokens)))
                           for r_ in sorted(sched.finished,
                                            key=lambda r_: r_.rid)]
                    eq, n, worst, p, routes = _r1_hold(
                        torch, eng, ref, tag, got["ranks"], got["prefill"],
                        run, routing=got["routing"])
                problems += p
                rec[run] = {
                    "equal_tokens": f"{eq}/{n}",
                    "prefill_err_over_bound": worst,
                    "digest": ranks[0]["summary"]["stream_digest"],
                    "gemm_calls_a_forward": M.gemm_calls(cfg, tp=tp),
                    "launches": [{k: r["launches"][k] for k in names}
                                 for r in ranks],
                    "peak_gib": [r["peak_gib"] for r in ranks],
                    "itl_p50_ms": [r["summary"]["decode_itl_p50_ms"]
                                   for r in ranks],
                    "wall_s": [r["wall_s"] for r in ranks]}
                if routes:
                    rec[run]["routing_parted"] = routes["parted"]
                    rec[run]["routing_gate"] = [
                        g and [round(g["spread_over_bound"], 4),
                               round(g["margin_over_2spread"], 4)]
                        for g in routes["gate"]]
                log(f"{tag} {run} against its one-process stream (digest "
                    f"{summary['stream_digest']}, ITL p50 "
                    f"{summary.get('decode_itl_p50_ms')} ms): {eq} of {n} "
                    f"tokens equal, prefill logits {worst:.4f} of the bound "
                    f"(R1); per rank: digest {rec[run]['digest']}, ITL p50 "
                    f"{rec[run]['itl_p50_ms']} ms, peak "
                    f"{[x and round(x, 3) for x in rec[run]['peak_gib']]} "
                    f"GiB, launches {rec[run]['launches']} (one process "
                    f"{rec['one_process_launches']})"
                    + (f"; routing parted {rec[run]['routing_parted']}, "
                       f"gate {rec[run]['routing_gate']}" if routes else ""))
            out[key] = rec
            del eng, sched
            gc.collect()
            torch.cuda.empty_cache()
    if problems:
        raise AssertionError("parallel_family check failed: "
                             + "; ".join(problems))
    return out


def _expected_train_tiles(torch, bwd_launches):
    """The SA GEMM's launches by tile that the train phase's shapes imply:
    a microbatch of TRAIN_M rows runs each layer's 7 forward GEMMs twice
    (the forward, and remat's recompute in the backward) and the lm_head
    once, each on the tile `mma_plan` gives its (M, N) on this card (q, o,
    gate, up, down and the lm_head on `large`, wk and wv on `small`); every
    backward GEMM runs the `split3` tile."""
    from repro_torch.kernels import sa_matmul as mm
    from repro_torch.kernels.gemm_cases import LAYER_GEMMS, LM_HEAD

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = {t: 0 for t in mm.MMA_TILES}
    per_micro = [(n, 2 * TRAIN_LAYERS) for _, _, n, _, _ in LAYER_GEMMS]
    for n, times in per_micro + [(LM_HEAD[2], 1)]:
        tile = mm.mma_plan(TRAIN_M, n, "mma", sms)["tile"]
        want[tile] += times * TRAIN_ACCUM * TRAIN_STEPS
    want["split3"] = bwd_launches
    return want


def _start_lane():
    """Start the parallel lane (`parallel_lane`) in a process group of its
    own, its output to LANE_DIR."""
    shutil.rmtree(LANE_DIR, ignore_errors=True)
    os.makedirs(LANE_DIR)
    result = os.path.join(LANE_DIR, "result.pt")
    with open(os.path.join(LANE_DIR, "stdout"), "w") as fo, \
            open(os.path.join(LANE_DIR, "stderr"), "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--lane-parallel",
             result], stdout=fo, stderr=fe, env=dict(
                os.environ, REPRO_GEMM_BACKEND="cuda"),
            start_new_session=True)
    proc.result, proc.t0 = result, time.monotonic()
    return proc


def _descendants(pid: int) -> list:
    """The processes under `pid`, from /proc (torchrun's workers run in
    sessions of their own, out of reach of a group's signal)."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass
    out, todo = [], [pid]
    while todo:
        kids = [p for p, pp in parent.items() if pp == todo[-1]]
        todo.pop()
        out += kids
        todo += kids
    return out


def _end_lane(lane):
    """End the lane and every process under it: SIGTERM first, SIGKILL to
    what is left after a grace."""
    pids = [lane.pid] + _descendants(lane.pid)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in pids:
            try:
                os.kill(p, sig)
            except ProcessLookupError:
                pass
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20:
            lane.poll()
            alive = []
            for p in pids:
                try:
                    os.kill(p, 0)
                    alive.append(p)
                except ProcessLookupError:
                    pass
            if not alive:
                return
            time.sleep(0.5)


def _join_lane(torch, lane):
    """Wait for the parallel lane, log its output here and return its
    result; raises where it failed."""
    try:
        lane.wait(timeout=1500)
    except subprocess.TimeoutExpired:
        _end_lane(lane)
    with open(os.path.join(LANE_DIR, "stdout")) as f:
        for line in f.read().splitlines():
            log(line)
    got = (torch.load(lane.result, weights_only=False)
           if os.path.exists(lane.result) else {"error": "no result"})
    if lane.returncode != 0 or "error" in got:
        with open(os.path.join(LANE_DIR, "stderr")) as f:
            log(f.read()[-4000:])
        raise AssertionError(f"parallel lane: exit {lane.returncode}: "
                             f"{got.get('error', '')[-2000:]}")
    log(f"[parallel_lane] wall {time.monotonic() - lane.t0:.1f} s beside "
        f"this process's phases")
    return got


def _serve_phases(torch, card, kernels, launches, phases, state):
    """Every phase after the kernel phase. The parallel phase runs in a
    lane of its own beside them (`parallel_lane`, started first), and the
    card's memory passes between the two: the families, ssm, whisper and
    granite phases (at most ~10 GiB) run
    here while the lane holds its references and its (2, 2) worlds (61
    GiB, then the FSDP world's 57; they start once the families phase is
    done), pixtral's serve, granite's training and the qwen serve phases
    (~30 GiB) once those worlds have ended, beside
    the lane's later worlds (at most 35 GiB), the second tuned process and
    the examples (~38 GiB), the dry run's serving cells
    (`dryrun_serving`, at most ~6 GiB), then emulate, the study (~30 GiB) and pixtral's
    training (39 GiB), once its (1, 2) world has ended; llama4's (35 GiB),
    the checks that read the lane's results and the train phase after the
    lane has ended. The
    wall times of these phases are read beside the lane's work on the
    card and its host; the kernel phase before them runs alone. Returns
    (the tiers' and the emulate run's launches by mode)."""
    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    gc.collect()
    torch.cuda.empty_cache()
    lane = state["lane"] = _start_lane()

    def step(name, fn):
        t = time.monotonic()
        got = fn()
        phases[name] = time.monotonic() - t
        gc.collect()
        torch.cuda.empty_cache()
        return got

    fam = step("families", lambda: families(torch))
    _signal(GO_2X2)
    for k_, name in ((0, "sa_matmul"), (2, "paged_decode"),
                     (3, "prefill_attention")):
        kernels[k_]["readings"]["families_launches"] = {
            arch: r["launches"][name] for arch, r in fam.items()}
    kernels[2]["readings"]["families_ring_launches"] = {
        arch: r["ring"]["paged_decode"] for arch, r in fam.items()
        if "ring" in r}
    log("[families] " + json.dumps({
        arch: {key: r[key] for key in (
            "stream_digest", "decode_itl_p50_ms", "ttft_mean_s",
            "prefill_s", "decode_tok_s", "max_abs_logit")}
        | ({"spec": r["spec"]} if "spec" in r else {})
        for arch, r in fam.items()}))

    ssm_out = step("ssm", lambda: ssm(torch))
    for k_, name in ((0, "sa_matmul"), (2, "paged_decode"),
                     (3, "prefill_attention")):
        kernels[k_]["readings"]["ssm_launches"] = {
            arch: ssm_out[arch]["launches"][name]
            for arch in (MAMBA2, HYMBA)} | {
            f"{arch}_ring": ssm_out[arch]["ring"]["launches"][name]
            for arch in (MAMBA2, HYMBA)}
    kernels[1]["readings"]["ssm_train"] = {
        key: ssm_out["train"][key] for key in ("counts", "routes")}
    log("[ssm] " + json.dumps({
        arch: {key: ssm_out[arch][key] for key in (
            "stream_digest", "kv_layout", "decode_itl_p50_ms",
            "ttft_mean_s", "prefill_s", "decode_tok_s", "decode_step",
            "peak_gib", "prefill_decode", "backend_logits")}
        | ({"profile": ssm_out[arch]["profile"],
            "generate": ssm_out[arch]["generate"]}
           if arch == MAMBA2 else {})
        for arch in (MAMBA2, HYMBA)} | {"train": {
            key: ssm_out["train"][key] for key in (
                "mean_step_s", "step_s", "losses", "peak_gib",
                "step0")}}))

    fe_out = step("frontend_whisper",
                  lambda: frontend(torch, FRONTEND_ORDER[:2]))
    moe_out = step("moe_granite", lambda: moe(torch, runs=("granite",)))
    phases["wait_2x2"] = _wait_signal(DONE_2X2, lambda: lane.poll() is None)
    # pixtral's serve reads its prefill under `torch` too: fp32 copies of
    # its 131072-row head, more than the (2, 2) world leaves
    fe_out |= step("frontend_pixtral_serve",
                   lambda: frontend(torch, FRONTEND_ORDER[2:3]))
    moe_out |= step("moe_train", lambda: moe(torch, runs=("train",)))

    t = time.monotonic()
    summary, got, engine, sched = serve(torch)
    launches.update(sa_matmul=got["sa_matmul"],
                    paged_decode_attention=got["paged_decode"],
                    prefill_attention=got["prefill_attention"])
    phases["serve"] = time.monotonic() - t
    t = time.monotonic()
    serve_bf16_pool(torch, engine, summary)
    phases["serve_bf16_pool"] = time.monotonic() - t
    t = time.monotonic()
    prompt = min(sched.finished, key=lambda r: r.rid).prompt
    backend_logits(torch, engine, prompt)
    phases["backends"] = time.monotonic() - t
    t = time.monotonic()
    profile_serve(torch, engine)
    phases["profile"] = time.monotonic() - t
    t = time.monotonic()
    tier_modes = tiers(torch, engine, sched)
    phases["tiers"] = time.monotonic() - t
    t = time.monotonic()
    ring_launches = ring(torch, engine, summary, sched)
    phases["ring"] = time.monotonic() - t
    t = time.monotonic()
    disagg_out = disagg(torch, engine)
    phases["disagg"] = time.monotonic() - t
    t = time.monotonic()
    spec_out = spec(torch, engine, summary)
    phases["spec"] = time.monotonic() - t
    t = time.monotonic()
    bucket_out = bucket(torch, engine)
    phases["bucket"] = time.monotonic() - t
    t = time.monotonic()
    tuned = autotune_serve(torch, engine, summary)
    phases["autotune"] = time.monotonic() - t
    L = engine.cfg.num_layers
    kernels[0]["readings"]["spec"] = {
        E: {key: spec_out[E][key]
            for key in ("launches", "verify_launches", "routes")}
        for E in (L // 2, L)} | {"layer_ms": spec_out["layer_ms"]}
    kernels[2]["readings"]["spec_launches"] = {
        E: spec_out[E]["launches"]["paged_decode"] for E in (L // 2, L)}
    yard = spec_out["verify_yardsticks"]
    kernels[0]["readings"]["verify_M20_layer"] = yard["gemm_layer"]
    kernels[2]["readings"]["verify_rows20"] = yard["paged_decode"]
    # the dense-row decode (F5) and the disagg runs' launches
    kernels[2]["readings"]["gather_ring_launches"] = ring_launches
    for k_, name in ((2, "paged_decode"), (3, "prefill_attention")):
        kernels[k_]["readings"]["disagg_launches"] = {
            run: r["launches"][name] for run, r in disagg_out.items()}
    kernels[3]["readings"]["bucket"] = {
        name: {key: v[key] for key in ("prefill_launches", "prefill_s",
                                       "prefill_compiles")}
        for name, v in bucket_out.items()}
    # the engine holds itself through its step closures: collect it
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()

    # the second process and the four examples side by side (each is a
    # process of its own, this one waits), after the lane's (1, 2) world
    # (35 GiB): the lane then holds at most 30.5 GiB
    phases["wait_1x2"] = _wait_signal(DONE_1X2, lambda: lane.poll() is None)
    t = time.monotonic()
    tuned["second_process"], ex_out = autotune_second_process(
        torch, tuned, during=lambda: examples(torch))
    for k_, kind in ((0, "gemm"), (2, "decode_attn")):
        kernels[k_]["readings"]["autotune"] = {
            run: {key: (v if key != "sweeps" else
                        [s for s in v if s["kind"] == kind])
                  for key, v in r.items()}
            for run, r in tuned.items()}
    kernels[0]["readings"]["examples"] = ex_out
    phases["autotune_second_process+examples"] = time.monotonic() - t
    gc.collect()
    torch.cuda.empty_cache()

    # the dry run's serving cells against real steps (at most ~6 GiB),
    # once the tuned runs are done: on the heuristic's tiles, as on meta
    dry = step("dryrun", lambda: dryrun_serving(torch, card))
    for k_ in (0, 2, 3):
        kernels[k_]["readings"]["dryrun"] = dry
    log("[dryrun] " + json.dumps(dry))

    # emulate and the study beside the lane's last worlds (~30 GiB here,
    # at most 30.5 GiB there): the lane's worlds are the
    # run's longest path
    t = time.monotonic()
    e_sum, e_got, engine, sched = serve_emulate(torch)
    launches["fp_emu"] = e_got["fp_emu"]
    log(f"[serve emulate] launches {e_got}; prefill_s "
        f"{e_sum['prefill_s']} decode_s {e_sum['decode_s']} "
        f"compile_s {e_sum['compile_s']} wall_s {e_sum['wall_s']} "
        f"itl_p50 {e_sum.get('decode_itl_p50_ms')} ms")
    phases["emulate_serve"] = time.monotonic() - t
    t = time.monotonic()
    kernels[5]["readings"]["emulate_serve"] = dict(
        profile_emulate(torch, engine),
        serve_prefill_s=e_sum["prefill_s"],
        serve_decode_itl_p50_ms=e_sum.get("decode_itl_p50_ms"))
    phases["emulate_profile"] = time.monotonic() - t
    t = time.monotonic()
    prompt = min(sched.finished, key=lambda r: r.rid).prompt
    backend_logits(torch, engine, prompt, ("emulate", "cuda"))
    phases["emulate_backends"] = time.monotonic() - t
    t = time.monotonic()
    emu_modes, emu_step = tiers_emulate(
        torch, engine, {"prefill_s": e_sum["prefill_s"],
                        "itl": e_sum.get("decode_itl_p50_ms")})
    kernels[5]["readings"]["emulate_bulk_step_ms"] = emu_step
    phases["tiers_emulate"] = time.monotonic() - t
    del engine, sched
    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    gc.collect()
    torch.cuda.empty_cache()

    t = time.monotonic()
    launches["quantize_fp8"] = study(torch)
    phases["study"] = time.monotonic() - t
    gc.collect()
    torch.cuda.empty_cache()
    # pixtral's training (39 GiB) beside the lane's last world and its
    # one-process references (at most ~26 GiB)
    fe_out |= step("frontend_pixtral_train",
                   lambda: frontend(torch, FRONTEND_ORDER[3:]))

    # the lane's results
    t = time.monotonic()
    par = _join_lane(torch, lane)
    phases["parallel_join"] = time.monotonic() - t
    phases["(parallel_lane)"] = par["wall_s"]
    kernels[0]["readings"]["parallel"], pserve = (par["readings"],
                                                  par["served"])
    held = par["held"]
    t = time.monotonic()
    nccl_serve_check(summary, got, pserve)
    moe_out["granite"]["parallel"] = par["granite"]
    # rows 1-3: each rank's launches in the tensor-parallel runs
    for k_, name in ((0, "sa_matmul"), (2, "paged_decode"),
                     (3, "prefill_attention")):
        kernels[k_]["readings"]["parallel_serve_launches"] = {
            f"{key}_{run}": [r[run]["launches"][name]
                             for r in pserve[key]["ranks"]]
            for key in ("qwen", "phi3", "granite", "llama4")
            for run in pserve[key]["ranks"][0]} | {
            "nccl": pserve["nccl"]["rank"][{
                "sa_matmul": "sa_matmul_launches",
                "paged_decode": "decode_attn_launches",
                "prefill_attention": "prefill_attn_launches"}[name]]}
    log("[parallel_serve] " + json.dumps({
        f"{key}_{run}": held.get(f"{key}_{run}", {}) | {
            k: pserve[key]["ranks"][0][run]["summary"][k]
            for k in ("decode_itl_p50_ms", "ttft_mean_s", "prefill_s",
                      "wall_s")}
        for key in ("qwen", "phi3", "nccl")
        for run in pserve[key]["ranks"][0]}))
    log(f"[parallel_serve] {card}")
    # the SSM, hybrid and frontend families and GRANITE_E6 on the mesh
    fam_par = par["families"]
    for k_, name in ((0, "sa_matmul"), (2, "paged_decode"),
                     (3, "prefill_attention")):
        kernels[k_]["readings"]["parallel_family_launches"] = {
            f"{key}_{run}": [ln.get(name) for ln in rec[run]["launches"]]
            for key, rec in fam_par.items() for run in rec
            if isinstance(rec[run], dict) and "launches" in rec[run]}
    log("[parallel_family] " + json.dumps(fam_par))
    log(f"[parallel_family] {card}")
    # serving over the data axis: the (2, 2) world's runs, and the
    # decode kernel's log-sum-exp launches in the batch-1 ring's run
    log("[parallel_data] " + json.dumps(par["data"]))
    log(f"[parallel_data] {card}")
    kernels[2]["readings"]["parallel_data"] = par["data"]
    launches["paged_decode_attention_lse"] = pserve["qwen_b1"]["ranks"][0][
        "ring"]["launches"]["paged_decode_lse"]
    phases["parallel_serve_check"] = time.monotonic() - t

    moe_out |= step("moe_llama4",
                    lambda: moe(torch, pserve, runs=("llama4",)))
    for k_, name in ((0, "sa_matmul"), (2, "paged_decode"),
                     (3, "prefill_attention")):
        kernels[k_]["readings"]["moe_launches"] = {
            run: moe_out[run]["launches"][name]
            for run in ("granite", "llama4")} | {
            "granite_ring": moe_out["granite"]["ring"]["launches"][name]}
    kernels[1]["readings"]["moe_train"] = {
        key: moe_out["train"][key] for key in ("counts", "routes")}
    log("[moe] " + json.dumps({
        "granite": {key: moe_out["granite"][key] for key in (
            "stream_digest", "decode_itl_p50_ms", "ttft_mean_s",
            "prefill_s", "decode_tok_s", "decode_step_gemms",
            "peak_gib", "backend_logits", "profile", "parallel")},
        "llama4": {key: moe_out["llama4"][key] for key in (
            "stream_digest", "itl_p50_ms", "prefill_s",
            "decode_tok_s", "peak_gib", "init_s", "backend_logits",
            "parallel")},
        "train": {key: moe_out["train"][key] for key in (
            "mean_step_s", "losses", "aux", "peak_gib")}}))

    for k_, name in ((0, "sa_matmul"), (2, "paged_decode"),
                     (3, "prefill_attention")):
        kernels[k_]["readings"]["frontend_launches"] = {
            arch: fe_out[arch]["launches"][name]
            for arch in (WHISPER, PIXTRAL)}
    kernels[1]["readings"]["frontend_train"] = {
        arch: {key: fe_out[f"{arch}_train"][key]
               for key in ("counts", "routes")}
        for arch in (WHISPER, PIXTRAL)}
    log("[frontend] " + json.dumps({
        arch: {key: fe_out[arch].get(key) for key in (
            "launches", "gemm_calls", "ttft_s", "itl_ms", "prefill_s",
            "decode_s", "decode_tok_s", "peak_gib", "prefill_decode",
            "backend_logits", "generate", "profile", "tokens_digest")}
        for arch in (WHISPER, PIXTRAL)} | {
        f"{arch}_train": {key: fe_out[f"{arch}_train"][key] for key in (
            "layers", "batch", "mean_step_s", "step_s", "losses",
            "peak_gib", "step0")}
        for arch in (WHISPER, PIXTRAL)}))

    t = time.monotonic()
    launches["sa_matmul_bwd"], _, train_routes, train_tiles, dry = train(
        torch, card)
    kernels[1]["readings"]["dryrun_train"] = dry
    kernels[1]["readings"]["train_routes"] = train_routes
    kernels[0]["readings"]["large_tile"]["train_tile_launches"] = \
        train_tiles
    phases["train"] = time.monotonic() - t
    return tier_modes, emu_modes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the kernel phase")
    ap.add_argument("--log", default=None,
                    help="also write every logged line to this file (the "
                         "end of the output may be all a caller keeps)")
    ap.add_argument("--serve-ranks", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lane-parallel", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve_ranks:    # a rank of the parallel_serve phase's torchrun
        return serve_ranks(args.serve_ranks)
    if args.lane_parallel:  # the parallel lane, beside the main process
        return parallel_lane(args.lane_parallel)
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 3
    # Python's bytecode of what this run imports (torch's modules among
    # them), written once under the ignored build/ and read by every
    # process the run starts: a fresh process otherwise compiles the
    # modules again where the installed packages carry no bytecode
    pycache = os.path.join(root, "build", "pycache")
    os.makedirs(pycache, exist_ok=True)
    sys.pycache_prefix = pycache
    os.environ["PYTHONPYCACHEPREFIX"] = pycache
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import build

    # the autotuner reads only this run's cache files: every phase but the
    # autotune phase runs the heuristic's tiles and cluster sizes
    import shutil
    import tempfile
    global TUNE_DIR
    TUNE_DIR = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    fresh_tune_cache("start")

    global LOG_FILE
    if args.log:
        LOG_FILE = os.path.abspath(args.log)
        os.makedirs(os.path.dirname(LOG_FILE), exist_ok=True)
        open(LOG_FILE, "w").close()

    phases = {}
    t_start = time.monotonic()
    t = time.monotonic()
    card = smi("name,power.limit")
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(subprocess.run([build.nvcc(), "--version"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[-1])
    phases["device"] = time.monotonic() - t

    t = time.monotonic()
    reports = build.build_all()
    for name, rep in reports.items():
        for line in rep.splitlines():
            # ptxas's C75xx notes: wgmma serialized (a performance loss)
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line or "(C75" in line):
                log(f"[build {name}] {line.strip()}")
    phases["build"] = time.monotonic() - t
    log(f"[build] {len(reports)} kernels for sm_90a in {phases['build']:.1f} s"
        f" (each nvcc's seconds: "
        + ", ".join(f"{n} {v:.1f}" for n, v in build.SECONDS.items()) + ")")

    t = time.monotonic()
    probe_out = probe(torch)
    phases["probe"] = time.monotonic() - t

    t = time.monotonic()
    timer = Timer(torch)
    one = torch.zeros(1, device="cuda")
    log(f"[timer] a 1-element add reads {timer.wall(lambda: one.add_(1)):.4f} "
        f"ms wall: the floor under every wall time below")
    kernels = [check_gemm(torch, timer), check_gemm_train(torch, timer),
               check_decode(torch, timer), check_prefill(torch, timer),
               check_quantize(torch, timer), check_fp_emu(torch, timer)]
    # the forward's training-shape readings belong to the forward's entry
    kernels[0]["readings"].update({
        key: kernels[1]["readings"].pop(key)
        for key in ("forward_M1024", "lm_head_fwd_M1024", "route_sweep_ms",
                    "tile_crossover_ms")})
    kernels[0]["readings"]["large_tile"] = {
        "design": LARGE_TILE_DESIGN, "k16_probe": probe_out}
    phases["kernels"] = time.monotonic() - t
    # the families' shapes: prefill and decode at hd 256, the tied head
    t = time.monotonic()
    hd256, w256, e256 = check_prefill_hd256(torch, timer)
    kernels[3]["readings"]["hd256"] = hd256
    kernels[3]["err_over_bound"] = max(kernels[3]["err_over_bound"], w256)
    kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], e256)
    rings, w_rings = check_decode_rings(torch, timer)
    kernels[2]["readings"]["hd256_rings"] = rings
    kernels[2]["err_over_bound"] = max(kernels[2]["err_over_bound"],
                                       w_rings)
    kernels[0]["readings"]["tied_lm_head"] = tied_head_times(torch, timer)
    phases["kernels_families"] = time.monotonic() - t
    # the MoE family's routers and expert GEMMs
    t = time.monotonic()
    moe_gemms, w_moe, e_moe = check_moe_gemms(torch, timer)
    kernels[0]["readings"]["moe_gemms"] = moe_gemms
    kernels[0]["err_over_bound"] = max(kernels[0]["err_over_bound"], w_moe)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], e_moe)
    phases["kernels_moe"] = time.monotonic() - t
    # the SSM family's projections (hymba's ragged in_proj on every tile),
    # hymba's prefill (hd 64, g = 5, window 2048) and its decode rings
    t = time.monotonic()
    ssm_gemms, w_ssm, e_ssm = check_ssm_gemms(torch, timer)
    kernels[0]["readings"]["ssm_gemms"] = ssm_gemms
    kernels[0]["err_over_bound"] = max(kernels[0]["err_over_bound"], w_ssm)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], e_ssm)
    hd64, w64, e64 = check_prefill_hd256(torch, timer, HYMBA_ATTN,
                                         HD64_PREFILL, "hd64", seed=64)
    kernels[3]["readings"]["hd64"] = hd64
    kernels[3]["err_over_bound"] = max(kernels[3]["err_over_bound"], w64)
    kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], e64)
    rings64, w_r64 = check_decode_rings(torch, timer, HYMBA_ATTN, HD64_RINGS,
                                        plan_slots=(2048, 2624), seed=64)
    kernels[2]["readings"]["hd64_rings"] = rings64
    kernels[2]["err_over_bound"] = max(kernels[2]["err_over_bound"], w_r64)
    phases["kernels_ssm"] = time.monotonic() - t
    # the frontend families: whisper's GEMMs at M = 6000 and 4, prefill at
    # whisper's g = 1, hd 64 and pixtral's T = 384, whisper's decode rings
    t = time.monotonic()
    fe_gemms, w_fe, e_fe = check_frontend_gemms(torch, timer)
    kernels[0]["readings"]["whisper_gemms"] = fe_gemms
    kernels[0]["err_over_bound"] = max(kernels[0]["err_over_bound"], w_fe)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], e_fe)
    for tag, attn, shapes, seed in (
            ("whisper", WHISPER_ATTN, WHISPER_PREFILL, 65),
            ("pixtral", PIXTRAL_ATTN, PIXTRAL_PREFILL, 128)):
        r_fe, w_p, e_p = check_prefill_hd256(torch, timer, attn, shapes, tag,
                                             seed=seed)
        kernels[3]["readings"][tag] = r_fe
        kernels[3]["err_over_bound"] = max(kernels[3]["err_over_bound"], w_p)
        kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], e_p)
    rings_w, w_rw = check_decode_rings(torch, timer, WHISPER_ATTN,
                                       WHISPER_RINGS, plan_slots=(80, 2048),
                                       seed=65)
    kernels[2]["readings"]["whisper_rings"] = rings_w
    kernels[2]["err_over_bound"] = max(kernels[2]["err_over_bound"], w_rw)
    phases["kernels_frontend"] = time.monotonic() - t
    t = time.monotonic()
    kernels[2]["readings"]["batch_fold_ms"] = check_fold(torch, timer)
    # what the fp32 routes' one order of sums (F2b) costs
    fp32 = fp32_gemm_times(torch, timer,
                           torch.Generator(device="cuda").manual_seed(3))
    kernels[0]["readings"]["fp32_policy_ms"] = fp32
    # the shapes a rank of the tensor-parallel serve gives the kernels
    ranks, w_rank, e_rank = check_rank_shapes(torch, timer)
    for k_, kind in ((0, "gemm"), (2, "decode"), (3, "prefill")):
        kernels[k_]["readings"]["rank_shapes"] = {
            tag: r[kind] for tag, r in ranks.items() if kind in r}
        kernels[k_]["err_over_bound"] = max(kernels[k_]["err_over_bound"],
                                            w_rank[kind])
        kernels[k_]["max_abs_err"] = max(kernels[k_]["max_abs_err"],
                                         e_rank[kind])
    # the decode kernel's log-sum-exp variant (the rings split over data)
    kernels.append(check_decode_lse(torch, timer))
    log("[fold] sa_matmul fp32 x fp32 (the fp32 policy's routes): " + ", ".join(
        f"{k_} {v:.4f}" if isinstance(v, float) else f"{k_} {v}"
        for k_, v in fp32.items()))
    del timer
    phases["fold"] = time.monotonic() - t
    log("kernels " + " ".join(
        f"{k['name']}: max_err={k['max_abs_err']:.3e} "
        f"err/bound={k['err_over_bound']:.4f} ms={k['ms']:.4f} "
        f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f}"
        for k in kernels))

    launches = {k["name"]: 0 for k in kernels}
    state = {}
    try:
        if not args.skip_serve:
            tier_modes, emu_modes = _serve_phases(
                torch, card, kernels, launches, phases, state)
    finally:
        lane = state.get("lane")
        if lane is not None and lane.poll() is None:
            # a phase failed here: the lane and its worlds end with it
            _end_lane(lane)
    total = time.monotonic() - t_start
    log("[phases] " + " ".join(f"{k}={v:.1f}s" for k, v in phases.items())
        + f" total={total:.1f}s")
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if not args.skip_serve:
        # the tiered runs' launches by mode (the tiers phase's for the
        # `cuda` path's kernels, the emulate bulk run's for fp_emu)
        for k in kernels:
            name = {"paged_decode_attention": "paged_decode"}.get(
                k["name"], k["name"])
            if name == "fp_emu":
                k["mode_launches"] = emu_modes["fp_emu"]
            elif name in tier_modes:
                k["mode_launches"] = tier_modes[name]
    keys = ("name", "route", "source", "replaces", "launches",
            "mode_launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "err_over_bound", "timed", "readings")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k}
                                  for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
