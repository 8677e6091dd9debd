#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's planning, LM serving and LM training
paths, distributed HFL and the dry-run on one NVIDIA card.

    python3 chip_smoke.py             # every phase (one card)
    python3 chip_smoke.py --kernels   # build and check the kernels only

Phases, each reported on its own lines:

0. The card (``nvidia-smi``) and the build of ``src/repro_torch/kernels/
   csrc/*.cu`` with nvcc (one process per source, all at once), with
   ``-Xptxas -v``'s registers, spills and static shared memory per kernel,
   K2's two kernels' registers on a line of their own, and the SASS
   instructions of K1's and K2's bisection loops at each depth
   (``cuobjdump -sass``).
1. The branch-free log1pf and division of K1 and K2 against the
   toolkit's (every float of [+0, FLT_MAX]; 2^32 hashed pairs), bitwise.
   K1 (Lemma-1 inversion) against its plain PyTorch version at the fleet's
   flattened shape and at odd shapes: rtol 1e-5, atol 1e-3, and bitwise
   at the fleet's shape at every speculation depth (each timed on the same
   tensors).  K1 with one scalar cap (the TPU's ``_bisect_kernel``) is
   timed apart at n = 56.
2. K2 (the fused Algorithm 2-4 solve) on one engine round of the README
   fleet (128 cells x 9 candidates, N_max users) and at the re-price shape
   (one problem per cell): the one-thread-per-user kernel at every
   speculation depth, PR 11's one-warp-per-problem kernel and the plain
   version give the same bits (the plain version adds in the kernel's warp
   order; feasible identical, R and t to rtol 1e-4 and b to rtol 1e-3 are
   checked too); a problem solved alone equals the same problem inside the
   batch bitwise.  Both kernels are timed on the same tensors at both
   shapes, each depth of the new one too, and every depth on the round's
   first 256, 512 and 768 problems (where the depth rule's crossover
   lies); the blocks an SM holds are printed.
3. K3 (top-k move nomination): the routed call, the one-warp-per-cell
   kernel, the block kernel and the plain version give identical
   user, dst and score at the planning shape (128, N_max, 5); the routed
   call, the cluster and block kernels and the plain version at (128,
   128, 4) (the warp kernel's cap) and (16, 300, 7) (past it: the cluster
   kernel's route), k = 8 and 40; and the three kernels and the plain
   version at (128, N_max, 5) on operands that leave the branch-free
   ranges (tiny and huge gains and H, noise past 2^60 in every other
   cell).  The two
   kernels are timed on the same tensors in turns, beside ``torch.topk``
   on the twin's score tile (selection only), an empty kernel's launch
   (the floor), the bound and the wrapper's host cost; the warp kernel's
   blocks an SM and K3's ``-Xptxas -v`` lines are printed.
4. K4 (flash attention), its three kernels, against its plain version:
   at the LM prefill's (B, H, T, hd) = (4, 16, 1024, 64) in bf16 and f32,
   at hd 128 (llama3.2-3b's heads) in bf16 and f32, at hd 256 and 192 in
   bf16, at the JAX sweep's odd shapes and at hd 160 and 256, non-causal,
   with windows of 16 and 48, at Tq = 1 with q_offset = S - 1, at Tq != Tk
   with q_offset 100 and on strided views of one fused QKV tensor: 2e-5 in
   f32, 2e-2 in bf16 (exp, P's bf16 rounding and the summation order
   differ).  Every bf16 case must take the wgmma kernel, every f32 case
   with hd <= 128 the 3xTF32 kernel, and f32 at hd 256 and an f32 view
   whose strides TMA cannot take the SIMT one.  Each route is timed at its
   own operands, (4, 1024, 16, 64) bf16 and f32, (1, 1024, 24, 128) f32,
   (4, 1024, 8, 256) and (4, 1024, 8, 192) bf16, causal: events and device
   ms, the bound (bytes at 3.35 TB/s, products at 989 TFLOP/s bf16 or 495
   TF32) and its share, the SIMT kernel on the same tensors, and
   ``scaled_dot_product_attention`` as PyTorch picks its backend and with
   each backend forced (the picked one named).  The bf16 hd-64 kernel is
   also timed with a cold L2 and for its host cost; at (1, 24, 1024, 128),
   at llama4-scout's prefill shape (4, 40, 1024, 128), at zamba2-7b's (4,
   32, 1024, 112) with window 4,096, at hubert-xlarge's (4, 16, 1024, 80)
   non-causal and at internvl2-76b's (4, 64, 1024, 128) beside SDPA and
   its bound.  zamba2's shape is also held to the plain version with
   windows of 4,096 and 16, and hubert's and internvl2's shapes are held
   to it too.
5. K5 (fused RMSNorm) against its plain version at the LM's hidden-state
   shape (4096, 1024) in bf16 and f32, bitwise (the twin adds in the
   kernel's order and rsqrtf is torch.rsqrt), timed with its f32 scale
   beside ``torch.nn.functional.rms_norm``.  No model calls K5.
6. The planning path: ``PlanningService`` over ``draw_fleet(0, 128)`` with
   the fused solve and top-8 move pruning, driven by ``run_load`` for 3
   ticks.
7. The ``use_pallas`` route: ``solve_batch`` with the inversion on K1,
   against the same call on the eager inversion (rtol 1e-5 on R) and
   against phase 6's fused re-price (rtol 5e-3).
8. The LM path: ``run_lm`` at qwen1.5-0.5b's full width and depth in bf16,
   B = 4, 1024-token prompts, 32 greedy tokens, on ``attn_impl="pallas"``
   (K4: one launch per layer per prefill) and on the default chunked
   route with the same weights; every K4 launch takes the tensor-core
   kernel.  The last-position prefill logits of the two routes agree to
   5e-2 of max |logit| (bf16 rounds each layer's output; both round their
   probabilities to bf16 before the PV product, in other orders).  One
   more prefill on K4 and four decode steps run under ``torch.profiler``
   (lines ``[q]``).
a. The LM path in float32 (lines ``[a]``, run after phase 8): ``run_lm``
   at qwen1.5-0.5b's full width and depth with ``dtype=float32`` and
   ``attn_impl="pallas"``, B = 4, 1024-token prompts, 8 greedy tokens,
   TF32 off: all 24 K4 launches take the 3xTF32 kernel; the last-position
   prefill logits lie within 1e-4 of max |logit| of the chunked route's in
   float32 and the greedy tokens are equal; prefill ms on both routes and
   K4's share of one traced prefill's device time.
m. The moe family (lines ``[m]``, run after phase a, whose weights are
   freed first): (a) ``run_lm`` on llama4-scout-17b-a16e at full width (40
   heads of 128, 8 KV heads, d 5120, d_ff 8192, 16 experts top-1 + 1
   shared, vocab 202,048, bf16) cut to 12 of its 48 layers (57 GB of
   weights), ``attn_impl="pallas"``, B = 4, 1024-token prompts, 32 greedy
   tokens: 12 K4 launches, all on the tensor-core kernel; finite logits,
   tokens in range; prefill ms, decode tok/s and peak memory beside the
   bounds of :func:`_moe_bounds`.  (b) On the same weights, layer by layer
   with the K4 route's input: K4's layer output against the chunked
   route's within ``MOE_LAYER_RTOL`` of max |x| on the tokens routed alike,
   the top-1 flips counted, and the whole-model logit gap of the two
   routes as information.  (c) ``moe.route`` on the card against the CPU,
   bitwise (expert_idx, pos, keep, load, capacity), on layer 0's router
   logits (E 16, k 1) and on bfloat16-grid draws at kimi-k2's E 384, k 8,
   each with rows of exact ties.  (d) One traced prefill and four traced
   decode steps: device time by kernel, busy share, and the device time in
   the router and dispatch, the expert products, the combine, the shared
   expert (``record_function`` ranges of ``models/moe.py``) and K4.
s. The hybrid and xlstm families (lines ``[s]``, run after phase m, whose
   weights are freed first), nothing cut: (a) ``run_lm`` on zamba2-7b at
   full width and depth (81 Mamba2 layers, d 3584, ssm_state 64, the
   shared block after every 6 layers: 32 heads of 112, window 4,096, d_ff
   14,336; vocab 32,000, bf16, 13.5 GB of weights), ``attn_impl="pallas"``,
   B = 4, 1024-token prompts, 32 greedy tokens, after a warm-up at 64
   tokens: 13 K4 launches, all on the tensor-core kernel, and 81 S1
   launches (the Mamba2 recurrence, ``csrc/ssm_scan.cu``) in the prefill
   and in each decode step; finite logits, tokens in range; prefill ms,
   decode tok/s and peak memory beside the bounds of :func:`_ssm_bounds`;
   the same ``run_lm`` on the recurrences' plain twins (the route before
   the ops), its prefill ms and decode tok/s beside the kernels', its
   logits' gap and greedy tokens as information.  (b) On the same weights,
   group by
   group on the K4 route's stream: each shared block's output on K4
   against the chunked route's within 5e-2 of max |x|; the whole model's
   last-position logits of the two routes as information, beside a
   control (the chunked route at key chunks of 512 against 1,024: bf16
   rounding alone, amplified through 94 blocks of random weights, moves
   the logits past 5e-2).  (c) The cache re-layout at full width and
   depth in float32 (TF32 off): T tokens prefilled, re-laid for T + 1
   positions, one decode step, against a prefill of the T + 1 tokens:
   within 5e-2 of max |logit|.  (f) One Mamba2 layer's
   prefill, one shared-attention group and four decode steps, timed
   untraced and traced: device time by kernel, busy share, launches a time
   step, and from these the whole prefill's split.  (d) In float32 at full
   width, B = 1, T = 64, TF32 off: one zamba2 Mamba2 layer and one
   xlstm-125m m/s pair on the card against the CPU, within 1e-4 of max
   |leaf|, the recurrences on S1-S3.  (e) ``run_lm`` on xlstm-125m at
   full size (12 layers, d 768, 4 heads of 192, vocab 50,304), B = 4,
   T = 1,024, 32 tokens: finite, in range, timed beside its bounds; 6 S2
   and 6 S3 launches in the prefill and in each decode step and no other
   kernel; the same on the twins, as for zamba2.  (g) Each recurrence
   kernel against its twin on the card on the operands of the first layer
   of its kind (zamba2's first Mamba2 layer, xlstm's first pair, at B = 4,
   T = 1,024 of ``run_lm``'s prompt), a state carried in (the one the
   kernel leaves after the T steps), over all T steps and over the first
   step alone (the decode shape): max |delta| / max |.| of y and of each
   state within 1e-4, and whether the states are bitwise the twin's; each
   timed (events and device ms) beside the twin and the bound (operands
   read and outputs written once, phase s's float32 count at 67
   TFLOP/s).  The same for each backward kernel (S1b-S3b,
   ``csrc/ssm_scan_bwd.cu``) against its backward twin, on the same
   operands with seeded upstream gradients of every output: every
   gradient within 1e-4 of max |.|.  S1 and S1b run on both routes
   (``_mamba2_rows``), forced on the same tensors: the chunked kernels
   (``csrc/ssd_chunked.cu``) also within 1e-5 of their plain model
   (``ref.mamba2_chunked_plain`` and ``_bwd_plain``), the sequential
   S1's state bitwise the twin's (asserted; S1b's d s0 recorded); each
   timed beside the other, the plain version (twin or model) and its
   bound (the chunked kernels': three TF32 passes of their chunk products
   at 495 TFLOP/s, or bytes), and all four at T = 1, 8, 32, 64, 128 and
   1,024 (device ms: ``ssm_scan.MAMBA2_CHUNKED_MIN_T``'s source).  S2b
   and S3b run on both their kernels (``_ssm_bwd_rows``), forced on the
   same tensors, at T = 1,024 and T = 1: the chunked S2b
   (``csrc/mlstm_chunked.cu``) also within 1e-5 of its model
   (``ref.mlstm_chunked_bwd_plain``), the sequential S2b, the short
   S3b step and S3b's barrier kernel within 1e-4 of the twins; each timed
   whole and launch by launch (the saving forward, the reverse kernels,
   the stabiliser's; the sequential S2b's stabiliser kernel alone), both
   S2b kernels at T = 1, 8, 16, 32, 64, 128 and 1,024
   (``ssm_scan.MLSTM_CHUNKED_MIN_T``'s source), and S3b's handshake floor
   (1,024 steps of the walk's handshake alone on its cluster shape, the
   cluster barrier and the mbarrier).  Every
   prefill S1 launch of (a) must take the chunked kernel and every decode
   step the sequential one.  (h) Each of zamba2-7b's 81 Mamba2 layers in bf16 on the
   kernels' route against the twins' route, both from the twins' route's
   input to that layer: the largest gap as a share of max |y| and in bf16
   ulps.
e. The encoder family and the mixed frontend (lines ``[e]``, run after
   phase s, whose weights are freed first): (a) hubert-xlarge at full size
   (48 layers, d 1280, 16 heads of 80, d_ff 5120, vocab 504, bf16: 0.946 B
   parameters), B = 4, 1,024 frames of embeddings, through ``forward`` on
   K4 (the CLIs refuse it: no decode): 48 launches, all on the
   tensor-core kernel; finite logits; forward ms on K4 and on the chunked
   route beside the bound of :func:`_dense_bounds`; each layer on K4
   against the chunked route from the same input within 5e-2 of max |x|,
   the whole-model logit gap as information; one traced forward.  (b)
   internvl2-76b at full width (d 8192, 64 heads of 128, 8 KV heads, d_ff
   28,672, vocab 128,256, bf16) cut to 32 of its 80 layers (59 GB of
   weights), through ``run_lm``: B = 4, 256 patches + 768 tokens, 32
   greedy tokens, on K4: 32 launches, all on the tensor cores; finite
   logits, tokens in range, prefill ms and decode tok/s beside their
   bounds; the same checks layer by layer; the prefill cache holds the
   patches and the tokens; a traced prefill and four traced decode steps.
l. LM training (lines ``[l]``, run after phase e): (a) one float32
   ``make_train_step`` (SGD, a cosine schedule, the clip, remat) of each
   kind of model at ``reduced()`` size (dense, moe, hybrid, xlstm,
   encoder, mixed) on the card against the CPU, TF32 off: every new
   parameter within 1e-4 of its max |leaf|; (b) qwen1.5-0.5b at full size
   (464 M parameters, bf16, AdamW, the chunked route, remat on), B = 4,
   T = 1,024, 4 steps on one batch: finite losses, every leaf changed; the
   losses, ms a step and peak memory beside the bound (3 x the forward's
   operations); one traced step; (c) ``make_hfl_lm_train_step`` at that
   size, 2 pods x 2 local steps: every leaf bitwise equal across the pods
   and to the float32 mean of the pods' own steps run apart; (d) K4 raises
   under autograd on the card before any launch, and so does a train step
   on ``attn_impl="pallas"``; (e) xlstm-125m at full size (12 layers,
   112.7 M parameters) and zamba2-7b at full width cut to 12 of its 81
   layers (1.37 B parameters), AdamW, remat, B = 4, T = 1,024, 4 steps:
   each step's recurrence launches (each forward op twice a layer, each
   backward op once; zamba2's S1 and S1b all on the chunked kernels,
   xlstm's S2b on the chunked kernel and S3b on its short step),
   finite losses, ms a step and peak memory beside the bound, one traced
   step; xlstm-125m one step on the twins' route too (the route before
   the backward kernels), at T = 128.  In (a) and (e) a recurrence
   twin that runs on the card raises, and (a)'s hybrid and xlstm steps must
   launch S1-S3 and S1b-S3b as (e)'s do.  The training path launches no
   other kernel.
t. TSIA, the RA baselines and the per-cell planner (lines ``[t]``, run
   between phases l and 9): (a) ``tsia.solve(draw_scenario(0))`` at the
   paper's N = 50, M = 5 and full caps on K2, one lanes-kernel launch a
   score, its R the trace's minimum and ``evaluate``'s; K2 at TSIA's
   P = 1 and at the host loop's P = 1 + N (M - 1) = 201 (timed in phase 2,
   before any plain twin runs; checked and bounded here); (b) TSIA at
   the serve caps with every score recorded, all the scored patterns then
   solved in one call of K2's plain twin: b, f, p bitwise, R to rtol
   1e-4; (c) HFEL and SROA at the nearest-edge pattern with and without
   ``use_pallas`` (K1 launched, R to rtol 1e-5), SROA below every other
   ``RA_METHODS`` entry (Fig 2); (d) ``serve --no-stream`` over 16 cells
   of up to 50 users on 5 edges with top-8 pruning (K2 and K3, every K3
   launch on the warp kernel), then ``--host-loop`` over 2 cells: every
   assignment in range, every R finite, unchanged cells cache hits.
h. The planner's extended decision space (lines ``[h]``, run after phase
   t): the README's four planning examples through ``serve --mode
   plan``'s construction (``serve.build_service``) on the README fleet,
   ``draw_fleet(0, 128)`` (M = 8 candidate sites for h4), the CLI's caps
   and top-8 pruning: h1
   ``--n-starts 4``, h2 ``--horizon 4 --switch-cost 100``, h3
   ``--compression`` over three device tiers, 3 ticks each; h4 ``--m-cand
   8 --topology-period 2 --edge-cost 2000``, 3 ticks (the redesign runs
   at tick 2); h5 all four knobs at once on 16 cells, 2 ticks.
   Each run reports plans/s, tick p50/p99, sum R, K2's and K3's launches
   and problems a launch, and one traced tick's K2 and K3 device time;
   every launch must take the lanes K2 and the warp K3.  Then K2 on one
   h5 cell's horizon round of the joint (assignment, compression) search
   (82 problems: comp-scaled loads, a predicted slot's gains, B over open
   sites) and K3 on the comp-aware upload bits at M = 8 (the routed call
   and both kernels) are held bitwise to their twins.
x. The large-cell planning path (lines ``[x]``, run after phase h),
   DESIGN.md D9's pruned candidate search at scale: (a)
   ``engine.solve_assignment`` on ``draw_scenario(1)`` at N = 2,048 users,
   M = 16 edges with the JAX package's ``bench_engine.run_scaling``
   arguments (caps 24/16/12/20, fused, max_rounds 8, escape_iters 1,
   top-16, 2 starts): wall ms, rounds, R no worse than the nearest-edge
   init's, every K2 launch on the cluster kernel and every K3 launch on
   the cluster kernel; (b) K2 on that search's first round's operands (P =
   34, N = 2,048), and at N = 600 and 4,096 (one problem each): the
   cluster kernel at every depth, the routed call, the one-warp kernel (up
   to 3,632 users) and the twin bitwise, each kernel timed beside the bound
   of the twin's counted work; (c) K3 on the first round's operands (2,
   2,048, 16), k = 16, and at k = 40 with two active users a cell: the
   cluster kernel, the block kernel and the twin bitwise, timed in turns
   beside ``torch.topk`` on the twin's tile, an empty kernel and the
   bound; (d) ``serve --mode plan`` through ``serve.build_service`` over 8
   cells of up to 2,048 users and 16 edges at the serve caps with
   ``--top-k 16`` for 2 ticks: every K2 and K3 launch on the cluster
   kernels, R finite, assignments in range.
f. The paper's training pipeline (lines ``[f]``, run after phase x): (a)
   ``launch.train.main`` on imagenette (the widest CNN, s = 899,912 bytes)
   at the paper's N = 50, M = 5 for 10 global iterations on the card
   (TSIA on K2 at full caps: one lanes-kernel launch a score, its R
   ``evaluate``'s at rtol 1e-5; the straggler deadline; Algorithm 1 with
   the users batched; the final accuracy above the first), then
   ``--iters 12 --resume``, which must start at step 10; (b) one
   ``global_iteration`` on the card and on the CPU on the same inputs,
   with users dropped and one edge's users all dropped: every leaf within
   1e-4 of its max |leaf| (the card against itself too), and top-k 0.05 +
   int8 compression of the same update bitwise on both devices; (c) one
   traced global iteration: device time, busy share, the five longest
   kernels and the device events a global iteration.
d. The mesh, sharding and dry-run layer and distributed HFL (lines
   ``[d]``, run after phase f, whose inputs it reuses): (a) Algorithm 1
   on phase f's users (imagenette, N = 50, M = 5, L = K = 2, users
   dropped, an edge emptied) split over ranks, NCCL at min(4, cards)
   ranks one a card and, on one card, gloo at 2 ranks sharing it, each
   held to phase f's single-process iteration on the card within 1e-4 of
   max |leaf|, with the ms an iteration and the bytes all-reduced; (b)
   ``launch.dryrun.run_cell`` on a 1 x 1 mesh for phase 8's prefill and
   phase l's AdamW train step (qwen1.5-0.5b, B = 4, T = 1,024): its
   argument bytes equal to what the same steps allocate on the card, its
   predicted peak beside ``torch.cuda.max_memory_allocated`` (printed,
   not held); (c) ``run_cell`` on the 16 x 16 mesh for qwen2.5-32b
   ``train_4k``, llama4-scout-17b-a16e ``decode_32k`` and the ``train_4k``
   of zamba2-7b and xlstm-125m (their recurrences' backward ops through
   their fakes; per-device bytes, FLOPs, collective bytes by kind, fits 80
   GB); (d) with two or
   more cards, ``solve_fleet_sharded`` over them bitwise one card's search
   on ``draw_fleet(0, 128)``.  No kernel lies on this path.
9. Launch counts of the main paths (every count reset to 0 right before
   a path and read right after it; phase t's, phase h's, phase x's, phase
   f's, phase a's, phase m's, phase s's and phase e's two paths as each
   kernel's ``launches_tsia_path``, ``launches_h_path``,
   ``launches_x_path``, ``launches_train_path``, ``launches_f32_path``,
   ``launches_moe_path``, ``launches_ssm_path``,
   ``launches_encoder_path`` and ``launches_vlm_path``: only K4's
   wgmma kernel may launch on phase e's paths, only it and S1-S3 on phase
   s's (whose counts are S1-S3's ``launches``), only its 3xTF32
   kernel on phase a's, only the cluster K2 and K3 on phase x's, and only
   S1-S3 and S1b-S3b on phase l's (``launches_lm_train_path``, and
   S1b-S3b's ``launches``); the two cluster kernels' ``launches`` are phase
   x's and the 3xTF32 kernel's phase a's), each
   kernel's time beside its plain
   version's, its bound and its library call, then the card and the
   result line; every K3 launch of the planning path must take the warp
   kernel.  Each kernel's time is given twice: CUDA events around
   one call (``ms``: the host's launch overhead included) and the device
   time ``torch.profiler`` records per call (``device_ms``).  K4's and
   K5's wrappers also get ``host_ms``: the host clock over 1,000
   unsynchronised calls at a small shape, where the card outruns the host.

Between phases 7 and 8, two more ticks of phase 6's service run under
``torch.profiler`` (lines ``[p]``): device time by kernel, and the
device's busy share of the traced wall time.  Every trace runs after its
path's launch counts have been read.

Every comparison raises on a mismatch; no phase catches a failure.  The
script exits non-zero, printing no result, when there is no CUDA device or
when it is not run from a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# TF32 on the tensor cores, dense: the fastest unit that reads f32 operands,
# so the bound of f32 work that may run there (K4's f32 route).
TF32_TENSOR_FLOPS_PER_S = 495e12
BF16_TENSOR_FLOPS_PER_S = 989e12
L2_FLUSH_BYTES = 2 * 50 * 2 ** 20      # twice the H100's 50 MB L2

# The LM path: qwen1.5-0.5b at full size, B prompts of T tokens.
LM_ARCH, LM_B, LM_T, LM_NEW = "qwen1.5-0.5b", 4, 1024, 32
LM_LOGIT_RTOL = 5e-2
# Phase a: the same model in float32 on K4's 3xTF32 kernel against the
# chunked route in float32 (TF32 off), F32_NEW greedy tokens: the last
# logits within F32_LOGIT_RTOL of max |logit|.
F32_NEW, F32_LOGIT_RTOL = 8, 1e-4

# Phase m: the moe family at llama4-scout-17b-a16e's full width (40 heads
# of 128, 8 KV heads, d 5120, d_ff 8192, 16 experts top-1 + 1 shared, vocab
# 202,048, untied head, bf16), cut to 12 of its 48 layers: 12 x 4.40 GB +
# 4.14 GB of embedding and head, 57.0 GB of weights on one 80 GB card (the
# whole model, 210 GB, fits on no single card, and sharding is not ported).
# The depth stays fixed so that runs compare.
MOE_ARCH, MOE_LAYERS = "llama4-scout-17b-a16e", 12
# Layer by layer on the same input, K4's output against the chunked
# route's on the tokens whose routing agrees: max |delta| within this
# share of the layer's max |x| (bf16 rounds every layer's output, and the
# two routes round their probabilities in other orders).
MOE_LAYER_RTOL = 5e-2
MOE_RANGES = ("moe.dispatch", "moe.experts", "moe.combine", "moe.shared")

# Phase s: the hybrid and xlstm families at full width and depth (nothing
# cut): zamba2-7b (81 Mamba2 layers, d 3584, ssm_state 64, a shared block
# of 32 heads of 112 with window 4,096 and a SwiGLU of 14,336 after every 6
# layers, vocab 32,000, bf16: 13.5 GB of weights) and xlstm-125m; B = 4,
# 1,024-token prompts, 32 tokens, zamba2 on K4.  The card against the CPU
# in float32 (one Mamba2 layer, one xLSTM pair, the recurrences on S1-S3):
# max |delta| within this share of max |leaf| (the same arithmetic in other
# summation orders).
SSM_ARCH, XLSTM_ARCH = "zamba2-7b", "xlstm-125m"
SSM_CPU_TOL = 1e-4
SSM_RANGES = ("hybrid.mamba", "hybrid.shared")

# Phase e: the encoder family and the mixed frontend.  hubert-xlarge at full
# size (48 layers, d 1280, 16 heads of 80, d_ff 5120, vocab 504, bf16:
# 0.946 B parameters, nothing cut) on B x T frames of embeddings; and
# internvl2-76b at full width (d 8192, 64 heads of 128, 8 KV heads, d_ff
# 28,672, vocab 128,256, bf16) cut to 32 of its 80 layers: 32 x 1.711 GB +
# 4.20 GB of embedding and head, 59.0 GB of weights on one 80 GB card (the
# whole model, 137 GB, fits on no single card, and sharding is not
# ported).  Its prompts are the config's 256 patches and T - 256 tokens.
# Layer by layer on the same input, K4's output against the chunked
# route's within this share of the layer's max |x|, as in phases m and s.
ENC_ARCH, VLM_ARCH, VLM_LAYERS = "hubert-xlarge", "internvl2-76b", 32
ENC_LAYER_RTOL = 5e-2

# Phase l: LM training.  One float32 train step of each kind of model at
# ``reduced()`` size on the card against the CPU (TF32 off): every new
# parameter within this share of its max |leaf| (the same arithmetic in
# other summation orders).  Then qwen1.5-0.5b at full size (bf16, adamw,
# the chunked route, remat on) for TRAIN_STEPS steps on one batch of B x T
# tokens, and ``make_hfl_lm_train_step`` at that size with P pods of K
# local steps.
TRAIN_KINDS = (("qwen1.5-0.5b", {}), ("llama4-scout-17b-a16e", {}),
               ("zamba2-7b", {"n_layers": 3}), ("xlstm-125m", {"n_layers": 4}),
               ("hubert-xlarge", {}), ("internvl2-76b", {}))
TRAIN_CPU_TOL = 1e-4
TRAIN_STEPS, HFL_PODS, HFL_K = 4, 2, 2
# Phase l (e): the recurrent families' training at full width, AdamW and
# remat, B x T tokens: xlstm-125m at full size and zamba2-7b cut to
# ZAMBA_TRAIN_LAYERS of its 81 layers (two shared-attention groups, 1.37 B
# parameters: all 81 layers, 6.75 B, with AdamW's state do not fit 80 GB).
ZAMBA_TRAIN_LAYERS = 12
TWIN_TRAIN_T = 128          # phase l (e)'s xlstm step on the twins' route

SERVE_CAPS = dict(b_iters=30, f_iters=24, p_iters=20, t_iters=28)
DEVICE_MS_SESSIONS = 3        # profiler sessions before "not measured"
TOP_K = 8


def _check(ok, msg: str) -> None:
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _time_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` on the card, by CUDA events (ms)."""
    import torch

    fn()                                  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, reps: int, cold: bool = False,
               kernel: str | None = None) -> float:
    """Device time of one call of ``fn``: the sum of every device event
    that ``torch.profiler`` records over ``reps`` calls, over ``reps``.
    Unlike :func:`_time_ms` it leaves out the host's time between launches
    (Python, ctypes, argument checks), which dominates a microsecond
    kernel's wall time.  ``cold`` rewrites a buffer of twice the card's
    50 MB L2 before every call (its kernel is left out of the sum), so the
    call reads its inputs from device memory, as a bound assumes.
    ``kernel`` names the one kernel ``fn`` launches: the result is then the
    median of that kernel's device events, which stays right when the
    profiler drops an event of a session of a few long kernels.  Now and
    then a session records no device activity at all (a K5 session did on
    an H100, after 37 phases' sessions had); up to ``DEVICE_MS_SESSIONS``
    sessions are run before the time counts as not measured (None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                         device="cuda") if cold else None)
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_MS_SESSIONS):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        if kernel is not None:
            times = sorted(evt.time_range.elapsed_us()
                           for evt in prof.events()
                           if evt.device_type != DeviceType.CPU
                           and kernel in evt.name)
            if times:
                return times[len(times) // 2] / 1e3
        rows = prof.key_averages()
        us = sum(evt.self_device_time_total for evt in rows
                 if evt.device_type != DeviceType.CPU
                 and not (cold and "bitwise_not" in evt.key))
        if us > 0:
            return us / 1e3 / reps
        print("chip_smoke: the profiler recorded no device time; its rows: "
              + json.dumps([(evt.key[:60], str(evt.device_type), evt.count,
                             evt.self_device_time_total) for evt in rows]))
    return None


def _fmt(x, spec: str = ".4g") -> str:
    """A measured number, or "not measured" where the profiler recorded
    none (``_device_ms`` returned None)."""
    return "not measured" if x is None else format(x, spec)


def _div(a, b):
    return None if a is None or b is None else a / b


def _sub(a, b):
    return None if a is None or b is None else a - b


def _host_ms(fn, n: int = 1000) -> float:
    """Host time per call of ``fn`` over ``n`` calls that are not
    synchronised (the card must outrun the host: call it at a small
    shape)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def _ptxas(log: str) -> list[str]:
    """One line per kernel of nvcc's ``-Xptxas -v`` report: its name, its
    registers, spills and static shared memory."""
    import re

    def short(mangled: str) -> str:
        # The <length><name> of the mangled symbol that names the kernel,
        # and its template arguments.
        for i in range(len(mangled)):
            for n in (1, 2, 3):
                digits = mangled[i:i + n]
                if not digits.isdigit():
                    break
                ident = mangled[i + n:i + n + int(digits)]
                if ident.endswith("_kernel"):
                    t = re.match(r"I((?:L[ib]\d+E)+)E",
                                 mangled[i + n + len(ident):])
                    args = ", ".join(re.findall(r"L[ib](\d+)E",
                                                t.group(1) if t else ""))
                    return ident + (f"<{args}>" if args else "")
        return mangled

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
            name = None
    return out


def _sass_rounds(sass: str) -> dict:
    """The SASS instructions of the bisection loops of each SROA kernel,
    read from ``cuobjdump -sass`` output: for every function whose name
    holds ``sroa``, the lengths of its innermost loops that hold a
    reciprocal (MUFU.RCP: the step's G / b), each marked "ieee" when it
    also holds FCHK (the IEEE division's slow-path check: PR 11's steps,
    one a loop) and "nb" when it does not (the branch-free rounds: the
    loop is unrolled twice, so it holds 2D steps at depth D)."""
    import re

    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"(sroa_(?:solve_lanes|solve_cluster|solve|"
                      r"invert_rate)_kernel)(?:I((?:Li\d+E)+)E)?",
                      chunk.split("\n", 1)[0])
        if not m:
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        loops = []
        for addr, op in ins:
            b = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", op)
            if b and int(b.group(1), 16) < addr:
                loops.append((int(b.group(1), 16), addr))
        found = set()
        for lo, hi in loops:
            if any(lo <= a < b <= hi and (a, b) != (lo, hi)
                   for a, b in loops):
                continue                      # not innermost
            body = [o for a, o in ins if lo <= a <= hi]
            if any("MUFU.RCP" in o for o in body):
                kind = ("ieee" if any(o.startswith("FCHK") for o in body)
                        else "nb")
                found.add(f"{len(body)} {kind}")
        args = ", ".join(re.findall(r"Li(\d+)E", m.group(2) or ""))
        out[m.group(1) + (f"<{args}>" if args else "")] = sorted(found)
    return out


def _bound_ms(nbytes: float, flops: float,
              peak: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _k2_bound(w: dict, n_prob: int, N: int, caps: dict = SERVE_CAPS):
    """K2's operations (this data's ``work`` from the twin, 8 flop a rate
    step) and its bound: (flops, (ms, "bytes" | "operations"))."""
    flops = N * (8 * caps["b_iters"] * w["inversions"] + 12 * w["f_steps"]
                 + 8 * w["p_steps"] + 20 * w["t_steps"]
                 + 10 * caps["t_iters"] * n_prob)
    nbytes = n_prob * N * 4 * (7 + 3) + n_prob * 4 * (5 + 3) + n_prob
    return flops, _bound_ms(nbytes, flops)


def _rel_err(got, want) -> float:
    """max |got - want| / max |want|: 0 where the two are equal (zeros
    too), inf where want is zero and got is not."""
    diff = float((got - want).abs().max())
    return 0.0 if diff == 0 else diff / float(want.abs().max())


def _max_abs_err(got, want) -> float:
    import torch

    errs = [float((g.double() - w.double()).abs().max())
            for g, w in zip(got, want) if g.dtype.is_floating_point]
    return max(errs) if errs else 0.0


def _profile(tag: str, what: str, fn, stats: dict | None = None,
             ranges: tuple = ()) -> list:
    """Run ``fn`` once under ``torch.profiler``; print device time by
    kernel and the device's busy share of the traced wall time: the time
    some device event is running (kernels that overlap on several streams,
    as cuDNN's per-group kernels do, count once) over the wall.  Returns
    the (ms, count, name) rows, largest first; ``stats``, when given,
    receives the wall ms, the summed device ms, the busy (union) ms and
    the device events, and under ``ranges`` the device time of the kernels
    launched inside each ``record_function`` range named in ``ranges``.
    The ranges' own device-side spans are left out of every sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def annotation(evt):
        return evt.key in ranges or getattr(evt, "is_user_annotation", False)

    rows, in_ranges = [], {}
    for evt in prof.key_averages():
        # Device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched.
        if evt.device_type == DeviceType.CPU:
            if evt.key in ranges:
                in_ranges[evt.key] = evt.device_time_total / 1e3
            continue
        us = evt.self_device_time_total
        if us > 0 and not annotation(evt):
            rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    spans = sorted((evt.time_range.start, evt.time_range.end)
                   for evt in prof.events()
                   if evt.device_type != DeviceType.CPU
                   and not (evt.name in ranges
                            or getattr(evt, "is_user_annotation", False)))
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    if stats is not None:
        stats.update(wall_ms=wall_ms, device_ms=device_ms,
                     union_ms=busy_us / 1e3, events=len(spans),
                     ranges={k: in_ranges.get(k, 0.0) for k in ranges})
    print(f"{tag} {what}: {wall_ms:.2f} ms wall, {device_ms:.2f} "
          f"ms device time in {sum(r[1] for r in rows)} device events "
          f"({len(rows)} names), the device busy {busy_us / 1e3:.2f} ms; "
          f"busy share "
          f"{busy_us / 1e3 / wall_ms if rows else float('nan'):.4f}")
    for ms, n, name in rows[:12]:
        print(f"{tag}   {ms:10.3f} ms  {n:6d} x  {name[:90]}")
    if not rows:
        print(f"{tag}   the trace holds no device time: not measured")
    return rows


def _attn_plain(q, k, v, **kw):
    """K4's plain version in the model layout (B, T, H, hd)."""
    from repro_torch.kernels import ref

    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(ref.attention_plain(t(q), t(k), t(v), **kw))


def _k4_bound(B: int, H: int, T: int, hd: int, dtype, causal: bool = True):
    """K4's least time at (B, H, T, hd) self-attention: q, k, v read once
    and the output written once at 3.35 TB/s, or 4 hd flop a (query, key)
    pair that the mask keeps (causal: T (T + 1) / 2 a head) at the tensor
    cores' peak for the operands' type (989 TFLOP/s bf16, 495 TF32 for
    f32).  Returns (ms, "bytes" | "operations", bytes, flop)."""
    import torch

    nbytes = 4 * B * T * H * hd * (2 if dtype == torch.bfloat16 else 4)
    keys = T * (T + 1) // 2 if causal else T * T
    flops = 4 * hd * B * H * keys
    peak = (BF16_TENSOR_FLOPS_PER_S if dtype == torch.bfloat16
            else TF32_TENSOR_FLOPS_PER_S)
    return (*_bound_ms(nbytes, flops, peak), nbytes, flops)


def _queued_ms(fn, n: int = 20) -> float:
    """Device time of one call of ``fn`` without the profiler and without
    the host's launch overhead: a spin kernel (``torch.cuda._sleep``)
    holds the stream while ``n`` calls queue behind it, and CUDA events
    around them time the calls back to back.  The median of three rounds.
    (The profiler's device events proved unreliable late in this script:
    sums and even medians of one kernel's events came out at half the
    time of the same call earlier.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e6 * (3 + 0.5 * n)))    # ~(3 + n / 2) ms
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / n)
    return sorted(rounds)[1]


def _sdpa_times(qt, kt, vt, causal: bool, reps: int = 20) -> dict:
    """``scaled_dot_product_attention`` on (B, H, T, hd) tensors as
    PyTorch picks its backend (events and device ms, :func:`_queued_ms`),
    the backend it picks (its dispatcher's own choice,
    ``torch._fused_sdp_choice``), and every backend forced in turn through
    ``torch.nn.attention.sdpa_kernel`` (device ms, or "refused" where the
    backend does not take the operands)."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    out = dict(ms=_time_ms(call, reps), device_ms=_queued_ms(call, reps),
               backend=SDPBackend(torch._fused_sdp_choice(
                   qt, kt, vt, is_causal=causal)).name, backends={})
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def forced(be=be):
            with sdpa_kernel([be]):
                return call()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                forced()
            except RuntimeError:
                out["backends"][be.name] = "refused"
                continue
        out["backends"][be.name] = _queued_ms(forced, reps)
    return out


def _sdpa_text(t: dict) -> str:
    return (f"SDPA {t['ms']:.4g} ms (device {_fmt(t['device_ms'])}, backend "
            f"{t['backend']}; forced: " + ", ".join(
                f"{k} {v if isinstance(v, str) else _fmt(v)}"
                for k, v in t["backends"].items()) + ")")


def _k4_route_of(dtype, hd: int) -> str:
    """The kernel K4's rule picks for contiguous operands."""
    import torch

    if dtype == torch.bfloat16:
        return "wgmma"
    return "tf32" if hd <= 128 else "simt"


# ops.LAUNCHES counter of each K4 route's kernel (the SIMT kernel's count
# is what the routed counter ``flash_attention`` leaves).
K4_COUNTERS = {"wgmma": "flash_attention_sm90",
               "tf32": "flash_attention_sm90_f32"}


def _k4_row(q, k, v, causal: bool = True, window=None) -> dict:
    """K4 on (B, T, H, hd) operands as the rule routes them, timed (events
    and device ms, :func:`_queued_ms`) beside the SIMT kernel on the
    same tensors, SDPA
    (:func:`_sdpa_times`), the plain twin (events) and the bound
    (:func:`_k4_bound`)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    B, T, H, hd = q.shape
    kw = dict(causal=causal, q_offset=0, window=window)
    k4 = lambda: ops.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                     window=window)
    simt = lambda: fa.flash_attention_cuda(  # noqa: E731
        q, k, v, _route="simt", **kw)[0]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bound = _k4_bound(B, H, T, hd, q.dtype, causal)
    row = dict(shape=[B, T, H, hd], dtype=str(q.dtype).replace("torch.", ""),
               causal=causal, window=window,
               route=_k4_route_of(q.dtype, hd), ms=_time_ms(k4, 20),
               device_ms=_queued_ms(k4), simt_ms=_time_ms(simt, 10),
               simt_device_ms=_queued_ms(simt, 10), bound_ms=bound[0],
               bound_by=bound[1], sdpa=_sdpa_times(qt, kt, vt, causal),
               plain_ms=_time_ms(lambda: _attn_plain(
                   q, k, v, causal=causal, window=window), 5))
    row["share"] = _div(bound[0], row["device_ms"])
    return row


def _k4_row_text(r: dict) -> str:
    B, T, H, hd = r["shape"]
    return (f"[4] K4 {r['route']} at (B, T, H, hd) = ({B}, {T}, {H}, {hd}) "
            f"{r['dtype']} {'causal' if r['causal'] else 'non-causal'}"
            f"{'' if r['window'] is None else ', window ' + str(r['window'])}"
            f": {r['ms']:.4g} ms (device {_fmt(r['device_ms'])}); bound "
            f"{r['bound_ms']:.4g} ms by {r['bound_by']}, "
            f"{_fmt(r['share'], '.4f')} of it; the SIMT kernel "
            f"{r['simt_ms']:.4g} ms (device {_fmt(r['simt_device_ms'])}), "
            f"{_fmt(_div(r['simt_device_ms'], r['device_ms']), '.3g')}x; "
            f"plain {r['plain_ms']:.4g} ms; " + _sdpa_text(r["sdpa"]))


def _check_k4(report: dict, dev) -> None:
    """Phase 4: K4's three kernels against their plain version, and times."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(4)

    def qkv(Tq, Tk, B, H, hd, dtype):
        return [torch.randn((B, T, H, hd), generator=gen, device=dev
                            ).to(dtype) for T in (Tq, Tk, Tk)]

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 2e-2, f32: 2e-5}
    cases = [((LM_T, LM_T, LM_B, 16, 64), dtype, dict(causal=True))
             for dtype in (bf16, f32)]
    cases.append(((LM_T, LM_T, 1, 24, 128), bf16, dict(causal=True)))
    cases.append(((LM_T, LM_T, LM_B, 40, 128), bf16, dict(causal=True)))
    # zamba2-7b's shared attention (hd 112: the HD = 128 template, its
    # second TMA box 16 columns past the row) at its window and at 16.
    for window in (4096, 16):
        cases.append(((LM_T, LM_T, LM_B, 32, 112), bf16,
                      dict(causal=True, window=window)))
    # hubert-xlarge's non-causal attention (hd 80: the P.V product's n
    # tile past the head reads TMA's zero fill) and internvl2-76b's prefill
    # (64 heads of 128 after the GQA repeat), phase e.
    cases.append(((LM_T, LM_T, LM_B, 16, 80), bf16, dict(causal=False)))
    cases.append(((LM_T, LM_T, LM_B, 64, 128), bf16, dict(causal=True)))
    # The operands the tensor-core kernels took over from the SIMT kernel:
    # f32 at hd 128 (3xTF32) and bf16 heads of 256 and 192 (wgmma).
    cases.append(((LM_T, LM_T, 1, 24, 128), f32, dict(causal=True)))
    cases.append(((LM_T, LM_T, LM_B, 8, 256), bf16, dict(causal=True)))
    cases.append(((LM_T, LM_T, LM_B, 8, 192), bf16, dict(causal=True)))
    for B, H, T, hd in ((1, 1, 8, 64), (2, 4, 16, 64), (1, 2, 128, 128),
                        (2, 2, 96, 80), (1, 4, 256, 112), (1, 2, 70, 256),
                        (2, 3, 200, 160)):
        for dtype in (bf16, f32):
            cases.append(((T, T, B, H, hd), dtype, dict(causal=True)))
    for dtype in (bf16, f32):
        cases += [((64, 64, 1, 2, 64), dtype, dict(causal=False)),
                  ((160, 160, 1, 2, 64), dtype,
                   dict(causal=True, window=16)),
                  ((1, 64, 1, 2, 64), dtype, dict(causal=True, q_offset=63)),
                  ((30, 130, 2, 3, 64), dtype,
                   dict(causal=True, q_offset=100))]
    for hd in (160, 256):
        cases += [((160, 160, 1, 2, hd), bf16, dict(causal=True, window=48)),
                  ((30, 130, 2, 3, hd), bf16,
                   dict(causal=True, q_offset=100))]
    errs, routes = [], []

    def check(q, k, v, dtype, kw, route):
        before = dict(ops.LAUNCHES)
        got = ops.flash_attention(q, k, v, **kw)
        took = "simt"
        for r, counter in K4_COUNTERS.items():
            if ops.LAUNCHES[counter] > before[counter]:
                took = r
        _check(took == route and ops.LAUNCHES["flash_attention"]
               == before["flash_attention"] + 1,
               f"K4 took {took}, not {route}, on {tuple(q.shape)} {dtype}")
        want = _attn_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=tol[dtype], atol=tol[dtype])
        errs.append(_max_abs_err([got.float()], [want.float()]))
        routes.append(route)

    for shape, dtype, kw in cases:
        check(*qkv(*shape, dtype), dtype, kw,
              _k4_route_of(dtype, shape[-1]))
    fused = torch.randn((2, 70, 3, 4, 64), generator=gen, device=dev
                        ).to(bf16)
    check(*fused.unbind(2), bf16, dict(causal=True), "wgmma")
    # An f32 fused projection cut to hd 64 from rows of 65: a time stride of
    # 780 elements is no multiple of 16 bytes, so the SIMT kernel takes it.
    odd = torch.randn((2, 70, 3, 4, 65), generator=gen, device=dev)[..., :64]
    check(*odd.unbind(2), f32, dict(causal=True), "simt")
    torch.cuda.synchronize()
    worst = {r: max((e for e, x in zip(errs, routes) if x == r), default=0.0)
             for r in ("wgmma", "tf32", "simt")}
    print(f"[4] K4 ok on {len(routes)} cases ({routes.count('wgmma')} bf16 "
          f"on the wgmma kernel at 2e-2, {routes.count('tf32')} f32 on the "
          f"3xTF32 kernel and {routes.count('simt')} on the SIMT kernel at "
          f"2e-5: LM prefill shape, hd 128 at 24 and at llama4-scout's (4, "
          f"40) heads, hd 192 and 256, the JAX sweep, non-causal, windows, "
          f"decode offset, Tq != Tk, fused QKV views): max |err| bf16 LM "
          f"shape {errs[0]:.3g}, f32 LM shape {errs[1]:.3g}, llama4-scout's "
          f"{errs[3]:.3g}, zamba2's (4, 1024, 32, 112) at window 4096 "
          f"{errs[4]:.3g} and 16 {errs[5]:.3g}, hubert's (4, 1024, 16, 80) "
          f"non-causal {errs[6]:.3g}, internvl2's (4, 1024, 64, 128) "
          f"{errs[7]:.3g}, f32 (1, 1024, 24, 128) {errs[8]:.3g}, bf16 (4, "
          f"1024, 8, 256) {errs[9]:.3g} and 192 {errs[10]:.3g}; worst by "
          f"route {json.dumps(worst)}")

    # Each route at its own operands: bf16 hd 64 (the LM path's), f32 at
    # qwen1.5-0.5b's prefill (phase a's) and at hd 128, bf16 at hd 256 and
    # 192; each beside the SIMT kernel on the same tensors and SDPA.
    rows = {}
    for key, (B, H, hd, dtype) in (
            ("bf16_hd64", (LM_B, 16, 64, bf16)),
            ("f32_hd64", (LM_B, 16, 64, f32)),
            ("f32_hd128", (1, 24, 128, f32)),
            ("bf16_hd256", (LM_B, 8, 256, bf16)),
            ("bf16_hd192", (LM_B, 8, 192, bf16))):
        q, k, v = qkv(LM_T, LM_T, B, H, hd, dtype)
        rows[key] = _k4_row(q, k, v)
        if key == "bf16_hd64":
            small = [torch.randn((1, 64, 1, 64), generator=gen, device=dev
                                 ).to(bf16) for _ in range(3)]
            rows[key]["host_ms"] = _host_ms(
                lambda: ops.flash_attention(*small, causal=True))
            rows[key]["device_ms_cold"] = _device_ms(
                lambda: ops.flash_attention(q, k, v, causal=True), 20,
                cold=True)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            rows[key]["library_device_ms_cold"] = _device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), 20, cold=True)
        print(_k4_row_text(rows[key]))
    r = rows["bf16_hd64"]
    print(f"[4] K4 wgmma at the LM shape: with a cold L2 "
          f"{_fmt(r['device_ms_cold'])} ms (SDPA "
          f"{_fmt(r['library_device_ms_cold'])}); host {r['host_ms']:.4g} ms "
          f"a call (1,000 unsynchronised at (1, 64, 1, 64)), events - device "
          f"{_fmt(_sub(r['ms'], r['device_ms']))} ms")

    def entry(name, source, row, err, **extra):
        return dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces="src/repro/kernels/flash_attention.py:26",
            max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["sdpa"]["ms"], device_ms=row["device_ms"],
            library_device_ms=row["sdpa"]["device_ms"],
            library_backend=row["sdpa"]["backend"], **extra)

    report["flash_attention_sm90"] = entry(
        "flash_attention_sm90", "flash_attention_sm90.cu", r, errs[0],
        device_ms_cold=r["device_ms_cold"],
        library_device_ms_cold=r["library_device_ms_cold"],
        host_ms=r["host_ms"], hd256=rows["bf16_hd256"],
        hd192=rows["bf16_hd192"])
    rf = rows["f32_hd64"]
    report["flash_attention_sm90_f32"] = entry(
        "flash_attention_sm90_f32", "flash_attention_sm90_f32.cu", rf,
        errs[1], hd128=rows["f32_hd128"])
    # The SIMT kernel (now the route of layouts TMA does not address,
    # and of f32 with hd > 128) on phase a's f32 tensors.
    report["flash_attention"] = dict(
        entry("flash_attention", "flash_attention.cu", rf, worst["simt"]),
        ms=rf["simt_ms"], device_ms=rf["simt_device_ms"],
        at_bf16_lm_shape=dict(ms=r["simt_ms"], device_ms=r["simt_device_ms"]))

    # hd 128: llama3.2-3b's heads, and llama4-scout's prefill (phase m);
    # hd 112 at zamba2-7b's prefill (phase s: window 4,096 > T, so the
    # causal bound and SDPA's causal mask compute the same function);
    # hubert-xlarge's non-causal forward and internvl2-76b's prefill
    # (phase e).
    for key, (B, H, T, hd), window, causal in (
            ("hd128", (1, 24, LM_T, 128), None, True),
            ("llama4", (LM_B, 40, LM_T, 128), None, True),
            ("zamba2", (LM_B, 32, LM_T, 112), 4096, True),
            ("hubert", (LM_B, 16, LM_T, 80), None, False),
            ("internvl2", (LM_B, 64, LM_T, 128), None, True)):
        q, k, v = qkv(T, T, B, H, hd, bf16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        k4 = lambda: ops.flash_attention(  # noqa: E731
            q, k, v, causal=causal, window=window)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            qt, kt, vt, is_causal=causal)
        b128 = _k4_bound(B, H, T, hd, bf16, causal)
        t = dict(ms=_time_ms(k4, 20), dev=_device_ms(k4, 20),
                 lib=_time_ms(sdpa, 20), lib_dev=_device_ms(sdpa, 20))
        report["flash_attention_sm90"][key] = dict(
            shape=[B, H, T, hd], window=window, causal=causal, ms=t["ms"],
            device_ms=t["dev"], library_ms=t["lib"],
            library_device_ms=t["lib_dev"], bound_ms=b128[0],
            bound_by=b128[1])
        print(f"[4] K4 at ({B}, {H}, {T}, {hd}) bf16 "
              f"{'causal' if causal else 'non-causal'}, window "
              f"{window}: tensor cores "
              f"{t['ms']:.4g} ms (device {_fmt(t['dev'])}); SDPA "
              f"{t['lib']:.4g} ms (device {_fmt(t['lib_dev'])}); bound "
              f"{b128[0]:.4g} ms by {b128[1]}, "
              f"{_fmt(_div(b128[0], t['dev']), '.4f')} of it")


def _check_k5(report: dict, dev) -> None:
    """Phase 5: K5 against its plain version, and its times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    rows, d = LM_B * LM_T, 1024
    bitwise = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        s = torch.randn((d,), generator=gen, device=dev).to(dtype)
        got, want = ops.fused_rmsnorm(x, s), ref.rmsnorm_plain(x, s)
        bitwise[str(dtype)] = bool(torch.equal(got, want))
        _check(bitwise[str(dtype)], f"K5 differs from its twin in {dtype}")
        if dtype == torch.bfloat16:
            err = _max_abs_err([got.float()], [want.float()])
            xb, sb = x, s
    torch.cuda.synchronize()
    sf = sb.float()          # the kernel's scale: f32, cast once
    k5 = lambda: ops.fused_rmsnorm(xb, sf)  # noqa: E731
    k5p = lambda: ref.rmsnorm_plain(xb, sf)  # noqa: E731
    lib = lambda: F.rms_norm(xb, (d,), weight=sb, eps=1e-6)  # noqa: E731
    bound = _bound_ms(2 * rows * d * 2 + d * 4, 4 * rows * d)
    xs = torch.randn((64, d), generator=gen, device=dev).to(torch.bfloat16)
    report["rmsnorm"] = dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:15",
        max_abs_err=err, ms=_time_ms(k5, 50), plain_ms=_time_ms(k5p, 20),
        bound_ms=bound[0], bound_by=bound[1], library_ms=_time_ms(lib, 50),
        device_ms=_device_ms(k5, 50), library_device_ms=_device_ms(lib, 50),
        device_ms_cold=_device_ms(k5, 50, cold=True),
        library_device_ms_cold=_device_ms(lib, 50, cold=True),
        host_ms=_host_ms(lambda: ops.fused_rmsnorm(xs, sf)))
    r = report["rmsnorm"]
    print(f"[5] K5 ok at ({rows}, {d}): bitwise equal to its twin "
          f"{json.dumps(bitwise)}; bf16 max |err| against the twin {err:.3g}; "
          f"{r['ms']:.4g} ms (device {_fmt(r['device_ms'])}), plain "
          f"{r['plain_ms']:.4g} ms, F.rms_norm {r['library_ms']:.4g} ms "
          f"(device {_fmt(r['library_device_ms'])}), bound {bound[0]:.4g} ms "
          f"by {bound[1]}, {_fmt(_div(bound[0], r['device_ms']), '.4f')} of it (the "
          f"timing loop's {4 * rows * d / 1e6:.3g} MB stay in L2); with a "
          f"cold L2 "
          f"{_fmt(r['device_ms_cold'])} ms (F.rms_norm "
          f"{_fmt(r['library_device_ms_cold'])}), "
          f"{_fmt(_div(bound[0], r['device_ms_cold']), '.4f')} of the bound; host "
          f"{r['host_ms']:.4g} ms a call (1,000 unsynchronised at (64, "
          f"{d})), events - device {_fmt(_sub(r['ms'], r['device_ms']))} ms")


K3_KERNELS = {"warp": "topk_moves_warp_kernel",
              "cluster": "topk_moves_cluster_kernel",
              "block": "topk_moves_kernel"}


def _k3_times(args, k, want, pair):
    """Two K3 kernels (routes ``pair``) on the same operands in turns (a,
    b, b, a), beside ``torch.topk`` on the twin's tile (selection only,
    its values held to the twin's scores ``want[2]``), an empty kernel's
    launch (the floor) and the bytes bound: ({route: {"ms", "device_ms",
    "turns"}}, the fields both kernels' report rows share)."""
    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.kernels import topk_moves as tk
    from repro_torch.kernels.sroa_bisect import _stream

    def on(route):
        return lambda: tk.topk_moves_cuda(*args, k, _route=route)[0]

    def mean(x):
        return None if None in x else sum(x) / len(x)

    turns = {r: {"ms": [], "device_ms": []} for r in pair}
    for r in pair + pair[::-1]:
        turns[r]["ms"].append(_time_ms(on(r), 50))
        turns[r]["device_ms"].append(_device_ms(on(r), 50,
                                                kernel=K3_KERNELS[r]))
    C, N, M = args[0].shape
    tile = ref.move_scores_plain(*args)
    lib = lambda: torch.topk(tile, k, dim=1, largest=False,  # noqa: E731
                             sorted=True)
    _check(torch.equal(lib()[0], want[2]),
           "torch.topk's values differ from the twin's scores")
    empty = lambda: build.check(  # noqa: E731
        build.load().topk_empty(_stream(tile)), "topk_empty")
    nbytes = C * N * M * 4 + C * N * (4 + 4 + 4 + 1) + C * 8 + C * k * 12
    bound = _bound_ms(nbytes, C * (12 + k) * N * M)
    times = {r: dict(ms=mean(t["ms"]), device_ms=mean(t["device_ms"]),
                     turns=t) for r, t in turns.items()}
    common = dict(route="cuda",
                  source="src/repro_torch/kernels/csrc/topk_moves.cu",
                  replaces="src/repro/kernels/topk_moves.py:41",
                  bound_ms=bound[0], bound_by=bound[1], nbytes=nbytes,
                  library_ms=_time_ms(lib, 50),
                  library_device_ms=_device_ms(lib, 50),
                  library_is="torch.topk on the twin's (P, N*M) tile: "
                             "selection only; the port never calls it",
                  floor_ms=_time_ms(empty, 50),
                  floor_device_ms=_device_ms(empty, 50, kernel="topk_empty"))
    return times, common


def _check_k3(report: dict, dev, cells, init, mask, sms: int) -> None:
    """Phase 3: K3's warp kernel, its block kernel and the plain twin,
    bitwise at the planning shape and at two synthetic ones; the two
    kernels timed on the same tensors in turns, beside ``torch.topk`` on
    the twin's score tile, an empty kernel's launch and the bound."""
    import torch

    from repro_torch.fleet import engine as fengine
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import topk_moves as tk

    C, N, M = cells.gain.shape
    targs = [cells.gain.contiguous(), fengine._move_H(cells).contiguous(),
             cells.p_max.contiguous(), init.contiguous(), mask.contiguous(),
             cells.N0.contiguous(), cells.B_open.contiguous()]

    def on(route, args, k):
        return lambda: tk.topk_moves_cuda(*args, k, _route=route)[0]

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    def synth(P, n, m, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((P, n, m), generator=g, device=dev).abs() * 1e-7
                + 1e-9, torch.full((P, n), 2.4e5, device=dev),
                torch.full((P, n), 0.2, device=dev),
                torch.randint(0, m, (P, n), generator=g, device=dev,
                              dtype=torch.int32),
                torch.rand((P, n), generator=g, device=dev) < 0.9,
                torch.full((P,), 1e-17, device=dev),
                torch.full((P,), 1e7, device=dev)]

    def off_range(P, n, m, seed):
        """synth's operands sent off the warp kernel's branch-free division
        and log1pf: a tenth of the gains 1e-30, one 1e30, and N0 = 1e-3,
        B = 1e25 (noise past 2^60) in the even cells; in the odd ones user
        1's H 1e30 and user 2's 1e-30 (with ordinary gains)."""
        g, H, pm, a, mk, N0, B = synth(P, n, m, seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        g[torch.rand(g.shape, generator=gen, device=dev) < 0.1] = 1e-30
        g[:, 1:3] = 2e-8
        H[1::2, 1], H[1::2, 2] = 1e30, 1e-30
        g[:, n // 2, m - 1] = 1e30
        N0[::2], B[::2] = 1e-3, 1e25
        return [g, H, pm, a, mk, N0, B]

    k3 = lambda: ops.topk_move_scores(*targs, k=TOP_K)  # noqa: E731
    k3p = lambda: ref.topk_moves_plain(*targs, k=TOP_K)  # noqa: E731
    w0 = ops.LAUNCHES["topk_moves_warp"]
    got, want = k3(), k3p()
    _check(ops.LAUNCHES["topk_moves_warp"] == w0 + 1,
           "K3 at the planning shape did not take the warp kernel")
    _check(same(got, want), "K3 differs from its twin")
    _check(same(on("warp", targs, TOP_K)(), want)
           and same(on("block", targs, TOP_K)(), want),
           "K3's warp and block kernels differ from the twin")
    err = _max_abs_err(got[2:], want[2:])
    cases = [f"({C}, {N}, {M}) warp"]
    for P, n, m, seed in ((128, 128, 4, 31), (16, 300, 7, 32)):
        args = synth(P, n, m, seed)
        route = tk.topk_route(n, m, TOP_K)
        for k in (TOP_K, 40):
            want_s = ref.topk_moves_plain(*args, k=k)
            c0 = ops.LAUNCHES[f"topk_moves_{route}"]
            _check(same(ops.topk_move_scores(*args, k=k), want_s)
                   and ops.LAUNCHES[f"topk_moves_{route}"] == c0 + 1
                   and all(same(on(r, args, k)(), want_s)
                           for r in ("block", "cluster", route)),
                   f"K3 at ({P}, {n}, {m}), k = {k} differs from its twin")
        cases.append(f"({P}, {n}, {m}) {route}")
    # The three kernels on the same off-range operands (the cluster kernel
    # forced onto the planning shape).
    args = off_range(C, N, M, 33)
    _check(not ref.move_scores_plain(*args).isnan().any(),
           "K3's off-range operands make a NaN score")
    for k in (TOP_K, 40):
        want_s = ref.topk_moves_plain(*args, k=k)
        _check(all(same(on(r, args, k)(), want_s)
                   for r in ("warp", "cluster", "block")),
               f"K3 off the fast ranges at ({C}, {N}, {M}), k = {k} differs "
               f"from its twin")
    cases.append(f"({C}, {N}, {M}) warp, cluster and block off the fast "
                 f"ranges")
    torch.cuda.synchronize()
    print(f"[3] K3 ok: the routed call, the cluster and block kernels and "
          f"the twin give identical user, dst and score at "
          f"{', '.join(cases)} (k = {TOP_K} and 40); max |score err| {err}")

    # Both kernels on the same tensors, in turns (warp, block, block,
    # warp).
    times, common = _k3_times(targs, TOP_K, want, ("warp", "block"))
    S = tk.warp_slots(N, M)
    blocks = ctypes.c_int()
    build.check(build.load().topk_moves_warp_occupancy(
        S, N, M, ctypes.byref(blocks)), "topk_moves_warp_occupancy")
    plain_ms = _time_ms(k3p, 5)
    common.update(max_abs_err=err, plain_ms=plain_ms)
    turns = {r: t["turns"] for r, t in times.items()}
    for r, name in (("warp", "topk_moves_warp"), ("block", "topk_moves")):
        report[name] = dict(common, name=name, **times[r])
    rw = report["topk_moves_warp"]
    rw.update(slots=S, blocks_per_sm=blocks.value,
              routed_ms=_time_ms(k3, 50), host_ms=_host_ms(k3))
    rb = report["topk_moves"]
    ptx = [line for line in _ptxas(build.build_log) if "topk" in line]
    print("[3] K3 ptxas (registers; stack frame, spill stores and loads): "
          + " | ".join(ptx))
    print(f"[3] warp kernel at ({C}, {N}, {M}): S = {S} entries a lane, "
          f"one cell (warp) a block, {blocks.value} blocks an SM "
          f"({sms} SMs)")
    print(f"[3] K3 at ({C}, {N}, {M}), k = {TOP_K}, in turns (warp, block, "
          f"block, warp): warp kernel {rw['ms']:.4g} ms (device "
          f"{rw['device_ms']}), the block kernel {rb['ms']:.4g} ms "
          f"(device {rb['device_ms']}); turns {json.dumps(turns)}; plain "
          f"{plain_ms:.4g} ms; torch.topk on the twin's tile (selection "
          f"only) {common['library_ms']:.4g} ms (device "
          f"{common['library_device_ms']}); empty kernel (launch floor) "
          f"{common['floor_ms']:.4g} ms (device "
          f"{common['floor_device_ms']}); bound {common['bound_ms']:.4g} ms "
          f"by {common['bound_by']} ({common['nbytes']} bytes); "
          f"ops.topk_move_scores "
          f"{rw['routed_ms']:.4g} ms, host {rw['host_ms']:.4g} ms a call "
          f"(1,000 unsynchronised)")


def _counted(fn):
    """Run ``fn`` with every launch count set to 0 first; returns its
    result and the counts of that run."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def _add(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def _by_kernel(c: dict) -> dict:
    """A path's ``ops.LAUNCHES`` as launches of each kernel: the routed
    counters (``sroa_solve``, ``topk_moves``, ``flash_attention``,
    ``mamba2_scan``, ``mamba2_scan_bwd``, ``mlstm_scan_bwd``,
    ``slstm_scan_bwd``) count every kernel of their op, so the one-warp
    K2's, the block K3's, the SIMT K4's, the sequential S1's, S1b's and
    S2b's and the barrier S3b's launches are what the others leave."""
    return {"sroa_invert": c["sroa_invert"],
            "sroa_solve_lanes": c["sroa_solve_lanes"],
            "sroa_solve_cluster": c["sroa_solve_cluster"],
            "sroa_solve": (c["sroa_solve"] - c["sroa_solve_lanes"]
                           - c["sroa_solve_cluster"]),
            "topk_moves_warp": c["topk_moves_warp"],
            "topk_moves_cluster": c["topk_moves_cluster"],
            "topk_moves": (c["topk_moves"] - c["topk_moves_warp"]
                           - c["topk_moves_cluster"]),
            "flash_attention_sm90": c["flash_attention_sm90"],
            "flash_attention_sm90_f32": c["flash_attention_sm90_f32"],
            "flash_attention": (c["flash_attention"]
                                - c["flash_attention_sm90"]
                                - c["flash_attention_sm90_f32"]),
            "rmsnorm": c["rmsnorm"],
            "mamba2_scan": c["mamba2_scan"] - c["mamba2_scan_chunked"],
            "mamba2_scan_chunked": c["mamba2_scan_chunked"],
            "mlstm_scan": c["mlstm_scan"], "slstm_scan": c["slstm_scan"],
            "mamba2_scan_bwd": (c["mamba2_scan_bwd"]
                                - c["mamba2_scan_bwd_chunked"]),
            "mamba2_scan_bwd_chunked": c["mamba2_scan_bwd_chunked"],
            "mlstm_scan_bwd": (c["mlstm_scan_bwd"]
                               - c["mlstm_scan_bwd_chunked"]),
            "mlstm_scan_bwd_chunked": c["mlstm_scan_bwd_chunked"],
            "slstm_scan_bwd": (c["slstm_scan_bwd"]
                               - c["slstm_scan_bwd_short"]),
            "slstm_scan_bwd_short": c["slstm_scan_bwd_short"]}


def _k2_operands(scn, assigns):
    """K2's operands for one scenario's patterns, each pattern's constants
    computed as ``sroa.solve`` computes them: per-user (P, N), per-problem
    (P,)."""
    import torch

    from repro_torch.core.system_model import sroa_constants

    cs = [sroa_constants(scn, a) for a in assigns]
    P, N = len(cs), scn.N
    pu = [torch.stack([getattr(c, k) for c in cs]).contiguous()
          for k in ("A", "J", "H", "delta", "h")]
    pu += [scn.f_max.expand(P, N).contiguous(),
           scn.p_max.expand(P, N).contiguous()]
    one = torch.ones(P, device=scn.device)
    pp = [scn.B_open * one, scn.B_open * one, scn.N0 * one, one,
          torch.stack([c.E_cloud_total for c in cs])]
    return pu, pp


def _k2_tsia_shapes(dev) -> dict:
    """K2 at TSIA's shape (P = 1: ``draw_scenario(0)``'s nearest-edge
    pattern, the first TSIA scores, at full caps) and at the host loop's
    (P = 1 + N (M - 1) = 201: that pattern's neighbourhood, serve caps)."""
    import torch

    from repro_torch.core import sroa, wireless
    from repro_torch.fleet.incremental import candidate_assigns

    scn = wireless.draw_scenario(0, device=dev)
    full = sroa.SroaConfig()
    full_caps = dict(b_iters=full.b_iters, f_iters=full.f_iters,
                     p_iters=full.p_iters, t_iters=full.t_iters)
    nearest = wireless.nearest_edge_assignment(scn)
    nb = torch.as_tensor(candidate_assigns(nearest.cpu().numpy(), scn.M),
                         device=dev)
    return {"tsia_p1": (_k2_operands(scn, [nearest]), full_caps),
            "host_loop_p201": (_k2_operands(scn, list(nb)), SERVE_CAPS)}


def _time_k2_tsia_shapes(shapes: dict) -> dict:
    """K2's events and device time at the shapes of
    :func:`_k2_tsia_shapes`, read before any plain twin runs (phase 2)."""
    from repro_torch.kernels import ops

    out = {}
    for key, ((pu, pp), caps) in shapes.items():
        fn = lambda: ops.sroa_solve_batched(*pu, *pp, **caps)  # noqa: E731
        out[key] = dict(P=pu[0].shape[0], N=pu[0].shape[1], caps=caps,
                        ms=_time_ms(fn, 3),
                        device_ms=_device_ms(fn, 3, kernel="sroa_solve"))
    return out


def _tsia_path(dev, report: dict, k2: dict) -> dict:
    """Phase t: TSIA (Algorithm 5) on K2, the RA baselines on K1 and K2,
    and the per-cell planner (``serve --no-stream``, ``--host-loop``) on K2
    and K3.  Returns the launch counts of the path's runs (timing and
    comparison launches left out)."""
    import numpy as np
    import torch

    from repro_torch.core import baselines, sroa, tsia, wireless
    from repro_torch.core.system_model import evaluate
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve

    path: dict = {}
    scn = wireless.draw_scenario(0, device=dev)
    N, M = scn.N, scn.M
    full = sroa.SroaConfig(fused=True)
    full_caps = dict(b_iters=full.b_iters, f_iters=full.f_iters,
                     p_iters=full.p_iters, t_iters=full.t_iters)
    k2 = {key: dict(t) for key, t in k2.items()}

    # (a) TSIA at the paper's N = 50, M = 5 and full caps: one K2 launch
    # a score.
    scores = []

    def score_full(a):
        scores.append(a.copy())
        return tsia._score(scn, a, 1.0, full)

    t0 = time.perf_counter()
    res, counts = _counted(lambda: tsia.solve(scn, 1.0, full,
                                              score_fn=score_full))
    wall_ms = (time.perf_counter() - t0) * 1e3
    _add(path, counts)
    h = res.history
    n_scores = len(scores)
    _check(n_scores == 2 + h.total_iters,
           f"TSIA scored {n_scores} patterns in {h.total_iters} moves")
    _check(counts["sroa_solve"] == n_scores,
           f"{counts['sroa_solve']} K2 launches for {n_scores} scores")
    _check(counts["sroa_solve_lanes"] == n_scores,
           f"{n_scores - counts['sroa_solve_lanes']} of TSIA's K2 launches "
           f"took PR 11's kernel")
    _check(res.R == min(h.R_trace), "TSIA's R is not its trace's minimum")
    best = torch.as_tensor(res.assign, device=dev)
    R_ev = float(evaluate(scn, best, res.sroa.b, res.sroa.f, res.sroa.p,
                          1.0).R)
    _check(abs(R_ev - res.R) <= 1e-5 * abs(res.R),
           f"evaluate gives {R_ev} for TSIA's R {res.R}")
    _check(all(src != dst for _, _, _, src, dst in h.moves),
           "a TSIA move with src == dst")
    _check(((res.assign >= 0) & (res.assign < M)).all(), "TSIA assignment")

    shapes = _k2_tsia_shapes(dev)
    nearest = wireless.nearest_edge_assignment(scn)
    print(f"[t] (a) TSIA at draw_scenario(0) (N = {N}, M = {M}), caps "
          f"{full_caps}, fused: {n_scores} scores ({h.iters_stage1} + "
          f"{h.iters_stage2} moves) in {wall_ms:.1f} ms, "
          f"{wall_ms / n_scores:.3f} ms a score; {counts['sroa_solve']} K2 "
          f"launches, all on the lanes kernel; R = {res.R:.6g} "
          f"(evaluate {R_ev:.6g}); K2 at P = 1 (phase 2, nearest-edge "
          f"pattern): {_fmt(k2['tsia_p1']['device_ms'])} ms device, "
          f"{k2['tsia_p1']['ms']:.4g} ms events")

    # (b) TSIA at the serve caps, every score recorded; then every scored
    # pattern in ONE call of K2's plain twin: the same bits, so the plain
    # version would have taken the same decisions.
    serve_cfg = sroa.SroaConfig(**SERVE_CAPS, fused=True)
    rec = []

    def score_rec(a):
        out = tsia._score(scn, a, 1.0, serve_cfg)
        rec.append((a.copy(), out[0]))
        return out

    res_b, counts = _counted(lambda: tsia.solve(scn, 1.0, serve_cfg,
                                                score_fn=score_rec))
    _add(path, counts)
    pu, pp = _k2_operands(scn, [torch.as_tensor(a, device=dev)
                                for a, _ in rec])
    t0 = time.perf_counter()
    want = ref.sroa_solve_plain(*pu, *pp, **SERVE_CAPS)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    for i, (_, got) in enumerate(rec):
        for k, name in enumerate(("b", "f", "p")):
            _check(torch.equal(getattr(got, name).reshape(-1), want[k][i]),
                   f"TSIA score {i}: K2's {name} differs from the twin's")
        torch.testing.assert_close(got.R.reshape(()), want[4][i],
                                   rtol=1e-4, atol=0)
    print(f"[t] (b) TSIA at the serve caps: {len(rec)} scores, "
          f"{len(res_b.history.moves)} moves; K2's b, f, p of every scored "
          f"pattern bitwise the twin's in one call at P = {len(rec)} "
          f"({twin_ms:.0f} ms), R to rtol 1e-4")

    # The plain twin at the two timed shapes, with this data's work.
    for key, ((pu, pp), caps) in shapes.items():
        w = {}
        t0 = time.perf_counter()
        plain = ref.sroa_solve_plain(*pu, *pp, **caps, work=w)
        torch.cuda.synchronize()
        k2[key]["plain_ms"] = (time.perf_counter() - t0) * 1e3
        got = ops.sroa_solve_batched(*pu, *pp, **caps)
        _check(all(torch.equal(x, y) for x, y in zip(got, plain)),
               f"K2 at {key} differs from its twin")
        flops, (bms, by) = _k2_bound(w, k2[key]["P"], N, caps)
        k2[key].update(work=w, flops=flops, bound_ms=bms, bound_by=by)
        print(f"[t] K2 at P = {k2[key]['P']}, N = {N} ({key}, caps "
              f"{caps}): device {_fmt(k2[key]['device_ms'])} ms, events "
              f"{k2[key]['ms']:.4g} ms, plain {k2[key]['plain_ms']:.0f} ms "
              f"(bitwise), bound {bms:.3g} ms by {by} (work {w})")
    report["sroa_solve_lanes"].update(k2)

    # (c) The baselines at the nearest-edge pattern, on the serve caps:
    # HFEL's and SROA's inversions on K1 (use_pallas) against the eager
    # inversion; SROA below every other method (Fig 2).
    eager_cfg = sroa.SroaConfig(**SERVE_CAPS)
    k1_cfg = sroa.SroaConfig(**SERVE_CAPS, use_pallas=True)

    def R_of(ra):
        return float(evaluate(scn, nearest, ra.b, ra.f, ra.p, 1.0).R)

    scores_ra = {}
    k1_n = {}
    for name in ("HFEL", "SROA"):
        fn = baselines.RA_METHODS[name]
        R_e = R_of(fn(scn, nearest, 1.0, eager_cfg))
        ra, counts = _counted(lambda: fn(scn, nearest, 1.0, k1_cfg))
        _add(path, counts)
        k1_n[name] = counts["sroa_invert"]
        _check(k1_n[name] > 0, f"{name} on use_pallas launched no K1")
        R_k = R_of(ra)
        _check(abs(R_k - R_e) <= 1e-5 * abs(R_e),
               f"{name}: R on K1 {R_k} against the eager inversion {R_e}")
        scores_ra[name] = R_e
    for name, fn in baselines.RA_METHODS.items():
        if name not in scores_ra:
            scores_ra[name] = R_of(fn(scn, nearest, 1.0, eager_cfg))
    _check(all(math.isfinite(R) for R in scores_ra.values()),
           f"non-finite baseline R: {scores_ra}")
    _check(min(scores_ra, key=scores_ra.get) == "SROA",
           f"SROA does not beat every baseline: {scores_ra}")
    print(f"[t] (c) RA baselines at the nearest-edge pattern: R "
          f"{json.dumps({k: round(v, 3) for k, v in scores_ra.items()})}; "
          f"SROA lowest; K1 launches on use_pallas: {json.dumps(k1_n)}, R "
          f"equal to the eager inversion's to rtol 1e-5")

    # (d) The per-cell planner through the CLI: the engine route at the
    # README fleet's width with top-8 pruning, then the host loop.
    argv = ["--mode", "plan", "--no-stream", "--device", "cuda",
            "--cells", "16", "--cell-users", "50", "--cell-edges", "5",
            "--rounds", "2", "--plan-rounds", "12"]
    runs = {}
    for key, extra in (("no_stream", ["--top-k", str(TOP_K)]),
                       ("host_loop", ["--host-loop", "--cells", "2",
                                      "--rounds", "1"])):
        out, counts = _counted(lambda: serve.main(argv + extra))
        _add(path, counts)
        for i, rnd in enumerate(out["rounds"]):
            for c, r in enumerate(rnd["responses"]):
                a = np.asarray(r["assign"])
                _check(((a >= 0) & (a < 5)).all() and len(a) > 0,
                       f"{key} round {i} cell {c}: assignment off range")
                _check(math.isfinite(r["objective"]),
                       f"{key} round {i} cell {c}: non-finite R")
                if c not in rnd["changed"]:
                    _check(r["cached"], f"{key} round {i}: unchanged cell "
                           f"{c} was not a cache hit")
        _check(counts["sroa_solve"] > 0, f"{key}: no K2 launch")
        _check(counts["sroa_solve_lanes"] == counts["sroa_solve"],
               f"{key}: a K2 launch took the one-warp-per-problem kernel")
        if key == "no_stream":
            _check(counts["topk_moves"] > 0, "no_stream: no K3 launch")
            block = counts["topk_moves"] - counts["topk_moves_warp"]
            _check(block == 0, f"no_stream: {block} K3 launches took the "
                   f"block kernel")
        n_cells = len(out["rounds"][0]["responses"])
        runs[key] = dict(cold_ms=out["cold_ms"], counts=counts,
                         rounds=[dict(changed=len(r["changed"]),
                                      hits=r["hits"], ms=r["ms"],
                                      plans_per_s=n_cells / r["ms"] * 1e3)
                                 for r in out["rounds"]])
        print(f"[t] (d) serve {' '.join(argv[2:3] + extra)} ({n_cells} "
              f"cells of up to 50 users, M = 5): cold {out['cold_ms']:.1f} "
              f"ms; rounds " + "; ".join(
                  f"{r['changed']} changed, {r['hits']} hits, "
                  f"{r['ms']:.1f} ms, {r['plans_per_s']:.4g} plans/s"
                  for r in runs[key]["rounds"])
              + f"; launches {json.dumps(counts)}")
    return {"counts": path, "tsia": dict(scores=n_scores, wall_ms=wall_ms,
                                         ms_per_score=wall_ms / n_scores),
            "k2": k2, "baselines": scores_ra, "serve": runs}


# Phase h: the README's planning examples (`README.md`, "Planning"), each
# through the CLI's own construction on the README fleet: (key, cells,
# ticks, flags).  h4 runs 3 ticks so that the redesign (every 2 ticks from tick
# 1 on) runs at tick 2; h5 sets every knob at once on 16 cells.
H_TIERS = "lo:1.6:1.0:0.55:0.35,mid,hi:0.7:1.2:1.5:0.3"
H_RUNS = (
    ("h1", 128, 3, ["--n-starts", "4"]),
    ("h2", 128, 3, ["--horizon", "4", "--switch-cost", "100"]),
    ("h3", 128, 3, ["--tiers", H_TIERS, "--compression", "--topk-frac",
                    "0.05"]),
    ("h4", 128, 3, ["--m-cand", "8", "--topology-period", "2",
                    "--edge-cost", "2000"]),
    ("h5", 16, 2, ["--n-starts", "4", "--horizon", "4", "--switch-cost",
                   "100", "--tiers", H_TIERS, "--compression",
                   "--topk-frac", "0.05", "--m-cand", "8",
                   "--topology-period", "1", "--edge-cost", "2000"]),
)


@contextlib.contextmanager
def _launch_sizes():
    """Record the problems (P) of every K2 and K3 wrapper call made inside
    the block: ``{"sroa_solve": [P, ...], "topk_moves": [P, ...]}``."""
    from repro_torch.kernels import ops

    sizes = {"sroa_solve": [], "topk_moves": []}
    k2, k3 = ops.sroa_solve_batched, ops.topk_move_scores

    def k2_rec(*args, **kw):
        out = k2(*args, **kw)
        sizes["sroa_solve"].append(out[3].numel())      # t: one a problem
        return out

    def k3_rec(*args, **kw):
        out = k3(*args, **kw)
        sizes["topk_moves"].append(out[0].numel() // kw["k"])
        return out

    ops.sroa_solve_batched, ops.topk_move_scores = k2_rec, k3_rec
    try:
        yield sizes
    finally:
        ops.sroa_solve_batched, ops.topk_move_scores = k2, k3


def _histogram(xs) -> dict:
    out = {}
    for x in xs:
        out[str(x)] = out.get(str(x), 0) + 1
    return dict(sorted(out.items(), key=lambda kv: int(kv[0])))


def _check_h_kernels(svc, dev) -> dict:
    """K2 and K3 against their twins on operands of h5's last state: one
    cell's horizon round of the joint (assignment, compression) search
    over two predicted slots (comp-scaled loads, a predicted slot's gains,
    B over open sites only), and K3 on the comp-aware upload bits at
    M = 8 for every cell, on the routed call and both kernels."""
    import numpy as np
    import torch

    from repro_torch.core.system_model import expand_scenario, sroa_constants
    from repro_torch.fleet import dynamics
    from repro_torch.fleet import engine as fengine
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import topk_moves as tk

    sub = svc.fleet.index([0])
    cells = sub.cells
    stack = torch.as_tensor(dynamics.predict_fleet_rollout(
        sub, svc.state, svc.cfg.horizon, cfg=svc.cfg.stream,
        rows=np.array([0]))[:, :2], device=dev)
    cur = torch.as_tensor(svc.assigns[:1], device=dev)
    comp = torch.as_tensor(svc.comps[:1], device=dev)
    cands, comps, _ = fengine._pruned_candidates_comp(
        cells, cur, comp, sub.mask, TOP_K, svc.ladder)
    C, A, N = cands.shape
    K = stack.shape[1]
    _check(int(comps.max()) > 0, "h5's cell 0 has no compressed user")
    _check(bool((cells.B_open < cells.B_total).all()),
           "h5's cell 0 has every site open")
    _check(not torch.equal(stack[:, 1], stack[:, 0]),
           "the predicted slot equals the live channel")
    cs = expand_scenario(expand_scenario(cells, 1), 1)._replace(
        gain=stack[:, :, None])
    c = sroa_constants(cs, cands[:, None].expand(C, K, A, N),
                       sub.mask[:, None, None, :],
                       comps[:, None].expand(C, K, A, N), svc.ladder)
    lead = (C, K, A)
    pu = [torch.broadcast_to(x, lead + (N,)).reshape(-1, N).contiguous()
          for x in (c.A, c.J, c.H, c.delta, c.h, cs.f_max, cs.p_max)]
    pp = [torch.broadcast_to(x, lead).reshape(-1).contiguous()
          for x in (cs.B_open, cs.B_open, cs.N0,
                    torch.ones((), device=dev), c.E_cloud_total)]
    lanes = ops.LAUNCHES["sroa_solve_lanes"]
    got = ops.sroa_solve_batched(*pu, *pp, **SERVE_CAPS)
    want = ref.sroa_solve_plain(*pu, *pp, **SERVE_CAPS)
    _check(ops.LAUNCHES["sroa_solve_lanes"] == lanes + 1,
           "K2 on h5's operands did not take the lanes kernel")
    _check(all(torch.equal(g, w) for g, w in zip(got, want)),
           "K2 on h5's operands differs from its twin")
    k2_err = _max_abs_err(got, want)

    fl = svc.fleet
    H = fengine._move_H(fl.cells, torch.as_tensor(svc.comps, device=dev),
                        svc.ladder)
    args = [x.contiguous() for x in (
        fl.cells.gain, H, fl.cells.p_max,
        torch.as_tensor(svc.assigns, device=dev), fl.mask, fl.cells.N0,
        fl.cells.B_open)]
    want3 = ref.topk_moves_plain(*args, k=TOP_K)
    w0 = ops.LAUNCHES["topk_moves_warp"]
    outs = [ops.topk_move_scores(*args, k=TOP_K)]
    _check(ops.LAUNCHES["topk_moves_warp"] == w0 + 1,
           "K3 at M = 8 did not take the warp kernel")
    outs += [tk.topk_moves_cuda(*args, TOP_K, _route=r)[0]
             for r in ("warp", "block")]
    _check(all(torch.equal(g, w) for out in outs
               for g, w in zip(out, want3)),
           "K3 on the comp-aware H at M = 8 differs from its twin")
    torch.cuda.synchronize()
    print(f"[h] K2 on h5's operands (cell 0, {K} predicted slots x {A} "
          f"joint candidates = {K * A} problems, N = {N}; levels up to "
          f"{int(comps.max())}, B over {int(cells.edge_mask.sum())} of "
          f"{cells.M} sites): bitwise its twin, max |err| {k2_err}")
    print(f"[h] K3 on the comp-aware H at ({fl.C}, {fl.N_max}, {fl.M}), "
          f"k = {TOP_K}: the routed call, the warp kernel "
          f"(S = {tk.warp_slots(fl.N_max, fl.M)}) and the block kernel "
          f"bitwise its twin")
    return {"k2_problems": K * A, "k2_max_abs_err": k2_err}


def _plan_extensions_path(dev) -> dict:
    """Phase h: the planner's extended decision space through
    ``serve.build_service``: restarts (h1), the rolling horizon
    (h2), the compression ladder over device tiers (h3), topology design
    (h4) and all four at once (h5).  Returns the launch counts of the
    runs (construction and ticks; checks and traces left out)."""
    import numpy as np
    import torch

    from repro_torch.core.wireless import ScenarioSpec
    from repro_torch.fleet import batch as fbatch
    from repro_torch.fleet.service import run_load
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    path: dict = {}
    runs = {}
    base = ["--mode", "plan", "--device", "cuda", "--cell-users", "56",
            "--cell-edges", "5", "--plan-rounds", "12", "--top-k",
            str(TOP_K), "--seed", "0"]
    t_phase = time.perf_counter()
    check = None
    for key, n_cells, ticks, flags in H_RUNS:
        args = serve.build_parser().parse_args(
            base + ["--cells", str(n_cells)] + flags)
        spec = dataclasses.replace(
            ScenarioSpec(), M=max(args.m_cand, args.cell_edges),
            tiers=serve._parse_tiers(args.tiers) if args.tiers else ())
        fleet = fbatch.draw_fleet(0, n_cells, spec, device=dev)
        recs = []
        with _launch_sizes() as sizes:
            ops.reset_launches()
            t0 = time.perf_counter()
            _, svc = serve.build_service(args, fleet)
            torch.cuda.synchronize()
            boot_ms = (time.perf_counter() - t0) * 1e3
            snap = run_load(svc, ticks=ticks, req_per_tick=2.0, seed=7,
                            on_tick=recs.append)
            torch.cuda.synchronize()
            counts = dict(ops.LAUNCHES)
        _add(path, counts)
        M = svc.fleet.M
        active = np.asarray(svc.state.active, bool)
        _check(len(recs) == ticks and snap["unserved"] == 0,
               f"{key}: unserved requests")
        _check(all(math.isfinite(r.sum_R) for r in recs),
               f"{key}: non-finite sum R")
        _check(((svc.assigns >= 0) & (svc.assigns < M)).all(),
               f"{key}: assignment off the edge range")
        _check(counts["sroa_solve"] > 0 and counts["topk_moves"] > 0,
               f"{key}: K2 or K3 never launched")
        _check(counts["sroa_solve_lanes"] == counts["sroa_solve"],
               f"{key}: a K2 launch took the one-warp-per-problem kernel")
        _check(counts["topk_moves_warp"] == counts["topk_moves"],
               f"{key}: a K3 launch took the block kernel")
        extra = {}
        if svc.fleet.edge_mask is not None:
            em = svc.fleet.edge_mask.cpu().numpy()
            on_open = np.take_along_axis(em, svc.assigns.astype(np.int64), 1)
            _check(on_open[active].all(), f"{key}: a user on a closed site")
            extra["topo_moves"] = sum(r.topo_moves for r in recs)
            extra["open_sites"] = _histogram(em.sum(axis=1))
        if svc.ladder is not None:
            _check(((svc.comps >= 0) & (svc.comps < len(svc.ladder))).all(),
                   f"{key}: a level off the ladder")
            extra["levels"] = snap["compression_hist"]
        if args.horizon > 1:
            extra["handovers"] = sum(r.handovers for r in recs)
        for r in recs:
            print(f"[h] {key} tick {r.tick}: changed {r.changed}, replanned "
                  f"{r.replanned.size}, handovers {r.handovers}, topology "
                  f"moves {r.topo_moves}, sum R {r.sum_R:.6g}, "
                  f"{r.tick_ms:.1f} ms")
        with _launch_sizes() as traced_sizes:
            rows = _profile("[h]", f"{key}: one traced tick", svc.tick)
        busy = sum(r[0] for r in rows)
        k2_ms = sum(r[0] for r in rows if "sroa_solve" in r[2])
        k2_n = sum(r[1] for r in rows if "sroa_solve" in r[2])
        k3_ms = sum(r[0] for r in rows if "topk_moves" in r[2])
        run = dict(
            cells=n_cells, ticks=ticks, flags=" ".join(flags),
            bootstrap_ms=boot_ms, plans_per_s=snap["plans_per_s"],
            tick_ms=snap["tick_ms"], sum_R=recs[-1].sum_R,
            k2_launches=counts["sroa_solve"],
            k3_launches=counts["topk_moves"],
            k2_P=_histogram(sizes["sroa_solve"]),
            k3_P=_histogram(sizes["topk_moves"]),
            traced=dict(device_ms=busy, k2_ms=k2_ms, k2_launches=k2_n,
                        k2_ms_a_launch=_div(k2_ms, k2_n or None),
                        k2_P=_histogram(traced_sizes["sroa_solve"]),
                        k3_ms=k3_ms, k2_share=_div(k2_ms, busy or None),
                        k3_share=_div(k3_ms, busy or None)), **extra)
        runs[key] = run
        tr = run["traced"]
        print(f"[h] {key} ({n_cells} cells, {flags}): bootstrap "
              f"{boot_ms:.1f} ms; {snap['plans_per_s']:.4g} plans/s, tick "
              f"p50 {snap['tick_ms']['p50']:.4g} ms, p99 "
              f"{snap['tick_ms']['p99']:.4g} ms; sum R {run['sum_R']:.6g}; "
              f"K2 {run['k2_launches']} launches (P: {json.dumps(run['k2_P'])}"
              f"), K3 {run['k3_launches']} (P: {json.dumps(run['k3_P'])}); "
              f"{json.dumps(extra)}")
        print(f"[h] {key} traced tick: K2 {_fmt(tr['k2_ms'])} ms in "
              f"{k2_n} launches ({_fmt(tr['k2_ms_a_launch'])} ms a launch, "
              f"P: {json.dumps(tr['k2_P'])}), {_fmt(tr['k2_share'])} of "
              f"{_fmt(busy)} ms device time; K3 {_fmt(k3_ms)} ms "
              f"({_fmt(tr['k3_share'])})")
        if key == "h5":
            check = _check_h_kernels(svc, dev)
        del svc
    seconds = time.perf_counter() - t_phase
    print(f"[h] phase h: {seconds:.1f} s; launches {json.dumps(path)}")
    return {"counts": path, "runs": runs, "check": check,
            "seconds": seconds}


# Phase x: the large-cell planning path, DESIGN.md D9's pruned candidate
# search at scale: the JAX package's `benchmarks/bench_engine.py`
# `run_scaling` call (N = 2,048 users, M = 16 edges, top-16, 2 starts, 8
# rounds, its trimmed caps, fused) and `serve --mode plan --cell-users 2048
# --cell-edges 16 --top-k 16` over X_CELLS cells.  K2 runs there on its
# cluster kernel and K3 on its cluster kernel.
X_N, X_M, X_TOP_K, X_STARTS = 2048, 16, 16, 2
X_CAPS = dict(b_iters=24, f_iters=16, p_iters=12, t_iters=20)
X_CELLS, X_TICKS = 8, 2


@contextlib.contextmanager
def _first_operands(n_prob: int):
    """Record the operands of the first K2 launch of ``n_prob`` problems
    (flattened per-user and per-problem tensors and the keywords) and of
    the first K3 launch, as the launchers receive them, inside the block."""
    from repro_torch.kernels import sroa_bisect as sb
    from repro_torch.kernels import topk_moves as tk

    seen = {}
    solve, launch = sb.solve_cuda, tk._launch

    def solve_rec(per_user, per_problem, **kw):
        if "k2" not in seen and per_user[0].shape[0] == n_prob:
            seen["k2"] = ([x.clone() for x in per_user],
                          [x.clone() for x in per_problem],
                          {k: v for k, v in kw.items() if k != "_route"})
        return solve(per_user, per_problem, **kw)

    def launch_rec(*args, **kw):
        if "k3" not in seen:
            seen["k3"] = ([x.clone() for x in args[:7]], int(args[7]))
        return launch(*args, **kw)

    sb.solve_cuda, tk._launch = solve_rec, launch_rec
    try:
        yield seen
    finally:
        sb.solve_cuda, tk._launch = solve, launch


def _once_ms(fn):
    """fn's result and its CUDA-event time (ms) over this one call."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def _x_k2(dev, pu, pp, kw, one_warp: bool, reps: int = 3) -> dict:
    """K2's cluster kernel at every depth, the routed call, the one-warp kernel
    (where it runs) and the twin on the same (P, N) operands: bitwise, each
    kernel timed (events and device time), the twin's work and the bound."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import sroa_bisect as sb

    P, N = pu[0].shape
    caps = {k: kw[k] for k in X_CAPS}

    def on(route):
        return lambda: sb.solve_cuda(tuple(pu), tuple(pp), **kw,
                                     _route=route)[0]

    route = sb.solve_route(P, N, sb._sms(dev.index))
    _check(route[0] == "cluster", f"K2 at P = {P}, N = {N} took {route}")
    routed = lambda: sb.solve_cuda(tuple(pu), tuple(pp), **kw)[0]  # noqa
    got = routed()
    out = dict(P=P, N=N, route=list(route),
               ms=_time_ms(routed, reps),
               device_ms=_device_ms(routed, reps,
                                    kernel="sroa_solve_cluster"),
               depth_device_ms={d: _device_ms(on(("cluster", d)), reps,
                                              kernel="sroa_solve_cluster")
                                for d in sb.DEPTHS})
    outs = [on(("cluster", d))() for d in sb.DEPTHS]
    if one_warp:
        old, out["one_warp_ms"] = _once_ms(on(("warp", 0)))
        outs.append(old)
        out["one_warp_device_ms"] = _device_ms(on(("warp", 0)), 2,
                                           kernel="sroa_solve_kernel")
    torch.cuda.synchronize()
    work = {}
    want, out["plain_ms"] = _once_ms(
        lambda: ref.sroa_solve_plain(*pu, *pp, **kw, work=work))
    for o in [got] + outs:
        _check(all(torch.equal(a, b) for a, b in zip(o, want)),
               f"K2 at P = {P}, N = {N} differs from its twin")
    flops, (bms, by) = _k2_bound(work, P, N, caps)
    out.update(work=work, flops=flops, bound_ms=bms, bound_by=by,
               max_abs_err=_max_abs_err(got, want),
               feasible=int(got[6].sum()),
               # one problem's dependent step: an inversion and its
               # reduction over the cluster
               us_a_step=_div(out["device_ms"] and out["device_ms"] * 1e3,
                              work["inversions"] / P))
    return out


def _x_k3(args, k) -> dict:
    """K3's cluster kernel (routed), the block kernel and the twin on
    the same operands, bitwise, also at k = 40 past the legal moves; both
    kernels timed by :func:`_k3_times`."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import topk_moves as tk

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    C, N, M = args[0].shape
    want = ref.topk_moves_plain(*args, k=k)
    c0 = ops.LAUNCHES["topk_moves_cluster"]
    got = ops.topk_move_scores(*args, k=k)
    _check(ops.LAUNCHES["topk_moves_cluster"] == c0 + 1,
           f"K3 at ({C}, {N}, {M}) did not take the cluster kernel")
    _check(same(got, want)
           and same(tk.topk_moves_cuda(*args, k, _route="block")[0], want),
           f"K3 at ({C}, {N}, {M}), k = {k} differs from its twin")
    # k = 40 on the same cells with two active users: 2 (M - 1) legal moves
    # a cell, fewer than 40.
    few = list(args)
    few[4] = torch.zeros_like(args[4])
    few[4][:, :2] = True
    want40 = ref.topk_moves_plain(*few, k=40)
    _check(bool((want40[2][:, 2 * (M - 1):] >= 1e29).all()),
           "the two-user cells have more legal moves than expected")
    _check(same(ops.topk_move_scores(*few, k=40), want40)
           and same(tk.topk_moves_cuda(*few, 40, _route="block")[0],
                    want40),
           f"K3 at ({C}, {N}, {M}), k = 40 past the legal moves differs "
           f"from its twin")
    times, common = _k3_times(args, k, want, ("cluster", "block"))
    return dict(common, shape=[C, N, M], k=k, **times["cluster"],
                block_ms=times["block"]["ms"],
                block_device_ms=times["block"]["device_ms"],
                block_turns=times["block"]["turns"],
                plain_ms=_time_ms(lambda: ref.topk_moves_plain(*args, k=k),
                                  5),
                max_abs_err=_max_abs_err(got[2:], want[2:]),
                smem=tk.cluster_smem_bytes(N, M, k),
                cluster=tk.cluster_shape(N, M, k))


def _large_cell_path(dev) -> dict:
    """Phase x: (a) ``engine.solve_assignment`` at the large-cell shape,
    counted; (b) K2 on its first round's operands (and at N = 600 and
    4,096, one problem each); (c) K3 on its first round's operands; (d)
    ``serve.build_service`` over X_CELLS such cells for X_TICKS ticks,
    counted.  Returns the path's launch counts ((a) and (d)) and the
    measurements."""
    import numpy as np
    import torch

    from repro_torch.core import sroa, wireless
    from repro_torch.fleet import engine as fengine
    from repro_torch.fleet.service import run_load
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    path: dict = {}
    spec = dataclasses.replace(wireless.ScenarioSpec(), N=X_N, M=X_M)
    scn = wireless.draw_scenario(1, spec, device=dev)
    cfg = sroa.SroaConfig(**X_CAPS, fused=True)
    n_prob = X_STARTS * (1 + X_TOP_K)

    def cluster_only(counts, what):
        _check(counts["sroa_solve"] > 0
               and counts["sroa_solve_cluster"] == counts["sroa_solve"],
               f"{what}: {counts['sroa_solve']} K2 launches, "
               f"{counts['sroa_solve_cluster']} on the cluster kernel")
        _check(counts["topk_moves_cluster"] == counts["topk_moves"],
               f"{what}: {counts['topk_moves']} K3 launches, "
               f"{counts['topk_moves_cluster']} on the cluster kernel")

    # (a) The search, and the nearest-edge init's R (max_rounds = 0).
    init, counts = _counted(lambda: fengine.solve_assignment(
        scn, cfg=cfg, max_rounds=0))
    _add(path, counts)
    cluster_only(counts, "the init's solve")
    with _first_operands(n_prob) as first:
        t0 = time.perf_counter()
        res, counts = _counted(lambda: fengine.solve_assignment(
            scn, cfg=cfg, max_rounds=8, escape_iters=1, top_k=X_TOP_K,
            n_starts=X_STARTS))
        search_ms = (time.perf_counter() - t0) * 1e3
    _add(path, counts)
    cluster_only(counts, "the search")
    _check(counts["topk_moves"] > 0, "the search launched no K3")
    R, R0 = float(res.R), float(init.R)
    a = res.assign.cpu().numpy()
    _check(math.isfinite(R) and R <= R0,
           f"the search's R {R} is worse than the nearest-edge init's {R0}")
    _check(((a >= 0) & (a < X_M)).all(), "assignment off the edge range")
    search = dict(wall_ms=search_ms, rounds=int(res.rounds),
                  escapes=int(res.escapes), R=R, R_init=R0, counts=counts)
    print(f"[x] (a) solve_assignment(draw_scenario(1, N={X_N}, M={X_M}), "
          f"caps {X_CAPS} fused, max_rounds=8, escape_iters=1, "
          f"top_k={X_TOP_K}, n_starts={X_STARTS}): {search_ms:.1f} ms, "
          f"{search['rounds']} rounds, {search['escapes']} escapes; R = "
          f"{R:.6g} (nearest-edge init {R0:.6g}); launches "
          f"{json.dumps(counts)}: every K2 launch on the cluster kernel, "
          f"every K3 launch on the cluster kernel")

    # (b) K2 on the first round's operands, and one problem at N = 600 and
    # 4,096 (the one-warp kernel holds 3,632 users at most).
    _check("k2" in first, f"no K2 launch of {n_prob} problems")
    pu, pp, kw = first["k2"]
    k2 = {"round": _x_k2(dev, pu, pp, kw, one_warp=True, reps=3)}
    for n_users, one_warp in ((600, True), (4096, False)):
        s1 = wireless.draw_scenario(n_users, dataclasses.replace(
            spec, N=n_users), device=dev)
        pu1, pp1 = _k2_operands(s1, [wireless.nearest_edge_assignment(s1)])
        k2[f"N{n_users}"] = _x_k2(dev, pu1, pp1, dict(kw), one_warp,
                                  reps=3)
    for key, r in k2.items():
        print(f"[x] (b) K2 {key} (P = {r['P']}, N = {r['N']}, route "
              f"{r['route']}): cluster kernel {r['ms']:.4g} ms (device "
              f"{_fmt(r['device_ms'])}), device ms by depth "
              f"{json.dumps(r['depth_device_ms'])}; the one-warp kernel "
              + (f"{r['one_warp_ms']:.4g} ms (device "
                 f"{_fmt(r['one_warp_device_ms'])})" if "one_warp_ms" in r
                 else "not run (N > 3632)")
              + f"; the twin {r['plain_ms']:.0f} ms; bitwise; bound "
              f"{r['bound_ms']:.4g} ms by {r['bound_by']} (work "
              f"{json.dumps(r['work'])}); {_fmt(r['us_a_step'])} us a "
              f"problem's inversion step; feasible {r['feasible']}/{r['P']}")

    # (c) K3 on the first round's operands.
    _check("k3" in first, "no K3 launch")
    k3 = _x_k3(*first["k3"])
    print(f"[x] (c) K3 at {tuple(k3['shape'])}, k = {k3['k']} "
          f"({k3['cluster'][1]} blocks a cluster, {k3['cluster'][0]} "
          f"slices, {k3['smem']} shared bytes a block): the routed call "
          f"(cluster kernel), the block kernel and the twin identical, and "
          f"at k = 40 with 2 active users a cell; in turns (cluster, block, "
          f"block, cluster): cluster kernel {k3['ms']:.4g} ms (device "
          f"{_fmt(k3['device_ms'])}), block kernel {k3['block_ms']:.4g} ms "
          f"(device {_fmt(k3['block_device_ms'])}); turns "
          f"{json.dumps([k3['turns'], k3['block_turns']])}; torch.topk on "
          f"the twin's tile "
          f"{k3['library_ms']:.4g} ms (device "
          f"{_fmt(k3['library_device_ms'])}); empty kernel "
          f"{k3['floor_ms']:.4g} ms (device {_fmt(k3['floor_device_ms'])}); "
          f"plain {k3['plain_ms']:.4g} ms; bound {k3['bound_ms']:.4g} ms by "
          f"{k3['bound_by']} ({k3['nbytes']} bytes)")

    # (d) The served planner at that cell size.
    argv = ["--mode", "plan", "--device", "cuda", "--cells", str(X_CELLS),
            "--cell-users", str(X_N), "--cell-edges", str(X_M), "--top-k",
            str(X_TOP_K), "--seed", "0"]
    args = serve.build_parser().parse_args(argv)
    recs = []

    def run():
        _, svc = serve.build_service(args)
        torch.cuda.synchronize()
        boot = (time.perf_counter() - t0) * 1e3
        snap = run_load(svc, ticks=X_TICKS, req_per_tick=2.0, seed=7,
                        on_tick=recs.append)
        return svc, boot, snap

    t0 = time.perf_counter()
    (svc, boot_ms, snap), counts = _counted(run)
    _add(path, counts)
    cluster_only(counts, "serve")
    _check(counts["topk_moves"] > 0, "serve launched no K3")
    _check(len(recs) == X_TICKS and snap["unserved"] == 0,
           "serve: unserved requests")
    _check(all(math.isfinite(r.sum_R) for r in recs), "serve: non-finite R")
    _check(np.isfinite(svc.alloc.R).all(), "serve: non-finite R")
    _check(((svc.assigns >= 0) & (svc.assigns < X_M)).all(),
           "serve: assignment off the edge range")
    served = dict(cells=X_CELLS, ticks=X_TICKS, bootstrap_ms=boot_ms,
                  plans_per_s=snap["plans_per_s"], tick_ms=snap["tick_ms"],
                  sum_R=recs[-1].sum_R, counts=counts)
    print(f"[x] (d) serve {' '.join(argv[2:])} (N_max = "
          f"{svc.fleet.N_max}): bootstrap {boot_ms:.1f} ms; ticks "
          + "; ".join(f"{r.tick}: changed {r.changed}, replanned "
                      f"{r.replanned.size}, {r.tick_ms:.1f} ms"
                      for r in recs)
          + f"; {snap['plans_per_s']:.4g} plans/s; sum R "
          f"{recs[-1].sum_R:.6g}; launches {json.dumps(counts)}")
    del svc
    seconds = time.perf_counter() - t_phase
    print(f"[x] phase x: {seconds:.1f} s; launches {json.dumps(path)}")
    return {"counts": path, "search": search, "k2": k2, "k3": k3,
            "serve": served, "seconds": seconds}


# Phase f: the paper's training pipeline through its entry point at the
# paper's §VI-A size (N = 50 users, M = 5 edges) on the widest of its CNNs.
TRAIN_ARGV = ["--dataset", "imagenette", "--users", "50", "--edges", "5",
              "--device", "cuda"]
TRAIN_ITERS = 10
# The card against the CPU, per leaf: max |delta| <= TRAIN_TOL * max |leaf|
# (float32 on both, in other summation orders; cuDNN may add its weight
# gradients atomically, so the card is not bitwise even against itself).
TRAIN_TOL = 1e-4


def _train_path(dev) -> dict:
    """Phase f: ``launch.train.main`` (TSIA on K2, the straggler deadline,
    Algorithm 1 over the imagenette CNN with users batched) for 10 global
    iterations, then resumed to 12; one global iteration on the card and
    on the CPU on the same inputs, a participation mask that drops users
    and empties an edge; the uplink compression on both devices; one
    traced global iteration.  Returns the launch counts of the two
    pipeline runs."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.system_model import evaluate
    from repro_torch.data import (DATASET_SHAPES, make_dataset,
                                  partition_to_users)
    from repro_torch.fed import hfl
    from repro_torch.launch import train
    from repro_torch.models import cnn

    t_phase = time.perf_counter()
    path: dict = {}
    with tempfile.TemporaryDirectory() as ckpt:
        # (a) The pipeline, then a resumed run.
        argv = TRAIN_ARGV + ["--iters", str(TRAIN_ITERS), "--ckpt-dir", ckpt]
        run, counts = _counted(lambda: train.main(argv))
        _add(path, counts)
        plan, rep = run.plan, run.report
        scores = len(plan.history.R_trace) + 1      # stage 2 rescores once
        _check(counts["sroa_solve"] == scores,
               f"{counts['sroa_solve']} K2 launches for {scores} TSIA "
               f"scores")
        _check(counts["sroa_solve_lanes"] == counts["sroa_solve"],
               "a plan-time K2 launch took the one-warp-per-problem kernel")
        res = plan.sroa
        cb = evaluate(run.scenario, torch.as_tensor(plan.assign, device=dev),
                      res.b, res.f, res.p, 1.0)
        _check(math.isclose(float(cb.R), plan.R, rel_tol=1e-5),
               f"plan R {plan.R} is not evaluate's {float(cb.R)}")
        acc = run.history["acc"]
        _check(len(acc) == TRAIN_ITERS and all(map(math.isfinite, acc)),
               "accuracy history")
        _check(acc[-1] > acc[0], f"accuracy fell: {acc}")
        ms_iter = rep["train_wall_s"] * 1e3 / TRAIN_ITERS
        print(f"[f] (a) train {' '.join(argv[:-2])}: plan "
              f"{rep['plan_s'] * 1e3:.1f} ms, {scores} TSIA scores "
              f"({rep['plan_s'] * 1e3 / scores:.4g} ms a score), K2 "
              f"launches {counts['sroa_solve']} (lanes "
              f"{counts['sroa_solve_lanes']}); R {plan.R:.6g} == "
              f"evaluate's {float(cb.R):.6g}; deadline {run.deadline:.6g} "
              f"s; {ms_iter:.2f} ms a global iteration (with evaluation "
              f"and checkpoint); accuracy {json.dumps(acc)}")
        argv2 = TRAIN_ARGV + ["--iters", str(TRAIN_ITERS + 2), "--resume",
                              "--ckpt-dir", ckpt]
        run2, counts2 = _counted(lambda: train.main(argv2))
        _add(path, counts2)
        _check(run2.history["iter"] == [TRAIN_ITERS, TRAIN_ITERS + 1]
               and run2.report["global_iters"] == 2,
               f"the resumed run ran iterations {run2.history['iter']}")
        _check(counts2["sroa_solve_lanes"] == counts2["sroa_solve"] > 0,
               "resumed run: K2 off the lanes kernel")
        print(f"[f] (a) --iters {TRAIN_ITERS + 2} --resume: started at step "
              f"{TRAIN_ITERS}, accuracy {json.dumps(run2.history['acc'])}")

    # (b) One global iteration on the card and on the CPU, same inputs.
    cfg = cnn.PAPER_CNNS["imagenette"]
    scn = run.scenario
    N, M = scn.N, scn.M
    ds = make_dataset("imagenette", n_train=4000, n_test=800,
                      shape=DATASET_SHAPES["imagenette"], seed=0)
    x_u, y_u, mask, sizes = partition_to_users(
        ds.x_train, ds.y_train, np.asarray(scn.D.cpu().numpy(), int),
        seed=0)
    assign = np.asarray(plan.assign)
    part = np.ones(N, np.float32)
    part[::7] = 0.0                                    # dropped users
    occupied = np.flatnonzero(np.bincount(assign, minlength=M))
    empty = int(occupied[np.argmin(np.bincount(assign)[occupied])])
    part[assign == empty] = 0.0                        # an edge emptied
    hcfg = hfl.HflConfig(L=2, K=2, lr=0.2)

    def inputs(device):
        d = torch.device(device)
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(assign, dtype=torch.long), M).float()
        return (cnn.tree_map(lambda t: t.detach().to(d), run.weights),
                *(torch.as_tensor(a).to(d) for a in (x_u, y_u, mask)),
                torch.as_tensor(sizes, dtype=torch.float32).to(d),
                onehot.to(d), torch.as_tensor(part).to(d))

    on = {d: inputs(d) for d in ("cuda", "cpu")}

    def iteration(device):
        return hfl.global_iteration(cfg, hcfg, *on[device])

    card, card2 = iteration("cuda"), iteration("cuda")
    t0 = time.perf_counter()
    host = iteration("cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    errs = {}
    for (layer, k), g, g2, c in zip(
            [(la, k) for la in sorted(host) for k in sorted(host[la])],
            cnn.tree_leaves(card), cnn.tree_leaves(card2),
            cnn.tree_leaves(host)):
        scale = float(c.abs().max())
        err = float((g.cpu() - c).abs().max())
        again = float((g - g2).abs().max())
        errs[f"{layer}/{k}"] = dict(err=err, card_again=again, scale=scale)
        _check(err <= TRAIN_TOL * scale and again <= TRAIN_TOL * scale,
               f"{layer}/{k}: card {err:.3g} from the CPU, {again:.3g} from "
               f"itself, past {TRAIN_TOL} x {scale:.3g}")
    ctol = hfl.HflConfig(topk_frac=0.05, int8=True)
    gen = torch.Generator().manual_seed(0)
    upd = cnn.tree_map(lambda t: 0.01 * torch.randn(
        (N,) + tuple(t.shape), generator=gen), on["cpu"][0])
    c_host = hfl._compress_update(ctol, upd)
    c_card = hfl._compress_update(ctol, cnn.tree_map(
        lambda t: t.to(dev), upd))
    for a, b in zip(cnn.tree_leaves(c_card), cnn.tree_leaves(c_host)):
        _check(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)),
               "the compressed update differs between the card and the CPU")
    card_ms = _time_ms(lambda: iteration("cuda"), 5)
    print(f"[f] (b) one global iteration (imagenette, N = {N}, M = {M}, "
          f"K = L = 2; users {np.flatnonzero(part == 0).tolist()} dropped, "
          f"edge {empty} emptied): card {card_ms:.3f} ms (events), CPU "
          f"{cpu_ms:.1f} ms; max |card - CPU| / max |leaf| "
          f"{max(e['err'] / e['scale'] for e in errs.values()):.3g}, card "
          f"run to run {max(e['card_again'] / e['scale'] for e in errs.values()):.3g} "
          f"(tolerance {TRAIN_TOL}); top-k 0.05 + int8 compression bitwise "
          f"on both devices; {json.dumps(errs)}")

    # (c) One traced global iteration.
    stats: dict = {}
    rows = _profile("[f]", "(c) one traced global iteration",
                    lambda: iteration("cuda"), stats)
    launches = sum(r[1] for r in rows if not r[2].startswith("Mem"))
    print(f"[f] (c) {launches} kernel launches a global iteration (of "
          f"{stats['events']} device events); the device busy "
          f"{stats['union_ms']:.2f} of {stats['wall_ms']:.2f} ms (busy "
          f"share {_fmt(_div(stats['union_ms'], stats['wall_ms']), '.4f')}; "
          f"kernel times summed {stats['device_ms']:.2f} ms); five longest "
          f"kernels: " + "; ".join(
              f"{name[:60]} {ms:.3f} ms x {n}" for ms, n, name in rows[:5]))
    seconds = time.perf_counter() - t_phase
    print(f"[f] phase f: {seconds:.1f} s; launches {json.dumps(path)}")
    return {"counts": path, "scores": scores, "plan_ms": rep["plan_s"] * 1e3,
            "hfl": dict(cfg=cfg, hcfg=hcfg, M=M, inputs=on["cpu"],
                        card=card),
            "ms_per_iter": ms_iter, "acc": acc, "card_ms": card_ms,
            "cpu_ms": cpu_ms, "errs": errs, "trace": dict(stats, launches=
                                                          launches),
            "seconds": seconds}


def _lm_path(dev) -> dict:
    """Phase 8: the LM serving path on K4 and on the chunked route."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_lm
    from repro_torch.models import transformer as tf

    chunked = configs.get(LM_ARCH)
    flash = dataclasses.replace(chunked, attn_impl="pallas")
    kw = dict(batch=LM_B, prompt_len=LM_T, seed=0, device=dev)
    run_lm(flash, new_tokens=2, **kw)             # warm-up: cold starts
    torch.cuda.synchronize()
    ops.reset_launches()
    a = run_lm(flash, new_tokens=LM_NEW, **kw)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    b = run_lm(chunked, new_tokens=LM_NEW, **kw)
    torch.cuda.synchronize()
    _check(counts["flash_attention"] == flash.n_layers,
           f"K4 launched {counts['flash_attention']} times in one prefill "
           f"of {flash.n_layers} layers")
    _check(counts["flash_attention_sm90"] == flash.n_layers,
           f"only {counts['flash_attention_sm90']} of the prefill's K4 "
           f"launches took the tensor-core kernel")
    la, lb = a["logits"].float(), b["logits"].float()
    _check(la.shape == (LM_B, flash.vocab), "prefill logits shape")
    _check(bool(torch.isfinite(la).all() & torch.isfinite(lb).all()),
           "non-finite prefill logits")
    rel = float((la - lb).abs().max() / lb.abs().max())
    _check(rel <= LM_LOGIT_RTOL, f"K4 and chunked prefill logits differ by "
           f"{rel:.3g} of max |logit| (limit {LM_LOGIT_RTOL})")
    for out in (a, b):
        toks = out["tokens"]
        _check(toks.shape == (LM_B, LM_NEW + 1) and (toks >= 0).all()
               and (toks < flash.vocab).all(), "generated tokens")
    agree = float(np.mean(a["tokens"] == b["tokens"]))
    print(f"[8] LM {LM_ARCH} full size ({flash.n_layers} layers, d "
          f"{flash.d_model}, vocab {flash.vocab}, {flash.dtype}), B = {LM_B}, "
          f"prompt {LM_T}, {LM_NEW} new tokens")
    print(f"[8] K4 route: prefill {a['prefill_s'] * 1e3:.3f} ms, decode "
          f"{a['tok_per_s']:.1f} tok/s; chunked route: prefill "
          f"{b['prefill_s'] * 1e3:.3f} ms, decode {b['tok_per_s']:.1f} tok/s")
    print(f"[8] K4 launches in the K4 route's run: "
          f"{counts['flash_attention']} (one per layer of one prefill), "
          f"{counts['flash_attention_sm90']} of them on the tensor cores; "
          f"last-position prefill logits max |delta| {rel:.4g} of max "
          f"|logit| {float(lb.abs().max()):.4g} (limit {LM_LOGIT_RTOL}); "
          f"greedy tokens agree at {agree:.4f} of positions "
          f"(identical: {bool(agree == 1.0)})")

    # One more prefill on K4 under the profiler (counts already read).
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = tf.init_params(flash, gen, dev)
        batch = {"tokens": torch.randint(0, flash.vocab, (LM_B, LM_T),
                                         generator=gen, device=dev)}
        prefill = tf.make_prefill_step(flash)
        prefill(params, batch)
        rows = _profile("[q]", "1 traced prefill on K4", lambda: prefill(
            params, batch))
        k4_ms = sum(ms for ms, _, name in rows if "flash_attention" in name)
        k4_n = sum(n for _, n, name in rows if "flash_attention" in name)
        busy = sum(ms for ms, _, _ in rows)
        print(f"[q] K4 share of the traced prefill's device time: "
              f"{k4_ms / busy if busy else float('nan'):.4f} ({k4_ms:.3f} "
              f"of {busy:.3f} ms in {k4_n} launches)")
        logits, cache = prefill(params, batch)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        serve_step = tf.make_serve_step(flash)

        def decode(steps=4):
            nonlocal cache, tok
            for _ in range(steps):
                step_logits, cache = serve_step(params, cache, tok)
                tok = torch.argmax(step_logits[:, -1], -1)[:, None]

        decode()
        _profile("[q]", "4 traced decode steps", decode)
    return {"counts": counts, "flash": a, "chunked": b, "rel": rel,
            "agree": agree, "n_layers": flash.n_layers}


def _f32_lm_path(dev) -> dict:
    """Phase a: qwen1.5-0.5b at full size in float32 on K4 (every launch on
    the 3xTF32 kernel) against the chunked route in float32, TF32 off."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.fed.hfl import f32_math
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_lm
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    chunked = dataclasses.replace(configs.get(LM_ARCH), dtype=torch.float32)
    flash = dataclasses.replace(chunked, attn_impl="pallas")
    kw = dict(batch=LM_B, prompt_len=LM_T, seed=0, device=dev)
    with f32_math():
        run_lm(flash, new_tokens=1, **kw)             # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        a = run_lm(flash, new_tokens=F32_NEW, **kw)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        b = run_lm(chunked, new_tokens=F32_NEW, **kw)
        torch.cuda.synchronize()
    L = flash.n_layers
    _check(counts["flash_attention"] == L
           and counts["flash_attention_sm90_f32"] == L,
           f"of {counts['flash_attention']} K4 launches in the f32 prefill "
           f"of {L} layers, {counts['flash_attention_sm90_f32']} took the "
           f"3xTF32 kernel")
    la, lb = a["logits"].float(), b["logits"].float()
    _check(la.shape == (LM_B, flash.vocab) and bool(
        torch.isfinite(la).all() & torch.isfinite(lb).all()),
        "f32 prefill logits not finite or of the wrong shape")
    rel = float((la - lb).abs().max() / lb.abs().max())
    _check(rel <= F32_LOGIT_RTOL, f"f32 K4 and chunked prefill logits differ "
           f"by {rel:.3g} of max |logit| (limit {F32_LOGIT_RTOL})")
    _check(np.array_equal(a["tokens"], b["tokens"]),
           "f32 greedy tokens differ between K4 and the chunked route")
    print(f"[a] LM {LM_ARCH} full size in float32 ({L} layers, TF32 off), "
          f"B = {LM_B}, prompt {LM_T}, {F32_NEW} new tokens: K4 prefill "
          f"{a['prefill_s'] * 1e3:.3f} ms, decode {a['tok_per_s']:.1f} "
          f"tok/s; chunked prefill {b['prefill_s'] * 1e3:.3f} ms, decode "
          f"{b['tok_per_s']:.1f} tok/s")
    print(f"[a] K4 launches: {counts['flash_attention']} (one a layer), "
          f"{counts['flash_attention_sm90_f32']} on the 3xTF32 kernel; last "
          f"logits max |delta| {rel:.4g} of max |logit| "
          f"{float(lb.abs().max()):.4g} (limit {F32_LOGIT_RTOL}); greedy "
          f"tokens identical")

    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode(), f32_math():
        params = tf.init_params(flash, gen, dev)
        batch = {"tokens": torch.randint(0, flash.vocab, (LM_B, LM_T),
                                         generator=gen, device=dev)}
        prefill = tf.make_prefill_step(flash)
        prefill(params, batch)
        stats = {}
        rows = _profile("[a]", "1 traced f32 prefill on K4",
                        lambda: prefill(params, batch), stats)
        del params
    k4_ms = sum(ms for ms, _, name in rows if "flash_attention" in name)
    k4_n = sum(n for _, n, name in rows if "flash_attention" in name)
    share = _div(k4_ms, stats["device_ms"] or None)
    print(f"[a] K4 share of the traced f32 prefill's device time: "
          f"{_fmt(share, '.4f')} ({k4_ms:.3f} of {stats['device_ms']:.3f} ms "
          f"in {k4_n} launches; {time.perf_counter() - t0:.1f} s)")
    return {"counts": counts, "flash": a, "chunked": b, "rel": rel,
            "k4_share": share, "k4_ms": k4_ms, "n_layers": L,
            "seconds": time.perf_counter() - t0}


def _moe_bounds(cfg, B: int, T: int) -> dict:
    """The least time of phase m's prefill and decode step at the card's
    peaks.  The prefill's operations: B*T tokens through the attention
    projections, the router and the shared expert, E x C capacity slots
    through the routed experts, causal attention, the last position's head.
    A decode step's bytes: every weight but the embedding (of which it
    reads B rows) read once, and the KV cache of T positions."""
    from repro_torch.models.moe import capacity

    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    E, ff, fs, V, L = (cfg.n_experts, cfg.d_ff,
                       cfg.d_ff * cfg.n_shared_experts, cfg.vocab,
                       cfg.n_layers)
    n = B * T
    C = capacity(n, cfg.top_k, E, cfg.capacity_factor)
    qkvo = d * (2 * H * hd + 2 * Hkv * hd)
    layer_flops = (2 * n * qkvo + 4 * hd * B * H * T * (T + 1) // 2
                   + 2 * n * d * E + 6 * E * C * d * ff + 6 * n * d * fs)
    flops = L * layer_flops + 2 * B * d * V
    width = cfg.dtype.itemsize
    layer_bytes = width * (qkvo + d * E + 3 * E * d * ff + 3 * d * fs
                           + 2 * d)
    step_bytes = (L * layer_bytes + width * (d * V + d)
                  + L * 2 * B * T * Hkv * hd * width)
    prefill_ms = flops / BF16_TENSOR_FLOPS_PER_S * 1e3
    step_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    return dict(capacity=C, prefill_flops=flops, prefill_ms=prefill_ms,
                step_bytes=step_bytes, step_ms=step_ms,
                tok_per_s=B / step_ms * 1e3)


def _moe_path(dev) -> dict:
    """Phase m: the moe family through ``run_lm`` at llama4-scout's full
    width and 12 layers, on K4; then, on the same weights, K4 against the
    chunked route layer by layer, the dispatch on the card against the
    CPU, and one traced prefill and four traced decode steps."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm

    t_phase = time.perf_counter()
    chunked = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_LAYERS)
    flash = dataclasses.replace(chunked, attn_impl="pallas")
    L, V, d, n = flash.n_layers, flash.vocab, flash.d_model, LM_B * LM_T
    kw = dict(batch=LM_B, prompt_len=LM_T, seed=0, device=dev)
    # One set of weights at a time: each run_lm frees its own on return.
    run_lm(flash, new_tokens=2, **kw)             # warm-up: cold starts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    a = run_lm(flash, new_tokens=LM_NEW, **kw)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check(counts["flash_attention"] == L,
           f"K4 launched {counts['flash_attention']} times in one prefill "
           f"of {L} layers")
    _check(counts["flash_attention_sm90"] == L,
           f"only {counts['flash_attention_sm90']} of the moe prefill's K4 "
           f"launches took the tensor-core kernel")
    logits, toks = a["logits"].float(), a["tokens"]
    _check(logits.shape == (LM_B, V) and bool(torch.isfinite(logits).all()),
           "moe prefill logits: shape or non-finite values")
    _check(toks.shape == (LM_B, LM_NEW + 1) and (toks >= 0).all()
           and (toks < V).all(), "moe generated tokens")
    bnd = _moe_bounds(flash, LM_B, LM_T)
    step_ms = a["decode_s"] * 1e3 / LM_NEW
    print(f"[m] {MOE_ARCH} at full width, {L} of 48 layers (d {d}, "
          f"{flash.n_heads} heads of {flash.head_dim}, {flash.n_kv_heads} kv "
          f"heads, d_ff {flash.d_ff}, {flash.n_experts} experts top-"
          f"{flash.top_k} + {flash.n_shared_experts} shared, vocab {V}, "
          f"{flash.dtype}), B = {LM_B}, prompt {LM_T}, {LM_NEW} new tokens, "
          f"on K4")
    print(f"[m] prefill {a['prefill_s'] * 1e3:.3f} ms (bound "
          f"{bnd['prefill_ms']:.4g} ms: {bnd['prefill_flops']:.4g} flop at "
          f"989 TFLOP/s; capacity {bnd['capacity']} per expert); decode "
          f"{a['tok_per_s']:.2f} tok/s, {step_ms:.3f} ms a step (bound "
          f"{bnd['step_ms']:.4g} ms: {bnd['step_bytes']:.4g} bytes at 3.35 "
          f"TB/s, {bnd['tok_per_s']:.4g} tok/s); peak memory allocated "
          f"{peak:,} bytes ({peak / 2 ** 30:.2f} GiB)")
    print(f"[m] K4 launches in the run: {counts['flash_attention']} (one per "
          f"layer of one prefill), {counts['flash_attention_sm90']} on the "
          f"tensor cores; first sequence {toks[0][:12].tolist()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        # run_lm's weights and prompts again: the same generator sequence.
        params = tf.init_params(flash, gen, dev)
        batch = {"tokens": torch.randint(0, V, (LM_B, LM_T), generator=gen,
                                         device=dev)}
        # (b) Layer by layer on the K4 route's input: a flip of routing
        # changes only its own layer's output.
        x, positions, _ = tf.embed_inputs(flash, params, batch)
        xc = x                        # the chunked route's own stream
        blocks, layers, logits0 = params["blocks"], [], None
        for i, (pa, pm) in enumerate(zip(tf._layers(blocks["attn"]),
                                         tf._layers(blocks["moe"]))):
            out = []
            for cfg in (flash, chunked):
                xa, _ = tf._attn_apply(cfg, pa, x, positions=positions)
                lr = (rms_norm(xa, pm["ln"]).reshape(1, n, d)
                      @ pm["router"]).float()
                out.append((tf._ffn_apply(cfg, pm, xa)[0], lr,
                            moe_lib.route(lr, cfg.top_k,
                                          cfg.capacity_factor)))
            (yf, lf, rf), (yc, _, rc) = out
            logits0 = lf if logits0 is None else logits0
            same = (rf.expert_idx == rc.expert_idx).all(-1).reshape(n)
            kept = (rf.keep == rc.keep).reshape(n, -1).all(-1)
            delta = (yf.float() - yc.float()).abs().reshape(n, d)
            scale = float(yc.float().abs().max())
            rel = float(delta[same & kept].max()) / scale
            layers.append(dict(rel=rel, rel_all=float(delta.max()) / scale,
                               flips=int((~same).sum()),
                               keep_flips=int((same & ~kept).sum()),
                               dropped=int((~rf.keep).sum()),
                               max_load=int(rf.load.max())))
            _check(rel <= MOE_LAYER_RTOL,
                   f"layer {i}: K4 and chunked outputs differ by {rel:.3g} "
                   f"of max |x| on the tokens routed alike (limit "
                   f"{MOE_LAYER_RTOL})")
            xa, _ = tf._attn_apply(chunked, pa, xc, positions=positions)
            xc = tf._ffn_apply(chunked, pm, xa)[0]
            x = yf
        lk = tf.unembed(flash, params, x[:, -1:])[:, 0].float()
        lc = tf.unembed(chunked, params, xc[:, -1:])[:, 0].float()
        gap = float((lk - lc).abs().max() / lc.abs().max())
        same_top = float((lk.argmax(-1) == lc.argmax(-1)).float().mean())
        rerun = float((lk - logits).abs().max())
        for i, r in enumerate(layers):
            print(f"[m] layer {i:2d}: K4 vs chunked max |delta| "
                  f"{r['rel']:.4g} of max |x| on the tokens routed alike "
                  f"(all tokens {r['rel_all']:.4g}; limit {MOE_LAYER_RTOL}); "
                  f"top-1 flips {r['flips']} of {n}, keep flips "
                  f"{r['keep_flips']}; K4 route: {r['dropped']} pairs "
                  f"dropped, max load {r['max_load']}")
        print(f"[m] whole model, each route on its own stream: last-position "
              f"logits max |delta| {gap:.4g} of max |logit|, the same top "
              f"token in {same_top:.4f} of sequences (information); the "
              f"layer-by-layer K4 stream against run_lm's prefill logits: "
              f"max |delta| {rerun:.4g}")

        # (c) The dispatch on the card against the CPU, bitwise, on f32
        # logits with rows of exact ties: layer 0's router logits (E 16,
        # k 1) and bfloat16-grid draws at kimi-k2's E 384, k 8.
        g = torch.Generator(device=dev).manual_seed(1)
        l384 = torch.randn((1, n, 384), generator=g, device=dev).to(
            torch.bfloat16).float()
        for name, lg, k in (("llama4-scout", logits0.clone(), 1),
                            ("kimi-k2", l384, 8)):
            E = lg.shape[-1]
            lg[0, 0] = 0.5
            lg[0, 1, [0, E // 2, E - 1]] = float(lg[0, 1].max()) + 1.0
            rg = moe_lib.route(lg, k, 1.25)
            rh = moe_lib.route(lg.cpu(), k, 1.25)
            _check(rg.capacity == rh.capacity, f"{name}: capacity")
            for field in ("expert_idx", "pos", "keep", "load"):
                _check(torch.equal(getattr(rg, field).cpu(),
                                   getattr(rh, field)),
                       f"{name}: {field} differs between the card and the "
                       f"CPU")
            top = torch.sort(rh.probs[0], -1, descending=True).values
            ties = int((top[:, :k] == top[:, 1:k + 1]).any(-1).sum())
            print(f"[m] dispatch {name} (E {E}, k {k}, {n} tokens): "
                  f"expert_idx, pos, keep and load bitwise on the card and "
                  f"the CPU; capacity {rg.capacity}, {ties} rows with an "
                  f"exact tie at or across the k-th place, "
                  f"{int((~rh.keep).sum())} pairs dropped")

        # (d) One traced prefill and four traced decode steps.
        prefill = tf.make_prefill_step(flash)
        prefill(params, batch)
        traced = {"prefill": {}, "decode": {}}
        rows = _profile("[m]", "1 traced prefill on K4", lambda: prefill(
            params, batch), traced["prefill"], MOE_RANGES)
        traced["prefill"]["k4_ms"] = sum(
            ms for ms, _, nm in rows if "flash_attention" in nm)
        step_logits, cache = prefill(params, batch)
        tok = torch.argmax(step_logits[:, -1], -1)[:, None]
        serve_step = tf.make_serve_step(flash)

        def decode(steps=4):
            nonlocal cache, tok
            for _ in range(steps):
                step_logits, cache = serve_step(params, cache, tok)
                tok = torch.argmax(step_logits[:, -1], -1)[:, None]

        decode()
        rows = _profile("[m]", "4 traced decode steps", decode,
                        traced["decode"], MOE_RANGES)
        traced["decode"]["k4_ms"] = sum(
            ms for ms, _, nm in rows if "flash_attention" in nm)
        for what, st in traced.items():
            rg = st["ranges"]
            rest = st["device_ms"] - sum(rg.values()) - st["k4_ms"]
            print(f"[m] traced {what}: device {st['device_ms']:.3f} ms of "
                  f"{st['wall_ms']:.3f} ms wall (busy share "
                  f"{_fmt(_div(st['union_ms'], st['wall_ms']), '.4f')}); "
                  f"router and dispatch {rg['moe.dispatch']:.3f} ms, expert "
                  f"products {rg['moe.experts']:.3f} ms, combine "
                  f"{rg['moe.combine']:.3f} ms, shared expert "
                  f"{rg['moe.shared']:.3f} ms, K4 {st['k4_ms']:.3f} ms, the "
                  f"rest {rest:.3f} ms")
        del params, cache
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[m] phase m: {seconds:.1f} s")
    return {"counts": counts, "run": a, "peak_bytes": peak, "bounds": bnd,
            "flips": [r["flips"] for r in layers], "seconds": seconds,
            "n_layers": L}


def _wall_ms(fn) -> float:
    """Host-clock ms of one synchronised call of ``fn``, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _ssm_bounds(cfg, B: int, T: int) -> dict:
    """The least time of phase s's prefill and decode step at the card's
    peaks, for the hybrid and xlstm families.  The prefill's operations:
    B*T tokens through every projection (bf16, tensor cores) and, for the
    hybrid, causal attention in each of its L // attn_every shared blocks;
    the time loops' float32 arithmetic on the states (per state element a
    step: Mamba2 5, the decay, the rank-one update, the add and the
    read-out's multiply-add; mLSTM 6; sLSTM its recurrence product) apart,
    at the FP32 peak; the last position's head.  A decode step's bytes:
    every weight but the embedding (of which it reads B rows) read once,
    and the hybrid's shared block once for each of its G applications
    (0.41 GB at zamba2's width: no cache holds it between groups); the
    recurrent states read and written; the K/V ring of T positions read."""
    from repro_torch.models import ssm

    d, V, L, n = cfg.d_model, cfg.vocab, cfg.n_layers, B * T
    w = cfg.dtype.itemsize
    if cfg.family == "mamba_hybrid":
        H, Hkv, hd, ds = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.ssm_state)
        d_inner, Hs = ssm.mamba2_dims(d, ds, cfg.ssm_headdim)
        G = L // cfg.attn_every
        proj = d * (2 * d_inner + 2 * ds + Hs) + d_inner * d
        conv_c = d_inner + 2 * ds
        shared = d * (2 * H * hd + 2 * Hkv * hd) + 3 * d * cfg.d_ff
        mm_flops = (L * 2 * n * proj
                    + G * (2 * n * shared + 4 * hd * B * H * T * (T + 1) // 2)
                    + 2 * B * d * V)
        state = Hs * ds * cfg.ssm_headdim               # a token, a layer
        f32_flops = L * n * 5 * state
        weights = w * (L * (proj + ssm.CONV_W * conv_c + d) + d * V + d) \
            + 4 * 3 * L * Hs
        shared_bytes = G * w * (shared + 2 * d)
        states = 2 * L * B * (4 * state + w * (ssm.CONV_W - 1) * conv_c)
        kv = G * 2 * B * min(cfg.window or T, T) * Hkv * hd * w
    else:
        H = cfg.n_heads
        hd = d // H
        L2 = L // 2
        proj = 9 * d * d + 2 * d * H                    # an m/s pair
        mm_flops = L2 * 2 * n * proj + 2 * B * d * V
        f32_flops = L2 * n * (6 * H * hd * hd + 2 * H * hd * 4 * hd)
        weights = w * (L2 * (proj + 4 * H * hd * hd + 2 * d) + d * V + d)
        shared_bytes = 0
        states = 2 * L2 * B * 4 * (H * hd * hd + H * hd + H + 4 * H * hd)
        kv = 0
    step_bytes = weights + shared_bytes + states + kv + B * d * w
    mm_ms = mm_flops / BF16_TENSOR_FLOPS_PER_S * 1e3
    f32_ms = f32_flops / FP32_FLOPS_PER_S * 1e3
    step_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    return dict(prefill_flops=mm_flops, prefill_f32_flops=f32_flops,
                prefill_ms=max(mm_ms, f32_ms), prefill_mm_ms=mm_ms,
                prefill_f32_ms=f32_ms, step_bytes=step_bytes,
                step_weight_bytes=weights, step_shared_bytes=shared_bytes,
                step_state_bytes=states, step_kv_bytes=kv, step_ms=step_ms,
                tok_per_s=B / step_ms * 1e3)


def _ssm_serve(cfg, dev, tag: str) -> dict:
    """``run_lm`` at B = 4, T = 1,024, 32 tokens, after a warm-up at a
    64-token prompt (a full-length warm-up would cost a whole prefill of
    the time loop); launch counts from 0 and the peak memory of the
    timed run.  Checks finite logits and tokens in range."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_lm

    kw = dict(batch=LM_B, seed=0, device=dev)
    run_lm(cfg, prompt_len=64, new_tokens=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = run_lm(cfg, prompt_len=LM_T, new_tokens=LM_NEW, **kw)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    logits, toks = out["logits"].float(), out["tokens"]
    _check(logits.shape == (LM_B, cfg.vocab)
           and bool(torch.isfinite(logits).all()),
           f"{tag} prefill logits: shape or non-finite values")
    _check(toks.shape == (LM_B, LM_NEW + 1) and (toks >= 0).all()
           and (toks < cfg.vocab).all(), f"{tag} generated tokens")
    bnd = _ssm_bounds(cfg, LM_B, LM_T)
    step_ms = out["decode_s"] * 1e3 / LM_NEW
    print(f"[s] {tag}: prefill {out['prefill_s'] * 1e3:.3f} ms (bound "
          f"{bnd['prefill_ms']:.4g} ms: {bnd['prefill_flops']:.4g} bf16 flop "
          f"at 989 TFLOP/s = {bnd['prefill_mm_ms']:.4g} ms, the time loops' "
          f"{bnd['prefill_f32_flops']:.4g} f32 flop at 67 TFLOP/s = "
          f"{bnd['prefill_f32_ms']:.4g} ms); decode {out['tok_per_s']:.2f} "
          f"tok/s, {step_ms:.3f} ms a step (bound {bnd['step_ms']:.4g} ms: "
          f"{bnd['step_bytes']:.4g} bytes at 3.35 TB/s, weights "
          f"{bnd['step_weight_bytes']:.4g}, shared block re-reads "
          f"{bnd['step_shared_bytes']:.4g}, states "
          f"{bnd['step_state_bytes']:.4g}, K/V {bnd['step_kv_bytes']:.4g}; "
          f"{bnd['tok_per_s']:.4g} tok/s); peak memory allocated "
          f"{peak:,} bytes ({peak / 2 ** 30:.2f} GiB); first sequence "
          f"{toks[0][:12].tolist()}")
    return {"run": out, "counts": counts, "peak_bytes": peak, "bounds": bnd,
            "step_ms": step_ms}


# S1-S3 (csrc/ssm_scan.cu): each op's name, its kernel's name in a trace,
# the ``lax.scan`` it replaces, and how many of its leading operands run
# along the time axis (sLSTM's R and every state follow them).
SSM_SCANS = {
    "mamba2_scan": ("mamba2_scan_kernel", "src/repro/models/ssm.py:103", 4),
    "mlstm_scan": ("mlstm_scan_kernel", "src/repro/models/ssm.py:159", 5),
    "slstm_scan": ("slstm_scan_kernel", "src/repro/models/ssm.py:205", 4),
}
# S1b-S3b (csrc/ssm_scan_bwd.cu): each backward op's counter, its kernel's
# name in a trace, and the ``lax.scan`` whose autodiff it replaces; S3b's
# two (its short step, and its barrier kernel, forced only).
SSM_BWD = {
    "mamba2_scan_bwd": ("mamba2_scan_bwd_kernel",
                        "src/repro/models/ssm.py:103"),
    "mlstm_scan_bwd": ("mlstm_scan_bwd_kernel", "src/repro/models/ssm.py:159"),
    "slstm_scan_bwd": ("slstm_scan_bwd_kernel", "src/repro/models/ssm.py:205"),
    "slstm_scan_bwd_short": ("slstm_bwd_short_kernel",
                             "src/repro/models/ssm.py:205"),
}
# Each kernel against its twin: max |delta| within this share of max |.|
# of y and of each state, or of each gradient (the read-outs, sLSTM's
# h . R and the backward's contractions add in other orders; phase s
# (d)'s limit).
SSM_KERNEL_TOL = 1e-4


def _scan_operands(fn) -> dict:
    """A copy of the operands of each recurrence op's first call in
    ``fn()``, by op name ("mamba2_scan", ...)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Capture(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.args = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "repro_torch" and \
                    func._opname not in self.args:
                self.args[func._opname] = tuple(a.clone() for a in args)
            return func(*args, **(kwargs or {}))

    with Capture() as cap:
        fn()
    return cap.args


def _ssm_f32_flops(name: str, B: int, T: int, H: int, hd: int,
                   ds: int = 0) -> int:
    """Phase s's float32 count of one recurrence (``_ssm_bounds``'s per
    layer): Mamba2 5 a state element a step, mLSTM 6, sLSTM its h . R."""
    if name == "mamba2_scan":
        return B * T * 5 * H * ds * hd
    if name == "mlstm_scan":
        return B * T * 6 * H * hd * hd
    return B * T * 2 * H * hd * 4 * hd


def _ssm_kernel_row(name: str, args: tuple, tag: str, time_it: bool = True,
                    carry: bool = True) -> dict:
    """One recurrence kernel against its plain twin on the same operands
    ``args`` (each op's own order): with ``carry`` the state the kernel
    leaves after the T steps from the given one is carried in, then the
    kernel and the twin run from it over all T steps and over the first
    step alone (the decode shape).  Raises past ``SSM_KERNEL_TOL`` of max
    |.| on y or any state.  With ``time_it`` at all T: CUDA-event ms of
    one call, its device ms (``_queued_ms``), the twin's ms (the host clock
    around the checking call at all T, synchronised) and the bound
    (operands read and outputs written once; ``_ssm_f32_flops`` at the
    FP32 peak)."""
    import torch

    from repro_torch.kernels import ops, ref, ssm_scan

    op = getattr(ssm_scan, name)
    twin = getattr(ref, name.replace("_scan", "_recurrence_plain"))
    kernel, replaces, n_time = SSM_SCANS[name]
    first = op(*args)
    if carry:
        args = args[:-(len(first) - 1)] + tuple(first[1:])
    torch.cuda.synchronize()
    B, T, H, hd = first[0].shape
    step = tuple(a[:, :1] for a in args[:n_time]) + args[n_time:]
    row = {"name": name, "shape": [B, T, H, hd]}
    for key, ops_ in (("T", args), ("T1", step)):
        before = ops.LAUNCHES[name]
        got = op(*ops_)
        torch.cuda.synchronize()
        _check(ops.LAUNCHES[name] == before + 1, f"{name} did not launch")
        t0 = time.perf_counter()
        want = twin(*ops_)
        torch.cuda.synchronize()
        twin_ms = (time.perf_counter() - t0) * 1e3
        rels = [_rel_err(g, w) for g, w in zip(got, want)]
        _check(all(g.shape == w.shape for g, w in zip(got, want))
               and max(rels) <= SSM_KERNEL_TOL,
               f"{tag} {name} at T = {ops_[0].shape[1]}: max |delta| / max "
               f"|.| of (y, states) {rels} (limit {SSM_KERNEL_TOL})")
        row[f"rel_{key}"] = rels
        row[f"state_bitwise_{key}"] = all(
            torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
        if key == "T":
            row["max_abs_err"] = _max_abs_err(got, want)
            row["plain_ms"] = twin_ms
    if time_it:
        call = lambda: op(*args)  # noqa: E731
        flops = _ssm_f32_flops(name, B, T, H, hd)
        nbytes = sum(a.numel() * 4 for a in args) + sum(
            y.numel() * 4 for y in op(*args))
        bound, by = _bound_ms(nbytes, flops)
        row.update(ms=_time_ms(call, 10), device_ms=_queued_ms(call, 10),
                   bound_ms=bound, bound_by=by, f32_flops=flops,
                   nbytes=nbytes)
    print(f"{tag} {name} ({kernel}) at (B, T, H, hd) = {row['shape']}"
          f", a state carried in: max |delta| / max |.| of (y, states) "
          f"{json.dumps([float(f'{r:.3g}') for r in row['rel_T']])} over "
          f"T = {T} and "
          f"{json.dumps([float(f'{r:.3g}') for r in row['rel_T1']])} at "
          f"T = 1 (limit {SSM_KERNEL_TOL}); states bitwise the twin's: "
          f"{row['state_bitwise_T']} and {row['state_bitwise_T1']}"
          + (f"; {row['ms']:.4g} ms events, {row['device_ms']:.4g} ms "
             f"device, twin {row['plain_ms']:.4g} ms, bound "
             f"{row['bound_ms']:.4g} ms by {row['bound_by']} "
             f"({row['f32_flops']:.4g} f32 flop, {row['nbytes']:.4g} bytes)"
             if time_it else ""))
    return row


def _ssm_bwd_f32_flops(name: str, B: int, T: int, H: int, hd: int,
                       ds: int = 0) -> int:
    """The float32 count of one backward recurrence, the recompute of the
    states included: S1b 14 a state element a step (the forward's 3, the
    adjoint's update 3 and four contractions 8), S2b 15 a C element a step
    (the forward's 4, 3 and 8), S3b its three products of h . R's size (the
    recomputed h . R, dR and dpre . R^T)."""
    if name == "mamba2_scan_bwd":
        return B * T * 14 * H * ds * hd
    if name == "mlstm_scan_bwd":
        return B * T * 15 * H * hd * hd
    return B * T * 3 * 2 * H * hd * 4 * hd


# S2b's and S3b's two kernels each, the routed one first: (route, the
# counter of its calls).  S3b's barrier kernel runs only when forced, and S2b's
# sequential one below MLSTM_CHUNKED_MIN_T steps.
SSM_BWD_ROUTES = {
    "mlstm_scan_bwd": (("chunked", "mlstm_scan_bwd_chunked"),
                       ("sequential", "mlstm_scan_bwd")),
    "slstm_scan_bwd": (("short", "slstm_scan_bwd_short"),
                       ("barrier", "slstm_scan_bwd")),
}
# The T sweep of both S2b kernels around their crossover
# (MLSTM_CHUNKED_MIN_T's source; PERF.md keeps the sweep to T = 1,024).
MLSTM_SWEEP_T = (1, 8, 16)


def _mlstm_chunked_flops(B: int, T: int, H: int, hd: int) -> int:
    """The chunked S2b's chunk products at their fewest (as
    ``_ssd_chunked_flops`` counts S1b's): a (b, h, chunk) of L steps with
    hd + 1 value columns (v and n), G = q k^T once, each product's
    multiply-adds counted twice, once (the 3xTF32 split runs each three
    times); the chunk's end state from its start (the saving forward's
    work in the chunk form) among them."""
    from repro_torch.kernels import ssm_scan

    L, nC, V = ssm_scan.S2_CHUNK, -(-T // ssm_scan.S2_CHUNK), hd + 1
    per = (2 * L * L * hd                   # G = q k^T
           + 2 * L * L * V                  # D = dY U^T
           + 2 * L * V * (L + hd)           # dU
           + 2 * 2 * L * hd * (L + V)       # dk, dq
           + 2 * 2 * hd * V * L             # A_prev, the end state
           + 2 * L * L * L)                 # F
    return per * B * H * nC


def _part_call(fn, tensors, ints):
    """One launch of a backward op's plan (``ssm_scan.*_bwd_plan``) alone,
    on the current stream, raising on a launch error."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sroa_bisect import _stream

    def call():
        build.check(fn(*(None if t is None else t.data_ptr()
                         for t in tensors), *ints, _stream(tensors[0])),
                    "part")
    return call


def _ssm_bwd_rows(name: str, args: tuple, tag: str,
                  time_it: bool = True) -> dict:
    """S2b or S3b (``name``) on both its kernels, forced on the same
    operands: the forward op's ``args`` with the state the forward leaves
    after the T steps carried in, and seeded upstream gradients of every
    output, final states too.  Each kernel against the backward twin over
    all T steps and over the first step alone (``SSM_KERNEL_TOL`` of max
    |.| of every gradient), the chunked S2b also against its model
    (``ref.mlstm_chunked_bwd_plain``, ``SSD_MODEL_TOL``).  With
    ``time_it``: each kernel's events and device ms (``_queued_ms``) of the
    op, the device ms of each of its launches alone (the saving forward,
    the reverse kernels, the stabiliser's; for the sequential S2b its stabiliser
    kernel alone too), the plain version's host ms (the
    model's for the chunked S2b, else the twin's), and the bound (operands and upstream
    gradients read and the gradients written once; the chunked S2b's
    products counted once at the TF32 peak, ``_mlstm_chunked_flops``,
    beside the sequential kernel's operations bound; else ``_ssm_bwd_f32_flops`` at the
    FP32 peak); S2b's T sweep and S3b's handshake floor (T steps of the
    walk's handshake alone, the cluster barrier and the mbarrier).  Returns
    rows by counter name, and "sweep" or "floor"."""
    import torch

    from repro_torch.kernels import build, ops, ref, ssm_scan

    fwd = name[:-len("_bwd")]
    op, routed = getattr(ssm_scan, fwd), getattr(ssm_scan, name + "_cuda")
    plan = getattr(ssm_scan, fwd.split("_")[0] + "_bwd_plan")
    twin = getattr(ref, fwd.replace("_scan", "_recurrence_bwd_plain"))
    n_time = SSM_SCANS[fwd][2]
    first = op(*args)
    args = args[:-(len(first) - 1)] + tuple(first[1:])
    outs = op(*args)
    gen = torch.Generator(device=outs[0].device).manual_seed(26)
    ups = tuple(torch.randn(o.shape, generator=gen, device=o.device)
                for o in outs)
    bargs = args + (outs[0],) + ups
    step = tuple(a[:, :1] for a in args[:n_time]) + args[n_time:]
    bstep = step + (op(*step)[0], ups[0][:, :1]) + ups[1:]
    del first, outs
    torch.cuda.synchronize()
    B, T, H, hd = args[0].shape
    rows, plain = {}, {}
    for key, ba in (("T", bargs), ("T1", bstep)):
        t0 = time.perf_counter()
        want = twin(*ba)
        torch.cuda.synchronize()
        plain[key] = (time.perf_counter() - t0) * 1e3
        model = None
        if fwd == "mlstm_scan":
            t0 = time.perf_counter()
            model = ref.mlstm_chunked_bwd_plain(*ba)
            torch.cuda.synchronize()
            plain["model_" + key] = (time.perf_counter() - t0) * 1e3
        for route, counter in SSM_BWD_ROUTES[name]:
            before = ops.LAUNCHES[counter]
            got = routed(*ba, _route=route)
            torch.cuda.synchronize()
            _check(ops.LAUNCHES[counter] == before + 1,
                   f"{counter} did not launch")
            rels = [_rel_err(g, w) for g, w in zip(got, want)]
            _check(all(g.shape == w.shape for g, w in zip(got, want))
                   and max(rels) <= SSM_KERNEL_TOL,
                   f"{tag} {counter} at T = {ba[0].shape[1]}: max |delta| / "
                   f"max |.| of the gradients {rels} (limit "
                   f"{SSM_KERNEL_TOL})")
            row = rows.setdefault(counter, {"name": counter, "route": route,
                                            "shape": [B, T, H, hd]})
            row[f"rel_{key}"] = rels
            if model is not None and route == "chunked":
                mrel = [_rel_err(g, w) for g, w in zip(got, model)]
                _check(max(mrel) <= SSD_MODEL_TOL, f"{tag} {counter} at T "
                       f"= {ba[0].shape[1]}: max |delta| / max |.| {mrel} "
                       f"against the chunked model (limit {SSD_MODEL_TOL})")
                row[f"rel_model_{key}"] = mrel
            if key == "T":
                row["max_abs_err"] = _max_abs_err(got, want)
            del got
        del want, model
    for row in rows.values():
        row["plain_ms"] = plain["model_T" if row["route"] == "chunked"
                                else "T"]
    if time_it:
        lib = build.load()
        for route, counter in SSM_BWD_ROUTES[name]:
            row = rows[counter]
            call = (lambda r: lambda: routed(*bargs, _route=r))(route)
            grads = call()
            nbytes = sum(a.numel() * 4 for a in bargs) + sum(
                g.numel() * 4 for g in grads)
            del grads
            flops = _ssm_bwd_f32_flops(name, B, T, H, hd)
            bound, by = _bound_ms(nbytes, flops)
            row.update(f32_flops=flops, nbytes=nbytes)
            if route == "chunked":
                row.update(bound_f32_ms=bound, bound_f32_by=by)
                tf = _mlstm_chunked_flops(B, T, H, hd)
                bound, by = _bound_ms(nbytes, tf, TF32_TENSOR_FLOPS_PER_S)
                row.update(tf32_flops=tf, tf32x3_flops=3 * tf)
            row.update(ms=_time_ms(call, 5), device_ms=_queued_ms(call, 5),
                       bound_ms=bound, bound_by=by)
            _, calls, sc, bufs = plan(bargs, route)
            row["parts"] = {label: _queued_ms(_part_call(fn, ts, ints), 5)
                            for label, fn, ts, ints in calls}
            if counter == "mlstm_scan_bwd":
                li, lf, m0, dm = bargs[3], bargs[4], bargs[7], bargs[12]
                dv, dli, dlf, dC0, dn0, dm0 = bufs
                row["parts"]["mlstm_gates_bwd_kernel alone"] = _queued_ms(
                    _part_call(lib.mlstm_gates_bwd_seq, (
                        li, lf, m0, dm, sc["dfi"], sc["scrM"], dli, dlf,
                        dm0), (B, T, H, sc["dfi"].shape[1])), 5)
            del sc, bufs
        if fwd == "mlstm_scan":
            sweep = []
            for t in MLSTM_SWEEP_T:
                a = (tuple(x[:, :t] for x in bargs[:5]) + bargs[5:8]
                     + (bargs[8][:, :t], bargs[9][:, :t]) + bargs[10:])
                sweep.append({"T": t, **{
                    route: _queued_ms((lambda r, x: lambda: routed(
                        *x, _route=r))(route, a), 5)
                    for route, _ in SSM_BWD_ROUTES[name]}})
            rows["sweep"] = sweep
        else:
            out = torch.empty(B * H * hd, device=bargs[0].device)
            rows["floor"] = {"T": T, **{
                kind: _queued_ms(_part_call(
                    lib.slstm_handshake_floor, (out,),
                    (mode, B, T, H, hd)), 5)
                for kind, mode in (("barrier", 0), ("mbarrier", 1))}}
    for counter, row in rows.items():
        if counter in ("sweep", "floor"):
            continue
        kernel = (SSM_CHUNKED[counter][0] if counter in SSM_CHUNKED
                  else SSM_BWD[counter][0])
        model = (f"; against the chunked model "
                 f"{json.dumps([float(f'{r:.3g}') for r in row['rel_model_T']])}"
                 f" and "
                 f"{json.dumps([float(f'{r:.3g}') for r in row['rel_model_T1']])}"
                 f" (limit {SSD_MODEL_TOL})" if "rel_model_T" in row else "")
        timed = ""
        if "ms" in row:
            extra = (f"; {row['tf32_flops']:.4g} flop of chunk products at "
                     f"TF32, {row['tf32x3_flops']:.4g} run by the 3xTF32 "
                     f"split; the sequential kernel's operations bound "
                     f"{row['bound_f32_ms']:.4g} ms by {row['bound_f32_by']}"
                     if "tf32_flops" in row else
                     f"; {row['f32_flops']:.4g} f32 flop")
            timed = (f"; {row['ms']:.4g} ms events, {row['device_ms']:.4g} "
                     f"ms device (alone: " + ", ".join(
                         f"{k} {v:.4g}" for k, v in row["parts"].items())
                     + f"), plain {row['plain_ms']:.4g} ms, bound "
                     f"{row['bound_ms']:.4g} ms by {row['bound_by']} "
                     f"({row['nbytes']:.4g} bytes{extra})")
        print(f"{tag} {counter} ({kernel}, the {row['route']} route) at (B, "
              f"T, H, hd) = {row['shape']}, a state carried in, every "
              f"output's upstream gradient: max |delta| / max |.| of the "
              f"gradients {json.dumps([float(f'{r:.3g}') for r in row['rel_T']])}"
              f" over T = {T} and "
              f"{json.dumps([float(f'{r:.3g}') for r in row['rel_T1']])} at "
              f"T = 1 (limit {SSM_KERNEL_TOL}){model}{timed}")
    if "sweep" in rows:
        print(f"{tag} S2b by T, device ms (_queued_ms) at (B, H, hd) = ({B}, "
              f"{H}, {hd}): " + "; ".join(
                  f"T {r['T']}: " + ", ".join(
                      f"{k} {v:.4g}" for k, v in r.items() if k != "T")
                  for r in rows["sweep"]))
    if "floor" in rows:
        f = rows["floor"]
        print(f"{tag} S3b's handshake floor (its cluster shape, {B * H} "
              f"clusters of 8 blocks of {2 * hd} threads, {T} steps of the "
              f"handshake alone): the cluster barrier {f['barrier']:.4g} ms "
              f"({f['barrier'] / max(T, 1) * 1e3:.4g} us a step), the "
              f"mbarrier {f['mbarrier']:.4g} ms "
              f"({f['mbarrier'] / max(T, 1) * 1e3:.4g} us a step)")
    return rows


# The chunked kernels: S1 and S1b's (csrc/ssd_chunked.cu, the route
# ``ssm_scan.mamba2_route`` gives long sequences) and S2b's
# (csrc/mlstm_chunked.cu, ``ssm_scan.mlstm_route``'s): each counter's name,
# its kernel's name in a trace, and the ``lax.scan`` it replaces.
SSM_CHUNKED = {
    "mamba2_scan_chunked": ("mamba2_chunked_kernel",
                            "src/repro/models/ssm.py:103"),
    "mamba2_scan_bwd_chunked": ("mamba2_chunked_bwd_kernel",
                                "src/repro/models/ssm.py:103"),
    "mlstm_scan_bwd_chunked": ("mlstm_chunked_bwd_kernel",
                               "src/repro/models/ssm.py:159"),
}
# The chunked kernels against their plain model (ref.mamba2_chunked_plain
# and _bwd_plain: the same chunks and products, the 3xTF32 split summed
# exactly): max |delta| within this share of max |.|; against the
# sequential twins they are held to SSM_KERNEL_TOL like every kernel.
SSD_MODEL_TOL = 1e-5
# The T sweep of both S1 and both S1b kernels (MAMBA2_CHUNKED_MIN_T's
# source).
SSD_SWEEP_T = (1, 8, 32, 64, 128, 1024)


def _ssd_chunked_flops(B: int, T: int, H: int, ds: int, hd: int,
                       bwd: bool) -> int:
    """The chunk products of the chunked S1 (or S1b, its saving forward
    included) at their fewest: G = C B^T once a (b, chunk), shared by the
    heads; the rest a (b, h, chunk).  Each counts twice its multiply-adds,
    once: the kernels' 3xTF32 split runs each three times, their own work
    and not the function's (``_ssd_bound``)."""
    from repro_torch.kernels import ssm_scan

    L, nC = ssm_scan.S1_CHUNK, -(-T // ssm_scan.S1_CHUNK)
    shared = 2 * L * L * ds * B * nC
    if not bwd:
        head = 2 * L * hd * (L + ds) + 2 * ds * hd * L
    else:
        head = (2 * ds * hd * L                     # saving forward's S
                + 2 * L * L * hd                    # D = dY U^T
                + 2 * L * hd * (L + ds)             # dU
                + 2 * 2 * L * ds * (L + hd)         # dB, dC
                + 2 * ds * hd * L                   # A_prev
                + 2 * L * L * L)                    # F
    return shared + head * B * H * nC


def _ssd_bound(nbytes: int, B: int, T: int, H: int, ds: int, hd: int,
               bwd: bool):
    """The chunked kernels' bound: operands read and outputs written once
    at 3.35 TB/s, or the chunk products counted once at the TF32 peak, 495
    TFLOP/s (as ``_k4_bound`` counts K4's 3xTF32 kernel).  Returns (ms,
    "bytes" | "operations", flop)."""
    flops = _ssd_chunked_flops(B, T, H, ds, hd, bwd)
    return (*_bound_ms(nbytes, flops, TF32_TENSOR_FLOPS_PER_S), flops)


def _mamba2_rows(args: tuple, tag: str, time_it: bool = True) -> dict:
    """S1 and S1b on both routes on the same operands ``args`` (S1's, a
    state carried in as in ``_ssm_kernel_row``): every kernel against the
    sequential twins over all T steps and at T = 1 (SSM_KERNEL_TOL of max
    |.| of y, s_T and each gradient), the chunked kernels also against
    their plain model (SSD_MODEL_TOL); the sequential S1's state must be
    bitwise the twin's at both lengths (S1b's d s0 is recorded).  With
    ``time_it``: each kernel's events and device ms on the same tensors,
    the twin's (the sequential kernels' plain version) or the model's (the
    chunked kernels') host-clock ms, the bound, and the T sweep.  Returns
    rows by counter name ("mamba2_scan", "mamba2_scan_chunked",
    "mamba2_scan_bwd", "mamba2_scan_bwd_chunked") and "sweep"."""
    import torch

    from repro_torch.kernels import ref, ssm_scan

    def fwd(route):
        return lambda *a: ssm_scan.mamba2_scan_cuda(*a, _route=route)

    def bwd(route):
        return lambda *a: ssm_scan.mamba2_scan_bwd_cuda(*a, _route=route)

    first = fwd("sequential")(*args)
    args = args[:4] + (first[1],)
    B, T, H, hd = args[3].shape
    ds = args[1].shape[-1]
    step = tuple(a[:, :1] for a in args[:4]) + args[4:]
    gen = torch.Generator(device=args[0].device).manual_seed(27)
    ups = tuple(torch.randn(o.shape, generator=gen, device=o.device)
                for o in first)
    del first
    chunked = (ds in ssm_scan.MAMBA2_CHUNKED_WIDTHS
               and hd in ssm_scan.MAMBA2_CHUNKED_WIDTHS)
    routes = (("chunked",) if chunked else ()) + ("sequential",)
    rows = {}

    def held(kind, route, key, got, want, model):
        name = "mamba2_scan" + ("_bwd" if kind == "bwd" else "") + (
            "_chunked" if route == "chunked" else "")
        rels = [_rel_err(g, w) for g, w in zip(got, want)]
        _check(all(g.shape == w.shape for g, w in zip(got, want))
               and max(rels) <= SSM_KERNEL_TOL,
               f"{tag} {name} at T = {want[0].shape[1]}: max |delta| / max "
               f"|.| {rels} against the twin (limit {SSM_KERNEL_TOL})")
        row = rows.setdefault(name, {"name": name, "route": route,
                                     "shape": [B, T, H, hd], "ds": ds})
        row[f"rel_{key}"] = rels
        if model is not None:
            mrel = [_rel_err(g, w) for g, w in zip(got, model)]
            _check(max(mrel) <= SSD_MODEL_TOL, f"{tag} {name} at T = "
                   f"{want[0].shape[1]}: max |delta| / max |.| {mrel} "
                   f"against the chunked model (limit {SSD_MODEL_TOL})")
            row[f"rel_model_{key}"] = mrel
        if kind == "fwd":
            row[f"state_bitwise_{key}"] = bool(torch.equal(got[1], want[1]))
        else:
            row[f"ds0_bitwise_{key}"] = bool(torch.equal(got[4], want[4]))
        if key == "T":
            row["max_abs_err"] = _max_abs_err(got, want)
        return row

    plain = {}
    for key, a in (("T", args), ("T1", step)):
        ga = a + (ups[0][:, :a[0].shape[1]], ups[1])
        t0 = time.perf_counter()
        want = ref.mamba2_recurrence_plain(*a)
        torch.cuda.synchronize()
        plain[("fwd", "sequential", key)] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        model = ref.mamba2_chunked_plain(*a)
        torch.cuda.synchronize()
        plain[("fwd", "chunked", key)] = (time.perf_counter() - t0) * 1e3
        for route in routes:
            got = fwd(route)(*a)
            torch.cuda.synchronize()
            held("fwd", route, key, got, want,
                 model if route == "chunked" else None)
        del want, model, got
        t0 = time.perf_counter()
        want = ref.mamba2_recurrence_bwd_plain(*ga)
        torch.cuda.synchronize()
        plain[("bwd", "sequential", key)] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        model = ref.mamba2_chunked_bwd_plain(*ga)
        torch.cuda.synchronize()
        plain[("bwd", "chunked", key)] = (time.perf_counter() - t0) * 1e3
        for route in routes:
            got = bwd(route)(*ga)
            torch.cuda.synchronize()
            held("bwd", route, key, got, want,
                 model if route == "chunked" else None)
        del want, model, got
    seq = rows["mamba2_scan"]
    _check(seq["state_bitwise_T"] and seq["state_bitwise_T1"],
           f"{tag} the sequential S1's state is not bitwise the twin's")
    bargs = args + ups
    if time_it:
        for name, row in rows.items():
            kind = "bwd" if "_bwd" in name else "fwd"
            call_args = bargs if kind == "bwd" else args
            fn = (bwd if kind == "bwd" else fwd)(row["route"])
            call = lambda: fn(*call_args)  # noqa: E731
            outs = call()
            nbytes = sum(x.numel() * 4 for x in call_args) + sum(
                y.numel() * 4 for y in outs)
            del outs
            if row["route"] == "chunked":
                bound, by, flops = _ssd_bound(nbytes, B, T, H, ds, hd,
                                              kind == "bwd")
                row.update(tf32_flops=flops, tf32x3_flops=3 * flops)
            else:
                flops = (_ssm_bwd_f32_flops("mamba2_scan_bwd", B, T, H, hd, ds)
                         if kind == "bwd" else
                         _ssm_f32_flops("mamba2_scan", B, T, H, hd, ds))
                bound, by = _bound_ms(nbytes, flops)
                row.update(f32_flops=flops)
            row.update(ms=_time_ms(call, 5), device_ms=_queued_ms(call, 5),
                       plain_ms=plain[(kind, row["route"], "T")],
                       bound_ms=bound, bound_by=by, nbytes=nbytes)
        sweep = []
        for t in SSD_SWEEP_T:
            a = tuple(x[:, :t] for x in args[:4]) + args[4:]
            ga = a + (ups[0][:, :t], ups[1])
            sweep.append({"T": t, **{
                f"{kind}_{route}": _queued_ms(
                    (lambda f, x: lambda: f(*x))(
                        (bwd if kind == "bwd" else fwd)(route),
                        ga if kind == "bwd" else a), 10)
                for kind in ("fwd", "bwd") for route in routes}})
        rows["sweep"] = sweep
    for name, row in rows.items():
        if name == "sweep":
            continue
        kernel = (SSM_CHUNKED[name][0] if name in SSM_CHUNKED else
                  (SSM_BWD[name][0] if name in SSM_BWD
                   else SSM_SCANS[name][0]))
        bits = (f"state bitwise the twin's {row['state_bitwise_T']} and "
                f"{row['state_bitwise_T1']}" if "state_bitwise_T" in row else
                f"d s0 bitwise the twin's {row['ds0_bitwise_T']} and "
                f"{row['ds0_bitwise_T1']}")
        model = (f"; against the chunked model "
                 f"{json.dumps([float(f'{r:.3g}') for r in row['rel_model_T']])}"
                 f" and {json.dumps([float(f'{r:.3g}') for r in row['rel_model_T1']])}"
                 f" (limit {SSD_MODEL_TOL})" if "rel_model_T" in row else "")
        print(f"{tag} {name} ({kernel}, the {row['route']} route) at (B, T, "
              f"H, hd) = {row['shape']}, ds {ds}, a state carried in: max "
              f"|delta| / max |.| against the sequential twin "
              f"{json.dumps([float(f'{r:.3g}') for r in row['rel_T']])} over "
              f"T = {T} and "
              f"{json.dumps([float(f'{r:.3g}') for r in row['rel_T1']])} at "
              f"T = 1 (limit {SSM_KERNEL_TOL}){model}; {bits}"
              + (f"; {row['ms']:.4g} ms events, {row['device_ms']:.4g} ms "
                 f"device, plain {row['plain_ms']:.4g} ms ("
                 f"{'the chunked model' if row['route'] == 'chunked' else 'the twin'}"
                 f"), bound {row['bound_ms']:.4g} ms by {row['bound_by']} ("
                 + (f"{row['tf32_flops']:.4g} flop of chunk products at "
                    f"TF32, {row['tf32x3_flops']:.4g} run by the 3xTF32 "
                    f"split"
                    if row["route"] == "chunked" else
                    f"{row['f32_flops']:.4g} f32 flop")
                 + f", {row['nbytes']:.4g} bytes)" if time_it else ""))
    if time_it:
        print(f"{tag} S1 and S1b by T, device ms (_queued_ms) at (B, H, ds, "
              f"hd) = ({B}, {H}, {ds}, {hd}): " + "; ".join(
                  f"T {r['T']}: " + ", ".join(
                      f"{k} {v:.4g}" for k, v in r.items() if k != "T")
                  for r in rows["sweep"]))
    return rows


@contextlib.contextmanager
def _twin_recurrences():
    """``models.ssm``'s recurrences on their plain twins (the route before
    the ops: each step a few eager kernels), for timing that route on the
    same card."""
    import types

    from repro_torch.kernels import ref
    from repro_torch.models import ssm

    saved = ssm.ssm_scan
    ssm.ssm_scan = types.SimpleNamespace(
        mamba2_scan=ref.mamba2_recurrence_plain,
        mlstm_scan=ref.mlstm_recurrence_plain,
        slstm_scan=ref.slstm_recurrence_plain)
    try:
        yield
    finally:
        ssm.ssm_scan = saved


def _twin_route(cfg, dev, kernels: dict, tag: str) -> dict:
    """``run_lm`` as ``_ssm_serve`` runs it, on the twins: its prefill ms
    beside the kernels' run ``kernels``, the last-position logits' gap
    and the greedy tokens that agree (information: bf16 rounds each
    layer's output, and the kernels' read-outs add in other orders)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_lm

    ops.reset_launches()
    with _twin_recurrences():
        out = run_lm(cfg, batch=LM_B, prompt_len=LM_T, new_tokens=LM_NEW,
                     seed=0, device=dev)
    torch.cuda.synchronize()
    _check(ops.LAUNCHES["ssm_scan"] == 0, f"{tag}: a recurrence kernel "
           f"launched on the twins' route")
    lt, lk = out["logits"].float(), kernels["run"]["logits"].float()
    gap = float((lt - lk).abs().max() / lt.abs().max())
    same = float((out["tokens"] == kernels["run"]["tokens"]).mean())
    print(f"[s] {tag} on the twins (the route before the ops): prefill "
          f"{out['prefill_s'] * 1e3:.3f} ms, decode {out['tok_per_s']:.2f} "
          f"tok/s, against {kernels['run']['prefill_s'] * 1e3:.3f} ms and "
          f"{kernels['run']['tok_per_s']:.2f} tok/s on the kernels; "
          f"last-position logits {gap:.4g} of max |logit| apart, "
          f"{same:.4f} of the greedy tokens equal (information)")
    return {"run": out, "gap": gap, "same_tokens": same}


def _ssm_path(dev) -> dict:
    """Phase s: the hybrid and xlstm families through ``run_lm`` at full
    width and depth, on K4 (zamba2); on zamba2's weights the chunked route
    group by group, a traced Mamba2 layer, shared group and four decode
    steps, and the cache re-layout in f32; one Mamba2 layer and one xLSTM
    pair in f32 on the card against the CPU."""
    import torch

    from repro_torch import configs
    from repro_torch.fed.hfl import f32_math
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    chunked = configs.get(SSM_ARCH)
    flash = dataclasses.replace(chunked, attn_impl="pallas")
    L, V, G = flash.n_layers, flash.vocab, flash.n_layers // flash.attn_every
    print(f"[s] {SSM_ARCH} at full width and depth ({L} Mamba2 layers, d "
          f"{flash.d_model}, ssm_state {flash.ssm_state}, the shared block "
          f"after every {flash.attn_every}: {G} applications of "
          f"{flash.n_heads} heads of {flash.head_dim}, window "
          f"{flash.window}, d_ff {flash.d_ff}; vocab {V}, {flash.dtype}), "
          f"B = {LM_B}, prompt {LM_T}, {LM_NEW} new tokens, on K4")
    # (a) The served path.
    a = _ssm_serve(flash, dev, SSM_ARCH)
    counts = a["counts"]
    _check(counts["flash_attention"] == G,
           f"K4 launched {counts['flash_attention']} times in one prefill "
           f"of {G} shared-attention applications")
    _check(counts["flash_attention_sm90"] == G,
           f"only {counts['flash_attention_sm90']} of the hybrid prefill's "
           f"K4 launches took the tensor-core kernel")
    print(f"[s] K4 launches in the run: {counts['flash_attention']} (one "
          f"per shared-attention application of one prefill), "
          f"{counts['flash_attention_sm90']} on the tensor cores")
    per_run = L * (1 + LM_NEW)
    _check(counts["mamba2_scan"] == counts["ssm_scan"] == per_run
           and counts["mlstm_scan"] == counts["slstm_scan"] == 0,
           f"{SSM_ARCH}'s run launched S1 {counts['mamba2_scan']} times "
           f"(want {L} a prefill and {L} a decode step: {per_run}), S2 "
           f"{counts['mlstm_scan']} and S3 {counts['slstm_scan']} times")
    _check(counts["mamba2_scan_chunked"] == L,
           f"{counts['mamba2_scan_chunked']} of the prefill's {L} S1 launches "
           f"took the chunked kernel (want all; every decode step the "
           f"sequential one)")
    print(f"[s] S1 launches in the run: {counts['mamba2_scan']} ({L} in the "
          f"prefill, all {counts['mamba2_scan_chunked']} on the chunked "
          f"kernel, and {L} in each of {LM_NEW} decode steps on the "
          f"sequential one)")
    a_twin = _twin_route(flash, dev, a, SSM_ARCH)

    gen = torch.Generator(device=dev).manual_seed(0)
    traced = {}
    with torch.inference_mode():
        # run_lm's weights and prompts again: the same generator sequence.
        params = tf.init_params(flash, gen, dev)
        toks = torch.randint(0, V, (LM_B, LM_T), generator=gen, device=dev)
        extra = torch.randint(0, V, (LM_B, 1), generator=gen, device=dev)
        lk = a["run"]["logits"].float()
        # (b) K4 against the chunked route, group by group on the K4
        # route's stream: each shared block's output from the same input.
        x, positions, _ = tf.embed_inputs(flash, params, {"tokens": toks})
        mm, ends = tf._layers(params["blocks"]["mamba"]), tf._group_ends(flash)
        groups = []
        for i in range(L):
            x, _ = tf._mamba_apply(flash, mm[i], x)
            if i in ends:
                yk = tf._shared_apply(flash, params, x, positions=positions)[0]
                yc = tf._shared_apply(chunked, params, x,
                                      positions=positions)[0]
                rel = float((yk.float() - yc.float()).abs().max()
                            / yc.float().abs().max())
                groups.append(rel)
                _check(rel <= LM_LOGIT_RTOL, f"{SSM_ARCH} group {len(groups)}: "
                       f"K4 and chunked shared-block outputs differ by "
                       f"{rel:.3g} of max |x| (limit {LM_LOGIT_RTOL})")
                x = yk
        stream = tf.unembed(flash, params, x[:, -1:])[:, 0].float()
        rerun = float((stream - lk).abs().max())
        del x, yk, yc
        # The whole model on the chunked route, and as a control the same
        # route with key chunks of 512 (another summation order of the
        # same function): how far bf16 rounding alone moves the logits
        # through 94 blocks of random weights.
        lc, cache = tf.make_prefill_step(chunked)(params, {"tokens": toks})
        lc512 = tf.make_prefill_step(dataclasses.replace(
            chunked, kv_chunk=512))(params, {"tokens": toks})[0]
        lc, lc512 = lc[:, 0].float(), lc512[:, 0].float()
        scale = float(lc.abs().max())
        gap = float((lk - lc).abs().max()) / scale
        control = float((lc512 - lc).abs().max()) / scale
        print(f"[s] (b) K4 against the chunked route, each of the {G} shared "
              f"blocks on the K4 stream's input: max |delta| "
              f"{max(groups):.4g} of max |x| (by group "
              f"{json.dumps([float(f'{r:.3g}') for r in groups])}; limit "
              f"{LM_LOGIT_RTOL}); the K4 stream's logits against run_lm's: "
              f"max |delta| {rerun:.4g}")
        print(f"[s] (b) whole model, last-position logits (information): K4 "
              f"against chunked {gap:.4g} of max |logit| {scale:.4g}, the "
              f"same top token in "
              f"{float((lk.argmax(-1) == lc.argmax(-1)).float().mean()):.4f} "
              f"of sequences; the control, chunked at key chunks of 512 "
              f"against 1,024: {control:.4g}")

        # (h) Each Mamba2 layer in bf16 on the kernels' route against the
        # twins' route, both from the twins' route's input to that layer.
        x, positions, _ = tf.embed_inputs(flash, params, {"tokens": toks})
        layer_gaps = []
        for i in range(L):
            h_in = tf.rms_norm(x, mm[i]["ln"])
            yk = ssm.mamba2_scan(mm[i], h_in, flash.ssm_state,
                                 flash.ssm_headdim)[0].float()
            with _twin_recurrences():
                yt = ssm.mamba2_scan(mm[i], h_in, flash.ssm_state,
                                     flash.ssm_headdim)[0]
            layer_gaps.append(float((yk - yt.float()).abs().max()
                                    / yt.float().abs().max()))
            x = x + yt
            if i in ends:
                x = tf._shared_apply(flash, params, x, positions=positions)[0]
        worst = max(range(L), key=layer_gaps.__getitem__)
        print(f"[s] (h) each of the {L} Mamba2 layers in {flash.dtype}, the "
              f"kernels' route against the twins' route from the twins' "
              f"input: max |delta| / max |y| at most {layer_gaps[worst]:.4g} "
              f"(layer {worst}; {layer_gaps[worst] / 2 ** -8:.3g} bf16 ulps "
              f"of max |y|), median "
              f"{sorted(layer_gaps)[L // 2]:.4g}; by layer "
              f"{json.dumps([float(f'{r:.3g}') for r in layer_gaps])}")
        del x, yk, yt, h_in

        # (f) Traces: one Mamba2 layer's prefill, one shared group, four
        # decode steps from the chunked prefill's cache.
        x, positions, _ = tf.embed_inputs(flash, params, {"tokens": toks})
        p0 = tf._layers(params["blocks"]["mamba"])[0]
        walls = {"mamba": _wall_ms(lambda: tf._mamba_apply(flash, p0, x)),
                 "shared": _wall_ms(lambda: tf._shared_apply(
                     flash, params, x, positions=positions))}
        traced["mamba"] = {}
        _profile("[s]", "1 traced Mamba2 layer's prefill",
                 lambda: tf._mamba_apply(flash, p0, x), traced["mamba"])
        traced["shared"] = {}
        rows = _profile("[s]", "1 traced shared-attention group (K4 + "
                        "shared SwiGLU)", lambda: tf._shared_apply(
                            flash, params, x, positions=positions),
                        traced["shared"])
        traced["shared"]["k4_ms"] = sum(
            ms for ms, _, nm in rows if "flash_attention" in nm)
        tok = lk.argmax(-1)[:, None]

        def decode(steps=4):
            nonlocal cache, tok
            for _ in range(steps):
                step_logits, cache = tf.decode_step(flash, params, cache, tok)
                tok = torch.argmax(step_logits[:, -1], -1)[:, None]

        decode()
        traced["decode"] = {}
        _profile("[s]", "4 traced decode steps", decode, traced["decode"],
                 SSM_RANGES)
        # (g) S1 and S1b against their twins on the first Mamba2 layer's
        # operands of the prompt, a state carried in.
        got = _scan_operands(lambda: tf._mamba_apply(flash, p0, x))
        # Both routes of each, new beside old on the same tensors, and the
        # T sweep.
        rows = _mamba2_rows(got["mamba2_scan"], "[s] (g)")
        sweep = rows.pop("sweep")
        bwd_extra = {}              # S2b's T sweep, S3b's handshake floor
        del cache, x, mm, p0, got

        # (c) The re-layout at full width and depth, in float32 with TF32
        # off (in bf16 the rounding of 94 blocks moves the logits further
        # than the limit; see (b)'s control): T tokens prefilled and
        # re-laid for T + 1 positions, one decode step on token T, against
        # a prefill of the T + 1 tokens.
        def widen(tree):
            return {k: widen(v) if isinstance(v, dict) else v.float()
                    for k, v in tree.items()}

        f32cfg = dataclasses.replace(flash, dtype=torch.float32)
        p32 = widen(params)
        del params
        with f32_math():
            _, cache = tf.make_prefill_step(f32cfg, pad_to=LM_T + 1)(
                p32, {"tokens": toks})
            dec = tf.decode_step(f32cfg, p32, cache, extra)[0][:, 0]
            del cache
            full = tf.make_prefill_step(f32cfg)(
                p32, {"tokens": torch.cat([toks, extra], 1)})[0][:, 0]
        rel_c = float((dec - full).abs().max() / full.abs().max())
        _check(rel_c <= LM_LOGIT_RTOL, f"{SSM_ARCH}: prefill T + re-layout + "
               f"decode differs from a prefill of T + 1 by {rel_c:.3g} of "
               f"max |logit| (limit {LM_LOGIT_RTOL})")
        same_top = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
        print(f"[s] (c) the re-layout in f32: prefill {LM_T} tokens, re-lay "
              f"for {LM_T + 1} positions, decode token {LM_T}, against a "
              f"prefill of {LM_T + 1}: max |delta| {rel_c:.4g} of max "
              f"|logit| {float(full.abs().max()):.4g} (limit "
              f"{LM_LOGIT_RTOL}); the same top token in {same_top:.4f} of "
              f"sequences")
        del p32
    torch.cuda.empty_cache()
    tm, ts, td = traced["mamba"], traced["shared"], traced["decode"]
    est_wall = L * walls["mamba"] + G * walls["shared"]
    est_dev = L * tm["device_ms"] + G * ts["device_ms"]
    print(f"[s] (f) one Mamba2 layer's prefill: {walls['mamba']:.2f} ms wall "
          f"untraced ({tm['wall_ms']:.2f} traced), "
          f"{tm['device_ms']:.3f} ms device, busy share "
          f"{_fmt(_div(tm['union_ms'], tm['wall_ms']), '.4f')}, "
          f"{tm['events']} device events ({tm['events'] / LM_T:.2f} a time "
          f"step); one shared group: {walls['shared']:.2f} ms wall untraced "
          f"({ts['wall_ms']:.2f} traced), "
          f"{ts['device_ms']:.3f} ms device (K4 {ts['k4_ms']:.3f}), busy "
          f"share {_fmt(_div(ts['union_ms'], ts['wall_ms']), '.4f')}, "
          f"{ts['events']} device events")
    print(f"[s] (f) the whole prefill from these: {L} x Mamba2 + {G} x "
          f"shared = {est_wall:.1f} ms wall ({L * walls['mamba']:.1f} in "
          f"the Mamba2 layers, {G * walls['shared']:.1f} in the shared "
          f"groups) "
          f"and {est_dev:.1f} ms of device time ({L * tm['device_ms']:.1f} "
          f"Mamba2, {G * ts['device_ms']:.1f} shared, K4 "
          f"{G * ts['k4_ms']:.2f}), against run_lm's "
          f"{a['run']['prefill_s'] * 1e3:.1f} ms; launches about "
          f"{L * tm['events'] + G * ts['events']:,}")
    rg = td["ranges"]
    print(f"[s] (f) 4 traced decode steps: {td['wall_ms'] / 4:.2f} ms wall "
          f"and {td['device_ms'] / 4:.3f} ms device a step (busy share "
          f"{_fmt(_div(td['union_ms'], td['wall_ms']), '.4f')}), "
          f"{td['events'] / 4:.0f} device events a step; device time a "
          f"step in the Mamba2 layers {rg['hybrid.mamba'] / 4:.3f} ms, in "
          f"the shared blocks {rg['hybrid.shared'] / 4:.3f} ms, the rest "
          f"{(td['device_ms'] - sum(rg.values())) / 4:.3f} ms")

    # (d) The card against the CPU in f32 at full width, B = 1, T = 64: one
    # zamba2 Mamba2 layer (A_log, D, dt_bias drawn too) and one xlstm-125m
    # m/s pair, weights from the seed, TF32 off.
    xcfg = configs.get(XLSTM_ARCH)
    g = torch.Generator().manual_seed(3)
    d, ds, hdm = flash.d_model, flash.ssm_state, flash.ssm_headdim
    pm = ssm.init_mamba2(g, d, ds, hdm, device="cpu")
    Hs = pm["A_log"].shape[0]
    pm.update(A_log=0.5 * torch.randn(Hs, generator=g),
              D=torch.randn(Hs, generator=g),
              dt_bias=torch.randn(Hs, generator=g), ln=torch.ones(d))
    xm = torch.randn((1, 64, d), generator=g)
    px = {"m": dict(ssm.init_mlstm(g, xcfg.d_model, xcfg.n_heads,
                                   device="cpu"), ln=torch.ones(xcfg.d_model)),
          "s": dict(ssm.init_slstm(g, xcfg.d_model, xcfg.n_heads,
                                   device="cpu"), ln=torch.ones(xcfg.d_model))}
    xx = torch.randn((1, 64, xcfg.d_model), generator=g)
    f32 = dict(dtype=torch.float32)
    mcfg = dataclasses.replace(flash, **f32)
    xcfg32 = dataclasses.replace(xcfg, **f32)
    def card(tree):
        return {k: card(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    def leaves(t):
        return ([t] if isinstance(t, torch.Tensor)
                else [y for z in t for y in leaves(z)])

    errs = {}
    with torch.inference_mode(), f32_math():
        for name, fn in (
                ("mamba2", lambda p, x: tf._mamba_apply(mcfg, p, x)),
                ("xlstm pair", lambda p, x: tf._xlstm_pair(xcfg32, p, x))):
            p, x = (pm, xm) if name == "mamba2" else (px, xx)
            want = fn(p, x)
            got = fn(card(p), x.to(dev))
            for i, (gt, wt) in enumerate(zip(leaves(got), leaves(want))):
                rel = float((gt.cpu() - wt).abs().max() / wt.abs().max())
                errs[f"{name}[{i}]"] = rel
                _check(rel <= SSM_CPU_TOL, f"{name} output {i} on the card "
                       f"differs from the CPU by {rel:.3g} of its max (limit "
                       f"{SSM_CPU_TOL})")
    shown = {k: float(f"{v:.4g}") for k, v in errs.items()}
    print(f"[s] (d) f32 at full width, B = 1, T = 64, the card against the "
          f"CPU (TF32 off), max |delta| over max |leaf| of y and each "
          f"state: {json.dumps(shown)} (limit {SSM_CPU_TOL})")
    del pm, px

    # (e) xlstm-125m at full size: S2 and S3 once a pair a prefill and a
    # decode step, no other kernel.
    x_run = _ssm_serve(xcfg, dev, XLSTM_ARCH)
    xc, pairs = x_run["counts"], xcfg.n_layers // 2
    per_run = pairs * (1 + LM_NEW)
    _check(xc["mlstm_scan"] == xc["slstm_scan"] == per_run
           and xc["ssm_scan"] == 2 * per_run and all(
               n == 0 for k, n in xc.items()
               if k not in ("ssm_scan", "mlstm_scan", "slstm_scan")),
           f"{XLSTM_ARCH}'s run: want S2 and S3 {pairs} times a prefill and "
           f"a decode step ({per_run} each) and nothing else, got {xc}")
    print(f"[s] S2 and S3 launches in the run: {xc['mlstm_scan']} and "
          f"{xc['slstm_scan']} ({pairs} each in the prefill and in each of "
          f"{LM_NEW} decode steps)")
    x_twin = _twin_route(xcfg, dev, x_run, XLSTM_ARCH)
    # (g) S2 and S3 against their twins on the first pair's operands of
    # run_lm's prompt (its weights and prompt: the same generator), a
    # state carried in.
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = tf.init_params(xcfg, gen, dev)
        toks = torch.randint(0, xcfg.vocab, (LM_B, LM_T), generator=gen,
                             device=dev)
        x = tf.embed_inputs(xcfg, params, {"tokens": toks})[0]
        blk = tf._layers(params["blocks"])[0]
        got = _scan_operands(lambda: tf._xlstm_pair(xcfg, blk, x))
        for name in ("mlstm_scan", "slstm_scan"):
            rows[name] = _ssm_kernel_row(name, got[name], "[s] (g)")
            bwd_rows = _ssm_bwd_rows(name + "_bwd", got[name], "[s] (g)")
            bwd_extra[name] = bwd_rows.pop("sweep" if name == "mlstm_scan"
                                           else "floor")
            rows.update(bwd_rows)
        del params, x, blk, got
    seconds = time.perf_counter() - t_phase
    print(f"[s] phase s: {seconds:.1f} s")
    path = {k: counts[k] + x_run["counts"][k] for k in counts}
    return {"counts": path, "zamba2": a, "xlstm": x_run, "kernels": rows,
            "sweep": sweep, "mlstm_sweep": bwd_extra["mlstm_scan"],
            "slstm_floor": bwd_extra["slstm_scan"],
            "twins": {"zamba2": a_twin, "xlstm": x_twin},
            "rel_b": max(groups), "rel_b_groups": groups, "gap_b": gap,
            "layer_gaps": layer_gaps,
            "gap_b_control": control, "rel_c": rel_c, "cpu_errs": errs, "traced": traced,
            "est_prefill_wall_ms": est_wall, "walls": walls,
            "seconds": seconds,
            "groups": G}


def _dense_bounds(cfg, B: int, T: int, head_rows: int) -> dict:
    """The least time of a dense or encoder model's forward over B x T
    positions and of one decode step, at the card's peaks.  The forward's
    operations: every position through each layer's attention projections
    and MLP (the SwiGLU's three matrices, the encoder's GELU two), attention
    over every key (non-causal) or the causal half, the embeds input's
    projection, and the head over ``head_rows`` positions (all of them for
    the encoder's forward and for training, the B last for a prefill).  A
    decode step's bytes: every weight but the embedding (of which it reads
    B rows) read once, and the K/V cache of T positions."""
    d, H, Hkv, hd, ff, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.d_ff, cfg.vocab,
                               cfg.n_layers)
    n = B * T
    qkvo = d * (2 * H * hd + 2 * Hkv * hd)
    mlp = (2 if cfg.family == "encoder" else 3) * d * ff
    keys = T * T if not cfg.causal else T * (T + 1) // 2
    flops = (L * (2 * n * (qkvo + mlp) + 4 * hd * B * H * keys)
             + 2 * head_rows * d * V
             + (2 * n * d * d if cfg.input_mode == "embeds" else 0))
    w = cfg.dtype.itemsize
    weights = w * (L * (qkvo + mlp + 2 * d) + d * V + d)
    step_bytes = weights + L * 2 * B * T * Hkv * hd * w + B * d * w
    step_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, ms=flops / BF16_TENSOR_FLOPS_PER_S * 1e3,
                weight_bytes=weights, step_bytes=step_bytes, step_ms=step_ms,
                tok_per_s=B / step_ms * 1e3)


def _k4_layers(flash, chunked, params, x, positions, ffn: str) -> list:
    """Layer by layer on K4's stream: each layer's output on K4 and on the
    chunked route from the same input; max |delta| over the chunked
    output's max |x| a layer, each checked against ENC_LAYER_RTOL.
    Returns (the shares, the K4 stream's last hidden state)."""
    from repro_torch.models import transformer as tf

    rels = []
    for i, (pa, pf) in enumerate(zip(tf._layers(params["blocks"]["attn"]),
                                     tf._layers(params["blocks"][ffn]))):
        ys = []
        for cfg in (flash, chunked):
            xa, _ = tf._attn_apply(cfg, pa, x, positions=positions,
                                   causal=cfg.causal, window=cfg.window)
            ys.append(tf._ffn_apply(cfg, pf, xa)[0])
        yk, yc = (y.float() for y in ys)
        rel = float((yk - yc).abs().max() / yc.abs().max())
        _check(rel <= ENC_LAYER_RTOL, f"{flash.name} layer {i}: K4 and "
               f"chunked outputs differ by {rel:.3g} of max |x| (limit "
               f"{ENC_LAYER_RTOL})")
        rels.append(rel)
        x = ys[0]
    return rels, x


def _encoder_path(dev) -> dict:
    """Phase e: hubert-xlarge at full size through ``forward`` on K4, and
    internvl2-76b at full width, 32 of 80 layers, through ``run_lm`` on K4
    (patches before the prompt); on each model's weights K4 against the
    chunked route layer by layer, and a traced forward or prefill and
    decode."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_lm
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import tree_leaves

    t_phase = time.perf_counter()
    # (a) hubert-xlarge, nothing cut.
    chunked = configs.get(ENC_ARCH)
    flash = dataclasses.replace(chunked, attn_impl="pallas")
    L, V, d = flash.n_layers, flash.vocab, flash.d_model
    gen = torch.Generator(device=dev).manual_seed(0)
    enc = {}
    with torch.inference_mode():
        params = tf.init_params(flash, gen, dev)
        n_params = sum(p.numel() for p in tree_leaves(params))
        batch = {"embeds": torch.randn((LM_B, LM_T, d), generator=gen,
                                       device=dev, dtype=flash.dtype)}

        def fwd(cfg):
            return tf.forward(cfg, params, batch)[0]

        fwd(flash)                                # warm-up: cold starts
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits, counts = _counted(lambda: fwd(flash))
        peak = torch.cuda.max_memory_allocated()
        _check(counts["flash_attention"] == L,
               f"K4 launched {counts['flash_attention']} times in one "
               f"{ENC_ARCH} forward of {L} layers")
        _check(counts["flash_attention_sm90"] == L,
               f"only {counts['flash_attention_sm90']} of the {ENC_ARCH} "
               f"forward's K4 launches took the tensor-core kernel")
        _check(logits.shape == (LM_B, LM_T, V)
               and bool(torch.isfinite(logits).all()),
               f"{ENC_ARCH} logits: shape or non-finite values")
        fwd_ms = _time_ms(lambda: fwd(flash), 5)
        chunked_ms = _time_ms(lambda: fwd(chunked), 5)
        bnd = _dense_bounds(flash, LM_B, LM_T, LM_B * LM_T)
        x, positions, _ = tf.embed_inputs(flash, params, batch)
        rels, _ = _k4_layers(flash, chunked, params, x, positions, "mlp")
        lc = fwd(chunked).float()
        gap = float((logits.float() - lc).abs().max() / lc.abs().max())
        stats = {}
        rows = _profile("[e]", f"1 traced {ENC_ARCH} forward on K4",
                        lambda: fwd(flash), stats)
        stats["k4_ms"] = sum(ms for ms, _, nm in rows
                             if "flash_attention" in nm)
        del params, batch, logits, lc, x
    torch.cuda.empty_cache()
    print(f"[e] {ENC_ARCH} at full size ({L} layers, d {d}, "
          f"{flash.n_heads} heads of {flash.head_dim}, non-causal, d_ff "
          f"{flash.d_ff}, vocab {V}, {flash.dtype}; {n_params:,} "
          f"parameters), B = {LM_B}, {LM_T} frames of embeddings, through "
          f"forward on K4")
    print(f"[e] forward {fwd_ms:.3f} ms on K4, {chunked_ms:.3f} ms on the "
          f"chunked route (CUDA events, median of 5); bound "
          f"{bnd['ms']:.4g} ms ({bnd['flops']:.4g} flop at 989 TFLOP/s); "
          f"peak memory allocated {peak:,} bytes ({peak / 2 ** 30:.2f} GiB)")
    print(f"[e] K4 launches in one forward: {counts['flash_attention']}, "
          f"{counts['flash_attention_sm90']} on the tensor cores; layer by "
          f"layer K4 against chunked max |delta| {min(rels):.4g} to "
          f"{max(rels):.4g} of max |x| (limit {ENC_LAYER_RTOL}); whole-model "
          f"logits {gap:.4g} of max |logit| (information); traced: device "
          f"{stats['device_ms']:.3f} ms, K4 {stats['k4_ms']:.3f} ms, busy "
          f"share {_fmt(_div(stats['union_ms'], stats['wall_ms']), '.4f')}")
    enc = dict(counts=counts, fwd_ms=fwd_ms, chunked_ms=chunked_ms,
               bounds=bnd, peak_bytes=peak, rels=rels, gap=gap,
               trace=stats, n_layers=L)

    # (b) internvl2-76b at full width, 32 of 80 layers, through run_lm.
    chunked = dataclasses.replace(configs.get(VLM_ARCH), n_layers=VLM_LAYERS)
    flash = dataclasses.replace(chunked, attn_impl="pallas")
    L, V, P = flash.n_layers, flash.vocab, flash.n_patches
    kw = dict(batch=LM_B, prompt_len=LM_T - P, seed=0, device=dev)
    run_lm(flash, new_tokens=2, **kw)             # warm-up: cold starts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, vcounts = _counted(lambda: run_lm(flash, new_tokens=LM_NEW, **kw))
    peak = torch.cuda.max_memory_allocated()
    _check(vcounts["flash_attention"] == L,
           f"K4 launched {vcounts['flash_attention']} times in one prefill "
           f"of {L} layers")
    _check(vcounts["flash_attention_sm90"] == L,
           f"only {vcounts['flash_attention_sm90']} of the {VLM_ARCH} "
           f"prefill's K4 launches took the tensor-core kernel")
    vlogits, toks = a["logits"].float(), a["tokens"]
    _check(vlogits.shape == (LM_B, V)
           and bool(torch.isfinite(vlogits).all()),
           f"{VLM_ARCH} prefill logits: shape or non-finite values")
    _check(toks.shape == (LM_B, LM_NEW + 1) and (toks >= 0).all()
           and (toks < V).all(), f"{VLM_ARCH} generated tokens")
    vb = _dense_bounds(flash, LM_B, LM_T, LM_B)
    step_ms = a["decode_s"] * 1e3 / LM_NEW
    gen = torch.Generator(device=dev).manual_seed(0)
    traced = {"prefill": {}, "decode": {}}
    with torch.inference_mode():
        # run_lm's weights, prompts and patches again: the same generator
        # sequence.
        params = tf.init_params(flash, gen, dev)
        prompts = torch.randint(0, V, (LM_B, LM_T - P), generator=gen,
                                device=dev)
        batch = {"tokens": prompts, "patches": torch.randn(
            (LM_B, P, flash.d_model), generator=gen, device=dev,
            dtype=flash.dtype)}
        x, positions, _ = tf.embed_inputs(flash, params, batch)
        vrels, xk = _k4_layers(flash, chunked, params, x, positions, "mlp")
        lk = tf.unembed(flash, params, xk[:, -1:])[:, 0].float()
        rerun = float((lk - vlogits).abs().max() / vlogits.abs().max())
        prefill = tf.make_prefill_step(flash)
        rows = _profile("[e]", f"1 traced {VLM_ARCH} prefill on K4",
                        lambda: prefill(params, batch), traced["prefill"])
        traced["prefill"]["k4_ms"] = sum(ms for ms, _, nm in rows
                                         if "flash_attention" in nm)
        step_logits, cache = prefill(params, batch)
        _check(int(cache["pos"]) == LM_T and cache["k"].shape[2] == LM_T,
               f"the {VLM_ARCH} prefill cache holds {int(cache['pos'])} "
               f"positions, not {P} patches + {LM_T - P} tokens")
        tok = torch.argmax(step_logits[:, -1], -1)[:, None]
        serve_step = tf.make_serve_step(flash)

        def decode(steps=4):
            nonlocal cache, tok
            for _ in range(steps):
                out, cache = serve_step(params, cache, tok)
                tok = torch.argmax(out[:, -1], -1)[:, None]

        decode()
        _profile("[e]", "4 traced decode steps", decode, traced["decode"])
        del params, cache, batch, x, xk
    torch.cuda.empty_cache()
    pre = traced["prefill"]
    print(f"[e] {VLM_ARCH} at full width, {L} of 80 layers (d "
          f"{flash.d_model}, {flash.n_heads} heads of {flash.head_dim}, "
          f"{flash.n_kv_heads} kv heads, d_ff {flash.d_ff}, vocab {V}, "
          f"{flash.dtype}; {vb['weight_bytes'] / 1e9:.4g} GB of weights), "
          f"B = {LM_B}, {P} patches + {LM_T - P} tokens, {LM_NEW} new "
          f"tokens, through run_lm on K4")
    print(f"[e] prefill {a['prefill_s'] * 1e3:.3f} ms (bound "
          f"{vb['ms']:.4g} ms: {vb['flops']:.4g} flop at 989 TFLOP/s); "
          f"decode {a['tok_per_s']:.2f} tok/s, {step_ms:.3f} ms a step "
          f"(bound {vb['step_ms']:.4g} ms: {vb['step_bytes']:.4g} bytes at "
          f"3.35 TB/s, {vb['tok_per_s']:.4g} tok/s); peak memory allocated "
          f"{peak:,} bytes ({peak / 2 ** 30:.2f} GiB)")
    print(f"[e] K4 launches in the run: {vcounts['flash_attention']} (one "
          f"per layer of one prefill), {vcounts['flash_attention_sm90']} on "
          f"the tensor cores; layer by layer K4 against chunked "
          f"{min(vrels):.4g} to {max(vrels):.4g} of max |x| (limit "
          f"{ENC_LAYER_RTOL}); the layer-by-layer K4 stream against "
          f"run_lm's prefill logits {rerun:.4g} of max |logit|; traced "
          f"prefill device {traced['prefill']['device_ms']:.3f} ms (K4 "
          f"{traced['prefill']['k4_ms']:.3f} ms), busy share "
          f"{_fmt(_div(pre['union_ms'], pre['wall_ms']), '.4f')}; first "
          f"sequence {toks[0][:12].tolist()}")
    seconds = time.perf_counter() - t_phase
    print(f"[e] phase e: {seconds:.1f} s")
    return {"encoder": enc, "vlm": dict(
        counts=vcounts, run=a, bounds=vb, peak_bytes=peak, rels=vrels,
        rerun=rerun, trace=traced, step_ms=step_ms, n_layers=L),
        "seconds": seconds}


def _lm_train_inputs(cfg, B=2, T=16, seed=0):
    """Parameters (every bias drawn non-zero) and a batch for ``cfg``'s
    input mode, on the CPU."""
    import torch

    from repro_torch.models import transformer as tf

    g = torch.Generator().manual_seed(seed)
    biases = {"ln_b", "final_ln_b", "bq", "bk", "bv", "b_in", "b_out"}

    def biased(node):
        return {k: biased(v) if isinstance(v, dict) else
                (0.1 * torch.randn(v.shape, generator=g) if k in biases
                 else v) for k, v in node.items()}

    params = biased(tf.init_params(cfg, g, "cpu"))
    V, d = cfg.vocab, cfg.d_model
    if cfg.input_mode == "embeds":
        batch = {"embeds": torch.randn((B, T, d), generator=g),
                 "labels": torch.randint(0, V, (B, T), generator=g)}
    elif cfg.input_mode == "mixed":
        P = cfg.n_patches
        batch = {"patches": torch.randn((B, P, d), generator=g),
                 "tokens": torch.randint(0, V, (B, T - P), generator=g)}
    else:
        batch = {"tokens": torch.randint(0, V, (B, T), generator=g)}
    return params, batch


def _lm_train_path(dev) -> dict:
    """Phase l: one float32 train step of each kind of model on the card
    against the CPU; qwen1.5-0.5b's full-size train steps, timed and
    traced; ``make_hfl_lm_train_step`` at that size; K4's refusal under
    autograd."""
    import torch

    from repro_torch import configs, optim
    from repro_torch.fed.hfl import f32_math
    from repro_torch.fed.hfl_lm import make_hfl_lm_train_step
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import tree_leaves, tree_map

    t_phase = time.perf_counter()
    ops.reset_launches()
    path = dict(ops.LAUNCHES)
    # (a) Each kind of model, reduced, float32: the card against the CPU;
    # the recurrent kinds on S1-S3 and S1b-S3b, no twin on the card.
    errs = {}
    for arch, changes in TRAIN_KINDS:
        cfg = dataclasses.replace(configs.get(arch).reduced(), **changes)
        params, batch = _lm_train_inputs(cfg)
        opt = optim.sgd(lr=0.1)
        step = tf.make_train_step(cfg, opt, lr_schedule=optim.cosine(10, 2))
        with f32_math():
            want = step(params, opt.init(params), batch)
            card = tree_map(lambda t: t.to(dev), params)
            before = dict(ops.LAUNCHES)
            with _no_twins():
                got = step(card, opt.init(card),
                           {k: v.to(dev) for k, v in batch.items()})
            torch.cuda.synchronize()
        made = {k: ops.LAUNCHES[k] - before[k] for k in before}
        need = _recurrent_counts(cfg, batch["tokens"].shape[1]
                                 if "tokens" in batch else 0)
        _check(all(made[k] == need.get(k, 0) for k in made
                   if k != "ssm_scan"), f"{arch}'s train step launched "
               f"{made}, want {need} (remat: each forward op twice a layer, "
               f"each backward once)")
        _add(path, made)
        err = max(float((g.cpu() - w).abs().max() / w.abs().max())
                  for g, w in zip(tree_leaves(got[0]), tree_leaves(want[0])))
        loss_err = abs(float(got[2]["loss"]) - float(want[2]["loss"]))
        _check(err <= TRAIN_CPU_TOL and loss_err <= TRAIN_CPU_TOL * max(
            1.0, abs(float(want[2]["loss"]))), f"{arch}: the card's train "
            f"step differs from the CPU's by {err:.3g} of max |leaf| (loss "
            f"{loss_err:.3g}; limit {TRAIN_CPU_TOL})")
        errs[arch] = err
    shown = {k: float(f"{v:.4g}") for k, v in errs.items()}
    print(f"[l] (a) one f32 train step (SGD, cosine schedule, clip, remat) "
          f"of each kind at reduced() size, the card against the CPU (TF32 "
          f"off), max |delta| over max |leaf|: {json.dumps(shown)} (limit "
          f"{TRAIN_CPU_TOL}); launches {json.dumps(_by_kernel(path))}, no "
          f"recurrence twin on the card")
    before = dict(ops.LAUNCHES)

    # (b) qwen1.5-0.5b at full size, adamw, B x T tokens, chunked, remat.
    cfg = configs.get(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(cfg, gen, dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_B, LM_T),
                                     generator=gen, device=dev)}
    opt = optim.get_optimizer(cfg.optimizer)
    step = tf.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, s, losses, step_ms = params, opt.init(params), [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        p, s, met = step(p, s, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated()
    _check(all(math.isfinite(x) for x in losses), f"non-finite losses "
           f"{losses}")
    # A norm scale of 1.0 in bf16 moves by less than half its ulp (2^-8)
    # in 4 AdamW steps of lr 3e-4, in the reference as here; every other
    # leaf must change.
    names = tf._map_defs(params, lambda name, _: name)
    still = [n for n, a, b in zip(tree_leaves(names), tree_leaves(p),
                                  tree_leaves(params)) if torch.equal(a, b)]
    _check(all(n in ("ln", "final_ln") for n in still),
           f"parameter leaves unchanged after {TRAIN_STEPS} steps: {still}")
    bnd = _dense_bounds(cfg, LM_B, LM_T, LM_B * LM_T)
    train_flops = 3 * bnd["flops"]
    train_bound = train_flops / BF16_TENSOR_FLOPS_PER_S * 1e3
    stats = {}
    _profile("[l]", "1 traced train step", lambda: step(p, s, batch), stats)
    print(f"[l] (b) {LM_ARCH} at full size ({n_params:,} parameters, "
          f"{cfg.dtype}, {cfg.optimizer}, remat {cfg.remat}, "
          f"{cfg.attn_impl} attention), B = {LM_B}, T = {LM_T}: leaves "
          f"unchanged {still}; losses "
          f"{[float(f'{x:.6g}') for x in losses]}; ms a step "
          f"{[float(f'{x:.4f}') for x in step_ms]} (host clock, "
          f"synchronised; the first with cold starts); bound "
          f"{train_bound:.4g} ms (3 x the forward's {bnd['flops']:.4g} flop "
          f"at 989 TFLOP/s); peak memory allocated {peak:,} bytes "
          f"({peak / 2 ** 30:.2f} GiB); traced step: device "
          f"{stats['device_ms']:.3f} ms, busy share "
          f"{_fmt(_div(stats['union_ms'], stats['wall_ms']), '.4f')}")
    del p, s, met

    # (c) make_hfl_lm_train_step at the same size: P pods, K local steps.
    toks = torch.randint(0, cfg.vocab, (HFL_PODS, HFL_K, LM_B, LM_T),
                         generator=gen, device=dev)
    stacked = tree_map(lambda t: torch.stack([t] * HFL_PODS), params)
    states = tree_map(lambda t: torch.stack([t] * HFL_PODS),
                      opt.init(params))
    hstep = make_hfl_lm_train_step(cfg, opt, K=HFL_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp, hs, hm = hstep(stacked, states, {"tokens": toks})
    torch.cuda.synchronize()
    hfl_ms = (time.perf_counter() - t0) * 1e3
    del stacked, states, hs
    pods = []
    for i in range(HFL_PODS):
        q, st = params, opt.init(params)
        for k in range(HFL_K):
            g = tf.value_and_grad(cfg, q, {"tokens": toks[i, k]})[2]
            q, st = opt.update(g, st, q)
        pods.append(q)
        del st
    same = apart = 0
    leaves = tree_leaves(hp)
    for j, leaf in enumerate(leaves):
        same += all(torch.equal(leaf[0], leaf[i])
                    for i in range(1, HFL_PODS))
        mean = torch.stack([tree_leaves(q)[j].float() for q in pods]
                           ).mean(0).to(leaf.dtype)
        apart += torch.equal(leaf[0], mean)
    _check(same == len(leaves), f"hfl_lm: only {same} of {len(leaves)} "
           f"leaves are bitwise equal across the pods")
    _check(apart == len(leaves), f"hfl_lm: only {apart} of {len(leaves)} "
           f"leaves equal the f32 mean of the pods' own steps, bitwise")
    _check(math.isfinite(float(hm["ce"])), "hfl_lm: non-finite ce")
    _add(path, {k: ops.LAUNCHES[k] - before[k] for k in before})
    print(f"[l] (c) make_hfl_lm_train_step at full size, P = {HFL_PODS} "
          f"pods x K = {HFL_K} local steps: {hfl_ms:.1f} ms, ce "
          f"{float(hm['ce']):.6g}; every leaf bitwise equal across the pods "
          f"and to the f32 mean of the pods' own steps run apart "
          f"({len(leaves)} leaves)")
    del hp, pods, params, batch, toks

    # (d) K4 refuses to run under autograd on the card, before a launch.
    q = torch.randn((1, 64, 2, 64), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    n0 = ops.LAUNCHES["flash_attention"]
    try:
        ops.flash_attention(q, q.detach(), q.detach())
        refused = False
    except RuntimeError:
        refused = True
    _check(refused and ops.LAUNCHES["flash_attention"] == n0,
           "K4 ran under autograd")
    rcfg = dataclasses.replace(configs.get(LM_ARCH).reduced(),
                               attn_impl="pallas")
    rp, rb = _lm_train_inputs(rcfg)
    rp = tree_map(lambda t: t.to(dev), rp)
    try:
        tf.make_train_step(rcfg, optim.sgd())(
            rp, optim.sgd().init(rp), {k: v.to(dev) for k, v in rb.items()})
        refused = False
    except RuntimeError:
        refused = True
    _check(refused, "a train step on attn_impl='pallas' ran")
    torch.cuda.empty_cache()
    print("[l] (d) K4 raised under autograd on the card, before any "
          "launch, and so did a train step on attn_impl='pallas'")
    # (e) The recurrent families at full width on S1-S3 and S1b-S3b.
    recurrent = {}
    for arch, layers in ((XLSTM_ARCH, None), (SSM_ARCH, ZAMBA_TRAIN_LAYERS)):
        recurrent[arch] = _recurrent_train(dev, arch, layers)
        _add(path, recurrent[arch]["counts"])
    seconds = time.perf_counter() - t_phase
    print(f"[l] the training path's launches: "
          f"{json.dumps(_by_kernel(path))}")
    print(f"[l] phase l: {seconds:.1f} s")
    return {"cpu_errs": errs, "losses": losses, "step_ms": step_ms,
            "bound_ms": train_bound, "peak_bytes": peak, "trace": stats,
            "hfl_ms": hfl_ms, "counts": path, "recurrent": recurrent,
            "seconds": seconds}


def _recurrent_counts(cfg, T: int) -> dict:
    """The recurrence launches of one train step of T tokens with remat:
    each forward op twice a layer (the forward and its recompute), each
    backward op once, S1's and S1b's on the chunked kernels where
    ``mamba2_route`` sends T, S2b's where ``mlstm_route`` does, S3b's on
    its short step; none for the other families."""
    from repro_torch.kernels import ssm_scan

    if cfg.family == "mamba_hybrid":
        need = {"mamba2_scan": 2 * cfg.n_layers,
                "mamba2_scan_bwd": cfg.n_layers}
        if ssm_scan.mamba2_route(T, cfg.ssm_state,
                                 cfg.ssm_headdim) == "chunked":
            need.update(mamba2_scan_chunked=2 * cfg.n_layers,
                        mamba2_scan_bwd_chunked=cfg.n_layers)
        return need
    if cfg.family == "xlstm":
        pairs = cfg.n_layers // 2
        need = {"mlstm_scan": 2 * pairs, "slstm_scan": 2 * pairs,
                "mlstm_scan_bwd": pairs, "slstm_scan_bwd": pairs,
                "slstm_scan_bwd_short": pairs}
        if ssm_scan.mlstm_route(T, cfg.d_model // cfg.n_heads) == "chunked":
            need["mlstm_scan_bwd_chunked"] = pairs
        return need
    return {}


@contextlib.contextmanager
def _no_twins():
    """Raise if a recurrence's plain twin (forward or backward) runs: on
    the card the ops launch their kernels or raise."""
    from repro_torch.kernels import ssm_scan

    class Trap:
        def __getattr__(self, name):
            def trap(*args, **kwargs):
                raise RuntimeError(f"the twin ref.{name} ran on the card")
            return trap

    saved = ssm_scan.ref
    ssm_scan.ref = Trap()
    try:
        yield
    finally:
        ssm_scan.ref = saved


def _recurrent_train(dev, arch: str, n_layers: int | None) -> dict:
    """Phase l (e): ``arch`` at full width (``n_layers`` of its layers, or
    all), AdamW, remat, B x T tokens, TRAIN_STEPS steps on one batch:
    each step's recurrence launches (``_recurrent_counts``) and no twin,
    finite losses, ms a step, peak memory beside the bound, one traced
    step; for xlstm-125m one step on the twins' route too (the route before
    the backward kernels)."""
    import torch

    from repro_torch import configs, optim
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import tree_leaves

    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(cfg, gen, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_B, LM_T),
                                     generator=gen, device=dev)}
    opt = optim.get_optimizer("adamw")
    step = tf.make_train_step(cfg, opt)
    need = _recurrent_counts(cfg, LM_T)
    total = {k: 0 for k in ops.LAUNCHES}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, s, losses, step_ms = params, opt.init(params), [], []
    with _no_twins():
        for _ in range(TRAIN_STEPS):
            ops.reset_launches()
            t0 = time.perf_counter()
            p, s, met = step(p, s, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
            made = dict(ops.LAUNCHES)
            _check(all(made[k] == need.get(k, 0) for k in made
                       if k != "ssm_scan"), f"{arch}: a train step launched "
                   f"{_by_kernel(made)}, want {need}")
            _add(total, made)
    peak = torch.cuda.max_memory_allocated()
    _check(all(math.isfinite(x) for x in losses), f"{arch}: non-finite "
           f"losses {losses}")
    stats = {}
    with _no_twins():
        _profile("[l]", f"1 traced {arch} train step",
                 lambda: step(p, s, batch), stats)
    # The bound: the bf16 products of forward, recompute-free backward
    # (3 x the forward's, the head over every position) and the float32
    # time loops (forward twice under remat, backward once).
    bnd = _ssm_bounds(cfg, LM_B, LM_T)
    head = 2 * LM_B * cfg.d_model * cfg.vocab
    mm = 3 * (bnd["prefill_flops"] - head + LM_T * head)
    if cfg.family == "mamba_hybrid":
        _, Hs = ssm.mamba2_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_headdim)
        bwd = cfg.n_layers * _ssm_bwd_f32_flops(
            "mamba2_scan_bwd", LM_B, LM_T, Hs, cfg.ssm_headdim, cfg.ssm_state)
    else:
        hd = cfg.d_model // cfg.n_heads
        bwd = cfg.n_layers // 2 * sum(
            _ssm_bwd_f32_flops(n, LM_B, LM_T, cfg.n_heads, hd)
            for n in ("mlstm_scan_bwd", "slstm_scan_bwd"))
    f32 = 2 * bnd["prefill_f32_flops"] + bwd
    bound = max(mm / BF16_TENSOR_FLOPS_PER_S, f32 / FP32_FLOPS_PER_S) * 1e3
    row = dict(arch=arch, n_layers=cfg.n_layers, n_params=n_params,
               losses=losses, step_ms=step_ms, peak_bytes=peak,
               bound_ms=bound, mm_flops=mm, f32_flops=f32, trace=stats,
               counts=total, per_step=need)
    twin = ""
    if arch == XLSTM_ARCH:
        # One step on the twins' route, cut to TWIN_TRAIN_T tokens (at
        # T = 1,024 it takes about a minute).
        short = {"tokens": batch["tokens"][:, :TWIN_TRAIN_T]}
        ops.reset_launches()
        with _twin_recurrences():
            t0 = time.perf_counter()
            step(p, s, short)
            torch.cuda.synchronize()
            row["twin_ms"] = (time.perf_counter() - t0) * 1e3
        _check(ops.LAUNCHES["ssm_scan"] == 0, f"{arch}: a recurrence kernel "
               f"launched on the twins' route")
        twin = (f"; one step on the twins' route (the route before the "
                f"backward kernels) at T = {TWIN_TRAIN_T} "
                f"{row['twin_ms']:.1f} ms")
    print(f"[l] (e) {arch} at full width, {cfg.n_layers} layers "
          f"({n_params:,} parameters, {cfg.dtype}, AdamW, remat), B = "
          f"{LM_B}, T = {LM_T}: launches a step {json.dumps(need)} and no "
          f"twin; losses {[float(f'{x:.6g}') for x in losses]}; ms a step "
          f"{[float(f'{x:.4f}') for x in step_ms]} (host clock, "
          f"synchronised; the first with cold starts); bound {bound:.4g} ms "
          f"(bf16 products {mm:.4g} flop at 989 TFLOP/s, the time loops "
          f"{f32:.4g} f32 flop at 67 TFLOP/s); peak memory allocated "
          f"{peak:,} bytes ({peak / 2 ** 30:.2f} GiB); traced step: device "
          f"{stats['device_ms']:.3f} ms, busy share "
          f"{_fmt(_div(stats['union_ms'], stats['wall_ms']), '.4f')}" + twin)
    del p, s, params, met
    torch.cuda.empty_cache()
    return row


# Phase d: the mesh, sharding and dry-run layer and distributed HFL.  (a)
# Algorithm 1 with phase f's users split over ranks, held to phase f's
# single-process iteration on the card within TRAIN_TOL of max |leaf|;
# (b) the dry-run on a 1 x 1 mesh against the same steps run for real:
# phase 8's prefill and phase l's AdamW train step (qwen1.5-0.5b, B x T);
# (c) two cells on the 16 x 16 production mesh (a fake process group of
# 256 ranks, meta shards); (d) the fleet split over the cards.
DRY_CELLS = (("qwen2.5-32b", "train_4k"),
             ("llama4-scout-17b-a16e", "decode_32k"),
             (SSM_ARCH, "train_4k"), (XLSTM_ARCH, "train_4k"))


def _dist_path(dev, hfl_run: dict) -> dict:
    """Phase d: distributed HFL on NCCL (one rank a card) and, on one
    card, on gloo at 2 ranks sharing it; the dry-run's arguments against
    the bytes the same steps allocate on the card, its peak beside the
    card's; two production-mesh cells; the fleet split over two or more
    cards."""
    import torch

    from repro_torch.core import sroa
    from repro_torch.fed import distributed as tdist
    from repro_torch.fleet import batch as fbatch
    from repro_torch.fleet import engine as fengine
    from repro_torch.fleet.service import shard as fshard
    from repro_torch.launch import dryrun
    from repro_torch.models.cnn import tree_leaves

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    # (a) Distributed HFL against the single-process iteration on the card.
    w, *data, part = hfl_run["inputs"]
    want = tree_leaves(hfl_run["card"])
    # Of the whole model's max |leaf|: cuDNN's weight gradients add in a
    # run-dependent order, and a bias leaf two orders of magnitude below
    # the weights has no room for that in a bound of its own (one NCCL
    # rank and the single-process iteration, the same arithmetic, lay
    # 1.4e-6 apart on a bias leaf of max 0.0101 on an H100).
    scale = max(float(c.abs().max()) for c in want)
    runs = [("nccl", min(4, n_cards))]
    if n_cards == 1:
        runs.append(("gloo", 2))
    dist_runs = {}
    for backend, world in runs:
        t0 = time.perf_counter()
        ranks = tdist.run_ranks(
            world, backend, tdist.global_iteration_on_ranks, hfl_run["cfg"],
            hfl_run["hcfg"], hfl_run["M"], False, w, tuple(data), [part], 3,
            device="cuda")
        spawn_s = time.perf_counter() - t0
        err = 0.0
        for out in ranks:
            for g, c in zip(tree_leaves(out["w"][0]), want):
                e = float((g - c.cpu()).abs().max())
                _check(e <= TRAIN_TOL * scale, f"{backend} x {world}: "
                       f"{e:.3g} from the single-process iteration, past "
                       f"{TRAIN_TOL} x {scale:.3g}")
                err = max(err, e / scale)
        key = f"{backend}x{world}"
        dist_runs[key] = dict(ms=ranks[0]["ms"], bytes=ranks[0]["bytes"],
                              err=err, spawn_s=spawn_s)
        print(f"[d] (a) distributed HFL, {backend} at {world} rank(s) "
              f"({'one a card' if backend == 'nccl' else 'sharing card 0'}"
              f"): {ranks[0]['ms']:.3f} ms an iteration (rank 0, host "
              f"clock, mean of 3); {ranks[0]['bytes']:,} bytes all-reduced "
              f"an iteration; max |delta| / max |leaf| against the "
              f"single-process card run {err:.3g} (limit {TRAIN_TOL}); "
              f"spawn and run {spawn_s:.1f} s")

    # (b) The dry-run on a 1 x 1 mesh against the real steps on the card.
    checks, cells = {}, {}
    for kind in ("prefill", "train"):
        checks[kind] = _dry_against_the_card(dev, kind)

    # (c) Two cells on the production mesh (16 x 16, cuda device type).
    for arch, name in DRY_CELLS:
        rec = dryrun.run_cell(arch, name, False, device_type="cuda")
        _check(rec["status"] == "ok", f"dry-run {arch} {name}: {rec}")
        _check(rec["collectives"]["total"] > 0, f"{arch} {name}: no "
               f"collective")
        cells[f"{arch}/{name}"] = rec
        m, c = rec["memory"], rec["collectives"]
        print(f"[d] (c) dry-run {arch} x {name} x 16x16: per device "
              f"arguments {m['argument_size_in_bytes']:,} B, temp "
              f"{m['temp_size_in_bytes']:,} B (the largest backward "
              f"recurrence op's scratch {m['scratch_size_in_bytes']:,} B of "
              f"it), output "
              f"{m['output_size_in_bytes']:,} B, fits 80 GB "
              f"{rec['fits_80gb']}; {rec['flops_per_device']:.4g} matmul "
              f"FLOPs a device; collectives {json.dumps(c)} (counts "
              f"{json.dumps(rec['collective_counts'])}); roofline "
              f"compute {rec['roofline']['compute_term_s']:.4g} s, memory "
              f"{rec['roofline']['memory_term_s']:.4g} s, collective "
              f"{rec['roofline']['collective_term_s']:.4g} s; traced in "
              f"{rec['trace_s']:.1f} s")

    # (d) The fleet split over the cards, bitwise one card's search.
    split = None
    if n_cards >= 2:
        fleet = fbatch.draw_fleet(0, 128, device=dev)
        kw = dict(lam=1.0, cfg=sroa.SroaConfig(**SERVE_CAPS, fused=True),
                  max_rounds=12, escape_iters=2, top_k=TOP_K)
        t0 = time.perf_counter()
        whole = fengine.solve_fleet_assignments(fleet, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        devices = [f"cuda:{i}" for i in range(n_cards)]
        parts = fshard.solve_fleet_sharded(fleet, devices=devices, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        a, b = list(_flat_tensors(whole)), list(_flat_tensors(parts))
        _check(len(a) == len(b) and all(
            x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
            for x, y in zip(a, b)), "the fleet split over the cards "
            "differs from one card's search")
        split = dict(cards=n_cards, one_ms=(t1 - t0) * 1e3,
                     split_ms=(t2 - t1) * 1e3)
        print(f"[d] (d) solve_fleet_sharded over {n_cards} cards on "
              f"draw_fleet(0, 128): bitwise one card's search ({len(a)} "
              f"tensors); one card {split['one_ms']:.1f} ms, split "
              f"{split['split_ms']:.1f} ms")
    else:
        print("[d] (d) the fleet split over cards not run: one card "
              "visible")
    seconds = time.perf_counter() - t_phase
    print(f"[d] phase d: {seconds:.1f} s")
    return {"dist": dist_runs, "dry": checks, "cells": cells,
            "split": split, "seconds": seconds}


def _dry_against_the_card(dev, kind: str) -> dict:
    """Phase d (b): the 1 x 1 dry-run of qwen1.5-0.5b's ``kind`` step at
    B x T against the same step run on the card: the arguments exactly,
    the predicted peak beside the card's."""
    import torch

    from repro_torch import configs, optim
    from repro_torch.configs import shapes as shp
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import tree_leaves

    cfg = configs.get(LM_ARCH)
    shape = shp.ShapeSpec(f"{kind}_{LM_T}", kind, LM_T, LM_B)
    rec = dryrun.run_cell(LM_ARCH, shape, False, device_type="cuda",
                          mesh_shape=((1, 1), ("data", "model")))
    _check(rec["status"] == "ok", f"dry-run {kind}: {rec}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(cfg, gen, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_B, LM_T),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    args = [params, batch]
    if kind == "train":
        opt = optim.get_optimizer(cfg.optimizer)
        args.insert(1, opt.init(params))
        step = tf.make_train_step(cfg, opt)
    else:
        step = tf.make_prefill_step(cfg)
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for a in args for t in tree_leaves(a)}
    allocated = sum(storages.values())
    mem = rec["memory"]
    _check(mem["argument_size_in_bytes"] == allocated,
           f"dry-run {kind}: arguments {mem['argument_size_in_bytes']:,} "
           f"bytes, the card allocates {allocated:,}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, args, params, batch
    torch.cuda.empty_cache()
    print(f"[d] (b) dry-run of {LM_ARCH} {kind} (B = {LM_B}, T = {LM_T}) on "
          f"a 1 x 1 mesh: arguments {allocated:,} bytes, equal to what the "
          f"card allocates; predicted temp {mem['temp_size_in_bytes']:,} "
          f"bytes beside the card's peak above the arguments {peak:,} "
          f"(ratio {mem['temp_size_in_bytes'] / peak:.4f}; information); "
          f"{rec['flops_per_device']:.4g} matmul FLOPs; traced in "
          f"{rec['trace_s']:.1f} s")
    return dict(arg=allocated, temp=mem["temp_size_in_bytes"], peak=peak,
                trace_s=rec["trace_s"], flops=rec["flops_per_device"])


def _flat_tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _flat_tensors(y)


def main(argv: list[str]) -> int:
    kernels_only = "--kernels" in argv
    try:
        import numpy as np
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the port's kernels run only on a card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return _fail(f"{SRC / 'repro_torch'} not found: run this script "
                     "from a checkout of the repository")
    sys.path.insert(0, str(SRC))

    from repro_torch.core import sroa
    from repro_torch.core.system_model import (expand_scenario,
                                               sroa_constants)
    from repro_torch.fleet import batch as fbatch
    from repro_torch.fleet import engine as fengine
    from repro_torch.fleet.service import (PlanningService, ServiceConfig,
                                           run_load)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import sroa_bisect as sb

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[0] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")

    # ---- phase 0: build every kernel from the checkout's sources --------
    t0 = time.perf_counter()
    build.load(verbose=True)
    print(f"[0] built {len(list(build.CSRC.glob('*.cu')))} sources into "
          f"{build.build_dir()} in {time.perf_counter() - t0:.1f} s")
    ptxas = _ptxas(build.build_log)
    for line in ptxas:
        print(f"[0]   ptxas: {line}")
    print("[0] K2 registers: " + "; ".join(
        line.split(" registers")[0] for line in ptxas
        if "sroa_solve" in line))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        rounds = json.dumps(_sass_rounds(subprocess.run(
            [cuobjdump, "-sass", build.load()._name], capture_output=True,
            text=True, check=True).stdout))
    except (OSError, subprocess.CalledProcessError) as exc:
        rounds = f"not measured ({exc})"
    print(f"[0] SASS instructions of the innermost bisection loops (with "
          f"MUFU.RCP; 'nb' branch-free, two rounds of D steps; 'ieee' one "
          f"step with the division's FCHK branch): {rounds}")
    for entry, kernel, hds in (
            ("flash_attention_sm90_occupancy", "flash_attention_sm90_kernel",
             (64, 128, 192, 256)),
            ("flash_attention_sm90_f32_occupancy",
             "flash_attention_tf32x3_kernel", (64, 128))):
        for hd in hds:
            smem, ctas = ctypes.c_int(), ctypes.c_int()
            build.check(getattr(build.load(), entry)(
                hd, ctypes.byref(smem), ctypes.byref(ctas)), entry)
            print(f"[0]   {kernel}<{hd}>: {smem.value} bytes of dynamic "
                  f"shared memory a CTA of 128 threads, {ctas.value} CTAs "
                  f"an SM")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fleet = fbatch.draw_fleet(0, 128, device=dev)
    C, N, M = fleet.C, fleet.N_max, fleet.M
    print(f"[0] fleet: draw_fleet(0, 128): C={C}, N_max={N}, M={M}, "
          f"{int(fleet.n_users.sum())} users")
    cells, mask = fleet.cells, fleet.mask
    init = fbatch.fleet_assignments(fleet)
    report = {}

    # ---- phase 1: K1 against its plain version -------------------------
    c0 = sroa_constants(cells, init, mask)
    G = (cells.p_max * c0.h / cells.N0[:, None]).contiguous()
    frac = torch.rand(G.shape, generator=torch.Generator(device="cpu")
                      .manual_seed(1)).to(dev) * 1.2
    tgt = (frac * G / math.log(2.0)).contiguous()
    bm = cells.B_open
    k1 = lambda: ops.sroa_invert_rate_batched(G, tgt, bm, 42)  # noqa: E731
    k1p = lambda: ref.invert_rate_plain(G, tgt, bm[:, None], 42)  # noqa
    got, want = k1(), k1p()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    _check(torch.equal(got, want), "K1 differs from its twin")
    err = _max_abs_err([got], [want])
    t0 = time.perf_counter()
    bad = sb.math_check(dev)
    _check(bad == (0, 0), f"the branch-free log1pf / division differ from "
           f"the toolkit's on {bad} inputs")
    print(f"[1] branch-free log1pf == log1pf on every float of [+0, "
          f"FLT_MAX] and fast division == IEEE division on 2^32 hashed pairs "
          f"(0 mismatches, {time.perf_counter() - t0:.2f} s)")
    # Every speculation depth gives the twin's bits; each is timed on the
    # same flattened tensors as the routed call.
    flat = [x.reshape(-1).contiguous()
            for x in (G, tgt, torch.broadcast_to(bm[:, None], G.shape))]
    k1_depth = sb.invert_depth(G.numel(), sms)
    k1_depth_ms = {}
    for d in sb.DEPTHS:
        for iters in (42, SERVE_CAPS["b_iters"], 7):
            _check(torch.equal(
                sb.invert_rate_cuda(*flat, iters, _depth=d).reshape(G.shape),
                ref.invert_rate_plain(G, tgt, bm[:, None], iters)),
                f"K1 at depth {d}, {iters} steps differs from its twin")
        k1_depth_ms[d] = _device_ms(
            lambda: sb.invert_rate_cuda(*flat, 42, _depth=d), 50)
    for n in (1, 17, 3 * 17):
        g, t = G.reshape(-1)[:n], tgt.reshape(-1)[:n]
        torch.testing.assert_close(
            ops.sroa_invert_rate(g, t, 1e6, 42),
            ref.invert_rate_plain(g, t, 1e6, 42), rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(
            ops.sroa_invert_rate_batched(g.reshape(1, n), t.reshape(1, n),
                                         bm[:1], 42),
            ref.invert_rate_plain(g.reshape(1, n), t.reshape(1, n),
                                  bm[:1, None], 42), rtol=1e-5, atol=1e-3)
    torch.cuda.synchronize()
    # K1 with one scalar cap (the TPU's `_bisect_kernel`) at one cell's
    # N_max users, timed apart: G and target in, the result out, one cap.
    g56, t56 = G.reshape(-1)[:56], tgt.reshape(-1)[:56]
    k1a = lambda: ops.sroa_invert_rate(g56, t56, 1e6, 42)  # noqa: E731
    k1a_bound = _bound_ms(12 * 56 + 4, 56 * 8 * 43)
    k1a_times = dict(k1a_ms=_time_ms(k1a, 50), k1a_device_ms=_device_ms(
        k1a, 50), k1a_plain_ms=_time_ms(
        lambda: ref.invert_rate_plain(g56, t56, 1e6, 42), 5),
        k1a_bound_ms=k1a_bound[0], k1a_bound_by=k1a_bound[1])
    n_el = G.numel()
    bound = _bound_ms(16 * n_el, n_el * 8 * 43)
    report["sroa_invert"] = dict(
        name="sroa_invert", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:84",
        max_abs_err=err, ms=_time_ms(k1, 50), plain_ms=_time_ms(k1p, 5),
        device_ms=_device_ms(k1, 50),
        bound_ms=bound[0], bound_by=bound[1], library_ms=None,
        depth=k1_depth, depth_device_ms=k1_depth_ms, **k1a_times)
    r = report["sroa_invert"]
    print(f"[1] K1 ok at ({C}, {N}) per-element caps and n = 1, 17, 51: "
          f"max |err| {err:.3g} Hz; bitwise its twin at depths "
          f"{list(sb.DEPTHS)} x 42, {SERVE_CAPS['b_iters']}, 7 steps")
    print(f"[1] K1 at ({C}, {N}), 42 steps: {r['ms']:.4g} ms (device "
          f"{_fmt(r['device_ms'])}) at the picked depth {k1_depth}; device ms "
          f"by depth {json.dumps(k1_depth_ms)}")
    print(f"[1] K1 with a scalar cap (K1a) at n = 56: "
          f"{k1a_times['k1a_ms']:.4g} ms (device "
          f"{_fmt(k1a_times['k1a_device_ms'])}), plain "
          f"{k1a_times['k1a_plain_ms']:.4g} ms, bound {k1a_bound[0]:.3g} ms "
          f"by {k1a_bound[1]}")

    # ---- phase 2: K2 against its plain version on one engine round -----
    cands, valid = fengine._pruned_candidates(cells, init, mask, TOP_K)
    cs = expand_scenario(cells, 1)
    cc = sroa_constants(cs, cands, mask[:, None, :])
    A = cands.shape[1]
    P = C * A

    def flat_u(x):
        return torch.broadcast_to(x, (C, A, N)).reshape(P, N).contiguous()

    def flat_s(x):
        return torch.broadcast_to(x, (C, A)).reshape(P).contiguous()

    ones = torch.ones((), device=dev)
    per_user = [flat_u(x) for x in (cc.A, cc.J, cc.H, cc.delta, cc.h,
                                    cs.f_max, cs.p_max)]
    per_prob = [flat_s(x) for x in (cs.B_open, cs.B_open, cs.N0, ones,
                                    cc.E_cloud_total)]
    k2_kw = dict(SERVE_CAPS, eps0=1e-4, eps1=1e-4, eps2=1e-4, t_low=1.0,
                 t_up=3e7)               # sroa_solve_batched's defaults

    def on(route, pu, pp):
        """K2 on one kernel (and depth), past the routing rule."""
        return lambda: sb.solve_cuda(tuple(pu), tuple(pp), **k2_kw,
                                     _route=route)[0]

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    # The re-price shape: one problem per cell (its nearest-edge pattern).
    rp_user = [x.contiguous() for x in (c0.A, c0.J, c0.H, c0.delta, c0.h,
                                        cells.f_max, cells.p_max)]
    rp_prob = [x.contiguous() for x in (cells.B_open, cells.B_open,
                                        cells.N0, ones.expand(C),
                                        c0.E_cloud_total)]
    shapes = {"plan": (per_user, per_prob), "reprice": (rp_user, rp_prob)}
    got, outs, t2 = {}, {}, {}
    for key, (pu, pp) in shapes.items():
        routed = lambda: ops.sroa_solve_batched(  # noqa: E731
            *pu, *pp, **SERVE_CAPS)
        got[key] = routed()
        outs[key] = on(("warp", 0), pu, pp)()
        route = sb.solve_route(pu[0].shape[0], N, sms)
        _check(route[0] == "lanes", f"K2 at {key} took {route}")
        _check(same(got[key], outs[key]), f"K2 at {key}: the routed call "
               f"{route} differs from PR 11's kernel")
        for d in sb.DEPTHS:
            _check(same(on(("lanes", d), pu, pp)(), outs[key]),
                   f"K2 at {key}: the lanes kernel at depth {d} differs "
                   f"from PR 11's kernel")
        # Times first: after the plain twin's 33 s of uninstrumented eager
        # kernels, a profiler session that holds only K2 records no device
        # activity (sessions of K1 still do), so K2's device times are
        # read before the twin runs.
        pr11 = on(("warp", 0), pu, pp)
        t2[key] = dict(
            route=route, ms=_time_ms(routed, 5), device_ms=_device_ms(
                routed, 3, kernel="sroa_solve"), pr11_ms=_time_ms(pr11, 5),
            pr11_device_ms=_device_ms(pr11, 3, kernel="sroa_solve"),
            depth_device_ms={d: _device_ms(on(("lanes", d), pu, pp), 3,
                                           kernel="sroa_solve")
                             for d in sb.DEPTHS})
    # Where the depth rule's crossover lies: the planning batch's first P
    # problems at every depth (2P warps, P / 264 warps a scheduler on 132
    # SMs), timed with the others before the twin runs.
    sweep = {}
    for n_prob in (256, 512, 768):
        pu, pp = ([x[:n_prob].contiguous() for x in xs]
                  for xs in (per_user, per_prob))
        sweep[n_prob] = {d: _device_ms(on(("lanes", d), pu, pp), 3,
                                       kernel="sroa_solve")
                         for d in sb.DEPTHS}
    # K2 at phase t's shapes (TSIA's P = 1, the host loop's P = 201).
    k2_tsia = _time_k2_tsia_shapes(_k2_tsia_shapes(dev))
    torch.cuda.synchronize()
    work, plain_ms = {}, {}
    for key, (pu, pp) in shapes.items():
        work[key] = {}
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = ref.sroa_solve_plain(*pu, *pp, **SERVE_CAPS, work=work[key])
        e1.record()
        e1.synchronize()
        plain_ms[key] = e0.elapsed_time(e1)
        _check(same(got[key], want), f"K2 at {key} differs from its twin")
        if key == "plan":
            _check(torch.equal(got[key][6], want[6]),
                   "K2 feasible flags differ")
            torch.testing.assert_close(got[key][4], want[4], rtol=1e-4,
                                       atol=0)
            torch.testing.assert_close(got[key][3], want[3], rtol=1e-4,
                                       atol=0)
            torch.testing.assert_close(got[key][0], want[0], rtol=1e-3,
                                       atol=1.0)
            err = _max_abs_err(got[key][4:5], want[4:5])
    for q in (0, P // 2 + 3, P - 1):
        alone = ops.sroa_solve_batched(*(x[q:q + 1] for x in per_user),
                                       *(x[q:q + 1] for x in per_prob),
                                       **SERVE_CAPS)
        for x, y in zip(got["plan"], alone):
            _check(torch.equal(x[q:q + 1], y), f"K2 problem {q} not bitwise")
    torch.cuda.synchronize()

    flops, bound = _k2_bound(work["plan"], P, N)
    rp_bound = _k2_bound(work["reprice"], C, N)[1]
    tp, tr = t2["plan"], t2["reprice"]
    reprice = dict(P=C, plain_ms=plain_ms["reprice"], bound_ms=rp_bound[0],
                   bound_by=rp_bound[1], work=work["reprice"])
    report["sroa_solve_lanes"] = dict(
        name="sroa_solve_lanes", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:167",
        max_abs_err=err, ms=tp["ms"], plain_ms=plain_ms["plan"],
        device_ms=tp["device_ms"], bound_ms=bound[0], bound_by=bound[1],
        library_ms=None, depth=tp["route"][1],
        depth_device_ms=tp["depth_device_ms"],
        reprice=dict(reprice, ms=tr["ms"], device_ms=tr["device_ms"],
                     depth=tr["route"][1],
                     depth_device_ms=tr["depth_device_ms"]))
    # PR 11's kernel (K2's route for N > 512) on the same tensors.
    report["sroa_solve"] = dict(
        name="sroa_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:167",
        max_abs_err=err, ms=tp["pr11_ms"], plain_ms=plain_ms["plan"],
        device_ms=tp["pr11_device_ms"], bound_ms=bound[0],
        bound_by=bound[1], library_ms=None,
        reprice=dict(reprice, ms=tr["pr11_ms"],
                     device_ms=tr["pr11_device_ms"]))
    worst = fengine.sroa_solve_flops(N, sroa.SroaConfig(**SERVE_CAPS)) * P
    print(f"[2] K2 ok on P = {C} x {A} = {P} problems, N = {N}: the lanes "
          f"kernel at depths {list(sb.DEPTHS)}, PR 11's kernel and the "
          f"twin bitwise equal (feasible {int(got['plan'][6].sum())}/{P}, "
          f"max |dR| {err:.3g}), 3 problems alone == in batch bitwise; this "
          f"data's work {work['plan']} = {flops:.4g} flop (cap model "
          f"{worst:.4g})")
    occ = {}
    for d in sb.DEPTHS:
        blocks = ctypes.c_int()
        build.check(build.load().sroa_solve_lanes_occupancy(
            d, N, ctypes.byref(blocks)), "sroa_solve_lanes_occupancy")
        occ[d] = blocks.value
    report["sroa_solve_lanes"]["blocks_per_sm"] = occ
    report["sroa_solve_lanes"]["depth_sweep_device_ms"] = sweep
    W = math.ceil(N / 32)
    print("[2] lanes kernel device ms by depth on the planning batch's "
          "first P problems: " + "; ".join(
              f"P = {n} ({n * W / (4 * sms):.3g} warps a scheduler) "
              f"{json.dumps(t)}" for n, t in sweep.items()))
    print(f"[2] lanes kernel at N = {N}: one problem a block of "
          f"{32 * math.ceil(N / 32)} threads; blocks an SM by depth "
          f"{json.dumps(occ)} ({sms} SMs)")
    cluster_occ = {}
    for n_users in (600, X_N, 4096):
        for d in sb.DEPTHS:
            b, c, cs, w = (ctypes.c_int() for _ in range(4))
            build.check(build.load().sroa_solve_cluster_occupancy(
                d, n_users, *map(ctypes.byref, (b, c, cs, w))),
                "sroa_solve_cluster_occupancy")
            cluster_occ[f"N{n_users} depth {d}"] = dict(
                blocks_a_cluster=cs.value, warps_a_block=w.value,
                blocks_per_sm=b.value, clusters_at_once=c.value)
    print(f"[2] cluster kernel (N > 512): one problem a cluster; "
          f"{json.dumps(cluster_occ)} ({sms} SMs)")
    for key, t in t2.items():
        n_prob = shapes[key][0][0].shape[0]
        pr11_dev, dev_ms = t["pr11_device_ms"], t["device_ms"]
        ratio = (f"{pr11_dev / dev_ms:.3g}x" if pr11_dev and dev_ms
                 else "not measured")
        print(f"[2] K2 at P = {n_prob}, N = {N} ({key}): lanes kernel depth "
              f"{t['route'][1]} {t['ms']:.4g} ms (device {dev_ms}); PR 11's "
              f"kernel {t['pr11_ms']:.4g} ms (device {pr11_dev}), {ratio} "
              f"the lanes kernel's device time; device ms by depth "
              f"{json.dumps(t['depth_device_ms'])}; bitwise equal to the "
              f"twin ({plain_ms[key]:.0f} ms)")

    # ---- phase 3: K3's two kernels against their plain version ---------
    _check_k3(report, dev, cells, init, mask, sms)

    # ---- phases 4 and 5: K4 and K5 against their plain versions --------
    _check_k4(report, dev)
    _check_k5(report, dev)
    if kernels_only:
        print(json.dumps({"kernels": list(report.values())}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 6: the planning path ------------------------------------
    cfg = sroa.SroaConfig(**SERVE_CAPS, fused=True)
    svc_cfg = ServiceConfig(top_k=TOP_K, max_rounds=12, escape_iters=2)
    ops.reset_launches()
    t0 = time.perf_counter()
    svc = PlanningService(fbatch.draw_fleet(0, 128, device=dev), lam=1.0,
                          sroa_cfg=cfg, cfg=svc_cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"[6] bootstrap: sum R = {float(svc.R_ref.sum()):.6g} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    recs = []

    def on_tick(rec):
        recs.append(rec)
        print(f"[6] tick {rec.tick}: changed {rec.changed}, replanned "
              f"{rec.replanned.size}, served {rec.served}, sum R "
              f"{rec.sum_R:.6g}, {rec.tick_ms:.1f} ms")

    snap = run_load(svc, ticks=3, req_per_tick=2.0, seed=7,
                    on_tick=on_tick)
    torch.cuda.synchronize()
    main_counts = dict(ops.LAUNCHES)
    print(f"[6] telemetry: {json.dumps(snap)}")
    _check(len(recs) == 3 and snap["unserved"] == 0, "unserved requests")
    _check(all(math.isfinite(r.sum_R) for r in recs), "non-finite sum R")
    _check(np.isfinite(svc.alloc.R).all() and np.isfinite(svc.R_ref).all(),
           "non-finite R")
    _check(((svc.assigns >= 0) & (svc.assigns < M)).all(),
           "assignment off the edge range")

    # ---- phase 7: the use_pallas route (K1 inside the eager nest) ------
    assigns = torch.as_tensor(svc.assigns, device=dev)
    pal = sroa.SroaConfig(**SERVE_CAPS, use_pallas=True)
    ops.reset_launches()
    got = fbatch.solve_batch(svc.fleet, assigns, 1.0, pal)
    torch.cuda.synchronize()
    invert_count = ops.LAUNCHES["sroa_invert"]
    want = fbatch.solve_batch(svc.fleet, assigns, 1.0,
                              sroa.SroaConfig(**SERVE_CAPS))
    torch.testing.assert_close(got.R, want.R, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.R.cpu(), torch.as_tensor(svc.alloc.R),
                               rtol=5e-3, atol=0)
    print(f"[7] use_pallas solve_batch ok: {invert_count} K1 launches; R "
          f"== eager nest (rtol 1e-5), == fused re-price (rtol 5e-3)")

    _profile("[p]", "2 traced ticks",
             lambda: [svc.tick() for _ in range(2)])
    del svc

    # ---- phase 8: the LM serving path ----------------------------------
    lm = _lm_path(dev)

    # ---- phase a: the LM serving path in float32 (3xTF32 K4) -----------
    torch.cuda.empty_cache()
    ap = _f32_lm_path(dev)

    # ---- phase m: the moe family at llama4-scout's full width ----------
    torch.cuda.empty_cache()
    mp = _moe_path(dev)

    # ---- phase s: the hybrid and xlstm families at full size ----------
    torch.cuda.empty_cache()
    sp = _ssm_path(dev)

    # ---- phase e: the encoder family and the mixed frontend ------------
    torch.cuda.empty_cache()
    ep = _encoder_path(dev)

    # ---- phase l: LM training ------------------------------------------
    lp = _lm_train_path(dev)

    # ---- phase t: TSIA, the baselines and the per-cell planner ---------
    tp = _tsia_path(dev, report, k2_tsia)

    # ---- phase h: restarts, horizon, compression, topology -------------
    hp = _plan_extensions_path(dev)

    # ---- phase x: the large-cell planning path (N = 2,048, M = 16) -----
    xp = _large_cell_path(dev)

    # ---- phase f: the training pipeline --------------------------------
    fp = _train_path(dev)

    # ---- phase d: distributed HFL, the dry-run, the fleet split --------
    dp = _dist_path(dev, fp["hfl"])

    # ---- phase 9: launch counts and times ------------------------------
    # Four kernels lie on no path: K5 (no model calls it), K4's SIMT
    # kernel (the route of layouts TMA does not address and of f32 with
    # hd > 128; every served model's operands go to a tensor-core kernel)
    # and the one-warp-per-problem K2 and the block K3 kernels (no route
    # takes them; they are the yardsticks).  Their counts are those of the
    # planning path's run, 0, and are not held to be positive.
    # ``flash_attention``, ``sroa_solve`` and ``topk_moves`` count every
    # K4, K2 and K3 launch, so those three kernels' launches are the ones
    # that took no other kernel.  K4's 3xTF32 kernel's launches are phase
    # a's.
    lmc = lm["counts"]
    a_counts = _by_kernel(ap["counts"])
    x_counts = _by_kernel(xp["counts"])
    main_k = _by_kernel(main_counts)
    counts = {"sroa_invert": invert_count,
              "sroa_solve_lanes": main_counts["sroa_solve_lanes"],
              "sroa_solve_cluster": x_counts["sroa_solve_cluster"],
              "sroa_solve": main_k["sroa_solve"],
              "topk_moves_warp": main_counts["topk_moves_warp"],
              "topk_moves_cluster": x_counts["topk_moves_cluster"],
              "topk_moves": main_k["topk_moves"],
              "flash_attention_sm90": lmc["flash_attention_sm90"],
              "flash_attention_sm90_f32": a_counts["flash_attention_sm90_f32"],
              "flash_attention": _by_kernel(lmc)["flash_attention"],
              "rmsnorm": lmc["rmsnorm"]}
    ssm_counts = _by_kernel(sp["counts"])
    for name in (*SSM_SCANS, "mamba2_scan_chunked"):
        counts[name] = ssm_counts[name]
    # S1b-S3b's path is phase l's: LM training.
    train_counts = _by_kernel(lp["counts"])
    for name in (*SSM_BWD, "mamba2_scan_bwd_chunked",
                 "mlstm_scan_bwd_chunked"):
        counts[name] = train_counts[name]
    print(f"[9] kernels: {json.dumps(counts)} (ops.LAUNCHES of the LM run: "
          f"{json.dumps(lmc)})")
    print(f"[9] kernels on phase a's path ({LM_ARCH} in float32): "
          f"{json.dumps(a_counts)}")
    _check(all(n == 0 for k, n in a_counts.items()
               if k != "flash_attention_sm90_f32"),
           f"a kernel other than K4's 3xTF32 kernel launched on phase a's "
           f"path: {a_counts}")
    _check(main_counts["topk_moves_warp"] == main_counts["topk_moves"] > 0,
           f"{main_counts['topk_moves'] - main_counts['topk_moves_warp']} "
           f"of the planning path's {main_counts['topk_moves']} K3 launches "
           f"took the block kernel")
    tsia_counts = _by_kernel(tp["counts"])
    print(f"[9] kernels on phase t's path (TSIA, baselines, per-cell "
          f"planner): {json.dumps(tsia_counts)}")
    for name in ("sroa_invert", "sroa_solve_lanes", "topk_moves_warp"):
        _check(tsia_counts[name] > 0, f"{name} never launched on phase "
               f"t's path")
    h_counts = _by_kernel(hp["counts"])
    print(f"[9] kernels on phase h's path (restarts, horizon, compression, "
          f"topology): {json.dumps(h_counts)}")
    for name in ("sroa_solve_lanes", "topk_moves_warp"):
        _check(h_counts[name] > 0, f"{name} never launched on phase h's "
               f"path")
    print(f"[9] kernels on phase x's path (the large-cell search and "
          f"serve at N = {X_N}, M = {X_M}, top-{X_TOP_K}): "
          f"{json.dumps(x_counts)}")
    _check(all(n == 0 for k, n in x_counts.items()
               if k not in ("sroa_solve_cluster", "topk_moves_cluster")),
           f"a kernel other than the cluster K2 and K3 launched on phase "
           f"x's path: {x_counts}")
    moe_counts = _by_kernel(mp["counts"])
    print(f"[9] kernels on phase m's path (llama4-scout at full width, "
          f"{mp['n_layers']} layers): {json.dumps(moe_counts)}")
    _check(moe_counts["flash_attention_sm90"] == mp["n_layers"],
           "flash_attention_sm90 did not launch once a layer on phase m's "
           "path")
    print(f"[9] kernels on phase s's path (zamba2-7b and xlstm-125m at full "
          f"size): {json.dumps(ssm_counts)}")
    _check(ssm_counts["flash_attention_sm90"] == sp["groups"],
           "flash_attention_sm90 did not launch once a shared-attention "
           "application on phase s's path")
    _check(all(n == 0 for k, n in ssm_counts.items()
               if k not in ("flash_attention_sm90", "mamba2_scan_chunked")
               and k not in SSM_SCANS),
           f"a kernel other than K4's tensor-core kernel and S1-S3 launched "
           f"on phase s's path: {ssm_counts}")
    for name, (kernel, replaces) in (
            *((n, v[:2]) for n, v in SSM_SCANS.items()),
            ("mamba2_scan_chunked", SSM_CHUNKED["mamba2_scan_chunked"])):
        r = sp["kernels"][name]
        report[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/" + (
                "ssd_chunked.cu" if name in SSM_CHUNKED else "ssm_scan.cu"),
            replaces=replaces, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], device_ms=r["device_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            kernel=kernel, shape=r["shape"], rel_err=r["rel_T"],
            rel_err_T1=r["rel_T1"], state_bitwise=r["state_bitwise_T"],
            path="phase s: run_lm, B = 4, T = 1,024, 32 tokens")
        if name.startswith("mamba2"):
            report[name].update(
                mamba2_route=r["route"], sweep=sp["sweep"],
                rel_err_model=r.get("rel_model_T"))
    enc_counts = _by_kernel(ep["encoder"]["counts"])
    vlm_counts = _by_kernel(ep["vlm"]["counts"])
    print(f"[9] kernels on phase e's paths: {ENC_ARCH}'s forward "
          f"{json.dumps(enc_counts)}; {VLM_ARCH}'s run_lm "
          f"{json.dumps(vlm_counts)}")
    for tag, c, n in ((ENC_ARCH, enc_counts, ep["encoder"]["n_layers"]),
                      (VLM_ARCH, vlm_counts, ep["vlm"]["n_layers"])):
        _check(c["flash_attention_sm90"] == n and all(
            v == 0 for k, v in c.items() if k != "flash_attention_sm90"),
            f"{tag}'s path did not launch K4's tensor-core kernel once a "
            f"layer, and nothing else: {c}")
    print(f"[9] kernels on phase l's path (LM training): "
          f"{json.dumps(train_counts)}")
    _check(all(n == 0 for k, n in train_counts.items()
               if k not in SSM_SCANS and k not in SSM_BWD
               and k not in SSM_CHUNKED),
           f"a kernel other than S1-S3 and S1b-S3b launched on phase l's "
           f"training path: {train_counts}")
    for name, (kernel, replaces) in (
            *SSM_BWD.items(),
            *((n, SSM_CHUNKED[n]) for n in ("mamba2_scan_bwd_chunked",
                                            "mlstm_scan_bwd_chunked"))):
        r = sp["kernels"][name]
        report[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/" + (
                "ssd_chunked.cu" if name == "mamba2_scan_bwd_chunked" else
                "mlstm_chunked.cu" if name == "mlstm_scan_bwd_chunked"
                else "ssm_scan_bwd.cu"),
            replaces=replaces, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], device_ms=r["device_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            kernel=kernel, shape=r["shape"], rel_err=r["rel_T"],
            ds0_bitwise=r.get("ds0_bitwise_T"),
            path="phase l: make_train_step of the hybrid and xlstm families "
                 "(reduced, and at full width with AdamW, B = 4, T = 1,024)")
        if name.startswith("mamba2"):
            report[name].update(mamba2_route=r["route"],
                                rel_err_model=r.get("rel_model_T"))
        else:
            report[name].update(
                bwd_route=r["route"], rel_err_T1=r["rel_T1"],
                rel_err_model=r.get("rel_model_T"), parts=r.get("parts"),
                bound_f32_ms=r.get("bound_f32_ms"))
            if name.startswith("mlstm"):
                report[name]["sweep"] = sp["mlstm_sweep"]
            else:
                report[name]["floor"] = sp["slstm_floor"]
    f_counts = _by_kernel(fp["counts"])
    print(f"[9] kernels on phase f's path (the training pipeline): "
          f"{json.dumps(f_counts)}")
    _check(f_counts["sroa_solve_lanes"] > 0,
           "sroa_solve_lanes never launched on phase f's path")
    k2x, k3x = xp["k2"]["round"], xp["k3"]
    report["sroa_solve_cluster"] = dict(
        name="sroa_solve_cluster", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:167",
        max_abs_err=k2x["max_abs_err"], ms=k2x["ms"],
        plain_ms=k2x["plain_ms"], device_ms=k2x["device_ms"],
        bound_ms=k2x["bound_ms"], bound_by=k2x["bound_by"], library_ms=None,
        path="phase x: P = 34, N = 2,048 (the search's first round)",
        shapes=xp["k2"], occupancy=cluster_occ)
    report["topk_moves_cluster"] = dict(
        k3x, name="topk_moves_cluster",
        path="phase x: (2, 2,048, 16), k = 16 (the search's first round)")
    report["sroa_solve"]["large_cell"] = {
        key: {f: r.get(f)
              for f in ("P", "N", "one_warp_ms", "one_warp_device_ms")}
        for key, r in xp["k2"].items()}
    report["topk_moves"]["large_cell"] = dict(
        shape=k3x["shape"], ms=k3x["block_ms"],
        device_ms=k3x["block_device_ms"])
    for name, n in counts.items():
        _check(n > 0 or name in ("rmsnorm", "flash_attention",
                                 "sroa_solve", "topk_moves",
                                 "mlstm_scan_bwd", "slstm_scan_bwd"),
               f"{name} never launched on its path")
        report[name]["launches"] = n
        report[name]["launches_tsia_path"] = tsia_counts[name]
        report[name]["launches_h_path"] = h_counts[name]
        report[name]["launches_train_path"] = f_counts[name]
        report[name]["launches_lm_train_path"] = train_counts[name]
        report[name]["launches_moe_path"] = moe_counts[name]
        report[name]["launches_ssm_path"] = ssm_counts[name]
        report[name]["launches_encoder_path"] = enc_counts[name]
        report[name]["launches_vlm_path"] = vlm_counts[name]
        report[name]["launches_x_path"] = x_counts[name]
        report[name]["launches_f32_path"] = a_counts[name]
        r = report[name]
        lib = (f", library {r['library_ms']:.4g} ms"
               if r["library_ms"] is not None else "")
        dev_ms = _fmt(r["device_ms"]) + " ms" * (r["device_ms"] is not None)
        print(f"[9] {name}: {r['ms']:.4g} ms (device {dev_ms}, "
              f"plain {r['plain_ms']:.4g} ms, "
              f"bound {r['bound_ms']:.3g} ms by {r['bound_by']}{lib})")
    rounds = main_counts["sroa_solve"]
    ts, k2t = tp["tsia"], tp["k2"]
    print(f"[9] TSIA path: {ts['scores']} scores at "
          f"{ts['ms_per_score']:.4g} ms a score; K2 at P = 1 (full caps) "
          f"{_fmt(k2t['tsia_p1']['device_ms'])} ms device, at P = "
          f"{k2t['host_loop_p201']['P']} (serve caps) "
          f"{_fmt(k2t['host_loop_p201']['device_ms'])} ms; --no-stream "
          + "; ".join(f"{r['ms']:.1f} ms, {r['plans_per_s']:.4g} plans/s"
                      for r in tp["serve"]["no_stream"]["rounds"]))
    print(f"[9] planning path: {snap['plans_per_s']:.4g} plans/s, tick p50 "
          f"{snap['tick_ms']['p50']:.4g} ms; {rounds} K2 launches "
          f"({main_counts['sroa_solve_lanes']} on the lanes kernel) and "
          f"{main_counts['topk_moves']} K3 launches "
          f"({main_counts['topk_moves_warp']} on the warp kernel)")
    print("[9] phase h: " + "; ".join(
        f"{k} {r['plans_per_s']:.4g} plans/s, p50 {r['tick_ms']['p50']:.4g} "
        f"ms, K2 {_fmt(r['traced']['k2_ms_a_launch'])} ms a launch"
        for k, r in hp["runs"].items()) + f" ({hp['seconds']:.1f} s)")
    xs, xk2 = xp["search"], xp["k2"]
    print(f"[9] phase x: the search {xs['wall_ms']:.1f} ms, {xs['rounds']} "
          f"rounds, R {xs['R']:.6g} (init {xs['R_init']:.6g}); K2 "
          + "; ".join(f"{key} cluster {_fmt(r['device_ms'])} ms device"
                      + (f", one-warp {_fmt(r['one_warp_device_ms'])}"
                         if "one_warp_ms" in r else "")
                      for key, r in xk2.items())
          + f"; K3 cluster {_fmt(k3x['device_ms'])} ms device, block "
          f"{_fmt(k3x['block_device_ms'])}, torch.topk "
          f"{_fmt(k3x['library_device_ms'])}; serve "
          f"{xp['serve']['plans_per_s']:.4g} plans/s "
          f"({xp['seconds']:.1f} s)")
    tr = fp["trace"]
    print(f"[9] phase f: plan {fp['plan_ms']:.1f} ms ({fp['scores']} K2 "
          f"launches), {fp['ms_per_iter']:.2f} ms a global iteration in the "
          f"pipeline, {fp['card_ms']:.3f} ms alone (CPU {fp['cpu_ms']:.1f} "
          f"ms); traced: the device busy {tr['union_ms']:.2f} of "
          f"{tr['wall_ms']:.2f} ms, busy share "
          f"{_fmt(_div(tr['union_ms'], tr['wall_ms']), '.4f')}, "
          f"{tr['launches']} kernel launches ({fp['seconds']:.1f} s)")
    fl = lm["flash"]
    L = lm["n_layers"]
    k4_dev = report["flash_attention_sm90"]["device_ms"]
    k4_share = _div(None if k4_dev is None else L * k4_dev,
                    fl["prefill_s"] * 1e3)
    print(f"[9] LM path: prefill {fl['prefill_s'] * 1e3:.3f} ms, decode "
          f"{fl['tok_per_s']:.1f} tok/s on K4; "
          f"{counts['flash_attention_sm90']} K4 launches on the tensor "
          f"cores; {L} x K4's phase-4 device time is "
          f"{_fmt(k4_share, '.4f')} of the prefill's wall time")
    af, ac = ap["flash"], ap["chunked"]
    print(f"[9] f32 LM path: prefill {af['prefill_s'] * 1e3:.3f} ms on K4's "
          f"3xTF32 kernel ({a_counts['flash_attention_sm90_f32']} launches), "
          f"{ac['prefill_s'] * 1e3:.3f} ms on the chunked route; K4 "
          f"{_fmt(ap['k4_share'], '.4f')} of the traced prefill's device "
          f"time; logits {ap['rel']:.4g} of max |logit| apart "
          f"({ap['seconds']:.1f} s)")
    mr, mb = mp["run"], mp["bounds"]
    print(f"[9] moe path: prefill {mr['prefill_s'] * 1e3:.3f} ms (bound "
          f"{mb['prefill_ms']:.4g} ms), decode {mr['tok_per_s']:.2f} tok/s "
          f"(bound {mb['tok_per_s']:.4g}); peak "
          f"{mp['peak_bytes'] / 2 ** 30:.2f} GiB; {moe_counts['flash_attention_sm90']} K4 launches on the "
          f"tensor cores; top-1 flips a layer {mp['flips']} "
          f"({mp['seconds']:.1f} s)")
    for key, tag in (("zamba2", SSM_ARCH), ("xlstm", XLSTM_ARCH)):
        r, b = sp[key], sp[key]["bounds"]
        print(f"[9] ssm path, {tag}: prefill "
              f"{r['run']['prefill_s'] * 1e3:.3f} ms (bound "
              f"{b['prefill_ms']:.4g} ms), decode {r['run']['tok_per_s']:.2f} "
              f"tok/s (bound {b['tok_per_s']:.4g}); peak "
              f"{r['peak_bytes'] / 2 ** 30:.2f} GiB")
    for key, tag in (("zamba2", SSM_ARCH), ("xlstm", XLSTM_ARCH)):
        r, t = sp[key]["run"], sp["twins"][key]
        print(f"[9] ssm path, {tag} on the twins: prefill "
              f"{t['run']['prefill_s'] * 1e3:.3f} ms against "
              f"{r['prefill_s'] * 1e3:.3f} ms on the kernels, decode "
              f"{t['run']['tok_per_s']:.2f} against {r['tok_per_s']:.2f} "
              f"tok/s; logits {t['gap']:.4g} of max |logit| apart, "
              f"{t['same_tokens']:.4f} of the greedy tokens equal")
    print(f"[9] ssm path: {ssm_counts['flash_attention_sm90']} K4 launches "
          f"on the tensor cores, S1 {ssm_counts['mamba2_scan_chunked']} "
          f"chunked and {ssm_counts['mamba2_scan']} sequential, S2 "
          f"{ssm_counts['mlstm_scan']}, S3 {ssm_counts['slstm_scan']}; K4 "
          f"against chunked {sp['rel_b']:.4g} of max "
          f"|x| a shared block (whole model {sp['gap_b']:.4g}, control "
          f"{sp['gap_b_control']:.4g} of max |logit|), re-layout in f32 "
          f"{sp['rel_c']:.4g} of max |logit|; card against CPU at most "
          f"{max(sp['cpu_errs'].values()):.3g} ({sp['seconds']:.1f} s)")
    enc, vlm = ep["encoder"], ep["vlm"]
    print(f"[9] encoder path, {ENC_ARCH}: forward {enc['fwd_ms']:.3f} ms "
          f"(bound {enc['bounds']['ms']:.4g} ms), chunked route "
          f"{enc['chunked_ms']:.3f} ms; K4 against chunked at most "
          f"{max(enc['rels']):.4g} of max |x| a layer; peak "
          f"{enc['peak_bytes'] / 2 ** 30:.2f} GiB")
    print(f"[9] vlm path, {VLM_ARCH} ({vlm['n_layers']} layers): prefill "
          f"{vlm['run']['prefill_s'] * 1e3:.3f} ms (bound "
          f"{vlm['bounds']['ms']:.4g} ms), decode "
          f"{vlm['run']['tok_per_s']:.2f} tok/s (bound "
          f"{vlm['bounds']['tok_per_s']:.4g}); K4 against chunked at most "
          f"{max(vlm['rels']):.4g} of max |x| a layer; peak "
          f"{vlm['peak_bytes'] / 2 ** 30:.2f} GiB ({ep['seconds']:.1f} s)")
    print(f"[9] training path, {LM_ARCH} full size: "
          f"{sorted(lp['step_ms'])[len(lp['step_ms']) // 2]:.3f} ms a step "
          f"(median of {len(lp['step_ms'])}; bound {lp['bound_ms']:.4g} "
          f"ms), losses {lp['losses']}, peak "
          f"{lp['peak_bytes'] / 2 ** 30:.2f} GiB; hfl_lm step "
          f"{lp['hfl_ms']:.1f} ms; card against CPU at most "
          f"{max(lp['cpu_errs'].values()):.3g} ({lp['seconds']:.1f} s)")
    for arch, r in lp["recurrent"].items():
        print(f"[9] training path, {arch} at full width ({r['n_layers']} "
              f"layers, AdamW, remat): "
              f"{sorted(r['step_ms'])[len(r['step_ms']) // 2]:.3f} ms a step "
              f"(median of {len(r['step_ms'])}; bound {r['bound_ms']:.4g} "
              f"ms), peak {r['peak_bytes'] / 2 ** 30:.2f} GiB"
              + (f"; on the twins {r['twin_ms']:.1f} ms a step"
                 if "twin_ms" in r else ""))
    print(f"[9] ssm path, {SSM_ARCH}'s Mamba2 layers in bf16, kernels "
          f"against twins: at most {max(sp['layer_gaps']):.4g} of max |y|")
    print("[9] phase d: distributed HFL " + "; ".join(
        f"{k} {r['ms']:.3f} ms an iteration ({r['err']:.3g} of max |leaf| "
        f"from one process)" for k, r in dp["dist"].items())
        + "; dry-run arguments exact, temp / the card's peak "
        + ", ".join(f"{k} {r['temp'] / r['peak']:.4f}"
                    for k, r in dp["dry"].items())
        + "; production cells " + ", ".join(
            f"{k} fits 80 GB {r['fits_80gb']}" for k, r in
            dp["cells"].items())
        + ("; fleet split not run (one card)" if dp["split"] is None else
           f"; fleet split bitwise over {dp['split']['cards']} cards")
        + f" ({dp['seconds']:.1f} s)")
    print(json.dumps({"kernels": [report[k] for k in counts]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
