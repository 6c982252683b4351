#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port runs on the GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` only (never ``repro`` or ``jax``), on one CUDA device:

1. the device: its name, and its power limit as nvidia-smi reports it;
2. builds the hand-written kernels from ``src/repro_torch/csrc`` with nvcc, and
   prints ptxas's registers and spills of K4's tensor-core instantiations (bf16,
   head_dim 128 and 256), of its bf16 backward's main kernel (head_dim 64 and 128), of
   its five f32 SIMT instantiations (head_dim 16 to 256),
   of K2's three kernels (its routes), of K3's main kernel and of K5's five kernels (its
   three passes in bf16 and f32; none of them may spill), and, where ``cuobjdump`` is
   installed,
   the HMMA instructions of K5's bf16 passes (there must be some) and the FFMA and
   tensor-core instructions of K4's f32 kernel (FFMA only: no HMMA, no HGMMA);
3. holds each kernel against its plain PyTorch version on the card, at the test
   shapes (K4 in f32 on its SIMT kernel and in bf16 on its tensor-core kernel, plus
   bf16 cases at head_dim 256 with window 512, 16 query heads on 8 kv heads at Sq
   1024, and ragged Sq, Skv at head_dim 128 and 256; the f32 kernel also at the main
   paths' shapes, every head_dim at GQA groups of 1, 4 and 8, windows that cross a KV
   tile and ragged Sq != Skv, untimed, its lse against the chunked twin and two calls
   bitwise equal; K2 also at a width of 100, and forced onto each of its three routes at
   widths they take, a ragged width and rows off a 16-byte boundary, two calls bitwise
   equal) and
   at the shapes of the gemma3-1b serving path, and times the kernel, the plain
   version and one PyTorch library call that computes the same function (a yardstick
   the port never calls), with K4's achieved TFLOP/s and share of its bound.  Every
   kernel and library call is read three ways: ``kernel_ms``, the card's time alone
   (CUDA events with the card held behind the host by ``torch.cuda._sleep``, so no
   host work in the wrapper enters it; the record's ``ms`` and ``library_ms``),
   ``call_ms`` (events around the Python call, as before) and ``host_us`` per call.
   A negative control, K2 with 0.5 ms of host sleep before its launch, must keep its
   kernel_ms within 10% while its call_ms rises by about 0.5 ms;
4. checks the whole slice on a small f32 model: the card with its kernels against
   the CPU with the plain versions;
5. serves gemma3-1b at full width in bf16 (random weights from a seed): batch 4,
   prompt 1024, 32 greedy tokens, through ``repro_torch.launch.serve``, counting
   the kernel launches of the run;
6. runs the same prefill with the plain versions and compares the logits;
7. holds the training path's kernels against their plain versions: the rmsnorm
   backward (K3: two calls bitwise equal), the attention kernel's logsumexp and
   output (K4: two calls bitwise equal; also at phase 3's added bf16 cases), K4's bf16
   backward against the plain chunked backward at the training shapes, 8 x 1024 and
   2 x 4096 (every element at
   the bf16 tolerance, each gradient's relative norm error at most 1e-2; timed beside
   the chunked backward and SDPA's flash backward), and the gradients of the ops'
   autograd Functions against plain autograd; and the head's bf16 product with an f32
   result against f32 products, forward and backward;
8. checks one small f32 train step, the card with its kernels against the CPU with
   the plain versions;
9. trains internlm2-1.8b at full width in bf16 (random weights from a seed):
   AdamW, batch 8 x 1024, 1 untimed and 20 timed steps through
   ``repro_torch.distributed``, counting the kernel launches of every step;
10. computes one step's loss and gradients with the kernels and with the plain
    versions from the same state and batch, and compares the loss, the gradient
    norm and every gradient leaf;
11. runs the fault-tolerant loop (``repro_torch.runtime.train_loop``) on the
    reduced internlm2 config in bf16 with checkpoints, one injected crash, resume
    and replay;
12. holds the SSD scan kernel (K5, three chunk-parallel passes) against the stepwise
    recurrence on the card, y and the final state, at the test shapes (a ragged
    sequence and G > 1 among them) and at the mamba2-370m serving shape, and prints
    its kernel_ms, call_ms, host_us, scratch bytes and share of the bound beside the
    plain stepwise and chunked versions' times;
13. checks the Mamba slice on mamba2-reduced in f32: prefill and 4 decode steps,
    the card with its kernels against the CPU with the plain versions;
14. serves mamba2-370m at full width in bf16 (random weights from a seed): batch 4,
    prompt 1024, 32 greedy tokens, through ``repro_torch.launch.serve``, counting
    the kernel launches of the prefill (48 K5 calls of three grid launches each)
    and of every decode step;
15. runs the same prefill with the plain versions and compares the logits, in bf16
    and with the same weights widened to f32;
16. holds the gradients of the SSD op's autograd Function (K5 forward, plain
    chunked backward) against plain autograd through the stepwise recurrence;
17. holds K1, the Triton kernels generated per fusion cluster of the Myia
    compiler, against their torch oracles: every elementwise primitive of the
    fusion tier in f32 and bf16 with broadcast operands of rank 3, 1 and 0, and
    every reduction root over leading, trailing, middle, two and all axes; then
    the four clusters of the Myia train step at their full shapes, timed against
    their oracles, and cluster 2 (tanh's backward) against ``aten.tanh_backward``
    by device time;
18. checks the Myia LM train step at tiny dims in f32, the card with the K1
    kernels against the CPU with the oracles (loss and gradients);
19. trains ``--compiler myia`` at full width (internlm2-1.8b's V 92544, D 2048,
    H 8192, f32, SGD): batch 8 x 256, 1 untimed and 20 timed steps through
    ``repro_torch.launch.myia_step``, counting the K1 launches of every step: the
    plan's 4 clusters (3 map, 1 reduce) in exactly 5 launches (3 map, and the
    reduce's two passes), then two steps of ``python -m
    repro_torch.launch.train --compiler myia`` with its checkpoint;
20. computes one full-width step's loss and gradients with the K1 kernels and in
    kernel mode ``"ref"`` (the oracles) from the same state, and compares them;
21. holds the kernels at every shape this slice's paths give them, in bf16: K4 against
    the plain version and the tensor-core twin, its ``lse`` at the f32 tolerance
    (whisper-medium's non-causal encoder self-attention at 1500 frames, its decoder's
    causal self-attention and its cross-attention from 416 prompt tokens, all at
    head_dim 64; llama-3.2-vision-11b's causal GQA self-attention and its GQA
    cross-attention over 1600 image tokens); K2 at whisper's width 1024, vision's and
    Jamba's 4096 (the widest row of the warp-per-row kernel) and Jamba's gate norm over
    8192 (route 1, a block a row), prefill and decode rows, each with the route it
    took; and K5 at the Jamba
    block's 128 SSM heads against the stepwise recurrence; each timed three ways beside
    its library call (SDPA, ``F.rms_norm``) and its bound;
22. checks the reduced configs of the five MoE, cross-attention and encoder-decoder
    archs in f32: prefill (logits and every cache) and 4 decode steps, the card with
    its kernels against the CPU with the plain versions;
23. serves whisper-medium at full width in bf16 (random weights from a seed): batch 4,
    1500 encoder frames, prompt 416, 32 greedy tokens, through
    ``repro_torch.launch.serve``, with exactly 72 K4 and 122 K2 launches a prefill and
    73 K2 a decode step, and K2's launches by route (all on the warp-per-row kernel);
    then the same prefill with the plain versions, in bf16 and
    with the same weights widened to f32;
24. the same for llama-3.2-vision-11b (1600 image tokens, prompt 1024): 48 K4 and 89
    K2 a prefill, 89 K2 a decode step; its bf16 weights are freed as they are widened;
25. the same for one Jamba block (8 of jamba-v0.1-52b's 32 layers: the whole model
    does not fit on one card) at prompt 1024: 1 K4, 21 K5 (7 calls of 3 passes) and
    24 K2 a prefill and 24 a decode step (17 on the warp-per-row kernel, the 7 Mamba gate
    norms of 8192 on route 1), and the share of (token, k) routing choices
    on which the kernels and the plain versions agree (bounded in bf16 and in f32),
    beside the spread of two plain versions with no kernel between them; its f32
    comparison runs on the block's first 4 layers.  The bf16 logit bound of this path
    checks no kernel (phase 21 does, at its shapes);
26. the Myia serving runtime (``repro_torch.serve``) at tiny dims (V 48, D 8, H 16, f32,
    fused): the engine's streams on the card equal the CPU's (the oracles) and the card's
    ``oracle_generate``, prefill and decode logits within 1e-5 of the largest;
27. serves gemma3-1b's Myia LM at full width (V 262144, D 1152, H 4608, f32, TF32 off):
    4 requests of prompt 1024 and 32 greedy tokens over 4 slots, one bucket of 2048,
    through ``python -m repro_torch.launch.serve --compiler myia --check-oracle
    --metrics-out --cache-dir`` (unfused, as the launcher runs it), then a fused
    ``ServeEngine`` on the same requests; both streams equal the full-prefix oracle's,
    ``compile_retries`` and ``vm_fallbacks`` are 0, and K1's launches equal the fusion
    plan's exactly (the reference's plan forms no cluster on either graph: 0 a prefill,
    0 a decode step); prints TTFT, prefill s, decode tok/s, peak memory, compilations
    against the floor and the cache's counters;
28. restarts warm: a second process serves the same requests on phase 27's cache
    directory, unfused and fused, with no miss, no program built (no lowering, no Triton
    build), as many hits as the cold run's misses and identical streams; then profiles
    one fused decode step (each launch timed by CUDA events) against the H100's 3.35 TB/s;
29. the OO tape (``repro_torch.core.oo_tape``, the paper's operator-overloading baseline)
    on the card: the reference test's scalar chain and polynomials, its MLP pair at (8, 8),
    (8, 8), (4, 8) and at (4096, 4096), (4096, 4096), (256, 4096), and its relu pair, in
    f32 on CUDA tensors, against the port's ST gradient (unfused: bitwise; fused, with K1:
    within 1e-5) and ``torch.autograd``; then the footnote-1 numbers: a call of the tape
    and of the lowered ST program at the scalar chain and the wide MLP, and the tape's
    entries a call;
30. the SPMD tier: the Myia LM step at phase 19's full width under
    ``mesh_context(make_local_mesh(1, 1))``, an NCCL group of one rank: 3 SGD steps
    unfused, bitwise equal to the single-device tier (losses and every parameter), and 3
    fused within the reference's bounds (losses rtol 2e-5, parameters rtol 2e-4, atol
    1e-6); ``runner.spmd``, and the per-shard K1 launches by name against the per-shard
    fusion plan the host computes (``spmd.shard_graph``); each per-shard kernel against
    its oracle on the inputs the first step gave it (phase 17's bounds); the step time
    beside the single-device tier's;
31. two ranks sharing the card: ``python -m torch.distributed.run --standalone
    --nproc-per-node 2`` starts this script's rank program (``--spmd-rank``), which runs
    ``repro_torch.launch.train``'s ``main`` with ``--compiler myia`` at the same full
    width on a 2x1 and a 1x2 mesh, over gloo (NCCL refuses two ranks on one device), 3
    steps each against phase 30's single-device run under its bounds (the losses each
    rank prints, the parameters of each rank's checkpoint); the parent checks each
    rank's backend, device, per-shard clusters (against the host's plan and, cluster by
    cluster, the global plan's kinds and members), K1 launches and step time.  Each rank
    holds every per-shard kernel against its oracle on the inputs its first step gave
    it, at the per-shard shapes (phase 17's bounds), and rank 0 runs its last step under
    ``torch.profiler``: the time in the collectives, the card's busy and idle time;
32. the model zoo's placed steps on a 1x1 NCCL mesh: internlm2-1.8b's train step (both
    it and the single-device step under PyTorch's deterministic algorithms, so that K4's
    backward orders dQ's adds) and gemma3-1b's prefill and decode, bitwise equal to the
    single-device path;
33. two ranks sharing the card over gloo: ``launch.train`` on 2x1 and 1x2 meshes, and this
    script's ``--sharded-rank`` program holding each rank's f32 step (and, on 1x2,
    mamba2's prefill, internlm2's placed prefill and greedy decode, the attention over
    the cache on each rank's heads, and gemma3-1b's with 8200 cache slots: its one kv
    head under two q-head shards and its global layer's cache sharded on its slots) to
    the single-device values; then K4's f32 kernel timed at a rank's prefill shapes;
34. the dry run (``repro_torch.launch.dryrun``) of five production cells on fake meshes
    (among them internlm2's and mamba2's ``decode_32k``, the decode on local shards),
    in processes of their own beside phases 32-33, with their memory, bytes accessed and
    collective bytes; and the peak it computes for phase 32's train step (8 x 1024, the
    plain versions) on a fake 1x1 mesh (this script's ``--dryrun-peak`` process) against
    the card's ``max_memory_allocated`` for the same step: within 10%;
35. the examples, as a user runs them with no flags, on the default device:
    ``examples/torch_quickstart.py`` (its values, its results on the card),
    ``torch_train_lm_myia.py`` (its checks; batch 0's Myia gradients card against CPU),
    ``torch_serve_batch.py`` (four reduced archs, the card's kernels against the CPU's
    plain versions from the same weights; the engine cold and warm on one program cache),
    ``torch_train_e2e.py`` (300 steps of its f32 config from a fresh checkpoint directory,
    K2/K3/K4 launches a step pinned at 17/17/8, step time, tokens/s, peak memory; one step
    against the plain versions); then every kernel at every shape those paths gave it,
    timed beside its bound and library call (SDPA in f32 for K4).

A failed phase raises and the script exits non-zero.  The last lines are the
kernels' record, the card's name and power limit, and the device line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# bf16 through 26 layers: each of ~52 sublayers may round an activation one bf16 ulp
# (2^-8 relative) differently in the kernels and the plain versions; as a random walk
# that is about sqrt(52) ulp ~ 3% of the logits' scale, so 5% is the bound.
SLICE_REL_BOUND = 5e-2

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# the rmsnorm backward's dx in f32, as tests/kernels/test_rmsnorm.py holds it
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
# attention gradients, as tests/kernels/test_flash_attention.py holds them
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
# K4's bf16 backward against the plain chunked backward on the same inputs, each
# gradient's relative norm error, as tests/test_torch_kernels_cuda.py holds it (P and dS
# enter the kernel's products rounded to bf16; read ~2.6e-3 there)
BWD_REL_NORM_BOUND = 1e-2

# Full-width training, kernels against plain versions from the same state and batch
# (phase 10), both in bf16 through 24 layers forward and backward.  Both compute
# each op in f32 and round to bf16 at the same places, so they differ only where f32
# sums in another order cross a bf16 rounding boundary.  Read on an H100 (this
# script, internlm2-1.8b after 21 steps): loss 7.6e-6 and gradient norm 4.5e-5
# relative to the naive plain versions; the bounds sit 13 and 22 times above.
TRAIN_LOSS_REL_BOUND = 1e-4
TRAIN_GNORM_REL_BOUND = 1e-3
# A wrong term can leave those two sums nearly unmoved (a change orthogonal to the
# gradient moves its norm only to second order), so the gradient is also held leaf
# by leaf, |g_kernel - g_plain| / |g_plain| over each leaf, against the plain chunked
# versions (impl="chunked": the chunked attention forward and backward, P and dS in
# f32).  The kernels' side runs K4's tensor-core backward, which rounds P and dS to
# bf16 as operands of its products.  Read on an H100 (internlm2-1.8b after 21 steps):
# at most 8.2e-3 (the embedding, whose bf16 rows gather many tokens' adds; 2.7e-3 for
# the rest).  The gradients of wq and wk pass through the softmax backward's
# p·(dp - delta), which cancels where attention is still nearly uniform, and delta sums
# do·o over the bf16 output o, which K4 and its plain version round apart: read
# 9.3e-2 and 1.08e-1 on two runs (the 21 steps before add dQ atomically, so each run
# reaches another state; 8.5e-2 with the chunked backward on both sides), held to
# their own bound.  A negative control, the rmsnorm backward
# without dx's x·r³·mean(dy·w·x) term (2.2% of dx at D 2048, fed to every earlier
# leaf), puts the median leaf at 0.45: the bounds catch it.
TRAIN_GRAD_REL_BOUND = 2e-2
TRAIN_QK_GRAD_REL_BOUND = 0.25

# Replayed steps after a restore see the same batches and restored state; the ops are
# deterministic except the embedding gradient's index_put_, which may add a token's
# repeated rows in another order.  Replayed bf16 losses must agree within 1e-3.
REPLAY_REL_BOUND = 1e-3

# The SSD scan (K5) against the stepwise recurrence, as tests/kernels/test_ssd_scan.py
# holds the chunked kernel (the chunk's decays are differences of a cumsum, not
# products of per-step factors); the f32 state at the same bound in both dtypes.
SSD_TOL = dict(rtol=2e-4, atol=2e-4)

# mamba2-370m prefill through 48 layers, kernels against plain versions, relative to
# the largest plain logit.  In f32 the two differ only where K5's chunked sums take
# another order than the stepwise recurrence (the chunk's decays are differences of
# a cumsum): the plain chunked and stepwise versions, with no kernel between them,
# are 4.1e-5 apart on these weights (CPU, batch 1, prompt 1024), and the bound sits
# 24 times above.  In bf16 every layer rounds the scan's y and two norms to bf16
# (2^-8), and the gated, renormalised layers amplify a one-ulp flip some thirtyfold:
# the same two plain versions are 11.5% apart (13% at prompt 128), so the bf16 bound
# is 50%, and only the f32 comparison can see a wrong term.
MAMBA_F32_REL_BOUND = 1e-3
MAMBA_BF16_REL_BOUND = 0.5

# K1 against its oracles (phase 17): the bounds of repro_torch.kernels.k1_cases,
# MAP_ULPS and REDUCE_TOL, as tests/test_torch_kernels_cuda.py holds them.
# The Myia LM step (phases 18 and 20) in f32.  Card against CPU (18): the same
# program, but cuBLAS and the CPU sum the matmuls in other orders; the loss within
# 1e-5 relative, each gradient within 1e-4 of its largest element.  Kernels against
# oracles on the card from the same state (20): only the four clusters differ (map
# kernels by at most an ulp, the cross-entropy sum in another order); the loss within
# 1e-6 relative, each gradient within 1e-5 of its largest element.
MYIA_CPU_LOSS_REL, MYIA_CPU_GRAD_REL = 1e-5, 1e-4
MYIA_REF_LOSS_REL, MYIA_REF_GRAD_REL = 1e-6, 1e-5
# the Myia LM step at full width: internlm2-1.8b's vocab and width (V 92544, D 2048,
# H 8192), the reference driver's batch and sequence, plain SGD
MYIA_B, MYIA_S, MYIA_LR, MYIA_STEPS = 8, 256, 3e-4, 20

# This slice's serving paths (phases 23-25): whisper-medium, llama-3.2-vision-11b and
# one Jamba block, batch 4, 32 greedy tokens; whisper's prompt and its 32 generated
# tokens fill its published decoder context (configs.DEC_CONTEXT, 448), after 1500
# encoder frames.
XA_B, XA_GEN, XA_PROMPT = 4, 32, 1024
# Jamba v0.1 at full width has 32 layers (52B, ~104 GB in bf16): one whole period of 8
# (attention at index 3, MoE at the odd ones, ~13.3B) fits on one card.  Its f32
# comparison takes the block's first 4 layers (2 MoE layers, ~28 GB in f32).
JAMBA_LAYERS, JAMBA_F32_LAYERS = 8, 4
# The last-position logits with the kernels against the plain versions, relative to
# the largest plain logit; written before the first run of these paths on the card.
# f32: the same math summed in another order (K4's SIMT kernel, K2), 1e-3 as for
# mamba2.  bf16 through whisper's 120 sublayers (24 encoder layers of 2, 24 decoder
# layers of 3) and vision's 88: each may round an activation one bf16 ulp (2^-8)
# differently, and K4 rounds P to bf16 where the plain version does not; as a random
# walk sqrt(120) ulps is ~4.3% of the logits' scale, so 10%.  The Jamba block in bf16:
# its 7 Mamba layers amplify a one-ulp flip as mamba2's do, and a flip can change a
# top-2 routing choice, so 50% as for mamba2; only f32 sees a wrong term there.
XA_F32_REL_BOUND = 1e-3
XA_BF16_REL_BOUND = 0.1
JAMBA_BF16_REL_BOUND = 0.5
# The Jamba bf16 bound is no check of a kernel: it cannot tell a wrong bf16 kernel from
# the amplified roundings.  The kernels are held at the path's shapes one by one in
# phase 21, and the path's wrong terms by the f32 comparison.  The share of (token, k)
# routing choices that the kernels and the plain versions make alike is bounded too:
# read on an H100 (this script, the first sound run of this path), 95.20% in bf16
# through the block's 4 MoE layers and 100% in f32 through its first 2.  A wrong
# router input routes near at random (2 of 16 experts alike by chance), so 90% and
# 99.9% catch it and leave room for the bf16 near-ties.  Beside them the script reads
# two plain versions with no kernel between them (impl "chunked": the chunked SSD and
# online-softmax attention against the stepwise recurrence and the whole softmax), the
# spread that bf16 alone makes on these weights.
JAMBA_BF16_ROUTE_MIN = 0.90
JAMBA_F32_ROUTE_MIN = 0.999

# The Myia serving runtime (phases 26-28): gemma3-1b's Myia LM (V 262144, D 1152, H 4608,
# f32, as serve.init_serve_params makes it), 4 requests of prompt 1024 and 32 greedy
# tokens over 4 slots, min bucket 32: one bucket of 2048.  Nothing is cut.  The f32
# products run without TF32 (PyTorch's default, set again in phase 1 and in the warm
# restart's process), so the engine's streams can be compared exactly with the
# full-prefix oracle's.
SM_REQS, SM_PROMPT, SM_GEN, SM_SLOTS, SM_MIN_BUCKET = 4, 1024, 32, 4, 32
# Tiny dims (phase 26), card against CPU: the same programs, the matmuls summed in
# other orders by cuBLAS and the CPU; logits within 1e-5 of the largest.
SM_TINY_REL = 1e-5
# The path itself runs no K1 kernel (no cluster forms on the serve graphs), so phase 28
# also proves that the cache finds a fused program's Triton binaries again: the Myia LM
# loss and its adjoint at tiny dims (4 clusters) through the same cache, cold in this
# process and warm in the second.  Run in both processes (exec'd from this source).
# The model zoo under a mesh (phases 32-34).  Phase 32: internlm2-1.8b at full width and
# depth in bf16, batch 8 x 1024, AdamW, 3 steps, and gemma3-1b's prefill of 4 x 1024 and
# 8 greedy steps, on a 1x1 mesh over NCCL against the single-device step.  Phase 33: two
# ranks sharing the card over gloo; their runs keep every width and cut internlm2's depth
# to SH_LAYERS of its 24 layers (printed), so that two ranks' states, each with a
# single-device reference beside it in f32, fit the card and the phase its time.  The
# reference's SPMD bounds hold the two-rank runs (and the 1x1 run where DTensor reorders
# a sum): losses rtol 2e-5, parameters rtol 2e-4 and atol 1e-6.
SH_STEPS, SH_B, SH_S, SH_GEN, SH_LAYERS = 3, 8, 1024, 8, 4
SH_SERVE_B = 4
SH_LOSS_RTOL, SH_PARAM_RTOL, SH_PARAM_ATOL = 2e-5, 2e-4, 1e-6
# the dry run's cells (phase 34): (arch, cell, mesh)
SH_DRYRUN = (("internlm2-1.8b", "train_4k", "single"), ("gemma3-1b", "decode_32k", "single"),
             ("grok-1-314b", "train_4k", "multi"), ("internlm2-1.8b", "decode_32k", "single"),
             ("mamba2-370m", "decode_32k", "single"))
# phase 33's placed decode (internlm2, SH_LAYERS layers, f32, on 1x2): the logits of the
# prefill and of each step within this share of the largest single-device logit (the
# sharded tests' rtol: the model axis sums the row-parallel products in two halves), and
# the greedy picks equal wherever the single device's top two logits are further apart
SH_DECODE_REL = 2e-4
# phase 33's long placed decode: gemma3-1b (f32) cut to its first period of 5 local and 1
# global layer, the fewest that keep a global layer, with 8200 cache slots: past 8192 the
# global layer's cache is sharded on its slots (tests/test_torch_sharded_exec.py's
# decode_long case at full width)
SH_GEMMA_LAYERS, SH_LONG_SLOTS = 6, 8200

# The examples (phase 35): each examples/torch_<name>.py runs in this process as ``python
# examples/torch_<name>.py`` runs it (its module loaded by runpy; its __main__ block is a
# call of main with no arguments), on the default device, so that the kernels' counters
# can be read before and after.
EXAMPLES_DIR = Path(__file__).resolve().parent / "examples"
# train_e2e's config_100m: 8 layers, none rematerialised (its period of 6 repeats once,
# so no scan segment has reps > 1), so a step launches K2 2·8 + 1 = 17 times (the
# forward's norms), K3 17 (their backward) and K4 8 (the forward; the attention's
# backward in f32 is the plain chunked one): pinned exactly over the run's 300 steps
E2E_STEPS = 300
E2E_LAUNCHES = {"rmsnorm_fwd": 17, "rmsnorm_bwd": 17, "flash_attention_fwd": 8}
# one f32 train_e2e step, kernels against plain versions: each gradient leaf's relative
# norm ||a - b|| / ||b||.  Another order of f32 sums moves a leaf by ~1e-6 of its norm;
# a wrong attention window or kv-head map moves the leaves it reaches by far more.
E2E_GRAD_REL = 1e-4
# quickstart's printed values (the reference's expected ones), exact in f32
QUICKSTART_EXPECTED = {"f(2.0)": 12.0, "g'(2.0)": 14.0, "g''(2.0)": 12.0, "x^5 at 2": 32.0,
                       "d/dx x^5 at 2": 80.0}
# the dry run's peak against the card's (phase 34): the same step, within 10%
DRYRUN_PEAK_REL = 0.10


class _Tee:
    """A text stream writing to every stream it is given."""

    def __init__(self, *streams) -> None:
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def run_example(name: str, argv: list[str], **kwargs) -> tuple[dict, str]:
    """``examples/torch_<name>.py``'s ``main(argv, **kwargs)`` in this process; its
    namespace and what it printed (shown as it runs).  It must return 0."""
    import io
    import runpy

    ns = runpy.run_path(str(EXAMPLES_DIR / f"torch_{name}.py"), run_name=f"torch_{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, out)):
        rc = ns["main"](argv, **kwargs)
    assert rc == 0, (name, rc)
    return ns, out.getvalue()


def printed_values(text: str) -> dict:
    """label -> the value printed after it, for each ``label = value`` or ``label: value``
    line (quickstart's)."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"^(.*?)(?: =|:) (\S+)", line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms for the extent, warning only where an op has
    none; the setting before is restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


@contextlib.contextmanager
def capturing_kernels(ops, seen: dict):
    """For the extent, every call of the ops' K2, K3, K4 and K5 entries goes on to the
    kernel (whose counter counts it) after its signature (operand shapes and dtypes,
    keyword arguments) is counted in ``seen``: the shapes a path gives each kernel."""
    names = ("rmsnorm_fwd", "rmsnorm_bwd", "flash_attention_fwd", "ssd_scan_fwd")
    saved = {n: getattr(ops, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            key = (name, tuple((tuple(a.shape), a.dtype) for a in args),
                   tuple(sorted(kwargs.items())))
            seen[key] = seen.get(key, 0) + 1
            return fn(*args, **kwargs)
        return call

    for n in names:
        setattr(ops, n, wrap(n, saved[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(ops, n, saved[n])


def dryrun_peak() -> int:
    """Phase 34's fourth dry-run process: internlm2-1.8b's train step at phase 32's batch
    (SH_B x SH_S, bf16, AdamW, remat) with the plain versions, on a fake 1x1 mesh; its
    record, whose peak the phase holds against the card's reading of the same step."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_fake_mesh

    cell = ShapeCell(f"train_{SH_B}x{SH_S}", "train", SH_S, SH_B)
    rec = run_cell("internlm2-1.8b", cell, make_fake_mesh((1, 1), ("data", "model")), "1x1",
                   impl="ref")
    print("DRYRUN " + json.dumps(rec), flush=True)
    return 0


SM_K1_PROBE = """
def k1_probe(cache_dir):
    import torch
    from repro_torch.core import api
    from repro_torch.core.torch_backend import ProgramCache
    from repro_torch.launch.myia_step import MyiaLMDims, build_lm_loss
    dims = MyiaLMDims(96, 16, 40)
    cache = ProgramCache(cache_dir)
    vag = api.value_and_grad(build_lm_loss(dims, 2, 8), wrt=(0, 1, 2, 3),
                             options=api.CompileOptions(fuse=True, program_cache=cache))
    gen = torch.Generator().manual_seed(0)
    shapes = ((96, 16), (16, 40), (40, 16), (16, 96))
    args = [(torch.randn(s, generator=gen) * 0.1).cuda() for s in shapes]
    args += [torch.randint(0, 96, (2, 8), generator=gen, dtype=torch.int32).cuda()
             for _ in range(2)]
    loss, _grads = vag(*args)
    torch.cuda.synchronize()
    kernels = vag.specialize(tuple(args)).fn.__fused_kernels__
    return {"loss": float(loss), "stats": cache.stats.as_dict(), "kernels": len(kernels)}
"""
# Phase 28's second process: the launcher's engine (unfused) and a fused engine on the
# cold run's cache directory, then the K1 probe; prints one JSON line (streams, cache
# counters, launches).
SM_WARM_SCRIPT = SM_K1_PROBE + """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32, as the cold run
from repro_torch.configs import get_config
from repro_torch.core.torch_backend import ProgramCache
from repro_torch.kernels import FUSED_LAUNCHES, LAUNCHES, reset_launches
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import ServeEngine

argv = json.loads(sys.argv[1])
reset_launches()
report = serve_cli.serve_myia_engine(serve_cli.parse_args(argv), get_config("gemma3-1b"))
cache = ProgramCache(report["engine"].program_cache.path)
fused = ServeEngine(report["dims"], report["params"], n_slots=report["engine"].n_slots,
                    min_bucket=report["engine"].min_bucket, program_cache=cache, fuse=True)
rids = [fused.submit(p, len(report["results"][r]["tokens"])) for r, p in report["requests"]]
got = fused.run()
print(json.dumps({
    "unfused": {str(r): report["results"][r]["tokens"] for r, _p in report["requests"]},
    "fused": {str(r): got[r]["tokens"] for r in rids},
    "stats": [report["cache_stats"], cache.stats.as_dict()],
    "launches": dict(LAUNCHES), "fused_launches": dict(FUSED_LAUNCHES),
    "k1_probe": k1_probe(sys.argv[2]),
}))
"""

# The OO tape on the card (phase 29), the paper's OO baseline against its ST pipeline.
# Array workloads: the tape and the unfused lowered adjoint run the same eager torch ops
# in the same dataflow (bitwise equal on the CPU, tests/test_torch_oo_tape.py), so they
# must be bitwise equal on the card too.  Against the fused adjoint (K1's map kernels,
# within an ulp of their oracles) and torch.autograd (its own tanh and relu backward
# kernels), the largest gradient difference within 1e-5 of the largest gradient element.
# Scalars: Python floats on the tape (float64) against f32 ST programs, rtol 1e-5 as the
# reference's test; the scalar chain as 0-d CUDA f32 tensors against the ST program on
# the same tensors, rtol 1e-5 (the adjoint may add a value's contributions in another
# order than the tape).
OO_REL = 1e-5
# the MLP pair's shapes (w1, w2, x): the reference test's, and one wide enough that the
# card does real work; weights scaled by 1/sqrt(fan-in) so that tanh does not saturate
OO_MLP_SHAPES = (((8, 8), (8, 8), (4, 8)), ((4096, 4096), (4096, 4096), (256, 4096)))
OO_RELU_SHAPES = ((8, 4), (5, 8))
# The SPMD tier (phases 30-31): the Myia LM step at phase 19's full width on a mesh.
# Unfused on a 1x1 mesh: bitwise equal to the single-device tier (psum over one rank is
# the identity; the reference pins this identity in TestMesh1x1Identity).  Otherwise the
# reference's bounds (tests/distributed/test_spmd_exec.py): losses rtol 2e-5, parameters
# rtol 2e-4 and atol 1e-6, after SPMD_STEPS SGD steps.
SPMD_LOSS_RTOL, SPMD_PARAM_RTOL, SPMD_PARAM_ATOL = 2e-5, 2e-4, 1e-6
SPMD_STEPS = 3


def oo_scalar_chain(x, y):
    """The paper's footnote-1 pathology: an unrolled scalar recurrence."""
    z = x
    z = z * y + x
    z = z * z + y
    z = z * y + x
    z = z * z + y
    z = z * y + x
    z = z * z + y
    return z


def oo_poly(x):
    return 2.0 * x * x * x + 4.0 * x * x + x + 1.0


def oo_cube(x):
    return x * x * x


def oo_mlp_pair(oo, P):
    def oo_loss(w1, w2, x):
        h = oo.tanh(x @ w1)
        return oo.reduce_sum(oo.tanh(h @ w2))

    def st_loss(w1, w2, x):
        h = P.tanh(x @ w1)
        return P.reduce_sum(P.tanh(h @ w2), (0, 1), False)

    return oo_loss, st_loss


def oo_relu_pair(oo, P):
    def oo_loss(w, x):
        return oo.reduce_sum(oo.relu(x @ w))

    def st_loss(w, x):
        return P.reduce_sum(P.relu(x @ w), (0, 1), False)

    return oo_loss, st_loss


# (B, H, KVH, Sq, Skv, D, causal): K4's calls on this slice's paths, at the serving
# batch (phase 21): whisper's encoder self-attention (non-causal), its decoder's
# causal self-attention over the 416-token prompt and its cross-attention, all at
# head_dim 64; vision's causal GQA self-attention and its GQA cross-attention over
# 1600 image tokens (the Jamba block's one attention layer has vision's shape)
XATTN_CASES = {
    "whisper encoder": (4, 16, 16, 1500, 1500, 64, False),
    "whisper decoder": (4, 16, 16, 416, 416, 64, True),
    "whisper cross": (4, 16, 16, 416, 1500, 64, False),
    "vision self": (4, 32, 8, 1024, 1024, 128, True),
    "vision cross": (4, 32, 8, 1024, 1600, 128, False),
}
# K2's bf16 rows on this slice's paths (phase 21): whisper's D 1024 (the encoder's 1500
# frames, the decoder's 416-token prompt), vision's and the Jamba block's D 4096 (the
# widest row of the warp-per-row kernel), the Jamba gate norm over d_inner 8192 (route
# 1, a block a row), and a decode step's rows at each width
RMS_XA_CASES = {
    "whisper encoder": (4, 1500, 1024),
    "whisper decoder": (4, 416, 1024),
    "whisper decode": (4, 1, 1024),
    "vision / Jamba": (4, 1024, 4096),
    "vision / Jamba decode": (4, 1, 4096),
    "Jamba gate norm": (4, 1024, 8192),
    "Jamba gate norm decode": (4, 1, 8192),
}
# K2's routes forced at (rows, D) (phase 3, both dtypes, untimed): all three at a decode
# step's rows of 1024 and at a width off the vector (100), the two wide ones at many
# rows of 8192 and at a ragged width, the streamed route at few rows of 16384 (wider
# than route 1 holds)
K2_ROUTE_CASES = {
    (4, 1024): ("warp-per-row", "row-per-block", "row-per-block-streamed"),
    (64, 100): ("warp-per-row", "row-per-block", "row-per-block-streamed"),
    (300, 8192): ("row-per-block", "row-per-block-streamed"),
    (16, 5000): ("row-per-block", "row-per-block-streamed"),
    (4, 16384): ("row-per-block-streamed",),
}
# (Bt, S, H, P, G, N): K5 at the Jamba block's serving shape (128 SSM heads)
SSD_JAMBA = (4, 1024, 128, 64, 1, 128)

# (Bt, S, H, P, G, N): the shapes of the SSD kernel tests, a ragged S with G > 1, and
# the mamba2-reduced shape
SSD_TEST_CASES = [
    (2, 64, 4, 16, 2, 32),
    (1, 32, 2, 8, 1, 16),
    (2, 128, 4, 8, 4, 16),
    (1, 32, 2, 16, 1, 32),
    (2, 200, 4, 16, 2, 32),
    (2, 12, 8, 16, 1, 16),
]

# (B, H, KVH, Sq, Skv, D, causal, window): the cases of the kernel tests
FA_TEST_CASES = [
    (2, 4, 2, 128, 128, 64, False, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 2, 2, 256, 256, 32, True, 64),
    (1, 8, 2, 64, 64, 32, True, None),
    (1, 2, 1, 64, 64, 32, True, 4096),
    (2, 4, 4, 64, 128, 32, False, None),
    (1, 2, 1, 64, 64, 128, True, None),
    (2, 4, 2, 37, 70, 64, True, 16),
]

# (B, H, KVH, Sq, Skv, D, causal, window): K4's f32 path (the register-blocked SIMT
# kernel) at the main paths' shapes (train_e2e's local and global layers, a 1x2 rank's
# heads in internlm2's and gemma3-1b's f32 placed prefills), every head_dim at GQA
# groups of 1, 4 and 8, windows whose edge crosses a KV tile mid-way, Sq != Skv, and
# Sq, Skv off its 64-row query and 64- or 32-key KV tiles, as
# tests/test_torch_kernels_cuda.py's SIMT_CASES
FA_SIMT_CASES = [
    (8, 8, 2, 256, 256, 64, True, 256),
    (8, 8, 2, 256, 256, 64, True, None),
    (4, 8, 4, 1024, 1024, 128, True, None),
    (4, 2, 1, 1024, 1024, 256, True, 512),
    (2, 8, 1, 77, 77, 16, True, None),
    (1, 8, 2, 300, 300, 32, True, 40),
    (2, 4, 4, 100, 230, 64, False, None),
    (1, 8, 1, 333, 333, 128, True, 40),
    (2, 4, 4, 70, 150, 128, False, None),
    (1, 4, 1, 130, 200, 256, True, None),
    (2, 2, 2, 150, 150, 256, True, 48),
]

# (B, H, KVH, Sq, Skv, D, causal, window): K4's bf16 tensor-core path at the main
# paths' geometries (gemma3-1b's local layers, internlm2-1.8b's 16 query heads on 8 kv
# heads) and Sq, Skv off its 128-row query and 64-key KV tiles at head_dim 128 and
# 256, as tests/test_torch_kernels_cuda.py's TC_CASES
FA_TC_CASES = [
    (1, 4, 1, 1024, 1024, 256, True, 512),
    (1, 16, 8, 1024, 1024, 128, True, None),
    (2, 4, 2, 200, 333, 128, False, None),
    (2, 4, 2, 200, 333, 128, True, 48),
    (1, 4, 1, 77, 130, 256, True, None),
]


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events, with the L2 cache flushed
    before each call (the serving path finds these operands cold or half-cold).  The
    start event is recorded before the Python call, so where the wrapper's host time
    exceeds the card's, this reading (``call_ms``) is the host's: see
    :func:`kernel_ms` for the card's alone."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(torch, fn, calls: int = 200) -> float:
    """Microseconds of host time per call (``repro_torch.launch.devtime.host_us``, the
    profile scripts' timer too)."""
    from repro_torch.launch import devtime
    return devtime.host_us(fn, calls)


def kernel_ms(torch, fn, reps: int = 30, warmup: int = 3, host: float | None = None) -> float:
    """Median milliseconds the card spends on one call, with no host time in them
    (``repro_torch.launch.devtime.kernel_ms``: after the L2 flush the card spins for
    twice the call's host time plus 0.2 ms, so the call's launches are queued before
    the start event fires).  ``host`` is the call's host µs (measured here when not
    given)."""
    from repro_torch.launch import devtime
    for _ in range(warmup):
        fn()
    if host is None:
        host = devtime.host_us(fn, calls=20)
    return devtime.kernel_ms(fn, host, reps)


def readings(torch, fn, reps: int = 30) -> dict:
    """A kernel's or library call's three readings: ``kernel_ms`` (the card alone),
    ``call_ms`` (events around the Python call) and ``host_us`` (per call)."""
    host = host_us(torch, fn)
    return {"kernel_ms": kernel_ms(torch, fn, reps=reps, host=host),
            "call_ms": time_ms(torch, fn, reps=reps), "host_us": host}


def record(name: str, route: str, source: str, replaces: str, err: float, kern: dict,
           plain_ms: float, bound_ms: float, bound_by: str, lib: dict | None) -> dict:
    """One row of the kernels' line: ``ms`` is the kernel's device time and
    ``library_ms`` the library call's; each beside its call time and host µs."""
    return dict(
        name=name, route=route, source=source, replaces=replaces, max_abs_err=err,
        ms=kern["kernel_ms"], call_ms=kern["call_ms"], host_us=kern["host_us"],
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None if lib is None else lib["kernel_ms"],
        library_call_ms=None if lib is None else lib["call_ms"],
        library_host_us=None if lib is None else lib["host_us"],
    )


def fmt(r: dict) -> str:
    return f"kernel_ms {r['kernel_ms']:.4f} call_ms {r['call_ms']:.4f} host_us {r['host_us']:.1f}"


# K4's f32 instantiations (csrc/flash_attention.cu): held to zero spills in phase 2
FA_SIMT_ENTRIES = {f"fa_fwd_simt_kernelILi{d}E": f"K4 SIMT f32, head_dim {d}"
                   for d in (16, 32, 64, 128, 256)}
# K5's kernels (csrc/ssd_scan.cu): every one is held to zero spills in phase 2
SSD_ENTRIES = {"ssd_chunk_state_tc": "K5 chunk state, bf16 (mma.sync)",
               "ssd_chunk_state_f32": "K5 chunk state, f32",
               "ssd_state_pass": "K5 state passing",
               "ssd_chunk_output_tc": "K5 chunk output, bf16 (mma.sync)",
               "ssd_chunk_output_f32": "K5 chunk output, f32"}


def sass_counts(lib: Path, opcode: str, entries: list[str]) -> dict | None:
    """How many SASS instructions of ``opcode`` each kernel whose name contains one of
    ``entries`` holds, by ``cuobjdump -sass``; None where cuobjdump is not installed."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, current = {key: 0 for key in entries}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((key for key in entries if key in line), None)
        elif current is not None and re.search(rf"\b{opcode}\b", line):
            counts[current] += 1
    return counts


def ptxas_entries(log: str) -> list[tuple[str, int, int, int]]:
    """(kernel entry, registers, spill-store bytes, spill-load bytes) of each entry
    function in nvcc's -Xptxas -v output."""
    from repro_torch.launch import devtime
    return devtime.ptxas_entries(log)


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave visible: the work attention must do."""
    from repro_torch.launch import devtime
    return devtime.visible_pairs(Sq, Skv, causal, window)


def k1_library_call(torch, members: list, operands: tuple, want):
    """One PyTorch call computing the same function as a K1 cluster of the Myia LM
    step, as ``(callable, label)``, or None where there is none.  A yardstick
    only: the port never calls it."""
    if members == ["mul", "sub", "mul"]:  # tanh's backward, dout * (1 - out * out)
        out, dout = operands
        return (lambda: torch.ops.aten.tanh_backward(dout, out)), "aten.tanh_backward"
    if members == ["unreduce", "eq", "cast"]:  # reduce_max's argmax mask, as f32
        row_max, x = operands
        buf = torch.empty_like(want)
        return (lambda: torch.eq(x, row_max, out=buf)), "torch.eq with an f32 out="
    return None  # ["sub", "mul", "reduce_sum"]: sum(onehot * (logits - lse))


def myia_phases(torch, dev, records, card: str) -> tuple[dict, dict, dict]:
    """Phases 17-20: K1 against its oracles, and the Myia-compiled LM step from
    tiny dims to full width.  Adds one K1 record per cluster of the main path to
    ``records`` and returns the launch counts of the main path's timed steps, by
    counter and by generated kernel, and the step's median time and its kernels'
    names in plan order."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import (
        FUSED_LAUNCHES, LAUNCHES, k1_cases, reset_launches, set_kernel_mode,
    )
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.myia_step import MyiaLMDims, make_myia_train_step

    def in_ref_mode(fn, *args):
        set_kernel_mode("ref")
        try:
            return fn(*args)
        finally:
            set_kernel_mode(None)

    # -- 17. K1 against its oracles at the card-test shapes --------------------------
    t0 = time.monotonic()
    ulps = {}
    for i, (cname, prog) in enumerate(sorted(k1_cases.ELEMENTWISE_CASES.items())):
        for dt in (torch.float32, torch.bfloat16):
            x, y = k1_cases.case_inputs(cname, (3, 37, 129), (3, 1, 0)[i % 3], dt, dev)
            fn = k1_cases.compile_case(prog, x, y)
            n_fused = len(fn.__fused_kernels__)
            assert n_fused >= 1, cname
            before = LAUNCHES["fused_map"]
            got = fn(x, y)
            torch.cuda.synchronize()
            assert LAUNCHES["fused_map"] == before + n_fused, cname
            want = in_ref_mode(fn, x, y)
            assert got.dtype == want.dtype and got.shape == want.shape, cname
            if got.dtype.is_floating_point:
                u = k1_cases.ulps(got, want)
                assert u <= k1_cases.MAP_ULPS.get(cname, 1), (cname, dt, u)
            else:
                assert torch.equal(got, want), (cname, dt)
                u = 0
            ulps[(cname, str(dt).removeprefix("torch."))] = u
    exact = sorted(k for k, u in ulps.items() if u == 0)
    say(f"[k1] {len(ulps)} map cases (every fusion.ELEMENTWISE primitive, f32 and bf16, "
        f"body (3, 37, 129), the second operand at rank 3, 1 or 0): bitwise equal to the "
        f"oracle in {len(exact)}; the rest within {{case: ulps}} "
        f"{ {f'{c}/{d}': u for (c, d), u in ulps.items() if u} }")
    red = []
    for cname, prog in sorted(k1_cases.REDUCE_CASES.items()):
        for dt in (torch.float32, torch.bfloat16):
            x, y = k1_cases.case_inputs(cname, (16, 37, 129), 1, dt, dev)
            fn = k1_cases.compile_case(prog, x, y)
            before = LAUNCHES["fused_reduce"]
            got = fn(x, y)
            torch.cuda.synchronize()
            assert LAUNCHES["fused_reduce"] == before + sum(
                k.launches_per_call for k in fn.__fused_kernels__), cname
            want = in_ref_mode(fn, x, y)
            tol = k1_cases.REDUCE_TOL[str(dt).removeprefix("torch.")]
            torch.testing.assert_close(got.float(), want.float(), **tol)
            red.append((got.float() - want.float()).abs().max().item())
    say(f"[k1] {len(red)} reduce cases (reduce_sum / reduce_max / unbroadcast over leading, "
        f"trailing, middle, two and all axes, f32 and bf16, body (16, 37, 129)): max_abs_err "
        f"{max(red):.3e} within {k1_cases.REDUCE_TOL}; {time.monotonic() - t0:.1f}s with the "
        f"Triton builds")

    # -- 18. the Myia LM step at tiny dims, f32: card with kernels vs CPU with oracles --
    tiny = MyiaLMDims(96, 16, 40)
    step_c, init_c = make_myia_train_step(tiny, 2, 8, 0.1, device="cpu")
    step_g, _ = make_myia_train_step(tiny, 2, 8, 0.1, device=dev)
    params_c = init_c()["params"]
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(0, 96, (2, 8)).astype(np.int32))
    lab = torch.from_numpy(rs.randint(0, 96, (2, 8)).astype(np.int32))
    loss_c, grads_c = step_c.vag(*params_c, tok, lab)
    reset_launches()
    loss_g, grads_g = step_g.vag(*(p.to(dev) for p in params_c), tok.to(dev), lab.to(dev))
    torch.cuda.synchronize()
    assert (LAUNCHES["fused_map"], LAUNCHES["fused_reduce"]) == (3, 2), dict(LAUNCHES)
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grel = max((g.cpu() - c).abs().max().item() / c.abs().max().item()
               for g, c in zip(grads_g, grads_c))
    say(f"[myia-tiny] V 96 D 16 H 40, batch 2 x 8, f32: loss {float(loss_g):.6f} card vs "
        f"{float(loss_c):.6f} CPU (rel {rel:.2e}, bound {MYIA_CPU_LOSS_REL}); gradients "
        f"within {grel:.2e} of their largest element (bound {MYIA_CPU_GRAD_REL}); 3 map and 2 "
        f"reduce K1 launches (the reduce's two passes)")
    assert rel <= MYIA_CPU_LOSS_REL and grel <= MYIA_CPU_GRAD_REL, (rel, grel)

    # -- 19. --compiler myia at full width ---------------------------------------------
    cfg = get_config("internlm2-1.8b")
    dims = MyiaLMDims.from_config(cfg)
    assert (dims.vocab, dims.d_model, dims.d_hidden) == (92544, 2048, 8192)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MYIA_S, global_batch=MYIA_B))
    step_fn, init_fn = make_myia_train_step(dims, MYIA_B, MYIA_S, MYIA_LR, device=dev)
    state = init_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch = to_device(ds.batch(0), dev)
    args = (*state["params"], batch["tokens"], batch["labels"])
    t0 = time.monotonic()
    runner = step_fn.vag.specialize(args)
    t_pipeline = time.monotonic() - t0
    plan = runner.fn.__fusion_plan__
    kinds = [c.kind for c in plan.clusters]
    fused = runner.fn.__fused_kernels__
    members = {k.name: [n.fn.value.name for n in c.order] for c, k in zip(plan.clusters, fused)}
    say(f"[train-myia] plan {plan.stats()}: clusters "
        f"{[(c.kind, c.body_shape, [n.fn.value.name for n in c.order]) for c in plan.clusters]}")
    assert sorted(kinds) == ["map", "map", "map", "reduce"], kinds
    # the first step, with the cluster inputs captured for the full-shape checks
    captured = {}
    with capturing_k1(captured):
        t0 = time.monotonic()
        state, m = step_fn(state, batch)
        losses = [float(m["loss"])]
        t_first = time.monotonic() - t0
    say(f"[train-myia] first call: pipeline (parse, AD, infer, optimize, fuse, lower) "
        f"{t_pipeline:.2f}s; first step with the Triton builds {t_first:.2f}s")
    step_s, per_step = [], []
    reset_launches()
    for i in range(1, MYIA_STEPS + 1):
        batch = to_device(ds.batch(i), dev)
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        per_step.append({n: LAUNCHES[n] - before[n] for n in LAUNCHES})
    counts = dict(LAUNCHES)
    fused_counts = dict(FUSED_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_s)
    tokens = MYIA_B * MYIA_S
    say(f"[train-myia] {card}: V {dims.vocab} D {dims.d_model} H {dims.d_hidden}, f32, SGD lr "
        f"{MYIA_LR}, batch {MYIA_B} x {MYIA_S}: median step {med:.4f}s over {MYIA_STEPS} "
        f"(min {min(step_s):.4f}, max {max(step_s):.4f}), {tokens / med:.0f} tokens/s, peak "
        f"memory {peak:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    say(f"[train-myia] launches per step {per_step[0]}; by kernel over the run {fused_counts}; "
        f"launches per call {({k.name: k.launches_per_call for k in fused})}")
    want = {kind: sum(k.launches_per_call for k in fused if k.kind == kind)
            for kind in ("map", "reduce")}
    # 3 map clusters, and the cross-entropy sum's two passes over 189.5M elements
    assert want == {"map": 3, "reduce": 2}, want
    assert all((c["fused_map"], c["fused_reduce"]) == (want["map"], want["reduce"])
               and sum(c.values()) == 5 for c in per_step), per_step
    assert fused_counts == {k.name: MYIA_STEPS * k.launches_per_call for k in fused}, \
        fused_counts
    assert all(math.isfinite(x) for x in losses), losses
    assert statistics.mean(losses[-5:]) < losses[0], losses
    # the user's entry point: two steps of the driver, with its checkpoint
    with tempfile.TemporaryDirectory() as ck:
        assert train_cli.main(["--compiler", "myia", "--steps", "2", "--ckpt-every", "100",
                               "--ckpt-dir", ck]) == 0

    # -- 17 (cont.). the main path's four clusters at their full shapes -----------------
    for kname, (k, a) in sorted(captured.items()):
        got = k.triton(*a)
        want = k.oracle(*a)
        torch.cuda.synchronize()
        if k.kind == "map":
            err_ulps = k1_cases.ulps(got, want)
            assert err_ulps <= 1, (kname, err_ulps)
        else:
            torch.testing.assert_close(got, want, **k1_cases.REDUCE_TOL["float32"])
            err_ulps = None
        err = (got - want).abs().max().item()
        n = int(np.prod(k.body_shape))
        bound_ms = max(k.bytes_moved / HBM_BYTES_PER_S, k.n_nodes * n / F32_FLOPS) * 1e3
        lib_r, lib_note = None, "no single PyTorch call"
        lib = k1_library_call(torch, members[kname], a, want)
        if lib is not None:
            call_lib, lib_note = lib
            lib_out = call_lib()
            torch.testing.assert_close(lib_out, want, **k1_cases.REDUCE_TOL["float32"])
            lib_r = readings(torch, call_lib)
            lib_note += f", max_abs_err {(lib_out - want).abs().max().item():.3e} vs the oracle"
        kern = readings(torch, lambda: k.triton(*a))
        rec = record(kname, "triton", "src/repro_torch/kernels/codegen.py",
                     "src/repro/kernels/codegen.py:205", err, kern,
                     time_ms(torch, lambda: k.oracle(*a)), bound_ms,
                     "bytes" if k.bytes_moved / HBM_BYTES_PER_S >= k.n_nodes * n / F32_FLOPS
                     else "operations", lib_r)
        rec["launches"] = fused_counts[kname]
        records[kname] = rec
        say(f"[k1] {kname} {k.kind} {members[kname]} body {k.body_shape} -> {k.out_shape}, "
            f"{k.launches_per_call} launch(es) a call: max_abs_err {err:.3e}"
            f"{f' ({err_ulps} ulp)' if err_ulps is not None else ''} {fmt(kern)} oracle_ms "
            f"{rec['plain_ms']:.4f}; library {'null' if lib_r is None else fmt(lib_r)} "
            f"({lib_note}); bound_ms {bound_ms:.4f} (bytes, {k.bytes_moved / 1e6:.1f} MB) = "
            f"{bound_ms / rec['ms'] * 100:.1f}% of the bound")
        if members[kname] == ["mul", "sub", "mul"] and k.body_shape[-1] == 2048:
            # cluster 2, tanh's backward at (8, 256, 2048): K1 is redesigned only if the
            # card's own time says it is more than 10% behind aten.tanh_backward's
            gap = rec["ms"] / rec["library_ms"] - 1
            say(f"[k1] decision on {kname} (tanh's backward, (8, 256, 2048) f32), by device "
                f"time: K1 {rec['ms']:.4f} ms against aten.tanh_backward "
                f"{rec['library_ms']:.4f} ms ({gap:+.1%}); call_ms {rec['call_ms']:.4f} "
                f"against {rec['library_call_ms']:.4f}; host_us {rec['host_us']:.1f} against "
                f"{rec['library_host_us']:.1f}: "
                f"{'more than 10% slower' if gap > 0.10 else 'within 10%'}")
    del captured

    # -- 20. one full-width step, kernels against kernel mode "ref" -------------------
    batch = to_device(ds.batch(MYIA_STEPS + 1), dev)
    args = (*state["params"], batch["tokens"], batch["labels"])
    loss_k, grads_k = step_fn.vag(*args)
    loss_r, grads_r = in_ref_mode(step_fn.vag, *args)
    rel = abs(float(loss_k) - float(loss_r)) / abs(float(loss_r))
    grels = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(grads_k, grads_r)]
    say(f"[train-myia] one full-width step, kernels vs kernel mode 'ref': loss rel {rel:.2e} "
        f"(bound {MYIA_REF_LOSS_REL}); gradients (emb, w1, w2, wout) within "
        f"{[f'{g:.2e}' for g in grels]} of their largest element (bound {MYIA_REF_GRAD_REL})")
    assert rel <= MYIA_REF_LOSS_REL and max(grels) <= MYIA_REF_GRAD_REL, (rel, grels)
    del state, grads_k, grads_r, args
    torch.cuda.empty_cache()
    return counts, fused_counts, {"step_s": med, "names": [k.name for k in fused],
                                  "clusters": [(k.kind, members[k.name]) for k in fused]}


def widen_in_place(tree):
    """Every tensor of a nested dict/list widened to f32, each dropped as it goes, so
    that the bf16 and f32 copies of a large model never exist whole at once."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in list(items):
        tree[key] = widen_in_place(val) if isinstance(val, (dict, list)) else val.float()
    return tree


def xattn_moe_phases(torch, dev, card: str) -> dict:
    """Phases 22-25: the MoE, cross-attention and encoder-decoder archs, reduced in f32
    (card against CPU), then whisper-medium, llama-3.2-vision-11b and one Jamba block
    served at full width.  Returns each served path's launch counts over its prefill
    and decode."""
    from repro_torch.configs import DEC_CONTEXT, ENC_FRAMES, get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.build import K2_ROUTES
    from repro_torch.launch.serve import make_requests, serve_decode, serve_prefill
    from repro_torch.models import init_params
    from repro_torch.tree import leaves, map_leaves

    cpu = torch.device("cpu")
    archs = ["grok-1-314b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "llama-3.2-vision-11b",
             "whisper-medium"]

    # -- 22. the five archs reduced, f32: card with kernels vs CPU plain ---------------
    for arch in archs:
        small = get_config(arch, reduced=True)
        sp = init_params(small, seed=0, device="cpu")
        sp_card = map_leaves(lambda t: t.to(dev), sp)
        prompts, extras = make_requests(small, 2, 12, cpu)
        lc, cc = serve_prefill(small, sp, prompts, 16, batch_extras=extras)
        lg, cg = serve_prefill(small, sp_card, prompts.to(dev), 16,
                               batch_extras={k: v.to(dev) for k, v in extras.items()})
        torch.testing.assert_close(lg.cpu(), lc, rtol=3e-4, atol=3e-4)
        for a, b in zip(cg, cc, strict=True):
            assert sorted(a) == sorted(b), arch
            for part in b:
                for key in b[part]:
                    torch.testing.assert_close(a[part][key].cpu(), b[part][key], rtol=3e-4,
                                               atol=3e-4)
        toks, kc = serve_decode(small, sp, lc, cc, 12, 4, keep_logits=True)
        _, kg = serve_decode(small, sp_card, lg, cg, 12, 4, forced=toks.to(dev),
                             keep_logits=True)
        for a, b in zip(kg, kc):
            torch.testing.assert_close(a.cpu(), b, rtol=5e-4, atol=5e-4)
    say(f"[xattn-small] {', '.join(archs)} reduced, f32 prefill (logits, self and cross "
        "caches, conv and SSM state) + 4 decode steps: card kernels agree with CPU plain "
        "within 3e-4 / 5e-4")

    def agreement(a, b) -> float:
        """The share of (token, k) routing choices that two runs make alike: a and b
        hold the expert indices (G, Sg, K) of every MoE layer, as ``prefill(routes=)``
        collects them."""
        same = sum(int((x == y).sum()) for x, y in zip(a, b, strict=True))
        return same / sum(x.numel() for x in a)

    def routing(a, b) -> str:
        by_layer = ", ".join(f"{agreement([x], [y]):.2%}" for x, y in zip(a, b, strict=True))
        return (f"(token, k) routing choices alike in {agreement(a, b):.4%} (by MoE layer: "
                f"{by_layer})")

    def compare(label, got, want, rel_bound, extra=""):
        diff = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tok = got.argmax(-1)
        agree = int((tok == want.argmax(-1)).sum())
        gap = (want.max(-1).values - want.gather(1, tok[:, None])[:, 0]).max().item()
        say(f"[{label}] kernels vs plain, last-position logits: max_abs_diff {diff:.4e} = "
            f"{diff / scale:.3e} x max|logit| {scale:.4e} (bound {rel_bound}){extra}; first "
            f"greedy tokens agree on {agree}/{got.shape[0]} rows, largest plain-logit gap of "
            f"the kernel's pick {gap:.4e}")
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()), label
        assert diff <= rel_bound * scale, (label, diff, scale)
        assert gap <= rel_bound * scale, (label, gap, scale)

    def serve_path(tag, cfg, prompt_len, want_prefill, want_step, bf16_bound, want_routes, *,
                   f32_layers=None, note=""):
        """Serve ``cfg`` at full width in bf16 through repro_torch.launch.serve, with the
        launches of the prefill and of every decode step asserted exactly, and K2's
        launches by route (``want_routes``: the prefill's and a step's); then the
        same prefill with the plain versions, in bf16 and with the weights widened to
        f32 (on the first ``f32_layers`` layers when given).  Returns the launches of
        the prefill and the decode steps together."""
        t0 = time.monotonic()
        params = init_params(cfg, seed=0, device=dev)
        n_params = sum(t.numel() for t in leaves(params))
        prompts, extras = make_requests(cfg, XA_B, prompt_len, dev, enc_frames=ENC_FRAMES)
        torch.cuda.synchronize()
        t_init = time.monotonic() - t0
        max_len = prompt_len + XA_GEN
        say(f"[{tag}] {cfg.name}: {cfg.n_layers} layers"
            f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.enc_dec else ''}, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} of {cfg.hd}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params / 1e9:.3f} B parameters in bf16, random "
            f"from seed 0 ({t_init:.1f}s to make); batch {XA_B}, prompt {prompt_len}, "
            f"{XA_GEN} greedy tokens; extras "
            f"{ {k: tuple(v.shape) for k, v in extras.items()} }{note}")
        wl, wc = serve_prefill(cfg, params, prompts, max_len, batch_extras=extras)  # warm-up
        serve_decode(cfg, params, wl, wc, prompt_len, 2)
        del wl, wc
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.monotonic()
        logits, caches = serve_prefill(cfg, params, prompts, max_len, batch_extras=extras)
        torch.cuda.synchronize()
        t_prefill = time.monotonic() - t0
        prefill_counts, prefill_routes = dict(LAUNCHES), dict(K2_ROUTES)
        reset_launches()
        step_counts, step_routes, step_logits, fed = [], [], [], []
        lg = logits
        t1 = time.monotonic()
        for i in range(XA_GEN):  # serve_decode one step at a time, to count each step
            before, before_routes = dict(LAUNCHES), dict(K2_ROUTES)
            tok, kept = serve_decode(cfg, params, lg, caches, prompt_len + i, 1,
                                     keep_logits=True)
            lg = kept[0]
            fed.append(tok)
            step_logits.append(lg)
            step_counts.append({n: LAUNCHES[n] - before[n] for n in LAUNCHES})
            step_routes.append({r: n - before_routes.get(r, 0) for r, n in K2_ROUTES.items()
                                if n != before_routes.get(r, 0)})
        torch.cuda.synchronize()
        t_decode = time.monotonic() - t1
        decode_counts = dict(LAUNCHES)
        tokens = torch.cat(fed, dim=1)
        say(f"[{tag}] {card}: prefill {t_prefill:.4f}s ({XA_B * prompt_len / t_prefill:.0f} "
            f"tok/s); decode {XA_GEN} steps in {t_decode:.4f}s ({XA_B * XA_GEN / t_decode:.1f} "
            f"tok/s, {t_decode / XA_GEN * 1e3:.2f} ms/step); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        say(f"[{tag}] launches: prefill {prefill_counts}; decode {decode_counts} over "
            f"{XA_GEN} steps; K2 by route: prefill {prefill_routes}, a decode step "
            f"{step_routes[0]}")
        none = {n: 0 for n in LAUNCHES}
        assert prefill_counts == {**none, **want_prefill}, (tag, prefill_counts)
        assert all(c == {**none, **want_step} for c in step_counts), (tag, step_counts)
        assert prefill_routes == want_routes[0], (tag, prefill_routes)
        assert all(r == want_routes[1] for r in step_routes), (tag, step_routes)
        assert logits.shape == (XA_B, cfg.vocab) and tokens.shape == (XA_B, XA_GEN)
        assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
        assert all(bool(torch.isfinite(x).all()) for x in step_logits), "non-finite decode"
        say(f"[{tag}] first tokens: {tokens[:, :8].tolist()}")
        del caches, step_logits

        def prefill(cfg_, impl, extras_=extras, routes=None):
            return serve_prefill(cfg_, params, prompts, max_len, batch_extras=extras_,
                                 impl=impl, routes=routes)[0]

        rk, rr, rc = [], [], []
        prefill(cfg, None, routes=rk)
        logits_ref = prefill(cfg, "ref", routes=rr)
        compare(f"{tag} bf16", logits, logits_ref, bf16_bound,
                f"; {routing(rk, rr)}" if cfg.num_experts else "")
        if cfg.num_experts:
            # bf16's own spread: two plain versions, no kernel between them
            logits_chunked = prefill(cfg, "chunked", routes=rc)
            spread = (logits_chunked - logits_ref).abs().max() / logits_ref.abs().max()
            say(f"[{tag} bf16] two plain versions, no kernel (impl 'chunked' against 'ref'): "
                f"last-position logits {spread.item():.3e} x max|logit|; {routing(rc, rr)}")
            assert agreement(rk, rr) >= JAMBA_BF16_ROUTE_MIN, (tag, agreement(rk, rr))
            del logits_chunked
        del logits, logits_ref
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        if f32_layers is not None:
            cfg32 = dataclasses.replace(cfg32, n_layers=f32_layers)
            del params["layers"][f32_layers:]
        widen_in_place(params)
        torch.cuda.empty_cache()
        extras32 = {k: v.float() for k, v in extras.items()}
        rk, rr = [], []
        lk, lr = prefill(cfg32, None, extras32, rk), prefill(cfg32, "ref", extras32, rr)
        compare(f"{tag} f32", lk, lr, XA_F32_REL_BOUND,
                f" (the same weights widened to f32"
                f"{f', the first {f32_layers} layers' if f32_layers else ''})"
                f"{f'; {routing(rk, rr)}' if cfg.num_experts else ''}")
        if cfg.num_experts:
            assert agreement(rk, rr) >= JAMBA_F32_ROUTE_MIN, (tag, agreement(rk, rr))
        del params, lk, lr
        torch.cuda.empty_cache()
        return {n: prefill_counts[n] + decode_counts[n] for n in LAUNCHES}

    counts = {}
    # -- 23. whisper-medium: 24 encoder + 24 decoder layers, cross-attention on each ----
    # K4: 24 encoder (non-causal), 24 decoder (causal), 24 cross; K2: 2 x 24 + 1 in the
    # encoder, 3 x 24 + 1 in the decoder, and 3 x 24 + 1 a decode step, all on the
    # warp-per-row kernel (rows of 1024)
    counts["serve_whisper"] = serve_path(
        "serve-whisper", get_config("whisper-medium"), DEC_CONTEXT - XA_GEN,
        {"flash_attention_fwd": 72, "rmsnorm_fwd": 122}, {"rmsnorm_fwd": 73},
        XA_BF16_REL_BOUND, ({"warp-per-row": 122}, {"warp-per-row": 73}),
        note=f"; {ENC_FRAMES} encoder frames (30 s at 50 Hz)")
    # -- 24. llama-3.2-vision-11b: 40 layers, cross-attention on 8 --------------------
    counts["serve_vision"] = serve_path(
        "serve-vision", get_config("llama-3.2-vision-11b"), XA_PROMPT,
        {"flash_attention_fwd": 48, "rmsnorm_fwd": 89}, {"rmsnorm_fwd": 89},
        XA_BF16_REL_BOUND, ({"warp-per-row": 89}, {"warp-per-row": 89}))
    # -- 25. one Jamba block: 7 Mamba-2 layers, attention at index 3, MoE on the odd -----
    from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL as SSD_LAUNCHES
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS)
    counts["serve_jamba"] = serve_path(
        "serve-jamba", jamba, XA_PROMPT,
        {"flash_attention_fwd": 1, "ssd_scan_fwd": 7 * SSD_LAUNCHES, "rmsnorm_fwd": 24},
        {"rmsnorm_fwd": 24}, JAMBA_BF16_REL_BOUND,
        # 17 norms of 4096 on the warp-per-row kernel, the 7 Mamba gate norms of 8192 on
        # route 1, in a prefill and in a step alike
        ({"warp-per-row": 17, "row-per-block": 7}, {"warp-per-row": 17, "row-per-block": 7}),
        f32_layers=JAMBA_F32_LAYERS,
        note=f"; depth cut to {JAMBA_LAYERS} of 32 layers, one whole Jamba block (52B in "
             f"bf16, ~104 GB, does not fit on one card)")
    return counts


def serve_myia_phases(torch, dev, card: str) -> dict:
    """Phases 26-28: the Myia serving runtime (``repro_torch.serve``) at tiny dims card
    against CPU, then gemma3-1b's Myia LM served at full width through ``python -m
    repro_torch.launch.serve --compiler myia`` (unfused, as the launcher runs it) and
    through a fused engine, then a warm restart in a second process on the same
    program cache, and the profiler over one fused decode step.  Returns the launch
    counts of each served path (K1's generated kernels by name under ``fused``)."""
    import os
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.torch_backend import ProgramCache
    from repro_torch.kernels import FUSED_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.launch import serve as serve_cli
    from repro_torch.obs import profile as obs_profile
    from repro_torch.serve import (
        ServeEngine, ServeLMDims, build_decode_step, build_prefill, causal_mask, decode_masks,
        init_serve_params, oracle_generate,
    )

    def plan_kernels(engine, kind: str, bucket: int) -> list:
        """The fused kernels of the engine's ``kind`` program at ``bucket``, from its plan."""
        fn = engine._prefill_fn if kind == "prefill" else engine._decode_fn
        runner = next(r for key, r in fn._specializations.items()
                      if any(a[0] == "arr" and bucket in a[1] for a in key[-1]))
        return list(runner.fn.__fused_kernels__)

    def rel(got, want) -> float:
        return ((got.cpu() - want).abs().max() / want.abs().max()).item()

    # -- 26. tiny dims, fused: the card against the CPU (the oracles) ------------------
    tiny = ServeLMDims(48, 8, 16)
    p_cpu = init_serve_params(tiny, torch.Generator().manual_seed(0), device="cpu")
    p_card = tuple(p.to(dev) for p in p_cpu)
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, 48, n).tolist(), m) for n, m in [(5, 6), (9, 4), (3, 8), (20, 6)]]
    streams = []
    for params in (p_cpu, p_card):
        eng = ServeEngine(tiny, params, n_slots=2, min_bucket=16, fuse=True)
        rids = [eng.submit(p, m) for p, m in work]
        res = eng.run()
        assert all(res[r]["status"] == "ok" for r in rids), res
        streams.append([res[r]["tokens"] for r in rids])
    oracle_card = [oracle_generate(tiny, p_card, p, m) for p, m in work]
    assert streams[1] == streams[0] == oracle_card, streams + [oracle_card]
    tok = torch.from_numpy(rng.integers(0, 48, (1, 16)).astype(np.int32))
    pre = api.myia(build_prefill(tiny), options=api.CompileOptions(fuse=True))
    want = pre(*p_cpu, tok, causal_mask(16))
    got = pre(*p_card, tok.to(dev), causal_mask(16, dev))
    e_pre = max(rel(g, w) for g, w in zip(got, want))
    dec = api.myia(build_decode_step(tiny, 2), options=api.CompileOptions(fuse=True))
    kc = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(1))
    pos = np.array([3, 11])
    want = dec(*p_cpu, torch.tensor([4, 31], dtype=torch.int32), kc, kc, *decode_masks(pos, 16))
    got = dec(*p_card, torch.tensor([4, 31], dtype=torch.int32, device=dev), kc.to(dev),
              kc.to(dev), *decode_masks(pos, 16, dev))
    e_dec = max(rel(g, w) for g, w in zip(got, want))
    say(f"[serve-myia-tiny] V 48 D 8 H 16 f32, fused, 4 requests over 2 slots: streams on the "
        f"card equal the CPU's and the card's oracle_generate; prefill (logits, k, v) within "
        f"{e_pre:.2e}, decode within {e_dec:.2e} of their largest element (bound {SM_TINY_REL})")
    assert e_pre <= SM_TINY_REL and e_dec <= SM_TINY_REL, (e_pre, e_dec)

    # -- 27. full width through the launcher (unfused), then a fused engine ------------
    cfg = get_config("gemma3-1b")
    work_dir = Path(tempfile.mkdtemp(prefix="serve_myia_"))
    cache_dir = str(work_dir / "progcache")
    argv = ["--compiler", "myia", "--arch", "gemma3-1b", "--batch", str(SM_REQS),
            "--prompt-len", str(SM_PROMPT), "--gen", str(SM_GEN), "--slots", str(SM_SLOTS),
            "--min-bucket", str(SM_MIN_BUCKET), "--cache-dir", cache_dir]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    report = serve_cli.serve_myia_engine(serve_cli.parse_args(
        argv + ["--check-oracle", "--trace", str(work_dir / "trace.json"),
                "--metrics-out", str(work_dir / "metrics.prom")]), cfg)
    t_cold = time.monotonic() - t0
    unfused_counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dims, params, engine = report["dims"], report["params"], report["engine"]
    assert (dims.vocab, dims.d_model, dims.d_hidden) == (262144, 1152, 4608)
    stats, cold_cs = report["stats"], report["cache_stats"]
    bucket = 2048
    assert stats["buckets_in_use"] == [bucket], stats
    results = report["results"]
    rids = [r for r, _p in report["requests"]]
    assert all(results[r]["status"] == "ok" for r in rids), results
    assert all(results[r]["tokens"] == report["oracle"][r] for r in rids)
    tracer = report["tracer"]
    # the serve.prefill span closes when the program has been launched; the admission
    # then waits for the card (the sentinel's copy), so a prefill's time is read here
    # with the card drained around the same call: median of 5, warm
    tok = torch.from_numpy(np.zeros((1, bucket), np.int32)).to(dev)
    prefills = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._prefill_fn(*params, tok, causal_mask(bucket, dev))
        torch.cuda.synchronize()
        prefills.append(time.perf_counter() - t0)
    first_build = tracer.find("serve.prefill")[0].dur_s
    steps = tracer.find("serve.decode_step")
    decode_tok_s = sum(e.attrs["n_active"] for e in steps) / sum(e.dur_s for e in steps)
    ttft = [results[r]["ttft_s"] for r in rids]
    prom = (work_dir / "metrics.prom").read_text()
    say(f"[serve-myia] {card}: gemma3-1b's Myia LM, V {dims.vocab} D {dims.d_model} H "
        f"{dims.d_hidden} f32 (TF32 off), {SM_REQS} requests x (prompt {SM_PROMPT} + gen "
        f"{SM_GEN}) over {SM_SLOTS} slots, bucket {bucket}, through python -m "
        f"repro_torch.launch.serve --compiler myia (unfused): run {report['wall_s']:.3f}s "
        f"({t_cold:.1f}s with the oracle check); TTFT first {ttft[0]:.4f}s, last "
        f"{ttft[-1]:.4f}s (the first admission's serve.prefill span, {first_build:.4f}s, "
        f"builds the program); prefill {statistics.median(prefills):.4f}s a request (median "
        f"of {prefills}); decode {decode_tok_s:.1f} tok/s over {len(steps)} steps (median step "
        f"{statistics.median(e.dur_s for e in steps) * 1e3:.3f} ms); peak memory {peak:.2f} "
        f"GiB; compilations {stats['compilations']} (floor {stats['compilation_floor']}); "
        f"streams equal the full-prefix oracle's ({len(rids)} requests)")
    say(f"[serve-myia] cold cache: {cold_cs}; metrics exposition {len(prom.splitlines())} "
        f"lines; kernel launches {unfused_counts}")
    assert stats["total_compilations"] == stats["compilation_floor"] == 2, stats
    assert cold_cs["misses"] == 2 and cold_cs["programs_built"] == 2, cold_cs
    assert cold_cs["compile_retries"] == 0 and cold_cs["vm_fallbacks"] == 0, cold_cs
    assert f"cache_misses {cold_cs['misses']}" in prom
    assert not any(unfused_counts.values()), unfused_counts

    fused_cache = ProgramCache(cache_dir)
    reset_launches()
    fused = ServeEngine(dims, params, n_slots=SM_SLOTS, min_bucket=SM_MIN_BUCKET,
                        program_cache=fused_cache, fuse=True)
    frids = [fused.submit(p, SM_GEN) for _r, p in report["requests"]]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fres = fused.run()
    torch.cuda.synchronize()
    t_fused = time.monotonic() - t0
    fused_counts, fused_by_name = dict(LAUNCHES), dict(FUSED_LAUNCHES)
    fcs = fused_cache.stats.as_dict()
    plan = {kind: plan_kernels(fused, kind, bucket) for kind in ("prefill", "decode")}
    per_prefill = sum(k.launches_per_call for k in plan["prefill"])
    per_step = sum(k.launches_per_call for k in plan["decode"])
    want_k1 = SM_REQS * per_prefill + fused.steps * per_step
    say(f"[serve-myia] fused engine, same requests: run {t_fused:.3f}s ({fused.tokens_generated} "
        f"tokens); K1 launches per prefill {per_prefill} and per decode step {per_step} by the "
        f"fusion plan (the reference's plan: no cluster forms on either graph), {want_k1} "
        f"expected over {SM_REQS} prefills and {fused.steps} steps, counted "
        f"{fused_counts['fused_map'] + fused_counts['fused_reduce']} ({fused_by_name}); cache "
        f"{fcs}")
    assert all(fres[r]["status"] == "ok" for r in frids), fres
    assert [fres[r]["tokens"] for r in frids] == [report["oracle"][r] for r in rids]
    assert fcs["misses"] == 2 and fcs["compile_retries"] == 0 and fcs["vm_fallbacks"] == 0, fcs
    assert fused_counts["fused_map"] + fused_counts["fused_reduce"] == want_k1, fused_counts
    # every cluster of the plan launched its Triton kernel, and nothing else launched
    assert sum(fused_by_name.values()) == want_k1, fused_by_name
    assert all(fused_by_name.get(k.name, 0) > 0 for ks in plan.values() for k in ks), plan
    assert not any(v for k, v in fused_counts.items() if not k.startswith("fused_"))

    # -- 28. a warm restart in a second process, then the profiler ---------------------
    probe_ns: dict = {}
    exec(SM_K1_PROBE, probe_ns)
    k1_dir = str(work_dir / "k1cache")
    cold_k1 = probe_ns["k1_probe"](k1_dir)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", SM_WARM_SCRIPT, json.dumps(argv), k1_dir],
                         capture_output=True, text=True, env=env, timeout=600)
    t_warm = time.monotonic() - t0
    assert out.returncode == 0, out.stderr[-4000:]
    warm = json.loads(out.stdout.strip().splitlines()[-1])
    ws = warm["stats"]
    hits, misses = sum(s["hits"] for s in ws), sum(s["misses"] for s in ws)
    built = sum(s["programs_built"] for s in ws)
    cold_misses = cold_cs["misses"] + fcs["misses"]
    say(f"[serve-myia-warm] second process on the same cache ({t_warm:.1f}s with its start): "
        f"hits {hits} (cold misses {cold_misses}), misses {misses}, programs built {built}, "
        f"compile_retries {sum(s['compile_retries'] for s in ws)}, vm_fallbacks "
        f"{sum(s['vm_fallbacks'] for s in ws)}; streams identical: unfused "
        f"{warm['unfused'] == {str(r): results[r]['tokens'] for r in rids}}, fused "
        f"{list(warm['fused'].values()) == [fres[r]['tokens'] for r in frids]}; launches "
        f"{warm['launches']}")
    assert misses == 0 and built == 0 and hits == cold_misses, ws
    assert all(s["compile_retries"] == 0 and s["vm_fallbacks"] == 0 for s in ws), ws
    assert warm["unfused"] == {str(r): results[r]["tokens"] for r in rids}
    assert list(warm["fused"].values()) == [fres[r]["tokens"] for r in frids]
    wk1 = warm["k1_probe"]
    say(f"[serve-myia-warm] K1 through the cache (the Myia LM loss and adjoint at V 96 D 16 "
        f"H 40, {cold_k1['kernels']} fused clusters): cold programs built "
        f"{cold_k1['stats']['programs_built']} (1 lowering + the Triton binaries), warm "
        f"{wk1['stats']['programs_built']} with hits {wk1['stats']['hits']}; loss "
        f"{cold_k1['loss']!r} cold, {wk1['loss']!r} warm")
    assert cold_k1["kernels"] == 4 and cold_k1["stats"]["programs_built"] > 1, cold_k1
    assert wk1["stats"]["programs_built"] == 0 and wk1["stats"]["hits"] == 1, wk1
    assert wk1["loss"] == cold_k1["loss"], (wk1, cold_k1)

    prof_fn = api.myia(build_decode_step(dims, SM_SLOTS),
                       options=api.CompileOptions(fuse=True, profile=True))
    b0 = fused._batches[bucket]
    wcol, amask = decode_masks(np.full(SM_SLOTS, SM_PROMPT + 5), bucket, dev)
    args = (*params, torch.from_numpy(b0.tok).to(dev), b0.kcache, b0.vcache, wcol, amask)
    prof_fn(*args)  # disarmed: builds the program
    with obs_profile.profiling(obs_profile.Profiler()):
        prof_fn(*args)  # armed once: builds the instrumented lowering, first launches
    prof = obs_profile.Profiler()
    with obs_profile.profiling(prof):
        prof_fn(*args)
    agg = prof.aggregate()
    say(f"[serve-myia-profile] one fused decode step at bucket {bucket}, {SM_SLOTS} slots, each "
        f"launch timed by CUDA events, against {prof.peak_gbps:.0f} GB/s ({card}):")
    for line in prof.attribution_table(top=12).splitlines():
        say(f"[serve-myia-profile] {line}")
    assert agg["calls"] > 0 and not prof.aggregate("fused")["calls"], agg
    assert agg["roofline_fraction"] is not None and 0 < agg["roofline_fraction"] <= 1, agg
    del report, params, fused, engine, b0, args
    torch.cuda.empty_cache()
    return {"serve_myia": unfused_counts, "serve_myia_fused": fused_counts,
            "fused": fused_by_name}


def oo_tape_phase(torch, dev, card: str) -> None:
    """Phase 29: the OO tape (``repro_torch.core.oo_tape``) on CUDA tensors against the
    port's ST gradient (unfused and fused) and torch.autograd; then the footnote-1
    numbers: time a call of the tape and of the lowered ST program, at a scalar and an
    array workload, and the tape's entries a call."""
    import repro_torch.core.primitives as P
    from repro_torch.core import api
    from repro_torch.core import oo_tape as oo
    from repro_torch.kernels import LAUNCHES

    def st_grad(fn, wrt, fuse):
        return api.value_and_grad(fn, wrt=wrt, options=api.CompileOptions(fuse=fuse))

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()

    # scalars: Python floats (the reference's test) and 0-d CUDA f32 tensors
    worst = 0.0
    for fn, args in ((oo_scalar_chain, (0.3, 0.7)), (oo_scalar_chain, (1.5, -0.2)),
                     (oo_scalar_chain, (-0.9, 0.1)), (oo_poly, (1.3,)), (oo_poly, (-0.4,)),
                     (oo_cube, (2.0,))):
        wrt = tuple(range(len(args)))
        got = oo.oo_grad(fn, wrt=wrt)(*args)
        assert all(isinstance(g, float) for g in got), got
        ins = [torch.tensor(a, dtype=torch.float64, device=dev, requires_grad=True)
               for a in args]
        auto = torch.autograd.grad(fn(*ins), ins)
        cuda_args = tuple(torch.tensor(a, dtype=torch.float32, device=dev) for a in args)
        oo_cuda = oo.oo_grad(fn, wrt=wrt)(*cuda_args)
        for fuse in (False, True):
            st = st_grad(fn, wrt, fuse)(*cuda_args)[1]
            for g, s_, o in zip(got, st, oo_cuda):
                assert o.is_cuda and s_.is_cuda, (o.device, s_.device)
                worst = max(worst, abs(g - float(s_)) / abs(g), abs(float(o) - float(s_)) / abs(g))
        for g, a in zip(got, auto):
            worst = max(worst, abs(g - float(a)) / abs(g))
    say(f"[oo-tape] scalar chain and polynomials: the tape's float64 gradients against the "
        f"port's ST gradient of 0-d CUDA f32 tensors (unfused, fused), the tape on those "
        f"tensors and torch.autograd in float64 on the card: worst relative difference "
        f"{worst:.2e} (bound {OO_REL})")
    assert worst <= OO_REL, worst

    # arrays: the MLP pair at the reference's shapes and a wide one, the relu pair
    gen = torch.Generator(device=dev).manual_seed(0)

    def arrays(shapes):
        out = []
        for i, s in enumerate(shapes):
            t = torch.randn(s, generator=gen, device=dev)
            out.append(t / s[0] ** 0.5 if i < len(shapes) - 1 else t)
        return tuple(out)

    cases = [("mlp", oo_mlp_pair, shp, (0, 1)) for shp in OO_MLP_SHAPES]
    cases.append(("relu", oo_relu_pair, OO_RELU_SHAPES, (0,)))
    for label, pair, shapes, wrt in cases:
        oo_loss, st_loss = pair(oo, P)
        args = arrays(shapes)
        ov, og = oo.oo_value_and_grad(oo_loss, wrt=wrt)(*args)
        for fuse in (False, True):
            vag = st_grad(st_loss, wrt, fuse)
            before = LAUNCHES["fused_map"] + LAUNCHES["fused_reduce"]
            sv, sg = vag(*args)
            torch.cuda.synchronize()
            k1 = LAUNCHES["fused_map"] + LAUNCHES["fused_reduce"] - before
            if fuse:
                errs = [rel(o, s_) for o, s_ in zip(og, sg)]
                assert k1 > 0 and max(errs) <= OO_REL, (label, shapes, k1, errs)
                say(f"[oo-tape] {label} {shapes} f32: tape vs fused ST ({k1} K1 launches): "
                    f"gradients within {max(errs):.2e} of their largest element, loss "
                    f"{rel(ov, sv):.2e} (bound {OO_REL})")
            else:
                assert torch.equal(ov, sv) and all(
                    torch.equal(o, s_) for o, s_ in zip(og, sg)), (label, shapes)
                say(f"[oo-tape] {label} {shapes} f32: tape vs unfused ST: bitwise equal, "
                    f"loss and {len(og)} gradient(s)")
        ins = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
        twin = (torch.sum(torch.tanh(torch.tanh(ins[-1] @ ins[0]) @ ins[1])) if label == "mlp"
                else torch.sum(torch.relu(ins[-1] @ ins[0])))
        auto = torch.autograd.grad(twin, [ins[i] for i in wrt])
        errs = [rel(o, a) for o, a in zip(og, auto)]
        assert max(errs) <= OO_REL, (label, shapes, errs)
        say(f"[oo-tape] {label} {shapes}: tape vs torch.autograd: gradients within "
            f"{max(errs):.2e} of their largest element (bound {OO_REL})")

    # footnote 1: what a call costs, traced anew at every call against ahead of time
    def per_call_us(fn, args, calls):
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    vag_s = oo.oo_value_and_grad(oo_scalar_chain, wrt=(0, 1))
    tape_s = per_call_us(vag_s, (0.3, 0.7), 2000)
    st_s = st_grad(oo_scalar_chain, (0, 1), False)
    st_us = per_call_us(st_s, (0.3, 0.7), 2000)
    say(f"[oo-tape] {card}: scalar chain (Python floats), {vag_s.tape_entries} tape entries a "
        f"call: tape {tape_s:.1f} us a call, lowered ST program {st_us:.1f} us a call "
        f"({tape_s / st_us:.2f}x)")
    oo_loss, st_loss = oo_mlp_pair(oo, P)
    args = arrays(OO_MLP_SHAPES[1])
    vag_a = oo.oo_value_and_grad(oo_loss, wrt=(0, 1))
    tape_a = per_call_us(vag_a, args, 50)
    st_a = {fuse: per_call_us(st_grad(st_loss, (0, 1), fuse), args, 50) for fuse in (False, True)}
    say(f"[oo-tape] {card}: MLP {OO_MLP_SHAPES[1]} f32 on the card, {vag_a.tape_entries} "
        f"tape entries a call: tape {tape_a / 1e3:.4f} ms a call, lowered ST program "
        f"{st_a[False] / 1e3:.4f} ms unfused, {st_a[True] / 1e3:.4f} ms fused")


def cpu_plan(graph, axes, in_specs):
    """The per-shard fusion plan the host computes for the optimized global ``graph``
    on a mesh of ``axes``: (kind, body shape, members, launches a call, bytes) per
    cluster, in plan order (graph logic only: nothing runs on the card)."""
    from repro_torch.core import lower_graph, spmd

    fn = lower_graph(spmd.shard_graph(graph, in_specs, axes).graph, fuse=True)
    return [(k.kind, tuple(k.body_shape), [n.fn.value.name for n in c.order],
             k.launches_per_call, k.bytes_moved)
            for c, k in zip(fn.__fusion_plan__.clusters, fn.__fused_kernels__)]


@contextlib.contextmanager
def capturing_k1(captured: dict):
    """Within it, each generated K1 kernel's first call keeps its inputs in
    ``captured`` (name -> (kernel, args)), for :func:`check_k1`."""
    from repro_torch.kernels import codegen

    call = codegen.FusedKernel.__call__

    def capture(self, *a):
        captured.setdefault(self.name, (self, a))
        return call(self, *a)

    codegen.FusedKernel.__call__ = capture
    try:
        yield captured
    finally:
        codegen.FusedKernel.__call__ = call


def _k1_members(k, a: tuple) -> list[str]:
    """The members of one of the Myia LM step's four clusters, told apart by kind and
    operands: the reduce; the argmax mask (a broadcast row max against the logits);
    tanh's backward (two operands of one shape)."""
    if k.kind != "map":
        return ["sub", "mul", "reduce_sum"]
    return ["mul", "sub", "mul"] if a[0].shape == a[1].shape else ["unreduce", "eq", "cast"]


def check_k1(torch, captured: dict, timed: bool = True) -> dict:
    """Each captured K1 kernel against its oracle on the inputs the path gave it, at
    phase 17's bounds (a map within an ulp, the reduce within REDUCE_TOL), and timed
    there by phase 21's method beside its library call (phase 17's, where one
    exists): name -> [max_abs_err, ulps (None for the reduce), kernel_ms, library_ms
    (None where no PyTorch call computes the cluster)]; untimed, both times are None
    (a rank that shares the card with the timed one)."""
    from repro_torch.kernels import k1_cases

    out = {}
    for name, (k, a) in sorted(captured.items()):
        got, want = k.triton(*a), k.oracle(*a)
        torch.cuda.synchronize()
        if k.kind == "map":
            u = k1_cases.ulps(got, want)
            assert u <= 1, (name, k.body_shape, u)
        else:
            torch.testing.assert_close(got, want, **k1_cases.REDUCE_TOL["float32"])
            u = None
        ms = lib_ms = None
        lib = k1_library_call(torch, _k1_members(k, a), a, want)
        if lib is not None:
            torch.testing.assert_close(lib[0](), want, **k1_cases.REDUCE_TOL["float32"])
            lib_ms = readings(torch, lib[0])["kernel_ms"] if timed else None
        if timed:
            ms = readings(torch, lambda: k.triton(*a))["kernel_ms"]
        out[name] = [(got - want).abs().max().item(), u, ms, lib_ms]
    return out


#: the host ranges of collectives: the port's own, and DTensor's (funcol) calls
_COLLECTIVE_RANGES = ("repro.all_", "c10d_functional::", "_c10d_functional::")


def trace_summary(torch, prof, wall_s: float) -> dict:
    """One step under ``torch.profiler``: its wall time; the host time of its
    collectives (the ``repro.*`` ranges the port's collectives run under, and
    DTensor's functional collectives, ``c10d_functional::*``, each from the call to
    its return); the card's busy time (the union of its kernels'
    and copies' spans), copies and idle share; the heaviest rows on the card and
    on the host (self time).  The card's rows leave out the profiler's mirrors of
    host ranges (``repro.*``, ``gloo:*``), which are no work on the card."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == cpu}
    coll, dev_ms, spans = {}, {}, []
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        if e.device_type == cpu and e.name.startswith(_COLLECTIVE_RANGES):
            n, t = coll.get(e.name, (0, 0.0))
            coll[e.name] = (n + 1, t + ms)
        elif e.device_type == cuda and e.name not in host_names:
            n, t = dev_ms.get(e.name, (0, 0.0))
            dev_ms[e.name] = (n + 1, t + ms)
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    busy /= 1e3
    dev = sorted(((t, n, k) for k, (n, t) in dev_ms.items()), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == cpu and e.self_cpu_time_total > 0), reverse=True)
    wall_ms = wall_s * 1e3
    coll_ms = sum(ms for _n, ms in coll.values())
    return {"wall_ms": wall_ms, "collective_ms": coll_ms, "collective_share": coll_ms / wall_ms,
            "collectives": {k: [n, round(ms, 3)] for k, (n, ms) in sorted(coll.items())},
            "device_busy_ms": busy, "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "memcpy_ms": sum(ms for ms, _n, k in dev if "memcpy" in k.lower()),
            "top_device": [[round(ms, 3), n, k[:70]] for ms, n, k in dev[:6]],
            "top_host": [[round(ms, 3), n, k[:70]] for ms, n, k in host[:6]]}


def spmd_rank(argv_json: str, traced: int) -> int:
    """Phase 31's rank program, started from this script by ``torch.distributed.run``:
    ``repro_torch.launch.train``'s ``main`` with the parent's flags, each K1 kernel's
    first call captured and, after the run, held against its oracle at the per-shard
    shapes; rank 0 runs step ``traced`` under ``torch.profiler``.  Prints one
    ``SPMD_CHECK`` JSON line after the launcher's own."""
    import os

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import line_out

    rank, trace, loop = int(os.environ["RANK"]), {}, train_cli.train_loop

    def traced_loop(cfg, step_fn, *a, **kw):
        calls = [0]

        def step(state, batch):
            calls[0] += 1
            if rank != 0 or calls[0] != traced:
                return step_fn(state, batch)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.monotonic()
                out = step_fn(state, batch)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            trace.update(trace_summary(torch, prof, wall))
            return out

        return loop(cfg, step, *a, **kw)

    captured = {}
    train_cli.train_loop = traced_loop
    try:
        with capturing_k1(captured):
            rc = train_cli.main(json.loads(argv_json))
    finally:
        train_cli.train_loop = loop
    line_out("SPMD_CHECK " + json.dumps({"rank": rank, "k1": check_k1(torch, captured,
                                                                       timed=rank == 0),
                                         "trace": trace}))
    return rc


def spmd_phases(torch, dev, card: str, myia: dict) -> dict:
    """Phases 30-31: the Myia LM step at full width on a mesh, a 1x1 mesh over NCCL in
    this process, then 2x1 and 1x2 meshes of two ranks sharing the card over gloo,
    through ``python -m torch.distributed.run -m repro_torch.launch.train``.  Returns,
    per path, the K1 launches of each cluster by its position in the plan, and the
    per-shard clusters with their byte bounds."""
    import os

    import torch.distributed as dist

    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import FUSED_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.myia_step import MyiaLMDims, lm_in_specs, make_myia_train_step
    from repro_torch.parallel import mesh_context

    cfg = get_config("internlm2-1.8b")
    dims = MyiaLMDims.from_config(cfg)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MYIA_S, global_batch=MYIA_B))
    batches = [to_device(ds.batch(s), dev) for s in range(SPMD_STEPS)]

    def run(fuse, mesh, captured=None):
        step_fn, init_fn = make_myia_train_step(dims, MYIA_B, MYIA_S, MYIA_LR, fuse=fuse,
                                                device=dev)
        state = init_fn()
        losses, times = [], []
        reset_launches()
        with mesh_context(mesh, {}), (contextlib.nullcontext() if captured is None
                                      else capturing_k1(captured)):
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                state, m = step_fn(state, b)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                times.append(time.monotonic() - t0)
            args = (*state["params"], b["tokens"], b["labels"])
            runner = step_fn.vag.specialize(args)
        return {"losses": losses, "params": state["params"], "times": times, "runner": runner,
                "launches": dict(LAUNCHES), "fused": dict(FUSED_LAUNCHES), "vag": step_fn.vag,
                "args": args}

    def within(got_params, want_params):
        """Largest |got - want| over atol + rtol |want|, over every parameter."""
        return max(((g - w).abs() / (SPMD_PARAM_ATOL + SPMD_PARAM_RTOL * w.abs())).max().item()
                   for g, w in zip(got_params, want_params))

    def loss_rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    def check_plan(label, kernels, plan_cpu, fused_counts):
        got = [(k.kind, tuple(k.body_shape), k.launches_per_call) for k in kernels]
        assert got == [(k, b, n) for k, b, _m, n, _by in plan_cpu], (label, got, plan_cpu)
        want = {k.name: SPMD_STEPS * k.launches_per_call for k in kernels}
        assert fused_counts == want, (label, fused_counts, want)
        return [fused_counts[k.name] for k in kernels]

    out = {}
    # -- 30. a 1x1 mesh through NCCL at full width ------------------------------------
    t_phase = time.monotonic()
    mesh = make_local_mesh(1, 1)
    assert dist.get_backend() == "nccl", dist.get_backend()
    try:
        single_u, mesh_u = run(False, None), run(False, mesh)
        assert not getattr(single_u["runner"], "spmd", False) and mesh_u["runner"].spmd
        assert mesh_u["losses"] == single_u["losses"], (mesh_u["losses"], single_u["losses"])
        assert all(torch.equal(a, b) for a, b in zip(mesh_u["params"], single_u["params"]))
        say(f"[spmd-1x1] unfused, {SPMD_STEPS} SGD steps at V {dims.vocab} D {dims.d_model} "
            f"H {dims.d_hidden}, batch {MYIA_B} x {MYIA_S}, f32: on a 1x1 mesh over NCCL "
            f"(runner.spmd {mesh_u['runner'].spmd}, per-shard collectives "
            f"{mesh_u['runner'].sharded.stats}) losses {mesh_u['losses']} and every parameter "
            f"bitwise equal to the single-device tier")
        del single_u, mesh_u
        torch.cuda.empty_cache()
        single_f = run(True, None)
        captured = {}
        mesh_f = run(True, mesh, captured)
    finally:
        dist.destroy_process_group()
    assert mesh_f["runner"].spmd
    # each per-shard kernel against its oracle on the inputs the first step gave it
    checked = check_k1(torch, captured)
    del captured
    lrel, prel = loss_rel(mesh_f["losses"], single_f["losses"]), within(
        mesh_f["params"], single_f["params"])
    assert lrel <= SPMD_LOSS_RTOL and prel <= 1.0, (lrel, prel)
    g_global = mesh_f["vag"].optimized_graph(*mesh_f["args"])
    plan_1x1 = cpu_plan(g_global, {"data": 1, "model": 1}, lm_in_specs())
    names_1x1 = [k.name for k in mesh_f["runner"].fn.__fused_kernels__]
    assert sorted(checked) == sorted(names_1x1), (checked, names_1x1)
    out["train_myia_spmd_1x1"] = {
        "launches": check_plan("1x1", mesh_f["runner"].fn.__fused_kernels__, plan_1x1,
                               mesh_f["fused"]),
        "plan": plan_1x1, "errs": [checked[n] for n in names_1x1]}
    med = statistics.median(mesh_f["times"][1:])
    med_single = statistics.median(single_f["times"][1:])
    say(f"[spmd-1x1] fused: losses within {lrel:.2e} (rtol {SPMD_LOSS_RTOL}), parameters at "
        f"{prel:.3f} of their bound (rtol {SPMD_PARAM_RTOL}, atol {SPMD_PARAM_ATOL}); "
        f"per-shard clusters {[(k, b, m) for k, b, m, _n, _by in plan_1x1]} as the host's "
        f"plan, K1 launches by name {mesh_f['fused']} ({SPMD_STEPS} steps); each per-shard "
        f"kernel against its oracle on the first step's inputs, [max_abs_err, ulps, kernel_ms, "
        f"library_ms] in plan "
        f"order {out['train_myia_spmd_1x1']['errs']}")
    say(f"[spmd-1x1] {card}: step {med:.4f}s on the 1x1 mesh against {med_single:.4f}s on "
        f"the single-device tier in this phase and {myia['step_s']:.4f}s in phase 19 "
        f"(median of the steps after the first); phase {time.monotonic() - t_phase:.1f}s")
    want_losses, want_params = single_f["losses"], single_f["params"]
    del mesh_f, single_f
    torch.cuda.empty_cache()

    # -- 31. two ranks sharing the card, over gloo --------------------------------------
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for data, model in ((2, 1), (1, 2)):
        t_phase = time.monotonic()
        with tempfile.TemporaryDirectory() as ck:
            flags = ["--compiler", "myia", "--data-mesh", str(data), "--model-mesh",
                     str(model), "--steps", str(SPMD_STEPS), "--batch", str(MYIA_B), "--seq",
                     str(MYIA_S), "--lr", str(MYIA_LR), "--ckpt-every", "1000", "--ckpt-dir", ck]
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", "2", str(Path(__file__).resolve()), "--spmd-rank",
                   json.dumps(flags), str(SPMD_STEPS)]
            res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=420)
            for line in res.stdout.splitlines():
                if line.startswith("[myia/spmd"):
                    say(f"[spmd-{data}x{model}] {line}")
            assert res.returncode == 0, res.stderr[-6000:]
            reports = sorted((json.loads(line.split(" ", 1)[1]) for line in
                              res.stdout.splitlines() if line.startswith("SPMD_RANK ")),
                             key=lambda r: r["rank"])
            assert [r["rank"] for r in reports] == [0, 1], res.stdout[-3000:]
            checks = sorted((json.loads(line.split(" ", 1)[1]) for line in
                             res.stdout.splitlines() if line.startswith("SPMD_CHECK ")),
                            key=lambda r: r["rank"])
            assert [c["rank"] for c in checks] == [0, 1], res.stdout[-3000:]
            target = {"params": want_params,
                      "step": torch.zeros((), dtype=torch.int32, device=dev)}
            prels = [within(restore(os.path.join(ck, f"rank{r}"), target=target)[1]["params"],
                            want_params) for r in (0, 1)]
        axes = {"data": data, "model": model}
        # the host's plan: phase 30's optimized global graph, sharded for this mesh
        plan = cpu_plan(g_global, axes, lm_in_specs())
        launches, errs = None, []
        for r, c in zip(reports, checks):
            assert r["backend"] == "gloo" and r["device"].startswith("cuda"), r
            assert r["steps"] == SPMD_STEPS and r["restarts"] == 0, r
            assert len(r["step_s"]) == SPMD_STEPS and all(
                0 < t < 120 for t in r["step_s"]), r["step_s"]
            got = [(k, tuple(b), m) for k, b, m in r["clusters"]]
            assert got == [(k, b, m) for k, b, m, _n, _by in plan], (got, plan)
            per_call = list(r["launches_per_call"].values())
            assert per_call == [n for _k, _b, _m, n, _by in plan], per_call
            counts = [r["fused_launches"][name] for name in r["launches_per_call"]]
            assert counts == [SPMD_STEPS * n for n in per_call], counts
            assert r["launches"]["fused_map"] + r["launches"]["fused_reduce"] == sum(counts)
            launches = counts
            # every per-shard kernel was held against its oracle on this rank's inputs
            assert sorted(c["k1"]) == sorted(r["launches_per_call"]), (c["k1"], r)
            errs.append([c["k1"][name] for name in r["launches_per_call"]])
        lrel = max(loss_rel(r["losses"], want_losses) for r in reports)
        assert lrel <= SPMD_LOSS_RTOL and max(prels) <= 1.0, (lrel, prels)
        # the worse of the two ranks, cluster by cluster, and rank 0's times
        errs = [[max(e[0] for e in per), None if per[0][1] is None else max(e[1] for e in per),
                 per[0][2], per[0][3]] for per in zip(*errs)]
        trace = checks[0]["trace"]
        assert trace["wall_ms"] > 0 and trace["collectives"] and trace["device_busy_ms"] > 0, \
            trace
        out[f"train_myia_spmd_{data}x{model}"] = {"launches": launches, "plan": plan,
                                                  "errs": errs, "trace": trace}
        say(f"[spmd-{data}x{model}] {card}: {SPMD_STEPS} steps on two ranks over gloo: runner.spmd "
            f"on both; per-shard clusters {[(k, b) for k, b, _m, _n, _by in plan]} as the host's "
            f"plan; K1 launches {launches}; losses within {lrel:.2e} of the single-device run "
            f"(rtol {SPMD_LOSS_RTOL}), parameters at {max(prels):.3f} of their bound; step "
            f"{[round(statistics.median(r['step_s'][1:-1]), 4) for r in reports]}s a rank "
            f"(the steps between the first and the profiled last); phase "
            f"{time.monotonic() - t_phase:.1f}s")
        say(f"[spmd-{data}x{model}] each per-shard kernel against its oracle on each rank's "
            f"first-step inputs, [max_abs_err, ulps, rank 0's kernel_ms and library_ms] in "
            f"plan order, the worse rank: {errs}")
        say(f"[spmd-{data}x{model}] {card}: rank 0's step {SPMD_STEPS} under torch.profiler: "
            f"wall {trace['wall_ms']:.1f} ms; collectives {trace['collective_ms']:.1f} ms "
            f"({trace['collective_share']:.1%}) {trace['collectives']} [calls, ms]; card busy "
            f"{trace['device_busy_ms']:.1f} ms (idle {trace['device_idle_share']:.1%}), copies "
            f"{trace['memcpy_ms']:.1f} ms; heaviest on the card [ms, calls, name] "
            f"{trace['top_device']}; on the host (self) {trace['top_host']}")
    return out


def _sh_train_cfg(dtype: str, layers: int | None):
    """internlm2-1.8b at full width in ``dtype``, cut to ``layers`` (None: all 24)."""
    from repro_torch.configs import get_config

    cfg = get_config("internlm2-1.8b")
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, param_dtype=dtype,
                               compute_dtype=dtype)


def _launch_counts() -> dict:
    """Every kernel counter as it stands: K2-K5 and K1's totals by name, and K1's
    generated kernels under ``fused`` (read whole: a kernel absent there did not
    launch)."""
    from repro_torch.kernels import FUSED_LAUNCHES, LAUNCHES

    return {**LAUNCHES, "fused": dict(FUSED_LAUNCHES)}


def _sh_train(torch, cfg, dev, step_fn, init, batches, trace_step=None):
    """Run ``step_fn`` over ``batches`` from ``init()``: losses, the final state, the
    step times and, per step, every kernel counter; with ``trace_step``, that step
    runs under ``torch.profiler`` (its summary in the result)."""
    from repro_torch.kernels import reset_launches

    state, losses, times, per_step, trace = init(), [], [], [], None
    for i, b in enumerate(batches):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if i == trace_step:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                state, m = step_fn(state, b)
                torch.cuda.synchronize()
            trace = trace_summary(torch, prof, time.monotonic() - t0)
        else:
            state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        per_step.append(_launch_counts())
    return {"losses": losses, "state": state, "times": times, "launches": per_step,
            "trace": trace}


def _sh_params_within(got: list, want: list) -> tuple[float, str]:
    """Largest |got - want| / (atol + rtol |want|) over every parameter (``got``:
    (path, tensor) pairs), and the leaf where it is."""
    worst, where = 0.0, ""
    for (path, g), w in zip(got, want, strict=True):
        r = ((g.float() - w.float()).abs() / (SH_PARAM_ATOL + SH_PARAM_RTOL * w.float().abs())
             ).max().item()
        if r > worst:
            worst, where = r, "/".join(str(k) for k in path)
    return worst, where


def sharded_phases(torch, dev, card: str) -> dict:
    """Phases 32-34: the model zoo's placed steps (``repro_torch.distributed.jit_*``) on
    a 1x1 mesh over NCCL against the single-device step; two ranks sharing the card
    over gloo (the launcher itself, and this script's rank program holding each rank
    against the single-device step); the dry run on the production meshes.  Returns the
    kernel launches by path."""
    import os

    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.distributed import (
        jit_decode_step, jit_prefill, jit_train_step, make_rules, make_serve_fns,
        make_train_state_fn, make_train_step)
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_params
    from repro_torch.models.model import abstract_params, stacked_layer_groups
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.parallel import MeshContext

    out: dict = {}
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # -- 34 (started). the dry run on the production meshes: each cell in a process of
    # its own (a fake world cannot share a process with a real one), on the host only,
    # at the lowest priority, while phases 32-33 run ------------------------------------
    t_dry = time.monotonic()
    dry_dir = tempfile.TemporaryDirectory()
    commands = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--cell",
                 cell, "--mesh", which, "--out", dry_dir.name]
                for arch, cell, which in SH_DRYRUN]
    # and phase 32's train step on a fake 1x1 mesh, whose peak the card's is held to
    commands.append([sys.executable, str(Path(__file__).resolve()), "--dryrun-peak"])
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, preexec_fn=lambda: os.nice(19)) for cmd in commands]
    card_mem: dict = {}
    try:
        # -- 32. a 1x1 mesh over NCCL, at full width and depth --------------------------
        t_phase = time.monotonic()
        mesh = make_local_mesh(1, 1)
        assert dist.get_backend() == "nccl", dist.get_backend()
        try:
            cfg = get_config("internlm2-1.8b")
            opt = make_optimizer(OptConfig(lr=3e-4, warmup_steps=1, total_steps=SH_STEPS),
                                 layer_groups=stacked_layer_groups(cfg))
            ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SH_S, global_batch=SH_B))
            batches = [to_device(ds.batch(s), dev) for s in range(SH_STEPS)]
            init = make_train_state_fn(cfg, opt, device=dev)
            # K4's backward adds dQ's f32 partials in an order that changes from run to
            # run unless PyTorch's deterministic algorithms are on (its adds then take
            # turns): two runs of the same step are bitwise equal only then
            with deterministic(torch):
                single = _sh_train(torch, cfg, dev, make_train_step(cfg, opt), init, batches)
            want = [(p, t.clone()) for p, t in T.leaves_with_paths(single.pop("state")["params"])]
            torch.cuda.empty_cache()
            shapes = abstract_params(cfg)
            template = {"params": shapes, "opt": opt.init(shapes),
                        "step": torch.zeros((), dtype=torch.int32, device="meta")}
            fn, _ = jit_train_step(cfg, opt, MeshContext(mesh, make_rules(cfg)), template,
                                   batches[0])
            with deterministic(torch):
                placed = _sh_train(torch, cfg, dev, fn, init, batches)
            got = [(p, t.to_local()) for p, t in T.leaves_with_paths(placed.pop("state")["params"])]
            bitwise = placed["losses"] == single["losses"] and all(
                torch.equal(g, w) for (_p, g), (_q, w) in zip(got, want))
            lrel = max(abs(a - b) / abs(b) for a, b in zip(placed["losses"], single["losses"]))
            prel, where = _sh_params_within(got, [w for _p, w in want])
            del got, want
            torch.cuda.empty_cache()
            assert placed["launches"] == single["launches"], (placed["launches"],
                                                              single["launches"])
            assert placed["launches"][0] == {"rmsnorm_fwd": 97, "rmsnorm_bwd": 49,
                                             "flash_attention_fwd": 48,
                                             "flash_attention_bwd": 24, "ssd_scan_fwd": 0,
                                             "fused_map": 0, "fused_reduce": 0, "fused": {}}, \
                placed["launches"][0]
            if bitwise:
                say(f"[sharded-1x1] internlm2-1.8b, bf16, {SH_STEPS} AdamW steps of {SH_B} "
                    f"x {SH_S} through jit_train_step on a 1x1 mesh over NCCL, both under "
                    f"PyTorch's deterministic algorithms: losses {placed['losses']} and "
                    f"every parameter bitwise equal to make_train_step's")
            else:
                say(f"[sharded-1x1] NOT bitwise: losses {placed['losses']} against "
                    f"{single['losses']} (rel {lrel:.2e}); parameters at {prel:.3f} of the SPMD "
                    f"bound, the worst at {where}; held to the reference's SPMD bounds")
                assert lrel <= SH_LOSS_RTOL and prel <= 1.0, (lrel, prel, where)
            med = statistics.median(placed["times"][1:])
            med0 = statistics.median(single["times"][1:])
            say(f"[sharded-1x1] {card}: step {med:.4f}s placed against {med0:.4f}s single-device "
                f"(median of the steps after the first); K2/K3/K4 launches a step "
                f"{placed['launches'][0]}, as the single-device step's")
            out["train_sharded_1x1"] = placed["launches"][-1]
            del placed, single
            torch.cuda.empty_cache()

            # -- 34 (the card's side). the same step with the plain versions, as the dry
            # run traces it: after one warm step (the placed state, cuBLAS's workspace),
            # the peak from a reset just before the next, the state already resident.
            # The process holds other tensors besides (earlier phases'): the reading
            # less them is the step's peak with its arguments.
            fn_ref, _ = jit_train_step(cfg, opt, MeshContext(mesh, make_rules(cfg)), template,
                                       batches[0], impl="ref")
            st, _m = fn_ref(init(), batches[0])
            del _m
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            args_b = sum(t.to_local().numel() * t.to_local().element_size()
                         if hasattr(t, "to_local") else t.numel() * t.element_size()
                         for t in T.leaves(st) + T.leaves(batches[1]))
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            st, _m = fn_ref(st, batches[1])
            torch.cuda.synchronize()
            raw = torch.cuda.max_memory_allocated()
            card_mem.update(raw=raw, before=before, arguments=args_b,
                            peak=raw - (before - args_b))
            del st, _m, fn_ref
            torch.cuda.empty_cache()

            # serving gemma3-1b through jit_prefill and jit_decode_step
            scfg = get_config("gemma3-1b")
            params = init_params(scfg, seed=0, device=dev)
            prompts = make_prompts(scfg, SH_SERVE_B, SH_S, dev)
            max_len = SH_S + SH_GEN
            pre, dec = make_serve_fns(scfg, max_len)
            ctx = MeshContext(mesh, make_rules(scfg))
            fp, _ = jit_prefill(scfg, ctx, max_len, params, {"tokens": prompts})

            def serve(prefill_fn, decode_fn):
                reset_launches()
                with torch.no_grad():
                    lg, caches = prefill_fn(params, prompts)
                    counts = {"prefill": _launch_counts()}
                    logits = [lg]
                    for i in range(SH_GEN):
                        token = logits[-1].argmax(-1).to(torch.int32)
                        lg, caches = decode_fn(params, caches, token, SH_S + i)
                        logits.append(lg)
                counts["total"] = _launch_counts()
                return logits, caches, counts

            want_lg, caches0, want_counts = serve(pre, dec)
            fd, _, _ = jit_decode_step(scfg, ctx, max_len, params, caches0, SH_SERVE_B)
            del caches0
            got_lg, _c, got_counts = serve(fp, fd)
            del _c
            same = all(torch.equal(a, b) for a, b in zip(got_lg, want_lg))
            err = max((a - b).abs().max().item() for a, b in zip(got_lg, want_lg))
            assert got_counts == want_counts, (got_counts, want_counts)
            assert got_counts["prefill"] == {"rmsnorm_fwd": 53, "rmsnorm_bwd": 0,
                                             "flash_attention_fwd": 26,
                                             "flash_attention_bwd": 0, "ssd_scan_fwd": 0,
                                             "fused_map": 0, "fused_reduce": 0, "fused": {}}, \
                got_counts
            assert same, f"gemma3 logits not bitwise: max |diff| {err:.3e}"
            say(f"[sharded-1x1] gemma3-1b, bf16, prompt {SH_SERVE_B} x {SH_S} and {SH_GEN} greedy "
                f"steps through jit_prefill and jit_decode_step: every logit bitwise equal to the "
                f"single-device path's; launches {got_counts} (K2 53 and K4 26 a prefill); phase "
                f"{time.monotonic() - t_phase:.1f}s")
            out["serve_sharded_1x1"] = got_counts["total"]
            del params, got_lg, want_lg
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        # -- 33. two ranks sharing the card over gloo --------------------------------------
        say(f"[sharded-2rank] the two-rank runs cut internlm2-1.8b's depth to {SH_LAYERS} of its "
            f"24 layers (every width kept) so that both ranks' states fit the card with their "
            f"single-device references")
        run2 = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                "2"]
        for data, model in ((2, 1), (1, 2)):
            t_phase = time.monotonic()
            with tempfile.TemporaryDirectory() as ck:
                cmd = run2 + ["-m", "repro_torch.launch.train", "--compiler", "torch", "--arch",
                              "internlm2-1.8b", "--batch", str(SH_B), "--seq", str(SH_S),
                              "--data-mesh", str(data), "--model-mesh", str(model), "--steps",
                              str(SH_STEPS), "--n-layers", str(SH_LAYERS), "--ckpt-every", "1000",
                              "--ckpt-dir", ck]
                res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=400)
                assert res.returncode == 0, res.stderr[-6000:]
                reports = sorted((json.loads(line.split(" ", 1)[1]) for line in
                                  res.stdout.splitlines() if line.startswith("SHARDED_RANK ")),
                                 key=lambda r: r["rank"])
                assert sorted(os.listdir(ck)) == ["rank0", "rank1"], os.listdir(ck)
            assert [r["rank"] for r in reports] == [0, 1], res.stdout[-3000:]
            for r in reports:
                assert r["backend"] == "gloo" and r["device"].startswith("cuda"), r
                assert r["steps"] == SH_STEPS and all(math.isfinite(x) for x in r["losses"]), r
                # the launcher reads and resets its counters after each step
                assert len(r["launches"]) == SH_STEPS and all(
                    c == r["launches"][-1] for c in r["launches"]), r["launches"]
            assert reports[0]["losses"] == reports[1]["losses"], reports
            say(f"[sharded-launch-{data}x{model}] python -m torch.distributed.run -m "
                f"repro_torch.launch.train --compiler torch --arch internlm2-1.8b --batch {SH_B} "
                f"--seq {SH_S} --data-mesh {data} --model-mesh {model} --steps {SH_STEPS} "
                f"--n-layers {SH_LAYERS}: losses {reports[0]['losses']} on both ranks; steps "
                f"{[[round(t, 3) for t in r['step_s']] for r in reports]}s; launches a step, "
                f"each rank {[r['launches'][-1] for r in reports]}; phase "
                f"{time.monotonic() - t_phase:.1f}s")
            out[f"train_launch_{data}x{model}"] = reports[0]["launches"][-1]

        for data, model in ((2, 1), (1, 2)):
            t_phase = time.monotonic()
            cmd = run2 + [str(Path(__file__).resolve()), "--sharded-rank",
                          json.dumps({"data": data, "model": model})]
            # a crash of a rank prints its Python stacks
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 env=dict(env, PYTHONFAULTHANDLER="1"), timeout=600)
            assert res.returncode == 0, res.stderr[-6000:]
            checks = sorted((json.loads(line.split(" ", 1)[1]) for line in res.stdout.splitlines()
                             if line.startswith("SHARDED_CHECK ")), key=lambda r: r["rank"])
            assert [c["rank"] for c in checks] == [0, 1], res.stdout[-3000:]
            for c in checks:
                say(f"[sharded-{data}x{model}] rank {c['rank']}: internlm2 f32 ({SH_LAYERS} "
                    f"layers) "
                    f"losses within {c['loss_rel']:.2e} of the single-device step (rtol "
                    f"{SH_LOSS_RTOL}), parameters at {c['param_within']:.3f} of their bound (worst "
                    f"{c['param_where']}); step {c['step_s']}s against {c['single_step_s']}s "
                    f"on one "
                    f"rank alone; launches a step {c['launches']}"
                    + (f"; mamba2-370m prefill in f32, K5 on {c['mamba']['local_heads']} local "
                       f"heads: max_abs_err {c['mamba']['err']:.3e} vs the single-device "
                       f"logits, {c['mamba']['rel']:.2e} of the largest (bound "
                       f"{MAMBA_F32_REL_BOUND}; within TOL['float32']: "
                       f"{c['mamba']['within_tol']}); the plain chunked path cut the same "
                       f"way: {c['mamba']['plain_err']:.3e}, {c['mamba']['plain_rel']:.2e}; "
                       f"launches {c['mamba']['launches']}"
                       if c.get("mamba") else "")
                    + (f"; internlm2 f32 ({SH_LAYERS} layers) placed decode, prefill "
                       f"{SH_SERVE_B} x {SH_S} and {SH_GEN} steps fed the single-device greedy "
                       f"tokens: logits within {c['decode']['err']:.3e} ({c['decode']['rel']:.2e} "
                       f"of the largest, bound {SH_DECODE_REL}), greedy picks differ at "
                       f"{c['decode']['flips']} of {c['decode']['picks']}; "
                       f"{c['decode']['step_s']}s a step; launches "
                       f"{c['decode']['launches']}" if c.get("decode") else "")
                    + (f"; gemma3-1b f32 ({SH_GEMMA_LAYERS} layers) placed decode with "
                       f"{SH_LONG_SLOTS} slots ({c['decode_long']['seq_sharded']} caches sharded "
                       f"on their slots), prefill {SH_SERVE_B} x {SH_S} and {SH_GEN} steps: "
                       f"logits within {c['decode_long']['err']:.3e} "
                       f"({c['decode_long']['rel']:.2e} of the largest, bound {SH_DECODE_REL}), "
                       f"greedy picks differ at {c['decode_long']['flips']} of "
                       f"{c['decode_long']['picks']}; {c['decode_long']['step_s']}s a step; "
                       f"launches {c['decode_long']['launches']}; "
                       f"{c['decode_long']['seconds']}s with its single-device reference"
                       if c.get("decode_long") else ""))
            trace = checks[0]["trace"]
            assert trace and trace["wall_ms"] > 0 and trace["device_busy_ms"] > 0, trace
            say(f"[sharded-{data}x{model}] {card}: rank 0's last step under torch.profiler: wall "
                f"{trace['wall_ms']:.1f} ms; collectives {trace['collective_ms']:.1f} ms "
                f"({trace['collective_share']:.1%}) {trace['collectives']} [calls, ms]; card busy "
                f"{trace['device_busy_ms']:.1f} ms (idle {trace['device_idle_share']:.1%}); "
                f"heaviest on the card {trace['top_device']}; on the host {trace['top_host']}; "
                f"phase {time.monotonic() - t_phase:.1f}s")
            out[f"train_sharded_{data}x{model}"] = checks[0]["launches"]
            if checks[0].get("mamba"):
                out[f"serve_mamba2_sharded_{data}x{model}"] = checks[0]["mamba"]["launches"]
            if checks[0].get("decode"):
                for part in ("prefill", "decode"):
                    out[f"{part}_placed_{data}x{model}"] = checks[0]["decode"]["launches"][part]
                    out[f"{part}_placed_long_{data}x{model}"] = \
                        checks[0]["decode_long"]["launches"][part]

    # -- 34 (collected). the dry run's processes, started before phase 32 ----------------
        records = []
        for cmd, p in zip(commands, procs):
            stdout, stderr = p.communicate(timeout=900)
            assert p.returncode == 0, (cmd, stdout[-3000:], stderr[-3000:])
            rec = [json.loads(line.split(" ", 1)[1]) for line in stdout.splitlines()
                   if line.startswith("DRYRUN ")]
            assert len(rec) == 1, stdout[-2000:]
            records.append(rec[0])
            say(f"[dryrun] {json.dumps(rec[0])}")
        for rec in records:
            mem = rec["memory"]
            say(f"[dryrun] {rec['arch']} x {rec['cell']} x {rec['mesh']}: a rank's peak "
                f"{mem['peak_size_bytes'] / 2**30:.3f} GiB (arguments "
                f"{mem['argument_size_bytes'] / 2**30:.3f}, temp {mem['temp_size_bytes'] / 2**30:.3f}"
                f", outputs {mem['output_size_bytes'] / 2**30:.3f}); bytes accessed "
                f"{rec['bytes_accessed_per_rank']:.4g}; collective bytes "
                f"{rec['collective_bytes']}")
        est = records[-1]["memory"]
        gap = abs(card_mem["peak"] - est["peak_size_bytes"]) / card_mem["peak"]
        say(f"[dryrun-vs-card] {card}: internlm2-1.8b's step ({SH_B} x {SH_S}, bf16, AdamW, the "
            f"plain versions) on a 1x1 mesh: the card's max_memory_allocated "
            f"{card_mem['raw']} bytes from a reset with {card_mem['before']} allocated, of which "
            f"{card_mem['arguments']} are the step's arguments: the step's peak "
            f"{card_mem['peak']} bytes ({card_mem['peak'] / 2**30:.3f} GiB); the dry run's "
            f"peak_size_bytes {est['peak_size_bytes']} ({est['peak_size_bytes'] / 2**30:.3f} "
            f"GiB, arguments {est['argument_size_bytes']}); {gap:.2%} apart (bound "
            f"{DRYRUN_PEAK_REL:.0%})")
        assert est["argument_size_bytes"] == card_mem["arguments"], (est, card_mem)
        assert gap <= DRYRUN_PEAK_REL, (card_mem, est)
    finally:  # every process this phase started ends here
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        dry_dir.cleanup()
    say(f"[dryrun] {len(records)} cells built on fake meshes, nothing allocated; "
        f"{time.monotonic() - t_dry:.1f}s from their start, beside phases 32-33")
    return out


def examples_phase(torch, dev, card: str) -> dict:
    """Phase 35: the four examples (``examples/torch_*.py``) as a user runs them, with no
    flags, on the default device (the card), each checked against what it must show.
    Returns the kernel launches of serve_batch's and train_e2e's runs, and the shapes
    they gave each kernel (``<path>_shapes``: signature -> calls)."""
    import os
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core import api as myia_api
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.distributed import make_train_state_fn
    from repro_torch.kernels import ops, reset_launches
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import leaves, map_leaves

    out: dict = {}
    # quickstart: every call has only Python scalars, or tensors made on the default
    # device; the results must lie on the card
    t0 = time.monotonic()
    results: dict = {}
    ns, printed = run_example("quickstart", [], results=results)
    got = printed_values(printed)
    for label, want in QUICKSTART_EXPECTED.items():
        assert float(got[label]) == want, (label, got[label], want)
    on_cpu: dict = {}
    with contextlib.redirect_stdout(None):
        ns["main"](["--device", "cpu"], results=on_cpu)
    hof_gap = max(abs(float(results[k]) - float(on_cpu[k])) for k in ("hof", "dhof"))
    assert hof_gap <= 1e-6, hof_gap
    tensors = {k: v for k, v in results.items() if isinstance(v, torch.Tensor)}
    assert len(tensors) == len(results) - 1 and all(v.device.type == dev.type
                                                    for v in tensors.values()), \
        {k: getattr(v, "device", v) for k, v in results.items()}
    assert got["myia grad == torch.autograd grad"] == "True"
    say(f"[example-quickstart] the expected values {QUICKSTART_EXPECTED}; hof and hof' within "
        f"{hof_gap:.1e} of the CPU run's; all {len(tensors)} results on "
        f"{sorted({str(v.device) for v in tensors.values()})}; {time.monotonic() - t0:.1f}s")

    # train_lm_myia: its own gradient check against torch.autograd on the card and its
    # loss drop; then batch 0's Myia gradients, card against CPU
    t0 = time.monotonic()
    ns, printed = run_example("train_lm_myia", [])
    first, last = (float(x) for x in re.search(r"loss (\S+) → (\S+) \(Myia", printed).groups())
    assert last < 0.8 * first, (first, last)
    vag = myia_api.value_and_grad(ns["lm_loss"], wrt=(0, 1, 2, 3))
    grads = {}
    for where in ("cpu", dev):
        b0 = to_device(ns["dataset"]().batch(0), where)
        grads[str(where)] = vag(*ns["init_params"](where), b0["tokens"], b0["labels"])[1]
    lm_gap = 0.0
    for a, b in zip(grads[str(dev)], grads["cpu"]):
        assert a.device.type == dev.type
        torch.testing.assert_close(a.cpu(), b, **BWD_TOL)
        lm_gap = max(lm_gap, (a.cpu() - b).abs().max().item())
    say(f"[example-train-lm-myia] 200 AdamW steps, loss {first:.4f} -> {last:.4f} (bound "
        f"{0.8 * first:.4f}); batch 0's Myia gradients card against CPU within {lm_gap:.3e} "
        f"(BWD_TOL); {time.monotonic() - t0:.1f}s")

    # serve_batch: the four archs, kernels on the card against the CPU's plain versions
    # from the same weights, then the engine, cold and warm on one program cache
    t0 = time.monotonic()
    cache_dir = tempfile.mkdtemp(prefix="serve_batch_cache_")
    os.environ["MYIA_SERVE_CACHE"] = cache_dir
    try:
        results, shapes = {}, {}
        reset_launches()
        with capturing_kernels(ops, shapes):
            ns, printed = run_example("serve_batch", [], results=results)
        out["example_serve_batch"] = _launch_counts()
        out["example_serve_batch_shapes"] = shapes
        gaps = {}
        with contextlib.redirect_stdout(None):
            for arch in ns["ARCHS"]:
                cfg = get_config(arch, reduced=True)
                params = map_leaves(lambda t: t.cpu(), init_params(cfg, seed=0, device=dev))
                plain = ns["serve"](arch, device="cpu", params=params)
                card_logits = results[arch]["logits"].cpu()
                torch.testing.assert_close(card_logits, plain["logits"], **TOL["float32"])
                assert (results[arch]["tokens"] == plain["tokens"]).all(), arch
                gaps[arch] = (card_logits - plain["logits"]).abs().max().item()
            eng = results["engine"]
            warm = ns["serve_myia_engine"](device=dev)
        rid = eng["submitted"][0][0]
        assert eng["results"][rid]["tokens"] == eng["oracle"]
        cold_c, warm_c = eng["stats"]["program_cache"], warm["stats"]["program_cache"]
        assert warm_c["programs_built"] == 0 and warm_c["misses"] == 0, warm_c
        assert [warm["results"][r]["tokens"] for r, _ in warm["submitted"]] == \
            [eng["results"][r]["tokens"] for r, _ in eng["submitted"]]
    finally:
        del os.environ["MYIA_SERVE_CACHE"]
        shutil.rmtree(cache_dir, ignore_errors=True)
    say(f"[example-serve-batch] {card}: the card's logits (every position generated, kernels) "
        f"against the CPU's plain versions from the same weights, largest gap by arch "
        f"{ {a: float(f'{g:.3e}') for a, g in gaps.items()} } (TOL float32), greedy tokens "
        f"equal; rates {[round(results[a]['rate'], 1) for a in ns['ARCHS']]} tok/s; the "
        f"engine's stream equals oracle_generate; cache cold {cold_c['misses']} misses, "
        f"{cold_c['programs_built']} built, warm {warm_c['hits']} hits, 0 built; launches "
        f"{out['example_serve_batch']}; {len(shapes)} kernel signatures; "
        f"{time.monotonic() - t0:.1f}s")

    # train_e2e: 300 steps from a fresh checkpoint directory, launches pinned a step
    t0 = time.monotonic()
    ckpt = tempfile.mkdtemp(prefix="train_e2e_ckpt_")
    try:
        stamps, shapes = [], {}
        reset_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with capturing_kernels(ops, shapes):
            ns, printed = run_example("train_e2e", ["--ckpt-dir", ckpt],
                                      on_step=lambda step, m: stamps.append(time.monotonic()))
        peak = torch.cuda.max_memory_allocated() - base
        counts = _launch_counts()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want = {k: E2E_STEPS * E2E_LAUNCHES.get(k, 0) for k in counts if k != "fused"}
    assert {k: v for k, v in counts.items() if k != "fused"} == want and not counts["fused"], \
        (counts, want)
    out["example_train_e2e"] = counts
    out["example_train_e2e_shapes"] = shapes
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(steps)
    first, last = (float(x) for x in re.search(r"loss (\S+) → (\S+)", printed).groups())
    n_params = re.search(r"(\S+)M params", printed).group(1)
    say(f"[example-train-e2e] {card}: {E2E_STEPS} steps of config_100m ({n_params}M params, "
        f"f32) at 8 x 256 in {time.monotonic() - t0:.1f}s with 4 checkpoints; loss {first:.3f} "
        f"-> {last:.3f}; median step {step_s:.4f}s (with the first port's SIMT K4 an "
        f"H100 at 700 W took 0.0544-0.0580s) "
        f"({8 * 256 / step_s:.0f} tokens/s; steps "
        f"{min(steps):.4f}-{max(steps):.4f}s), peak memory {peak / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB the process held; launches a step "
        f"{ {k: v // E2E_STEPS for k, v in want.items() if v} } (pinned)")

    # one train_e2e step from one state and batch: the kernels against the plain versions
    cfg = ns["config_100m"]()
    opt = make_optimizer(OptConfig(lr=6e-4, warmup_steps=E2E_STEPS // 10, total_steps=E2E_STEPS))
    state = make_train_state_fn(cfg, opt, device=dev)()
    batch = to_device(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=256,
                                             global_batch=8)).batch(0), dev)
    got = {}
    for impl in (None, "ref"):
        live = map_leaves(lambda t: t.detach().requires_grad_(True), state["params"])
        loss, _ = loss_fn(cfg, live, batch, impl=impl)
        got[impl] = (loss.detach(), torch.autograd.grad(loss, leaves(live)))
    torch.testing.assert_close(got[None][0], got["ref"][0], **BWD_TOL)
    worst, worst_rel = 0.0, 0.0
    for a, b in zip(got[None][1], got["ref"][1]):
        torch.testing.assert_close(a, b, **BWD_TOL)
        worst = max(worst, ((a - b).abs() / (BWD_TOL["atol"] + BWD_TOL["rtol"] * b.abs()))
                    .max().item())
        rel = ((a - b).norm() / b.norm()).item()
        assert rel <= E2E_GRAD_REL, (tuple(a.shape), rel)
        worst_rel = max(worst_rel, rel)
    say(f"[example-train-e2e] one step from the same state and batch, kernels against the "
        f"plain versions: loss {got[None][0].item():.6f} against {got['ref'][0].item():.6f}; "
        f"{len(got[None][1])} gradient leaves within BWD_TOL, the worst element at "
        f"{worst:.3f} of it; the worst leaf's relative norm {worst_rel:.3e} "
        f"(held to {E2E_GRAD_REL:g})")
    del state, got
    torch.cuda.empty_cache()
    return out


def _sh_decode(torch, cfg, mesh, dev, max_len: int = SH_S + SH_GEN) -> dict:
    """Phase 33's placed decode on this rank: ``cfg``'s prefill of SH_SERVE_B x SH_S and
    SH_GEN greedy steps through ``jit_prefill`` / ``jit_decode_step`` (the attention over
    the cache on this rank's heads, ``boundary.decode_attention``), fed the single-device
    greedy tokens, against the single-device prefill and steps on the same card.  A
    ``max_len`` past 8192 shards the global layers' caches on their slots where the kv
    heads leave the model axis free (the result's ``seq_sharded`` counts those caches)."""
    from repro_torch.distributed import jit_decode_step, jit_prefill, make_rules, make_serve_fns
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_params
    from repro_torch.parallel import MeshContext
    from repro_torch.tree import leaves as tree_leaves

    t_start = time.monotonic()
    params = init_params(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, SH_SERVE_B, SH_S, dev)
    pre, dec = make_serve_fns(cfg, max_len)
    with torch.no_grad():
        lg, caches = pre(params, prompts)
        want, toks = [lg], []
        for i in range(SH_GEN):
            toks.append(want[-1].argmax(-1).to(torch.int32))
            lg, caches = dec(params, caches, toks[-1], SH_S + i)
            want.append(lg)
    del caches
    ctx = MeshContext(mesh, make_rules(cfg))
    fp, _ = jit_prefill(cfg, ctx, max_len, params, {"tokens": prompts})
    reset_launches()
    lg, caches = fp(params, prompts)
    torch.cuda.synchronize()
    launches = {"prefill": _launch_counts()}
    fd, _, c_sh = jit_decode_step(cfg, ctx, max_len, params, caches, SH_SERVE_B)
    seq_sharded = sum(getattr(pl, "dim", None) == 2 for c in tree_leaves(
        c_sh, is_leaf=lambda x: isinstance(x, tuple)) for pl in c)
    got = [lg]
    reset_launches()
    t0 = time.perf_counter()
    for i in range(SH_GEN):
        lg, caches = fd(params, caches, toks[i], SH_S + i)
        got.append(lg)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / SH_GEN
    launches["decode"] = _launch_counts()
    scale = max(a.abs().max().item() for a in want)
    err = max((a - b).abs().max().item() for a, b in zip(want, got, strict=True))
    picks = flips = 0
    for a, b in zip(want, got, strict=True):
        top2 = a.topk(2, dim=-1).values
        differ = a.argmax(-1) != b.argmax(-1)
        picks += differ.numel()
        flips += int(differ.sum())
        assert not bool((differ & (top2[:, 0] - top2[:, 1] > 2 * SH_DECODE_REL * scale)).any())
    out = {"err": err, "rel": err / scale, "picks": picks, "flips": flips,
           "step_s": round(step_s, 4), "launches": launches, "max_len": max_len,
           "seq_sharded": seq_sharded, "seconds": round(time.monotonic() - t_start, 1)}
    assert err <= SH_DECODE_REL * scale, out
    if dev.type == "cuda":  # K2 on each rank's rows, K4 on its heads in the prefill only
        L = cfg.n_layers
        assert launches["prefill"]["rmsnorm_fwd"] == 2 * L + 1, launches
        assert launches["prefill"]["flash_attention_fwd"] == L, launches
        assert launches["decode"]["rmsnorm_fwd"] == (2 * L + 1) * SH_GEN, launches
        assert launches["decode"]["flash_attention_fwd"] == 0, launches
    return out


def sharded_rank(argv_json: str) -> int:
    """Phase 33's rank program, started from this script by ``torch.distributed.run``
    on a mesh of two ranks sharing the card over gloo: internlm2-1.8b in f32 at full
    width (depth cut to SH_LAYERS), SH_STEPS AdamW steps through ``jit_train_step``
    against ``make_train_step`` on this rank alone from the same state and batches;
    on a 1x2 mesh also mamba2-370m's prefill in f32 through ``jit_prefill`` against
    the single-device prefill, on the kernels and on the plain chunked path.  Rank 0
    runs its last placed step under ``torch.profiler``.  Prints one ``SHARDED_CHECK``
    JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.distributed import (
        jit_prefill, jit_train_step, make_rules, make_train_state_fn, make_train_step, place)
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.mesh import line_out, make_local_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_params
    from repro_torch.models.model import prefill, stacked_layer_groups
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.parallel import MeshContext

    args = json.loads(argv_json)
    data, model = args["data"], args["model"]
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(data, model)
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    assert dist.get_backend() == "gloo", dist.get_backend()
    cfg = _sh_train_cfg("float32", SH_LAYERS)
    opt = make_optimizer(OptConfig(lr=3e-4, warmup_steps=1, total_steps=SH_STEPS),
                         layer_groups=stacked_layer_groups(cfg))
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SH_S, global_batch=SH_B))
    batches = [to_device(ds.batch(s), dev) for s in range(SH_STEPS)]
    init = make_train_state_fn(cfg, opt, device=dev)
    single = _sh_train(torch, cfg, dev, make_train_step(cfg, opt), init, batches)
    want = [t.clone() for t in T.leaves(single.pop("state")["params"])]
    torch.cuda.empty_cache()
    fn, _ = jit_train_step(cfg, opt, MeshContext(mesh, make_rules(cfg)), init(), batches[0])
    traced = SH_STEPS - 1 if rank == 0 else None
    placed = _sh_train(torch, cfg, dev, fn, init, batches, trace_step=traced)
    # each rank holds its own blocks against the same blocks of the single-device
    # parameters (cut as ``place`` cuts a plain tensor, with no communication); a
    # DTensor's full_tensor() would gather through the functional collective, which
    # crashes over gloo on CUDA tensors (scripts/gloo_cuda_gather.py)
    got, local_want = [], []
    for (p, t), w in zip(T.leaves_with_paths(placed.pop("state")["params"]), want, strict=True):
        got.append((p, t.to_local()))
        local_want.append(place(w, t.placements, mesh).to_local())
    prel, where = _sh_params_within(got, local_want)
    lrel = max(abs(a - b) / abs(b) for a, b in zip(placed["losses"], single["losses"]))
    del got, want, local_want
    torch.cuda.empty_cache()
    report = {"rank": rank, "mesh": [data, model], "loss_rel": lrel, "param_within": prel,
              "param_where": where, "losses": placed["losses"],
              "launches": placed["launches"][-1],
              # the steps after the first, the profiled one left out
              "step_s": round(statistics.median(placed["times"][1:traced]), 4),
              "single_step_s": round(statistics.median(single["times"][1:]), 4),
              "trace": placed["trace"]}
    assert lrel <= SH_LOSS_RTOL and prel <= 1.0, report
    if model == 2:
        mcfg = dataclasses.replace(get_config("mamba2-370m"), param_dtype="float32",
                                   compute_dtype="float32")
        params = init_params(mcfg, seed=0, device=dev)
        prompts = make_prompts(mcfg, SH_SERVE_B, SH_S, dev)
        ctx = MeshContext(mesh, make_rules(mcfg))
        errs = {}
        # the kernel path (K5 on this rank's 16 heads) and, as the witness of where the
        # gap comes from, the plain chunked path, each against its own single-device run
        for impl in ("chunked", None):
            with torch.no_grad():
                want_lg = prefill(mcfg, params, prompts, SH_S, impl=impl)[0]
            fp, _ = jit_prefill(mcfg, ctx, SH_S, params, {"tokens": prompts}, impl=impl)
            reset_launches()
            got_lg = fp(params, prompts)[0]
            torch.cuda.synchronize()
            launches = _launch_counts()
            errs[impl or "kernel"] = (got_lg - want_lg).abs().max().item()
        err, scale = errs["kernel"], want_lg.abs().max().item()
        # 1x2 sums out_proj in two halves over the model axis (and cuBLAS splits in_proj
        # and the vocab product by columns), and mamba2's 48 gated layers amplify such a
        # reordering as they amplify the chunked scan's against the stepwise one (phase
        # 15): so the bound is phase 15's f32 bound, relative to the largest logit.  The
        # plain chunked path, with no kernel, is cut the same way: the kernel path's gap
        # must stay within 4x of the plain path's.  Whether TOL["float32"] (rtol = atol =
        # 2e-5, elementwise) would hold is printed.
        within_tol = bool(torch.allclose(got_lg, want_lg, **TOL["float32"]))
        report["mamba"] = {"err": err, "rel": err / scale, "within_tol": within_tol,
                           "plain_err": errs["chunked"], "plain_rel": errs["chunked"] / scale,
                           "launches": launches, "local_heads": mcfg.n_ssm_heads // model}
        assert err / scale <= MAMBA_F32_REL_BOUND, report["mamba"]
        assert err <= 4 * errs["chunked"], report["mamba"]
        del params
        torch.cuda.empty_cache()
        report["decode"] = _sh_decode(torch, cfg, mesh, dev)
        torch.cuda.empty_cache()
        # gemma3-1b's single kv head under two q-head shards (K and V cut to it, not
        # sharded) and, at SH_LONG_SLOTS, its global layers' caches sharded on their
        # slots: each rank attends over its own block, combined by a max and a sum
        # all-reduce; K4 f32 at head_dim 256 with window 512 in the prefill
        gcfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=SH_GEMMA_LAYERS,
                                   param_dtype="float32", compute_dtype="float32")
        report["decode_long"] = _sh_decode(torch, gcfg, mesh, dev, max_len=SH_LONG_SLOTS)
        assert report["decode_long"]["seq_sharded"] > 0, report["decode_long"]
    line_out("SHARDED_CHECK " + json.dumps(report))
    # the group ends as the launcher's does, and a crash here fails the phase
    dist.barrier()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return 0


def main() -> int:
    t_start = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.distributed import make_train_state_fn, make_train_step
    from repro_torch.kernels import LAUNCHES, build, ops, ref, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd, rmsnorm_fwd_on
    from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL as SSD_LAUNCHES
    from repro_torch.kernels.ssd_scan import plan as ssd_plan
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    from repro_torch.launch.serve import make_prompts, serve_decode, serve_prefill
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.model import _matmul_f32 as matmul_f32
    from repro_torch.models.model import remat_layers, stacked_layer_groups
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.runtime import TrainLoopConfig, train_loop
    from repro_torch.tree import leaves as tree_leaves
    from repro_torch.tree import leaves_with_paths as tree_leaves_with_paths
    from repro_torch.tree import map_leaves

    # -- 1. device -----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[device] {name}; nvidia-smi: {smi}")
    say(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    build.load()
    say(f"[build] kernels ready in {time.monotonic() - t0:.1f}s "
        f"(nvcc: {build.build_seconds if build.build_seconds is not None else 'cached'})")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[build] {line.strip()}")
    watched = {"fa_fwd_tc_kernelILi128E": "K4 tensor-core bf16, head_dim 128",
               "fa_fwd_tc_kernelILi256E": "K4 tensor-core bf16, head_dim 256",
               "fa_bwd_tc_kernelILi64E": "K4 backward bf16, head_dim 64 (atomic / ordered dQ)",
               "fa_bwd_tc_kernelILi128E": "K4 backward bf16, head_dim 128 (atomic / ordered dQ)",
               **FA_SIMT_ENTRIES,
               "rmsnorm_fwd_kernel": "K2 warp-per-row",
               "rmsnorm_fwd_row_kernel": "K2 row-per-block (route 1)",
               "rmsnorm_fwd_stream_kernel": "K2 row-per-block streamed",
               "rmsnorm_bwd_kernel": "K3 main kernel",
               **SSD_ENTRIES}
    seen = set()
    for entry, regs, spill_st, spill_ld in ptxas_entries(build.build_log()):
        for key, label in watched.items():
            if key in entry:
                seen.add(key)
                say(f"[build] {label} ({entry[-60:]}): {regs} registers at entry"
                    f"{' (setmaxnreg: consumers 240, producer 24)' if '_tc_kernel' in key else ''}"
                    f", {spill_st} bytes spill stores, {spill_ld} bytes spill loads")
                assert spill_st == spill_ld == 0, (entry, spill_st, spill_ld)
    assert seen == set(watched), f"the build log names no {set(watched) - seen}"
    hmma = sass_counts(build.library_path(), "HMMA", [k for k in SSD_ENTRIES if "_tc" in k])
    if hmma is None:
        say("[build] cuobjdump not found: K5's and K4 f32's SASS not inspected")
    else:
        say(f"[build] K5 bf16 passes, HMMA instructions in the SASS: {hmma}")
        assert all(n > 0 for n in hmma.values()), hmma
        # K4's f32 kernel computes on the CUDA cores only: FFMA, and no tensor-core
        # instruction (TF32 would be HMMA, wgmma HGMMA)
        mma = sass_counts(build.library_path(), "(?:HMMA|HGMMA)", list(FA_SIMT_ENTRIES))
        ffma = sass_counts(build.library_path(), "FFMA", list(FA_SIMT_ENTRIES))
        say(f"[build] K4 f32 instantiations, FFMA instructions in the SASS: {ffma}; tensor-core "
            f"instructions (HMMA, HGMMA): {mma}")
        assert all(n == 0 for n in mma.values()) and all(n > 0 for n in ffma.values()), (mma, ffma)

    # -- 3. kernels against plain versions ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(got, want, dtype):
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        return err

    def dtype_name(t):
        return str(t.dtype).removeprefix("torch.")

    def bound(nbytes, ops, peak):
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    def rms_case(x, w):
        """K2 against its plain version: error, kernel / plain / F.rms_norm times, bound,
        and the route that the checked launch took (its one count in ``K2_ROUTES``)."""
        before, n0 = dict(build.K2_ROUTES), LAUNCHES["rmsnorm_fwd"]
        got = rmsnorm_fwd(x, w)
        took = {r: n - before.get(r, 0) for r, n in build.K2_ROUTES.items()
                if n != before.get(r, 0)}
        assert LAUNCHES["rmsnorm_fwd"] - n0 == 1 and list(took.values()) == [1], took
        (taken,) = took
        err = check(got, ref.rmsnorm_ref(x, w), dtype_name(x))
        w_lib = w.to(x.dtype)  # F.rms_norm wants the weight in x's dtype
        bound_ms, bound_by = bound(
            2 * x.numel() * x.element_size() + w.numel() * 4, 4 * x.numel(), F32_FLOPS
        )
        kern = readings(torch, lambda: rmsnorm_fwd(x, w))
        lib = readings(torch, lambda: F.rms_norm(x, (x.shape[-1],), w_lib, 1e-6))
        rec = record("rmsnorm_fwd", "cuda", "src/repro_torch/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm.py:41", err, kern,
                     time_ms(torch, lambda: ref.rmsnorm_ref(x, w)), bound_ms, bound_by, lib)
        say(f"[kernels] rmsnorm_fwd {dtype_name(x)} x{tuple(x.shape)} ({taken}): max_abs_err "
            f"{err:.3e} {fmt(kern)} plain_ms {rec['plain_ms']:.4f}; F.rms_norm {fmt(lib)}; "
            f"bound_ms {bound_ms:.6f} ({bound_by}), {bound_ms / kern['kernel_ms']:.1%} of it")
        return {**rec, "k2_route": taken}

    def rms_route_case(x, w, r):
        """K2 forced onto route ``r`` against its plain version, and two calls bitwise
        equal (untimed)."""
        got = rmsnorm_fwd_on(x, w, r)
        err = check(got, ref.rmsnorm_ref(x, w), dtype_name(x))
        assert torch.equal(rmsnorm_fwd_on(x, w, r), got), (r, tuple(x.shape))
        say(f"[kernels] rmsnorm_fwd {dtype_name(x)} x{tuple(x.shape)} on route {r}"
            f"{'' if x.data_ptr() % 16 == 0 else ' (off a 16-byte boundary)'}: max_abs_err "
            f"{err:.3e}, two calls bitwise equal")

    def negative_control(x, w):
        """The timer's negative control: the same K2 call with 0.5 ms of host sleep in
        the Python callable before the launch.  Its kernel_ms must stay within 10% of
        the plain call's while its call_ms rises by about 0.5 ms."""
        def slowed():
            time.sleep(0.0005)
            return rmsnorm_fwd(x, w)
        fast, slow = readings(torch, lambda: rmsnorm_fwd(x, w)), readings(torch, slowed)
        rise = slow["call_ms"] - fast["call_ms"]
        drift = abs(slow["kernel_ms"] - fast["kernel_ms"]) / fast["kernel_ms"]
        say(f"[timer] negative control, K2 x{tuple(x.shape)} with 0.5 ms of host sleep before "
            f"the launch: kernel_ms {fast['kernel_ms']:.4f} -> {slow['kernel_ms']:.4f} "
            f"({drift:.1%}, bound 10%); call_ms {fast['call_ms']:.4f} -> {slow['call_ms']:.4f} "
            f"(+{rise:.4f} ms); host_us {fast['host_us']:.1f} -> {slow['host_us']:.1f}")
        assert drift <= 0.10, ("kernel_ms moved with host time", fast, slow)
        assert rise >= 0.4, ("call_ms did not see the host's 0.5 ms", fast, slow)

    def fa_path(q):
        """The K4 kernel a dtype runs (csrc/flash_attention.cu chooses by dtype)."""
        return "tensor-core bf16" if q.dtype == torch.bfloat16 else "SIMT f32"

    def fa_case(q, k, v, causal, window):
        """K4 against its plain version: error, kernel / plain / SDPA times, bound."""
        B_, H_, Sq, D_ = q.shape
        Skv = k.shape[2]
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = check(flash_attention_fwd(q, k, v, causal=causal, window=window), want,
                    dtype_name(q))
        if causal and window is None and Sq == Skv:
            lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        else:
            mask = None
            if causal or window is not None:
                mask = ref.attention_mask(Sq, Skv, causal=causal, window=window, device=dev)
            lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        lib_err = (lib().float() - want.float()).abs().max().item()
        flops = 4 * B_ * H_ * D_ * visible_pairs(Sq, Skv, causal, window)
        peak = BF16_TENSOR_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
        bound_ms, bound_by = bound(
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(), flops, peak
        )
        kern = readings(torch, lambda: flash_attention_fwd(q, k, v, causal=causal,
                                                           window=window))
        lib_r = readings(torch, lib)
        rec = record("flash_attention_fwd", "cuda", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:111", err, kern,
                     time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                                    window=window)),
                     bound_ms, bound_by, lib_r)
        say(f"[kernels] flash_attention_fwd {dtype_name(q)} ({fa_path(q)}) q{(B_, H_, Sq, D_)} "
            f"kv{(k.shape[1], Skv)} causal={causal} window={window}: max_abs_err {err:.3e} "
            f"{fmt(kern)} plain_ms {rec['plain_ms']:.4f}; SDPA {fmt(lib_r)} (max_abs_err "
            f"{lib_err:.3e}); bound_ms {bound_ms:.6f} ({bound_by}, {flops / 1e9:.3f} GFLOP) "
            f"achieved {flops / rec['ms'] / 1e9:.2f} TFLOP/s, {bound_ms / rec['ms']:.1%} of the "
            f"bound")
        return rec


    def rms_bwd_case(x, w, dy):
        """K3 against its plain version: errors, two calls bitwise equal, kernel / plain /
        F.rms_norm-backward times, bound."""
        dx, dw = rmsnorm_bwd(x, w, dy)
        dx2, dw2 = rmsnorm_bwd(x, w, dy)
        assert torch.equal(dx2, dx) and torch.equal(dw2, dw), "K3 is not deterministic"
        want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy)
        tol = BWD_TOL if x.dtype == torch.float32 else TOL["bfloat16"]
        torch.testing.assert_close(dx.float(), want_dx.float(), **tol)
        err = (dx.float() - want_dx.float()).abs().max().item()
        # dw sums every row in another order: bound 1e-6·Σ|dy·x·r| + 1e-5 (~17 ε)
        mag = ref.rmsnorm_bwd_ref(x.abs(), w, dy.abs())[1]
        dw_err = (dw - want_dw).abs()
        assert bool((dw_err <= 1e-5 + 1e-6 * mag).all()), dw_err.max().item()
        x_lib = x.detach().clone().requires_grad_(True)
        w_lib = w.to(x.dtype).requires_grad_(True)
        y_lib = F.rms_norm(x_lib, (x.shape[-1],), w_lib, 1e-6)
        D_ = x.shape[-1]
        blocks = min(x.numel() // D_, build.load().rmsnorm_bwd_blocks(
            D_, build.DTYPE_CODES[dtype_name(x)]))
        # what the function must move: x and dy read, dx written, w read, dw written
        # (the kernel's per-block dw partials are its own cost, not the function's)
        nbytes = 3 * x.numel() * x.element_size() + 2 * D_ * 4
        bound_ms, bound_by = bound(nbytes, 12 * x.numel(), F32_FLOPS)
        kern = readings(torch, lambda: rmsnorm_bwd(x, w, dy))
        lib = readings(torch, lambda: torch.autograd.grad(y_lib, (x_lib, w_lib), dy,
                                                          retain_graph=True))
        rec = record("rmsnorm_bwd", "cuda", "src/repro_torch/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm.py:72", max(err, dw_err.max().item()), kern,
                     time_ms(torch, lambda: ref.rmsnorm_bwd_ref(x, w, dy)), bound_ms, bound_by,
                     lib)
        say(f"[kernels] rmsnorm_bwd {dtype_name(x)} x{tuple(x.shape)}: max_abs_err dx {err:.3e} "
            f"dw {dw_err.max().item():.3e}, two calls bitwise equal; {fmt(kern)} (2 grid "
            f"launches, the dw pass a programmatic dependent) plain_ms {rec['plain_ms']:.4f}; F.rms_norm backward {fmt(lib)}; "
            f"bound_ms {bound_ms:.6f} ({bound_by}, {nbytes / 1e6:.1f} MB, {blocks} blocks), "
            f"{bound_ms / rec['ms']:.1%} of it")
        return rec

    def fa_lse_case(q, k, v, causal, window, timed=True):
        """K4 with its logsumexp against the chunked twin (and its output against the
        plain version too), two calls bitwise equal; timed, the kernel / twin / SDPA
        times and the bound.  Every row of these cases has a visible column."""
        B_, H_, Sq, D_ = q.shape
        Skv = k.shape[2]
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
        want_o, want_lse = ref.flash_attention_fwd_lse_chunked(q, k, v, causal=causal,
                                                               window=window)
        err = check(o, want_o, dtype_name(q))
        plain_err = check(o, ref.flash_attention_ref(q, k, v, causal=causal, window=window),
                          dtype_name(q))
        torch.testing.assert_close(lse, want_lse, **TOL["float32"])
        lse_err = (lse - want_lse).abs().max().item()
        o2, lse2 = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
        assert torch.equal(o2, o) and torch.equal(lse2, lse), "K4 is not deterministic"
        if not timed:
            say(f"[kernels] flash_attention_fwd+lse {dtype_name(q)} ({fa_path(q)}) "
                f"q{(B_, H_, Sq, D_)} kv{(k.shape[1], Skv)} causal={causal} window={window}: "
                f"max_abs_err o {err:.3e} (plain {plain_err:.3e}) lse {lse_err:.3e}, two calls "
                f"bitwise equal")
            return None
        if causal and window is None and Sq == Skv:
            lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        else:
            mask = None
            if causal or window is not None:
                mask = ref.attention_mask(Sq, Skv, causal=causal, window=window, device=dev)
            lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        flops = 4 * B_ * H_ * D_ * visible_pairs(Sq, Skv, causal, window)
        peak = BF16_TENSOR_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
        bound_ms, bound_by = bound(
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + B_ * H_ * Sq * 4,
            flops, peak,
        )
        kern = readings(torch, lambda: flash_attention_fwd(q, k, v, causal=causal,
                                                           window=window, return_lse=True))
        lib_r = readings(torch, lib)
        rec = record("flash_attention_fwd", "cuda", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:111", max(err, lse_err), kern,
                     time_ms(torch, lambda: ref.flash_attention_fwd_lse_chunked(
                         q, k, v, causal=causal, window=window)), bound_ms, bound_by, lib_r)
        say(f"[kernels] flash_attention_fwd+lse {dtype_name(q)} ({fa_path(q)}) "
            f"q{(B_, H_, Sq, D_)} kv{(k.shape[1], Skv)} causal={causal} window={window}: "
            f"max_abs_err o {err:.3e} lse {lse_err:.3e} {fmt(kern)} plain_ms "
            f"{rec['plain_ms']:.4f} (chunked twin); SDPA {fmt(lib_r)}; bound_ms "
            f"{bound_ms:.6f} ({bound_by}, {flops / 1e9:.3f} GFLOP) achieved "
            f"{flops / rec['ms'] / 1e9:.2f} TFLOP/s, {bound_ms / rec['ms']:.1%} of the bound")
        return rec

    def fa_bwd_case(q, k, v):
        """K4's backward (bf16, causal) against the plain chunked backward on the same
        inputs: every element of dq, dk, dv at the bf16 tolerance and each one's relative
        norm error at most BWD_REL_NORM_BOUND; the kernel / chunked / SDPA flash-backward
        times and the bound: 10·B·H·D FLOPs a visible pair (S and dP recomputed, then dV,
        dK and dQ) at the bf16 tensor-core peak, against q, k, v, o, dO, the gradients,
        lse and delta moved once."""
        B_, H_, Sq, D_ = q.shape
        KVH_, Skv = k.shape[1], k.shape[2]
        o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        do = randn(*q.shape, dtype=q.dtype)
        args = (q, k, v, o, lse, do)
        n0 = LAUNCHES["flash_attention_bwd"]
        got = flash_attention_bwd(*args, causal=True)
        assert LAUNCHES["flash_attention_bwd"] - n0 == 1, LAUNCHES
        want = ref.flash_attention_bwd_chunked(*args, causal=True)
        errs, rels = {}, {}
        for gname, a, b in zip(("dq", "dk", "dv"), got, want):
            errs[gname] = check(a, b, "bfloat16")
            rels[gname] = float(torch.linalg.vector_norm(a.float() - b.float())
                                / torch.linalg.vector_norm(b.float()))
        assert max(rels.values()) <= BWD_REL_NORM_BOUND, rels
        del got, want
        # SDPA's flash backward, K and V widened to the query heads outside the timing
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in
                      (q, k.repeat_interleave(H_ // KVH_, 1), v.repeat_interleave(H_ // KVH_, 1)))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        flops = 10 * B_ * H_ * D_ * visible_pairs(Sq, Skv, True, None)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 2 * B_ * H_ * Sq * 4
        bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        kern = readings(torch, lambda: flash_attention_bwd(*args, causal=True))
        lib_r = readings(torch, lambda: torch.autograd.grad(so, (qs, ks, vs), do,
                                                            retain_graph=True))
        rec = record("flash_attention_bwd", "cuda", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/ops.py:124", max(errs.values()), kern,
                     time_ms(torch, lambda: ref.flash_attention_bwd_chunked(*args, causal=True),
                             reps=10), bound_ms, bound_by, lib_r)
        say(f"[kernels] flash_attention_bwd bfloat16 (tensor-core) q{(B_, H_, Sq, D_)} "
            f"kv{(KVH_, Skv)} causal=True: max_abs_err {errs} relative norm error {rels} "
            f"(bound {BWD_REL_NORM_BOUND}) against the chunked backward; {fmt(kern)} (3 "
            f"launches) plain_ms {rec['plain_ms']:.4f} (chunked backward); SDPA flash "
            f"backward {fmt(lib_r)}; bound_ms {bound_ms:.6f} ({bound_by}, {flops / 1e9:.3f} "
            f"GFLOP) achieved {flops / rec['ms'] / 1e9:.2f} TFLOP/s, "
            f"{bound_ms / rec['ms']:.1%} of the bound")
        del qs, ks, vs, so
        return rec

    def logits_grad_case(x, w):
        """The head's bf16 product with an f32 result and its backward (the model's
        Function, which splits the f32 cotangent into two bf16 parts) against f32
        products of the widened operands, at the training shape; the cotangent is the
        cross-entropy's.  Each gradient element within one bf16 ulp (2^-7 relative)
        plus 1e-5 of the largest entry: rounded once to bf16 (half an ulp) from an f32
        sum in another order.  (Rounding the cotangent to bf16 first is off by ~5e-2
        relative.)  Returns the backward's ms."""
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = matmul_f32(a, b)
        g = torch.softmax(y.detach(), -1)
        labels = torch.randint(0, w.shape[1], (x.shape[0],), generator=gen, device=dev)
        g[torch.arange(x.shape[0], device=dev), labels] -= 1.0
        g /= x.shape[0]
        da, db = torch.autograd.grad(y, (a, b), g, retain_graph=True)
        wf = w.float()
        fracs = []
        for got, want in ((da, g @ wf.T), (db, x.float().T @ g)):
            lim = 2**-7 * want.abs() + 1e-5 * want.abs().max()
            fracs.append(((got.float() - want).abs() / lim).max().item())
            del want, lim
        del wf
        ms = time_ms(torch, lambda: torch.autograd.grad(y, (a, b), g, retain_graph=True),
                     reps=5)
        say(f"[train-kernels] logits product {tuple(x.shape)} @ {tuple(w.shape)} bf16 -> f32: "
            f"backward {ms:.4f} ms; largest error / bound: da {fracs[0]:.3f}, db {fracs[1]:.3f} "
            f"(bound: 2^-7 relative + 1e-5 of the largest entry)")
        assert max(fracs) <= 1.0, fracs
        return ms

    def grad_case_attention(B_, H_, KVH_, Sq, Skv, D_, causal, window):
        """K4 + the chunked backward (the Function) against plain autograd, f32."""
        base = [randn(B_, H_, Sq, D_), randn(B_, KVH_, Skv, D_), randn(B_, KVH_, Skv, D_)]
        g = randn(B_, H_, Sq, D_)
        grads = {}
        for impl in (None, "ref"):
            qkv = [t.clone().requires_grad_(True) for t in base]
            o = ops.flash_attention(*qkv, causal=causal, window=window, impl=impl)
            grads[impl] = torch.autograd.grad(o, qkv, g)
        for a, b in zip(grads[None], grads["ref"]):
            torch.testing.assert_close(a, b, **GRAD_TOL)

    def grad_case_rmsnorm(shape):
        """K2 + K3 (the Function) against plain autograd, f32."""
        x0, w0, g = randn(*shape), 1 + 0.1 * randn(shape[-1]), randn(*shape)
        grads = {}
        for impl in (None, "ref"):
            x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
            grads[impl] = torch.autograd.grad(ops.rmsnorm(x, w, impl=impl), (x, w), g)
        torch.testing.assert_close(grads[None][0], grads["ref"][0], **BWD_TOL)
        mag = ref.rmsnorm_bwd_ref(x0.abs(), w0, g.abs())[1]
        assert bool(((grads[None][1] - grads["ref"][1]).abs() <= 1e-5 + 1e-6 * mag).all())

    def train_small_card_vs_cpu():
        """Two AdamW steps of gemma3-reduced in f32 from one state and batch: the card
        with its kernels against the CPU with the plain versions.  Loss and gnorm at
        2e-4 (f32 sums in another order through 6 layers, forward and backward); the
        gradients at 2e-4 of each leaf's largest entry; parameters after the second
        step within 1e-4 (read: under 1e-5).  AdamW moves an element by about
        lr·sign(m/√v), so an element whose m took the other sign on the other device
        would sit 2·lr = 2e-3 apart: the bound allows no such flip."""
        small = get_config("gemma3-1b", reduced=True)
        sopt = make_optimizer(OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
        st_cpu = make_train_state_fn(small, sopt, device="cpu", seed=1)()
        st_card = map_leaves(lambda t: t.to(dev), st_cpu)
        sds = SyntheticLM(DataConfig(vocab=small.vocab, seq_len=32, global_batch=2))
        grads = {}
        for where, p in (("cpu", st_cpu["params"]), ("card", st_card["params"])):
            b = to_device(sds.batch(0), "cpu" if where == "cpu" else dev)
            live = map_leaves(lambda t: t.detach().requires_grad_(True), p)
            loss, _ = loss_fn(small, live, b)
            grads[where] = [g.cpu() for g in torch.autograd.grad(loss, tree_leaves(live))]
        for a, b in zip(grads["card"], grads["cpu"]):
            torch.testing.assert_close(a, b, rtol=0, atol=2e-4 * float(b.abs().max()) + 1e-8)
        sstep = make_train_step(small, sopt)
        for i in range(2):
            st_cpu, mc = sstep(st_cpu, to_device(sds.batch(i), "cpu"))
            st_card, mg = sstep(st_card, to_device(sds.batch(i), dev))
            for key in ("loss", "gnorm"):
                torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=2e-4, atol=2e-4)
        moved = 0
        for a, b in zip(tree_leaves(st_card["params"]), tree_leaves(st_cpu["params"])):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
            moved += int(((a.cpu() - b).abs() > 1e-5).sum())
        assert int(st_card["step"]) == 2
        say(f"[train-small] gemma3-reduced f32, 2 AdamW steps: card kernels agree with CPU "
            f"plain (grads 2e-4 of scale, loss/gnorm 2e-4, params within 1e-4; "
            f"{moved} parameters differ by more than 1e-5)")

    def train_loop_with_crash(device):
        """train_loop on internlm2-reduced in bf16 with checkpoints every 10 steps and
        a crash injected at step 25: one restart, replay from step 20, and the
        replayed losses against the first pass's.  Then the same run without a crash
        gives the same final parameters."""
        cfg_r = dataclasses.replace(get_config("internlm2-1.8b", reduced=True),
                                    param_dtype="bfloat16", compute_dtype="bfloat16")
        ropt = make_optimizer(OptConfig(lr=3e-3, warmup_steps=5, total_steps=40),
                              layer_groups=stacked_layer_groups(cfg_r))
        rds = SyntheticLM(DataConfig(vocab=cfg_r.vocab, seq_len=32, global_batch=4))
        init_fn = make_train_state_fn(cfg_r, ropt, device=device, seed=0)
        step = make_train_step(cfg_r, ropt)
        armed = {"on": True}

        def injector(s):
            if s == 25 and armed["on"]:
                armed["on"] = False
                raise RuntimeError("simulated preemption")

        with tempfile.TemporaryDirectory() as tmp:
            loop = TrainLoopConfig(total_steps=40, checkpoint_every=10,
                                   checkpoint_dir=str(Path(tmp) / "a"))
            t0 = time.monotonic()
            res = train_loop(loop, step, init_fn, lambda s: to_device(rds.batch(s), device),
                             device=device, fault_injector=injector)
            loop_s = time.monotonic() - t0
            clean = train_loop(dataclasses.replace(loop, checkpoint_dir=str(Path(tmp) / "b")),
                               step, init_fn, lambda s: to_device(rds.batch(s), device),
                               device=device)
        assert res.final_step == 40 and res.restarts == 1 and int(res.state["step"]) == 40
        assert len(res.losses) == 45, len(res.losses)  # steps 0-24, then 20-39 again
        first, again = res.losses[20:25], res.losses[25:30]
        rel = max(abs(a - b) / abs(b) for a, b in zip(again, first))
        same_params = all(torch.equal(a, b) for a, b in zip(tree_leaves(res.state["params"]),
                                                            tree_leaves(clean.state["params"])))
        say(f"[train-loop] internlm2-reduced bf16 on {device}: 40 steps in {loop_s:.2f}s with "
            f"1 crash at step 25 and {res.restarts} restart; replayed losses of steps 20-24 "
            f"vs first pass: max rel diff {rel:.3e} (bitwise equal: {again == first}); final "
            f"parameters equal to an uncrashed run's: {same_params}; loss "
            f"{statistics.mean(res.losses[:5]):.4f} -> {statistics.mean(res.losses[-5:]):.4f}")
        assert rel <= REPLAY_REL_BOUND, (again, first)
        assert statistics.mean(res.losses[-5:]) < statistics.mean(res.losses[:5])
        assert clean.losses[20:25] == first or max(
            abs(a - b) / abs(b) for a, b in zip(clean.losses[20:25], first)) <= REPLAY_REL_BOUND

    # the test shapes, f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KVH, Sq, Skv, D, causal, window in FA_TEST_CASES:
            q, k, v = randn(B, H, Sq, D, dtype=dtype), randn(B, KVH, Skv, D, dtype=dtype), \
                randn(B, KVH, Skv, D, dtype=dtype)
            fa_case(q, k, v, causal, window)
        for shape in ((2, 256, 64), (120, 96), (64, 100)):  # 100: no multiple of a vector
            rms_case(randn(*shape, dtype=dtype), 1 + 0.1 * randn(shape[-1]))
        # every K2 route at a width it takes, a ragged one, and rows off a 16-byte boundary
        for (rows, D_), routes in K2_ROUTE_CASES.items():
            x_, w_ = randn(rows, D_, dtype=dtype), 1 + 0.1 * randn(D_)
            for r in routes:
                rms_route_case(x_, w_, r)
        x_ = randn(16 * 8192 + 1, dtype=dtype)[1:].view(16, 8192)
        for r in ("row-per-block", "row-per-block-streamed"):
            rms_route_case(x_, 1 + 0.1 * randn(8192), r)
    for B, H, KVH, Sq, Skv, D, causal, window in FA_TC_CASES:
        fa_case(randn(B, H, Sq, D, dtype=torch.bfloat16), randn(B, KVH, Skv, D, dtype=torch.bfloat16),
                randn(B, KVH, Skv, D, dtype=torch.bfloat16), causal, window)
    for B, H, KVH, Sq, Skv, D, causal, window in FA_SIMT_CASES:  # its output, lse, repeat
        fa_lse_case(randn(B, H, Sq, D), randn(B, KVH, Skv, D), randn(B, KVH, Skv, D), causal,
                    window, timed=False)

    # the serving path's shapes: K2 on prefill rows and decode rows; K4 on the local
    # layers (window 512, 22 of 26: the kernel's record) and the global ones
    cfg = get_config("gemma3-1b")
    B, S, GEN = 4, 1024, 32
    D, H, KVH, HD = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    w = 1 + 0.1 * randn(D)
    records = {"rmsnorm_fwd": rms_case(randn(B, S, D, dtype=torch.bfloat16), w)}
    negative_control(randn(B, S, D, dtype=torch.bfloat16), w)
    rms_case(randn(B, 1, D, dtype=torch.bfloat16), w)
    q = randn(B, H, S, HD, dtype=torch.bfloat16)
    k, v = randn(B, KVH, S, HD, dtype=torch.bfloat16), randn(B, KVH, S, HD, dtype=torch.bfloat16)
    records["flash_attention_fwd"] = fa_case(q, k, v, True, cfg.local_window)
    fa_case(q, k, v, True, None)
    del q, k, v

    # -- 4. the slice on a small f32 model: card with kernels vs CPU plain ---
    small = get_config("gemma3-1b", reduced=True)
    sp = init_params(small, seed=0, device="cpu")
    sp_cuda = map_leaves(lambda t: t.to(dev), sp)
    prompts_small = make_prompts(small, 2, 12, torch.device("cpu"))
    lc, cc = serve_prefill(small, sp, prompts_small, 16)
    lg, cg = serve_prefill(small, sp_cuda, prompts_small.to(dev), 16)
    torch.testing.assert_close(lg.cpu(), lc, rtol=3e-4, atol=3e-4)
    tc, kc = serve_decode(small, sp, lc, cc, 12, 4, keep_logits=True)
    tg, kg = serve_decode(small, sp_cuda, lg, cg, 12, 4, forced=tc.to(dev), keep_logits=True)
    for a, b in zip(kg, kc):
        torch.testing.assert_close(a.cpu(), b, rtol=5e-4, atol=5e-4)
    say("[slice-small] gemma3-reduced f32 prefill + 4 decode steps: card kernels agree with "
        "CPU plain within 3e-4 / 5e-4")

    # -- 5. serve gemma3-1b at full width ------------------------------------
    params = init_params(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, B, S, dev)
    max_len = S + GEN
    # warm-up at the real shapes (cuBLAS handles, allocator), not counted
    wl, wc = serve_prefill(cfg, params, prompts, max_len)
    serve_decode(cfg, params, wl, wc, S, 2)
    del wl, wc
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.monotonic()
    logits, caches = serve_prefill(cfg, params, prompts, max_len)
    torch.cuda.synchronize()
    t_prefill = time.monotonic() - t0
    prefill_counts = dict(LAUNCHES)
    t1 = time.monotonic()
    tokens, step_logits = serve_decode(cfg, params, logits, caches, S, GEN, keep_logits=True)
    torch.cuda.synchronize()
    t_decode = time.monotonic() - t1
    run_counts = dict(LAUNCHES)
    decode_counts = {n: run_counts[n] - prefill_counts[n] for n in run_counts}
    say(f"[serve] gemma3-1b bf16 B={B} prompt={S}: prefill {t_prefill:.4f}s "
        f"({B * S / t_prefill:.0f} tok/s); decode {GEN} steps in {t_decode:.4f}s "
        f"({B * GEN / t_decode:.1f} tok/s, {t_decode / GEN * 1e3:.2f} ms/step); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"[serve] launches: prefill {prefill_counts}; decode {decode_counts} over {GEN} steps")
    n_layers = cfg.n_layers
    no_k1 = {"fused_map": 0, "fused_reduce": 0, "flash_attention_bwd": 0}
    assert prefill_counts == {"flash_attention_fwd": n_layers, "rmsnorm_fwd": 2 * n_layers + 1,
                              "rmsnorm_bwd": 0, "ssd_scan_fwd": 0, **no_k1}, prefill_counts
    assert decode_counts == {"flash_attention_fwd": 0, "rmsnorm_fwd": (2 * n_layers + 1) * GEN,
                             "rmsnorm_bwd": 0, "ssd_scan_fwd": 0, **no_k1}, decode_counts
    assert logits.shape == (B, cfg.vocab) and tokens.shape == (B, GEN)
    assert tokens.dtype == torch.int32
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    assert all(bool(torch.isfinite(lg_).all()) for lg_ in step_logits), "non-finite decode logits"
    say(f"[serve] first tokens: {tokens[:, :8].tolist()}")
    serve_counts = run_counts

    # -- 6. the same prefill with the plain versions -------------------------
    logits_ref, _ = serve_prefill(cfg, params, prompts, max_len, impl="ref")
    torch.cuda.synchronize()
    diff = (logits - logits_ref).abs().max().item()
    scale = logits_ref.abs().max().item()
    logit_bound = SLICE_REL_BOUND * scale
    tok_k, tok_r = logits.argmax(-1), logits_ref.argmax(-1)
    agree = int((tok_k == tok_r).sum())
    # where the first greedy tokens differ, the kernel's pick must be a near tie
    gap = (logits_ref.max(-1).values - logits_ref.gather(1, tok_k[:, None])[:, 0]).max().item()
    say(f"[slice] kernels vs plain, last-position logits: max_abs_diff {diff:.4e} "
        f"(bound {logit_bound:.4e} = {SLICE_REL_BOUND} x max|logit| {scale:.4e}); first greedy "
        f"tokens agree on {agree}/{B} rows, largest plain-logit gap of the kernel's pick "
        f"{gap:.4e}")
    assert diff <= logit_bound, (diff, logit_bound)
    assert gap <= logit_bound, (gap, logit_bound)

    del params, caches, logits, logits_ref, step_logits
    torch.cuda.empty_cache()

    # -- 7. the training path's kernels against their plain versions ---------
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 256, 64), (120, 96)):
            rms_bwd_case(randn(*shape, dtype=dtype), 1 + 0.1 * randn(shape[-1]),
                         randn(*shape, dtype=dtype))
        for B_, H_, KVH_, Sq, Skv, D_, causal, window in FA_TEST_CASES:
            fa_lse_case(randn(B_, H_, Sq, D_, dtype=dtype), randn(B_, KVH_, Skv, D_, dtype=dtype),
                        randn(B_, KVH_, Skv, D_, dtype=dtype), causal, window)
    for B_, H_, KVH_, Sq, Skv, D_, causal, window in FA_TC_CASES:
        fa_lse_case(randn(B_, H_, Sq, D_, dtype=torch.bfloat16),
                    randn(B_, KVH_, Skv, D_, dtype=torch.bfloat16),
                    randn(B_, KVH_, Skv, D_, dtype=torch.bfloat16), causal, window)
    for B_, H_, KVH_, Sq, Skv, D_, causal, window in FA_TEST_CASES:
        grad_case_attention(B_, H_, KVH_, Sq, Skv, D_, causal, window)
    for shape in ((2, 256, 64), (120, 96), (2, 64, 2048)):
        grad_case_rmsnorm(shape)
    say("[train-kernels] Function gradients (K4 + chunked backward, K2 + K3) agree with "
        f"plain autograd at the test shapes in f32 within {GRAD_TOL} / {BWD_TOL}")

    # the training path's shapes (internlm2-1.8b, batch 8 x 1024, bf16)
    tcfg = get_config("internlm2-1.8b")
    TB, TS = 8, 1024
    xt = randn(TB, TS, tcfg.d_model, dtype=torch.bfloat16)
    wt = 1 + 0.1 * randn(tcfg.d_model)
    records["rmsnorm_fwd"] = rms_case(xt, wt)
    dyt = randn(TB, TS, tcfg.d_model, dtype=torch.bfloat16)
    records["rmsnorm_bwd"] = rms_bwd_case(xt, wt, dyt)
    del xt, dyt
    q = randn(TB, tcfg.n_heads, TS, tcfg.hd, dtype=torch.bfloat16)
    k = randn(TB, tcfg.n_kv_heads, TS, tcfg.hd, dtype=torch.bfloat16)
    v = randn(TB, tcfg.n_kv_heads, TS, tcfg.hd, dtype=torch.bfloat16)
    records["flash_attention_fwd"] = fa_lse_case(q, k, v, True, None)
    records["flash_attention_bwd"] = fa_bwd_case(q, k, v)
    del q, k, v
    # the backward at internlm2-train-2x4096's shape too: 2 x 4096, the same heads
    rec = fa_bwd_case(randn(2, tcfg.n_heads, 4096, tcfg.hd, dtype=torch.bfloat16),
                      randn(2, tcfg.n_kv_heads, 4096, tcfg.hd, dtype=torch.bfloat16),
                      randn(2, tcfg.n_kv_heads, 4096, tcfg.hd, dtype=torch.bfloat16))
    records["flash_attention_bwd"]["at_shapes"] = [
        {"shape": f"q (2,{tcfg.n_heads},4096,{tcfg.hd}) kv (2,{tcfg.n_kv_heads},4096,"
                  f"{tcfg.hd}) bf16 causal", "path": "train 2 x 4096",
         **{key: rec[key] for key in ("max_abs_err", "ms", "call_ms", "host_us", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}}]
    del rec
    head_bwd_ms = logits_grad_case(
        randn(TB * TS, tcfg.d_model, dtype=torch.bfloat16),
        (randn(tcfg.d_model, tcfg.vocab) / math.sqrt(tcfg.d_model)).to(torch.bfloat16))
    torch.cuda.empty_cache()

    # -- 8. one small f32 train step: card with kernels vs CPU plain ---------
    train_small_card_vs_cpu()

    # -- 9. train internlm2-1.8b at full width ------------------------------------
    opt = make_optimizer(OptConfig(lr=3e-4, warmup_steps=2, total_steps=21),
                         layer_groups=stacked_layer_groups(tcfg))
    state = make_train_state_fn(tcfg, opt, device=dev, seed=0)()
    step_fn = make_train_step(tcfg, opt)
    ds = SyntheticLM(DataConfig(vocab=tcfg.vocab, seq_len=TS, global_batch=TB))
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state, m0 = step_fn(state, to_device(ds.batch(0), dev))  # untimed: allocator, cuBLAS
    losses = [float(m0["loss"])]
    torch.cuda.synchronize()
    say(f"[train] internlm2-1.8b bf16 ({n_params / 1e9:.3f} B parameters): first step "
        f"{time.monotonic() - t0:.3f}s, loss {losses[0]:.4f}")
    L, R = tcfg.n_layers, sum(remat_layers(tcfg))
    per_step = {"flash_attention_fwd": L + R, "flash_attention_bwd": L,
                "rmsnorm_fwd": 2 * L + 1 + 2 * R, "rmsnorm_bwd": 2 * L + 1, "ssd_scan_fwd": 0,
                "fused_map": 0, "fused_reduce": 0}
    torch.cuda.reset_peak_memory_stats()
    step_s, gnorms = [], []
    reset_launches()
    for i in range(1, 21):
        batch = to_device(ds.batch(i), dev)
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        gnorms.append(float(m["gnorm"]))
        got = {n: LAUNCHES[n] - before[n] for n in per_step}
        assert got == per_step, (i, got, per_step)
    train_counts = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_s)
    tokens = TB * TS
    pairs = visible_pairs(TS, TS, True, None)
    matmul_params = n_params - tcfg.vocab * tcfg.d_model - (2 * L + 1) * tcfg.d_model
    model_flops = 6 * matmul_params * tokens + 12 * L * TB * tcfg.n_heads * tcfg.hd * pairs
    say(f"[train] {name} ({smi}): 20 AdamW steps, batch {TB} x {TS}: median step "
        f"{med:.4f}s (min {min(step_s):.4f}, max {max(step_s):.4f}), {tokens / med:.0f} "
        f"tokens/s, peak memory {peak_gib:.2f} GiB, model {model_flops / 1e12:.1f} TFLOP per "
        f"step = {model_flops / med / 1e12:.1f} TFLOP/s")
    say(f"[train] step seconds: {[round(t, 4) for t in step_s]}")
    say(f"[train] losses: {[round(x, 4) for x in losses]}")
    say(f"[train] gnorms: {[round(x, 4) for x in gnorms]}")
    say(f"[train] launches over 20 steps: {train_counts}; per step {per_step} "
        f"(L={L}, remat R={R})")
    assert train_counts == {n: 20 * c for n, c in per_step.items()}, train_counts
    assert all(math.isfinite(x) for x in losses), losses
    assert statistics.mean(losses[-5:]) < statistics.mean(losses[:5]), losses
    for rec in records.values():
        rec["launches"] = train_counts[rec["name"]]

    # -- 10. one step's loss and gradients, kernels against plain versions ------
    batch = to_device(ds.batch(21), dev)
    paths = [path for path, _ in tree_leaves_with_paths(state["params"])]

    def loss_and_grads(impl):
        live = map_leaves(lambda t: t.detach().requires_grad_(True), state["params"])
        loss, _ = loss_fn(tcfg, live, batch, impl=impl)
        return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(live))

    def dropped_term_bwd(x, w, dy, *, eps):
        """The rmsnorm backward without dx's x·r³·mean(dy·w·x) term, in plain PyTorch:
        a fault the leaf-by-leaf bound must catch (phase 10's negative control)."""
        xf = x.float()
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        dw = (dy.float() * xf * r).reshape(-1, x.shape[-1]).sum(0)
        return (dy.float() * w.float() * r).to(x.dtype), dw.to(w.dtype)

    def rel_per_leaf(got, want):
        return [float(torch.linalg.vector_norm(a.float() - b.float())
                      / torch.linalg.vector_norm(b.float())) for a, b in zip(got, want)]

    def global_norm(grads):  # the optimizer's clip_by_global_norm, without the clip
        return float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads)))

    loss_k, g_k = loss_and_grads(None)
    loss_r, g_r = loss_and_grads("ref")
    gn_k, gn_r = global_norm(g_k), global_norm(g_r)
    vs_ref = rel_per_leaf(g_k, g_r)
    del g_r
    g_c = loss_and_grads("chunked")[1]
    vs_chunked = rel_per_leaf(g_k, g_c)
    del g_k
    kernel_bwd, ops.rmsnorm_bwd = ops.rmsnorm_bwd, dropped_term_bwd
    try:
        fault = rel_per_leaf(loss_and_grads(None)[1], g_c)
    finally:
        ops.rmsnorm_bwd = kernel_bwd
    del g_c, state
    torch.cuda.empty_cache()
    kinds = ["/".join(str(k) for k in p if not isinstance(k, int)) for p in paths]

    def by_kind(rel):
        out = {}
        for kind, r in zip(kinds, rel):
            out[kind] = max(out.get(kind, 0.0), r)
        return {kind: float(f"{r:.3e}") for kind, r in out.items()}

    dl, dg = abs(loss_k - loss_r) / abs(loss_r), abs(gn_k - gn_r) / abs(gn_r)
    say(f"[train-slice] kernels vs plain, one full-width step from the same state: loss "
        f"{loss_k:.6f} vs {loss_r:.6f} (rel {dl:.3e}, bound {TRAIN_LOSS_REL_BOUND}); gnorm "
        f"{gn_k:.6f} vs {gn_r:.6f} (rel {dg:.3e}, bound {TRAIN_GNORM_REL_BOUND})")
    for label, rel in (("vs ref", vs_ref), ("vs chunked", vs_chunked),
                       ("negative control vs chunked", fault)):
        say(f"[train-slice] gradient leaves {label}, |g - g_plain| / |g_plain|, worst by "
            f"kind: {by_kind(rel)}; median {statistics.median(rel):.3e}")
    qk = {"layers/mixer/wq", "layers/mixer/wk"}
    qk_worst = max(r for kind, r in zip(kinds, vs_chunked) if kind in qk)
    say(f"[train-slice] bounds vs chunked: {TRAIN_GRAD_REL_BOUND} per leaf, "
        f"{TRAIN_QK_GRAD_REL_BOUND} for attention's wq and wk; wq/wk read {qk_worst:.3e} "
        f"(K4's tensor-core backward against the chunked one)")
    assert dl <= TRAIN_LOSS_REL_BOUND and dg <= TRAIN_GNORM_REL_BOUND, (dl, dg)
    for kind, path, r in zip(kinds, paths, vs_chunked):
        assert r <= (TRAIN_QK_GRAD_REL_BOUND if kind in qk else TRAIN_GRAD_REL_BOUND), (path, r)
    assert statistics.median(fault) > TRAIN_GRAD_REL_BOUND, "the leaf bounds miss a K3 fault"
    say(f"[train] K4's attention backward at the training shape: "
        f"{records['flash_attention_bwd']['ms']:.4f} ms per call, {L} calls per step; the "
        f"head's product backward {head_bwd_ms:.4f} ms, once per step")

    # -- 11. the fault-tolerant loop on the card -------------------------------
    train_loop_with_crash(dev)

    # -- 12. K5 against the stepwise recurrence -----------------------------------
    def ssd_inputs(Bt, S, H, P, G, N, dtype):
        """x, B, C in ``dtype``; dt in [0.01, 0.2] and A = -exp(0.5·normal) in f32, as
        tests/kernels/test_ssd_scan.py draws them."""
        return (randn(Bt, S, H, P, dtype=dtype),
                0.01 + 0.19 * torch.rand((Bt, S, H), generator=gen, device=dev),
                -torch.exp(0.5 * randn(H)),
                randn(Bt, S, G, N, dtype=dtype), randn(Bt, S, G, N, dtype=dtype))

    def ssd_flops(Bt, S, H, P, N):
        """The chunked form's operations at the kernel's chunk of 64 rows, counting only
        the causal (j <= i) pairs: C·B and scores·x over the pairs, C·h and the state
        update over every row."""
        ops_ = 0
        for s0 in range(0, S, 64):
            rows = min(64, S - s0)
            pairs = rows * (rows + 1) // 2
            ops_ += 2 * pairs * (N + P) + 4 * rows * N * P
        return Bt * H * ops_

    def ssd_case(x, dt, A, B, C, timed=False):
        """K5 against ssd_scan_ref: y (f32 at 2e-4, bf16 at 2e-2) and the f32 state
        (2e-4); with ``timed``, kernel / stepwise / chunked times and the bound."""
        y, hT = ssd_scan_fwd(x, dt, A, B, C)
        want_y, want_h = ref.ssd_scan_ref(x, dt, A, B, C)
        y_tol = SSD_TOL if x.dtype == torch.float32 else TOL["bfloat16"]
        torch.testing.assert_close(y.float(), want_y.float(), **y_tol)
        torch.testing.assert_close(hT, want_h, **SSD_TOL)
        err = max((y.float() - want_y.float()).abs().max().item(),
                  (hT - want_h).abs().max().item())
        if not timed:
            return err
        nbytes = 2 * x.numel() * x.element_size() + dt.numel() * 4 + A.numel() * 4 + \
            2 * B.numel() * B.element_size() + hT.numel() * 4
        flops = ssd_flops(*x.shape, B.shape[3])
        peak = BF16_TENSOR_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
        bound_ms, bound_by = bound(nbytes, flops, peak)
        kern = readings(torch, lambda: ssd_scan_fwd(x, dt, A, B, C))
        rec = record("ssd_scan_fwd", "cuda", "src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:82", err, kern,
                     time_ms(torch, lambda: ref.ssd_scan_ref(x, dt, A, B, C), reps=5),
                     bound_ms, bound_by, None)
        chunked_ms = time_ms(torch, lambda: ref.ssd_scan_ref_chunked(
            x, dt, A, B, C, chunk=ops.SSD_CHUNK), reps=5)
        plan = ssd_plan(*x.shape[:3], B.shape[2], B.shape[3], x.shape[3], x.dtype)
        scratch = sum(math.prod(shape) * torch.empty((), dtype=dt_).element_size()
                      for shape, dt_ in filter(None, plan.scratch.values()))
        say(f"[ssd] ssd_scan_fwd {dtype_name(x)} x{tuple(x.shape)} B{tuple(B.shape)}: "
            f"max_abs_err {err:.3e} {fmt(kern)} plain_ms {rec['plain_ms']:.4f} (stepwise) "
            f"chunked_ms {chunked_ms:.4f} library_ms null (no single PyTorch call) bound_ms "
            f"{bound_ms:.6f} ({bound_by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{bound_ms / rec['ms']:.1%} of it; achieved {nbytes / rec['ms'] / 1e6:.1f} GB/s, "
            f"{flops / rec['ms'] / 1e9:.2f} TFLOP/s; {len(plan.passes)} passes "
            f"{[(p_.name, p_.grid, p_.smem) for p_ in plan.passes]}, chunk {plan.chunk}, "
            f"{plan.heads_per_block} heads a block, scratch {scratch / 1e6:.1f} MB")
        return rec

    for dtype in (torch.float32, torch.bfloat16):
        for shape in SSD_TEST_CASES:
            ssd_case(*ssd_inputs(*shape, dtype))
    extreme = (torch.ones(1, 16, 2, 4, device=dev), torch.full((1, 16, 2), 3.9, device=dev),
               torch.tensor([-1.0, -16.0], device=dev), torch.ones(1, 16, 1, 4, device=dev),
               torch.ones(1, 16, 1, 4, device=dev))
    ssd_case(*extreme)
    say(f"[ssd] K5 agrees with the stepwise recurrence at {len(SSD_TEST_CASES)} test shapes "
        "in f32 and bf16 (ragged S 200, G 2 and 4) and at dt·A down to -62")
    mcfg = get_config("mamba2-370m")
    MB, MS, MGEN = 4, 1024, 32
    MH, MP, MN = mcfg.n_ssm_heads, mcfg.ssm_head_dim, mcfg.ssm_state
    ssd_case(*ssd_inputs(MB, MS, MH, MP, 1, MN, torch.float32), timed=True)
    records["ssd_scan_fwd"] = ssd_case(*ssd_inputs(MB, MS, MH, MP, 1, MN, torch.bfloat16),
                                       timed=True)
    torch.cuda.empty_cache()

    # -- 13. the Mamba slice on mamba2-reduced f32: card with kernels vs CPU plain ----
    msmall = get_config("mamba2-370m", reduced=True)
    mp = init_params(msmall, seed=0, device="cpu")
    mp_cuda = map_leaves(lambda t: t.to(dev), mp)
    mprompts = make_prompts(msmall, 2, 12, torch.device("cpu"))
    lc, cc = serve_prefill(msmall, mp, mprompts, 16)
    lg, cg = serve_prefill(msmall, mp_cuda, mprompts.to(dev), 16)
    torch.testing.assert_close(lg.cpu(), lc, rtol=3e-4, atol=3e-4)
    for a, b in zip(cg, cc):
        for key in ("conv", "ssm"):
            torch.testing.assert_close(a["self"][key].cpu(), b["self"][key], rtol=3e-4,
                                       atol=3e-4)
    tc_, kc = serve_decode(msmall, mp, lc, cc, 12, 4, keep_logits=True)
    _, kg = serve_decode(msmall, mp_cuda, lg, cg, 12, 4, forced=tc_.to(dev), keep_logits=True)
    for a, b in zip(kg, kc):
        torch.testing.assert_close(a.cpu(), b, rtol=5e-4, atol=5e-4)
    say("[mamba-small] mamba2-reduced f32 prefill (logits, conv and SSM caches) + 4 decode "
        "steps: card kernels agree with CPU plain within 3e-4 / 5e-4")

    # -- 14. serve mamba2-370m at full width -------------------------------------
    mparams = init_params(mcfg, seed=0, device=dev)
    mprompts = make_prompts(mcfg, MB, MS, dev)
    wl, wc = serve_prefill(mcfg, mparams, mprompts, MS + MGEN)  # warm-up, not counted
    serve_decode(mcfg, mparams, wl, wc, MS, 2)
    del wl, wc
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    mlogits, mcaches = serve_prefill(mcfg, mparams, mprompts, MS + MGEN)
    torch.cuda.synchronize()
    t_prefill = time.monotonic() - t0
    mprefill_counts = dict(LAUNCHES)
    reset_launches()
    step_counts, step_logits, fed = [], [], []
    t1 = time.monotonic()
    lg_ = mlogits
    for i in range(MGEN):  # serve_decode one step at a time, to count each step
        before = dict(LAUNCHES)
        tok, kept = serve_decode(mcfg, mparams, lg_, mcaches, MS + i, 1, keep_logits=True)
        lg_ = kept[0]
        fed.append(tok)
        step_logits.append(lg_)
        step_counts.append({n: LAUNCHES[n] - before[n] for n in LAUNCHES})
    torch.cuda.synchronize()
    t_decode = time.monotonic() - t1
    mdecode_counts = dict(LAUNCHES)
    mtokens = torch.cat(fed, dim=1)
    nl = mcfg.n_layers
    say(f"[serve-mamba2] mamba2-370m bf16 B={MB} prompt={MS}: prefill {t_prefill:.4f}s "
        f"({MB * MS / t_prefill:.0f} tok/s); decode {MGEN} steps in {t_decode:.4f}s "
        f"({MB * MGEN / t_decode:.1f} tok/s, {t_decode / MGEN * 1e3:.2f} ms/step); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"[serve-mamba2] launches: prefill {mprefill_counts}; decode {mdecode_counts} over "
        f"{MGEN} steps")
    none = {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "fused_map": 0,
            "fused_reduce": 0}
    # K5's three passes are three grid launches a call
    assert mprefill_counts == {**none, "ssd_scan_fwd": nl * SSD_LAUNCHES,
                               "rmsnorm_fwd": 2 * nl + 1}, mprefill_counts
    assert all(c == {**none, "ssd_scan_fwd": 0, "rmsnorm_fwd": 2 * nl + 1}
               for c in step_counts), step_counts
    assert mlogits.shape == (MB, mcfg.vocab) and mtokens.shape == (MB, MGEN)
    assert mtokens.dtype == torch.int32
    assert bool(torch.isfinite(mlogits).all()), "non-finite prefill logits"
    assert all(bool(torch.isfinite(x).all()) for x in step_logits), "non-finite decode logits"
    say(f"[serve-mamba2] first tokens: {mtokens[:, :8].tolist()}")
    mamba_counts = {n: mprefill_counts[n] + mdecode_counts[n] for n in LAUNCHES}

    # -- 15. the same prefill with the plain versions, in bf16 and in f32 ----------
    def plain_prefill(cfg_, params_, impl):
        t0 = time.monotonic()
        out = serve_prefill(cfg_, params_, mprompts, MS + MGEN, impl=impl)[0]
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    def compare(label, got, want, rel_bound, extra=""):
        diff = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tok = got.argmax(-1)
        agree = int((tok == want.argmax(-1)).sum())
        gap = (want.max(-1).values - want.gather(1, tok[:, None])[:, 0]).max().item()
        say(f"[slice-mamba2] {label} kernels vs plain, last-position logits: max_abs_diff "
            f"{diff:.4e} = {diff / scale:.3e} x max|logit| {scale:.4e} (bound {rel_bound}){extra}; "
            f"first greedy tokens agree on {agree}/{MB} rows, largest plain-logit gap of the "
            f"kernel's pick {gap:.4e}")
        assert diff <= rel_bound * scale, (label, diff, scale)
        assert gap <= rel_bound * scale, (label, gap, scale)

    mlogits_ref, t_plain = plain_prefill(mcfg, mparams, "ref")
    mlogits_chunked, _ = plain_prefill(mcfg, mparams, "chunked")
    noise = (mlogits_chunked - mlogits_ref).abs().max().item() / mlogits_ref.abs().max().item()
    compare("bf16", mlogits, mlogits_ref, MAMBA_BF16_REL_BOUND,
            f"; plain chunked vs plain stepwise, no kernel: {noise:.3e} x max|logit|; plain "
            f"stepwise prefill {t_plain:.3f}s")
    del mcaches, mlogits, mlogits_ref, mlogits_chunked, step_logits
    f32cfg = dataclasses.replace(mcfg, param_dtype="float32", compute_dtype="float32")
    p32 = map_leaves(lambda t: t.float(), mparams)
    del mparams
    compare("f32", plain_prefill(f32cfg, p32, None)[0], plain_prefill(f32cfg, p32, "ref")[0],
            MAMBA_F32_REL_BOUND, " (the same weights widened to f32)")
    del p32
    torch.cuda.empty_cache()

    # -- 16. the SSD Function's gradients against plain autograd, f32 --------------
    for shape in ((1, 32, 2, 8, 1, 16), (2, 200, 4, 16, 2, 32)):
        base = ssd_inputs(*shape, torch.float32)
        g = randn(*base[0].shape)
        grads = {}
        for impl in (None, "ref"):
            ins = [t.clone().requires_grad_(True) for t in base]
            grads[impl] = torch.autograd.grad(ops.ssd_scan(*ins, impl=impl), ins, g)
        for a, b in zip(grads[None], grads["ref"]):
            torch.testing.assert_close(a, b, **SSD_TOL)
    say(f"[ssd] Function gradients (K5 + chunked backward) agree with plain autograd through "
        f"the stepwise recurrence within {SSD_TOL}")

    # -- 17-20. K1 and the Myia-compiled train step -------------------------------
    myia_counts, myia_fused, myia_info = myia_phases(torch, dev, records, f"{name} ({smi})")

    # -- 21. K4, K2 and K5 at this slice's shapes ---------------------------------
    def fa_xattn_case(label, q, k, v, causal):
        """K4 against the plain version and the tensor-core twin (o at the bf16
        tolerance, lse at the f32 one), timed beside SDPA: a row of the record."""
        B_, H_, Sq, D_ = q.shape
        Skv = k.shape[2]
        o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        twin_o, twin_lse = ref.flash_attention_fwd_tc_twin(q, k, v, causal=causal)
        chunked_lse = ref.flash_attention_fwd_lse_chunked(q, k, v, causal=causal)[1]
        err, twin_err = check(o, want, "bfloat16"), check(o, twin_o, "bfloat16")
        for want_lse in (chunked_lse, twin_lse):
            torch.testing.assert_close(lse, want_lse, **TOL["float32"])
        lse_err = max((lse - chunked_lse).abs().max().item(),
                      (lse - twin_lse).abs().max().item())
        # without lse, the same o
        assert torch.equal(flash_attention_fwd(q, k, v, causal=causal), o)
        del twin_o, twin_lse, chunked_lse
        assert not causal or Sq == Skv, "SDPA's is_causal aligns the mask at the top left"
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        lib_err = (lib().float() - want.float()).abs().max().item()
        del want
        flops = 4 * B_ * H_ * D_ * visible_pairs(Sq, Skv, causal, None)
        bound_ms, bound_by = bound((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                                   flops, BF16_TENSOR_FLOPS)
        kern = readings(torch, lambda: flash_attention_fwd(q, k, v, causal=causal))
        lib_r = readings(torch, lib)
        rec = record("flash_attention_fwd", "cuda", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:111", max(err, lse_err), kern,
                     time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=causal),
                             reps=10),
                     bound_ms, bound_by, lib_r)
        say(f"[xattn-kernels] flash_attention_fwd bf16 ({label}) q{(B_, H_, Sq, D_)} "
            f"kv{(k.shape[1], Skv)} causal={causal}: max_abs_err vs plain {err:.3e}, vs "
            f"tensor-core twin {twin_err:.3e}, lse {lse_err:.3e}; {fmt(kern)} plain_ms "
            f"{rec['plain_ms']:.4f}; SDPA {fmt(lib_r)} (max_abs_err {lib_err:.3e}); bound_ms "
            f"{bound_ms:.6f} ({bound_by}, {flops / 1e9:.3f} GFLOP) achieved "
            f"{flops / rec['ms'] / 1e9:.2f} TFLOP/s, {bound_ms / rec['ms']:.1%} of the bound; "
            f"{rec['ms'] / rec['library_ms']:.2f}x SDPA's device time")
        return {"shape": label, **{key: rec[key] for key in (
            "max_abs_err", "ms", "call_ms", "host_us", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_call_ms", "library_host_us")}}

    xattn_rows = []
    for label, (B_, H_, KVH_, Sq, Skv, D_, causal) in XATTN_CASES.items():
        qkv = (randn(B_, H_, Sq, D_, dtype=torch.bfloat16),
               randn(B_, KVH_, Skv, D_, dtype=torch.bfloat16),
               randn(B_, KVH_, Skv, D_, dtype=torch.bfloat16))
        xattn_rows.append(fa_xattn_case(label, *qkv, causal))
        del qkv
    records["flash_attention_fwd"]["at_shapes"] = xattn_rows
    rms_rows = []
    for label, shape in RMS_XA_CASES.items():
        rec = rms_case(randn(*shape, dtype=torch.bfloat16), 1 + 0.1 * randn(shape[-1]))
        rms_rows.append({"shape": f"{label} {shape}", **{key: rec[key] for key in (
            "max_abs_err", "ms", "call_ms", "host_us", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "k2_route")}})
    records["rmsnorm_fwd"]["at_shapes"] = rms_rows
    jrec = ssd_case(*ssd_inputs(*SSD_JAMBA, torch.bfloat16), timed=True)
    records["ssd_scan_fwd"]["at_shapes"] = [{"shape": "Jamba block, 128 SSM heads", **{
        key: jrec[key] for key in ("max_abs_err", "ms", "call_ms", "host_us", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}}]
    torch.cuda.empty_cache()

    # -- 22-25. the MoE, cross-attention and encoder-decoder archs ------------------
    xattn_counts = xattn_moe_phases(torch, dev, f"{name} ({smi})")

    # -- 26-28. the Myia serving runtime ----------------------------------------------
    serve_myia_counts = serve_myia_phases(torch, dev, f"{name} ({smi})")
    serve_myia_fused = serve_myia_counts.pop("fused")

    # -- 29. the OO tape on the card ----------------------------------------------------
    oo_tape_phase(torch, dev, f"{name} ({smi})")

    # -- 30-31. the SPMD tier: the Myia LM step on meshes at full width ------------------
    spmd_paths = spmd_phases(torch, dev, f"{name} ({smi})", myia_info)
    for path, info in spmd_paths.items():
        # a per-shard cluster stands beside the global one at its position in the plan
        got = [(kind, members) for kind, _b, members, _n, _by in info["plan"]]
        assert got == myia_info["clusters"], (path, got, myia_info["clusters"])
        assert len(info["launches"]) == len(info["errs"]) == len(got), (path, info)
        for kname, n, (err, u, ms, lib_ms), (kind, body, members, per_call, nbytes) in zip(
                myia_info["names"], info["launches"], info["errs"], info["plan"]):
            records[kname].setdefault("per_shard", []).append({
                "path": path, "kind": kind, "body_shape": list(body), "members": members,
                "launches": n, "launches_per_call": per_call, "max_abs_err": err, "ulps": u,
                "ms": ms, "library_ms": lib_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"})

    # -- 32-34. the model zoo under a mesh -------------------------------------------
    sharded_counts = sharded_phases(torch, dev, f"{name} ({smi})")
    # the kernels at the local shapes the two-rank runs give them (phase 33), by phase
    # 21's method, each beside its launches a step on each rank of its run
    keys = ("max_abs_err", "ms", "call_ms", "host_us", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    half, width = SH_B // 2, 2048
    rows = f"2x1 rank's rows ({half},{SH_S},{width}) bf16"
    rec = rms_case(randn(half, SH_S, width, dtype=torch.bfloat16), 1 + 0.1 * randn(width))
    records["rmsnorm_fwd"].setdefault("at_shapes", []).append(
        {"shape": rows, "launches_a_step": sharded_counts["train_launch_2x1"]["rmsnorm_fwd"],
         **{k: rec[k] for k in keys}})
    rec = rms_bwd_case(randn(half, SH_S, width, dtype=torch.bfloat16), 1 + 0.1 * randn(width),
                       randn(half, SH_S, width, dtype=torch.bfloat16))
    records["rmsnorm_bwd"].setdefault("at_shapes", []).append(
        {"shape": rows,
         "launches_a_step": sharded_counts["train_launch_2x1"]["rmsnorm_bwd"],
         **{k: rec[k] for k in keys}})
    for label, (B_, H_, KVH_), path in (("2x1 rank's batch", (half, 16, 8), "train_launch_2x1"),
                                       ("1x2 rank's heads", (SH_B, 8, 4), "train_launch_1x2")):
        row = fa_xattn_case(f"{label}, causal", randn(B_, H_, SH_S, 128, dtype=torch.bfloat16),
                            randn(B_, KVH_, SH_S, 128, dtype=torch.bfloat16),
                            randn(B_, KVH_, SH_S, 128, dtype=torch.bfloat16), True)
        records["flash_attention_fwd"].setdefault("at_shapes", []).append(
            {**row, "launches_a_step": sharded_counts[path]["flash_attention_fwd"]})
    # K4's f32 kernel at a 1x2 rank's heads in the f32 placed prefills: internlm2's, and
    # gemma3-1b's local (window 512) and global layers at head_dim 256, each row with the
    # launches of its own shape (one a layer: gemma3's by its layer pattern)
    g_kinds = [sp.attn_kind for sp in dataclasses.replace(
        get_config("gemma3-1b"), n_layers=SH_GEMMA_LAYERS).layer_specs()]
    g_total = sharded_counts["prefill_placed_long_1x2"]["flash_attention_fwd"]
    assert g_total == len(g_kinds), ("one K4 launch a layer", g_total, g_kinds)
    for label, (H_, KVH_, D_), window, launches in (
            ("1x2 rank's heads, internlm2 f32 placed prefill", (8, 4, 128), None,
             sharded_counts["prefill_placed_1x2"]["flash_attention_fwd"]),
            ("1x2 rank's heads, gemma3-1b f32 placed prefill, local layers", (2, 1, 256), 512,
             g_kinds.count("local")),
            ("1x2 rank's heads, gemma3-1b f32 placed prefill, global layer", (2, 1, 256), None,
             g_kinds.count("global"))):
        rec = fa_case(randn(SH_SERVE_B, H_, SH_S, D_), randn(SH_SERVE_B, KVH_, SH_S, D_),
                      randn(SH_SERVE_B, KVH_, SH_S, D_), True, window)
        records["flash_attention_fwd"].setdefault("at_shapes", []).append(
            {"shape": f"{label}: q ({SH_SERVE_B},{H_},{SH_S},{D_}) kv ({SH_SERVE_B},{KVH_},"
                      f"{SH_S},{D_}) f32 causal window={window}",
             "launches_a_prefill": launches, **{k: rec[k] for k in keys}})
    rec = ssd_case(*ssd_inputs(SH_SERVE_B, SH_S, 16, 64, 1, 128, torch.float32), timed=True)
    records["ssd_scan_fwd"].setdefault("at_shapes", []).append(
        {"shape": "1x2 rank's 16 of mamba2's 32 heads, f32", "launches_a_prefill":
         sharded_counts["serve_mamba2_sharded_1x2"]["ssd_scan_fwd"],
         **{k: rec[k] for k in keys}})
    torch.cuda.empty_cache()

    # -- 35. the examples, as a user runs them, on the default device ---------------
    t35 = time.monotonic()
    example_counts = examples_phase(torch, dev, f"{name} ({smi})")
    # each kernel at every shape the examples' paths gave it, by phase 21's method,
    # beside its calls there
    example_rows = 0
    for path in ("example_serve_batch", "example_train_e2e"):
        for (kname, shapes, kw), calls in example_counts.pop(f"{path}_shapes").items():
            kw = dict(kw)
            ins = [randn(*shape, dtype=dtype) for shape, dtype in shapes]
            if kname == "rmsnorm_fwd":
                rec = rms_case(ins[0], 1 + 0.1 * randn(shapes[1][0][0]))
            elif kname == "rmsnorm_bwd":
                rec = rms_bwd_case(ins[0], 1 + 0.1 * randn(shapes[1][0][0]), ins[2])
            elif kname == "flash_attention_fwd":
                D_ = shapes[0][0][3]
                assert math.isclose(kw["sm_scale"], D_ ** -0.5), kw  # the cases' default
                case = fa_lse_case if kw.get("return_lse") else fa_case
                rec = case(*ins, kw["causal"], kw["window"])
            else:
                (Bt, S_, H_, P_), (G_, N_) = shapes[0][0], shapes[3][0][2:]
                rec = ssd_case(*ssd_inputs(Bt, S_, H_, P_, G_, N_, shapes[0][1]), timed=True)
            label = " ".join(f"{tuple(shape)}" for shape, _ in shapes[:3]) + \
                f" {str(shapes[0][1]).removeprefix('torch.')}" + \
                "".join(f" {k}={v}" for k, v in sorted(kw.items()) if k != "sm_scale")
            records[kname].setdefault("at_shapes", []).append(
                {"shape": label, "path": path, "calls_on_path": calls,
                 **{k: rec[k] for k in keys}})
            if kname == "flash_attention_fwd":
                say(f"[examples-kernels] K4 f32 (SIMT) {label} on {path}: kernel_ms "
                    f"{rec['ms']:.4f} against SDPA's {rec['library_ms']:.4f} in f32: "
                    f"{rec['ms'] / rec['library_ms']:.2f}x; {rec['bound_ms'] / rec['ms']:.1%} of "
                    f"its bound ({rec['bound_by']})")
            example_rows += 1
    torch.cuda.empty_cache()
    say(f"[examples] phase 35 in {time.monotonic() - t35:.1f}s, {example_rows} kernel rows at "
        f"the examples' shapes")

    # -- records ---------------------------------------------------------------
    # times at the training shapes (K2, K3, K4) and the mamba2 serving shape (K5);
    # launches over the main path of each kernel's own slice (the 20 timed training
    # steps for K2, K3, K4; the mamba2 serve run for K5), and per path (the gemma3
    # serve run of phase 5, the training run of phase 9, the mamba2 serve run of 14)
    records["ssd_scan_fwd"]["launches"] = mamba_counts["ssd_scan_fwd"]

    def launches_on(counts, fused, rec):
        """A kernel's launches on one path: K2-K5 by their counters, K1's generated
        kernels by name (none of them runs off the Myia path)."""
        return counts[rec["name"]] if rec["name"] in counts else fused.get(rec["name"], 0)
    def spmd_launches(path, rec):
        """K1's launches on a sharded path: the per-shard cluster at this record's
        position in the plan (its generated name differs in each process)."""
        names = myia_info["names"]
        return spmd_paths[path]["launches"][names.index(rec["name"])] if rec["name"] in names \
            else 0
    def sharded_launches(counts, rec):
        """A kernel's launches on a placed path (phases 32-33), from every counter read
        there: K2-K5 by their own, K1's generated kernels from ``fused``."""
        return counts[rec["name"]] if rec["name"] in counts else counts["fused"].get(
            rec["name"], 0)
    kernels_line = [
        {**{key: rec[key] for key in ("name", "route", "source", "replaces", "launches",
                                      "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "call_ms", "host_us", "library_call_ms",
                                      "library_host_us")},
         "launches_by_path": {"serve": launches_on(serve_counts, {}, rec),
                              "train": launches_on(train_counts, {}, rec),
                              "serve_mamba2": launches_on(mamba_counts, {}, rec),
                              "train_myia": launches_on(myia_counts, myia_fused, rec),
                              **{path: launches_on(c, {}, rec)
                                 for path, c in xattn_counts.items()},
                              "serve_myia": launches_on(serve_myia_counts["serve_myia"], {},
                                                        rec),
                              "serve_myia_fused": launches_on(
                                  serve_myia_counts["serve_myia_fused"], serve_myia_fused,
                                  rec),
                              **{path: spmd_launches(path, rec) for path in spmd_paths},
                              **{path: sharded_launches(c, rec)
                                 for path, c in sharded_counts.items()},
                              **{path: launches_on(c, {}, rec)
                                 for path, c in example_counts.items()}},
         **({key: rec[key] for key in ("at_shapes", "per_shard") if key in rec})}
        for rec in records.values()
    ]
    say(f"[done] every phase passed in {time.monotonic() - t_start:.1f}s, the kernels' build "
        "included")
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--spmd-rank"]:
        sys.exit(spmd_rank(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--dryrun-peak"]:
        sys.exit(dryrun_peak())
    sys.exit(sharded_rank(sys.argv[2]) if sys.argv[1:2] == ["--sharded-rank"] else main())
