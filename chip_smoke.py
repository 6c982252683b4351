#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port runs on the GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` only (never ``repro`` or ``jax``), on one CUDA device:

1. the device: its name, and its power limit as nvidia-smi reports it;
2. builds the hand-written kernels from ``src/repro_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the test
   shapes and at the shapes of the gemma3-1b serving path, and times the kernel,
   the plain version and one PyTorch library call that computes the same function
   (a yardstick the port never calls);
4. checks the whole slice on a small f32 model: the card with its kernels against
   the CPU with the plain versions;
5. serves gemma3-1b at full width in bf16 (random weights from a seed): batch 4,
   prompt 1024, 32 greedy tokens, through ``repro_torch.launch.serve``, counting
   the kernel launches of the run;
6. runs the same prefill with the plain versions and compares the logits;
7. holds the training path's kernels against their plain versions: the rmsnorm
   backward (K3), the attention kernel's logsumexp (K4), and the gradients of the
   ops' autograd Functions against plain autograd; and the head's bf16 product with
   an f32 result against f32 products, forward and backward;
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
12. holds the SSD scan kernel (K5) against the stepwise recurrence on the card, y
    and the final state, at the test shapes (a ragged sequence and G > 1 among
    them) and at the mamba2-370m serving shape, and times the kernel and the plain
    stepwise and chunked versions;
13. checks the Mamba slice on mamba2-reduced in f32: prefill and 4 decode steps,
    the card with its kernels against the CPU with the plain versions;
14. serves mamba2-370m at full width in bf16 (random weights from a seed): batch 4,
    prompt 1024, 32 greedy tokens, through ``repro_torch.launch.serve``, counting
    the kernel launches of the prefill and of every decode step;
15. runs the same prefill with the plain versions and compares the logits, in bf16
    and with the same weights widened to f32;
16. holds the gradients of the SSD op's autograd Function (K5 forward, plain
    chunked backward) against plain autograd through the stepwise recurrence;
17. holds K1, the Triton kernels generated per fusion cluster of the Myia
    compiler, against their torch oracles: every elementwise primitive of the
    fusion tier in f32 and bf16 with broadcast operands of rank 3, 1 and 0, and
    every reduction root over leading, trailing, middle, two and all axes; then
    the four clusters of the Myia train step at their full shapes, timed against
    their oracles;
18. checks the Myia LM train step at tiny dims in f32, the card with the K1
    kernels against the CPU with the oracles (loss and gradients);
19. trains ``--compiler myia`` at full width (internlm2-1.8b's V 92544, D 2048,
    H 8192, f32, SGD): batch 8 x 256, 1 untimed and 20 timed steps through
    ``repro_torch.launch.myia_step``, counting the K1 launches of every step: the
    plan's 4 clusters (3 map, 1 reduce) in exactly 5 launches (3 map, and the
    reduce's two passes), then two steps of ``python -m
    repro_torch.launch.train --compiler myia`` with its checkpoint;
20. computes one full-width step's loss and gradients with the K1 kernels and in
    kernel mode ``"ref"`` (the oracles) from the same state, and compares them.

A failed phase raises and the script exits non-zero.  The last lines are the
kernels' record, the card's name and power limit, and the device line.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
# by leaf, |g_kernel - g_plain| / |g_plain| over each leaf, against the plain
# versions with the same attention backward (impl="chunked").  Read on an H100: at
# most 6.2e-3 (the embedding, whose bf16 rows gather many tokens' adds; 2.3e-3 for
# the rest).  The gradients of wq and wk pass through the softmax backward's
# p·(dp - delta), which cancels where attention is still nearly uniform, and delta
# sums do·o over the bf16 output o, which K4 and its plain version round apart:
# read 8.5e-2, held to their own bound.  A negative control, the rmsnorm backward
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


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events, with the L2 cache flushed
    before each call (the serving path finds these operands cold or half-cold)."""
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


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave visible: the work attention must do."""
    n = 0
    for i in range(Sq):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


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


def myia_phases(torch, dev, records, card: str) -> tuple[dict, dict]:
    """Phases 17-20: K1 against its oracles, and the Myia-compiled LM step from
    tiny dims to full width.  Adds one K1 record per cluster of the main path to
    ``records`` and returns the launch counts of the main path's timed steps, by
    counter and by generated kernel."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import (
        FUSED_LAUNCHES, LAUNCHES, codegen, k1_cases, reset_launches, set_kernel_mode,
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
    call = codegen.FusedKernel.__call__

    def capture(self, *a):
        captured[self.name] = (self, a)
        return call(self, *a)

    codegen.FusedKernel.__call__ = capture
    try:
        t0 = time.monotonic()
        state, m = step_fn(state, batch)
        losses = [float(m["loss"])]
        t_first = time.monotonic() - t0
    finally:
        codegen.FusedKernel.__call__ = call
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
        lib_ms, lib_note = None, "no single PyTorch call"
        lib = k1_library_call(torch, members[kname], a, want)
        if lib is not None:
            call_lib, lib_note = lib
            lib_out = call_lib()
            torch.testing.assert_close(lib_out, want, **k1_cases.REDUCE_TOL["float32"])
            lib_ms = time_ms(torch, call_lib)
            lib_note += f", max_abs_err {(lib_out - want).abs().max().item():.3e} vs the oracle"
        rec = dict(
            name=kname, route="triton", source="src/repro_torch/kernels/codegen.py",
            replaces="src/repro/kernels/codegen.py:205", launches=fused_counts[kname],
            max_abs_err=err,
            ms=time_ms(torch, lambda: k.triton(*a)), plain_ms=time_ms(torch, lambda: k.oracle(*a)),
            bound_ms=bound_ms,
            bound_by="bytes" if k.bytes_moved / HBM_BYTES_PER_S >= k.n_nodes * n / F32_FLOPS
            else "operations",
            library_ms=lib_ms,
        )
        records[kname] = rec
        say(f"[k1] {kname} {k.kind} {members[kname]} body {k.body_shape} -> {k.out_shape}, "
            f"{k.launches_per_call} launch(es) a call: max_abs_err {err:.3e}"
            f"{f' ({err_ulps} ulp)' if err_ulps is not None else ''} kernel_ms {rec['ms']:.4f} "
            f"oracle_ms {rec['plain_ms']:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"({lib_note}) bound_ms {bound_ms:.4f} (bytes, "
            f"{k.bytes_moved / 1e6:.1f} MB) = {bound_ms / rec['ms'] * 100:.1f}% of the bound")
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
    return counts, fused_counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.distributed import make_train_state_fn, make_train_step
    from repro_torch.kernels import LAUNCHES, build, ops, ref, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
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
        """K2 against its plain version: error, kernel / plain / F.rms_norm times, bound."""
        err = check(rmsnorm_fwd(x, w), ref.rmsnorm_ref(x, w), dtype_name(x))
        w_lib = w.to(x.dtype)  # F.rms_norm wants the weight in x's dtype
        bound_ms, bound_by = bound(
            2 * x.numel() * x.element_size() + w.numel() * 4, 4 * x.numel(), F32_FLOPS
        )
        rec = dict(
            name="rmsnorm_fwd", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:41", max_abs_err=err,
            ms=time_ms(torch, lambda: rmsnorm_fwd(x, w)),
            plain_ms=time_ms(torch, lambda: ref.rmsnorm_ref(x, w)),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(torch, lambda: F.rms_norm(x, (x.shape[-1],), w_lib, 1e-6)),
        )
        say(f"[kernels] rmsnorm_fwd {dtype_name(x)} x{tuple(x.shape)}: max_abs_err {err:.3e} "
            f"kernel_ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} library_ms "
            f"{rec['library_ms']:.4f} (F.rms_norm) bound_ms {bound_ms:.6f} ({bound_by})")
        return rec

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
        rec = dict(
            name="flash_attention_fwd", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:111", max_abs_err=err,
            ms=time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=causal, window=window)),
            plain_ms=time_ms(
                torch, lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            ),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(torch, lib),
        )
        say(f"[kernels] flash_attention_fwd {dtype_name(q)} q{(B_, H_, Sq, D_)} "
            f"kv{(k.shape[1], Skv)} causal={causal} window={window}: max_abs_err {err:.3e} "
            f"kernel_ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} library_ms "
            f"{rec['library_ms']:.4f} (SDPA, max_abs_err {lib_err:.3e}) bound_ms "
            f"{bound_ms:.6f} ({bound_by}, {flops / 1e9:.3f} GFLOP) achieved "
            f"{flops / rec['ms'] / 1e9:.2f} TFLOP/s")
        return rec


    def rms_bwd_case(x, w, dy):
        """K3 against its plain version: errors, kernel / plain / F.rms_norm-backward
        times, bound."""
        dx, dw = rmsnorm_bwd(x, w, dy)
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
        blocks = build.load().rmsnorm_bwd_blocks(x.numel() // D_, D_,
                                                 build.DTYPE_CODES[dtype_name(x)])
        # what the function must move: x and dy read, dx written, w read, dw written
        # (the kernel's per-block dw partials are its own cost, not the function's)
        nbytes = 3 * x.numel() * x.element_size() + 2 * D_ * 4
        bound_ms, bound_by = bound(nbytes, 12 * x.numel(), F32_FLOPS)
        rec = dict(
            name="rmsnorm_bwd", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:72", max_abs_err=max(err, dw_err.max().item()),
            ms=time_ms(torch, lambda: rmsnorm_bwd(x, w, dy)),
            plain_ms=time_ms(torch, lambda: ref.rmsnorm_bwd_ref(x, w, dy)),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(torch, lambda: torch.autograd.grad(
                y_lib, (x_lib, w_lib), dy, retain_graph=True)),
        )
        say(f"[kernels] rmsnorm_bwd {dtype_name(x)} x{tuple(x.shape)}: max_abs_err dx {err:.3e} "
            f"dw {dw_err.max().item():.3e} kernel_ms {rec['ms']:.4f} plain_ms "
            f"{rec['plain_ms']:.4f} library_ms {rec['library_ms']:.4f} (F.rms_norm backward) "
            f"bound_ms {bound_ms:.6f} ({bound_by}, {nbytes / 1e6:.1f} MB, {blocks} blocks)")
        return rec

    def fa_lse_case(q, k, v, causal, window):
        """K4 with its logsumexp against the chunked twin: errors, kernel / twin / SDPA
        times, bound.  Every row of these cases has a visible column."""
        B_, H_, Sq, D_ = q.shape
        Skv = k.shape[2]
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
        want_o, want_lse = ref.flash_attention_fwd_lse_chunked(q, k, v, causal=causal,
                                                               window=window)
        err = check(o, want_o, dtype_name(q))
        torch.testing.assert_close(lse, want_lse, **TOL["float32"])
        lse_err = (lse - want_lse).abs().max().item()
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
        rec = dict(
            name="flash_attention_fwd", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:111",
            max_abs_err=max(err, lse_err),
            ms=time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=causal, window=window,
                                                          return_lse=True)),
            plain_ms=time_ms(torch, lambda: ref.flash_attention_fwd_lse_chunked(
                q, k, v, causal=causal, window=window)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(torch, lib),
        )
        say(f"[kernels] flash_attention_fwd+lse {dtype_name(q)} q{(B_, H_, Sq, D_)} "
            f"kv{(k.shape[1], Skv)} causal={causal} window={window}: max_abs_err o {err:.3e} "
            f"lse {lse_err:.3e} kernel_ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
            f"(chunked twin) library_ms {rec['library_ms']:.4f} (SDPA) bound_ms "
            f"{bound_ms:.6f} ({bound_by}, {flops / 1e9:.3f} GFLOP) achieved "
            f"{flops / rec['ms'] / 1e9:.2f} TFLOP/s")
        return rec

    def flash_bwd_case(q, k, v):
        """The plain chunked flash backward at the training shape: its time per call."""
        o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        do = randn(*q.shape, dtype=q.dtype)
        return time_ms(torch, lambda: ref.flash_attention_bwd_chunked(q, k, v, o, lse, do,
                                                                      causal=True), reps=10)

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
        for shape in ((2, 256, 64), (120, 96)):
            rms_case(randn(*shape, dtype=dtype), 1 + 0.1 * randn(shape[-1]))

    # the serving path's shapes: K2 on prefill rows and decode rows; K4 on the local
    # layers (window 512, 22 of 26: the kernel's record) and the global ones
    cfg = get_config("gemma3-1b")
    B, S, GEN = 4, 1024, 32
    D, H, KVH, HD = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    w = 1 + 0.1 * randn(D)
    records = {"rmsnorm_fwd": rms_case(randn(B, S, D, dtype=torch.bfloat16), w)}
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
    no_k1 = {"fused_map": 0, "fused_reduce": 0}
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
    flash_bwd_ms = flash_bwd_case(q, k, v)
    del q, k, v
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
    per_step = {"flash_attention_fwd": L + R, "rmsnorm_fwd": 2 * L + 1 + 2 * R,
                "rmsnorm_bwd": 2 * L + 1, "ssd_scan_fwd": 0, "fused_map": 0, "fused_reduce": 0}
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
    say(f"[train-slice] bounds vs chunked: {TRAIN_GRAD_REL_BOUND} per leaf, "
        f"{TRAIN_QK_GRAD_REL_BOUND} for attention's wq and wk")
    assert dl <= TRAIN_LOSS_REL_BOUND and dg <= TRAIN_GNORM_REL_BOUND, (dl, dg)
    qk = {"layers/mixer/wq", "layers/mixer/wk"}
    for kind, path, r in zip(kinds, paths, vs_chunked):
        assert r <= (TRAIN_QK_GRAD_REL_BOUND if kind in qk else TRAIN_GRAD_REL_BOUND), (path, r)
    assert statistics.median(fault) > TRAIN_GRAD_REL_BOUND, "the leaf bounds miss a K3 fault"
    say(f"[train] plain chunked flash backward at the training shape: {flash_bwd_ms:.4f} ms "
        f"per call, {L} calls per step; the head's product backward {head_bwd_ms:.4f} ms, "
        f"once per step")

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
        rec = dict(
            name="ssd_scan_fwd", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:82", max_abs_err=err,
            ms=time_ms(torch, lambda: ssd_scan_fwd(x, dt, A, B, C)),
            plain_ms=time_ms(torch, lambda: ref.ssd_scan_ref(x, dt, A, B, C), reps=5),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        )
        chunked_ms = time_ms(torch, lambda: ref.ssd_scan_ref_chunked(
            x, dt, A, B, C, chunk=ops.SSD_CHUNK), reps=5)
        say(f"[ssd] ssd_scan_fwd {dtype_name(x)} x{tuple(x.shape)} B{tuple(B.shape)}: "
            f"max_abs_err {err:.3e} kernel_ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
            f"(stepwise) chunked_ms {chunked_ms:.4f} library_ms null (no single PyTorch "
            f"call) bound_ms {bound_ms:.6f} ({bound_by}, {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) achieved {nbytes / rec['ms'] / 1e6:.1f} GB/s, "
            f"{flops / rec['ms'] / 1e9:.2f} TFLOP/s")
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
    none = {"flash_attention_fwd": 0, "rmsnorm_bwd": 0, "fused_map": 0, "fused_reduce": 0}
    assert mprefill_counts == {**none, "ssd_scan_fwd": nl, "rmsnorm_fwd": 2 * nl + 1}, \
        mprefill_counts
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
    myia_counts, myia_fused = myia_phases(torch, dev, records, f"{name} ({smi})")

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
    kernels_line = [
        {**{key: rec[key] for key in ("name", "route", "source", "replaces", "launches",
                                      "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
         "launches_by_path": {"serve": launches_on(serve_counts, {}, rec),
                              "train": launches_on(train_counts, {}, rec),
                              "serve_mamba2": launches_on(mamba_counts, {}, rec),
                              "train_myia": launches_on(myia_counts, myia_fused, rec)}}
        for rec in records.values()
    ]
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
