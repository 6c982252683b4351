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
6. runs the same prefill with the plain versions and compares the logits.

A failed phase raises and the script exits non-zero.  The last lines are the
kernels' record, the card's name and power limit, and the device line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, build, ref, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    from repro_torch.launch.serve import make_prompts, serve_decode, serve_prefill
    from repro_torch.models import init_params

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
    sp_cuda = _to_device(sp, dev)
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
    assert prefill_counts == {"flash_attention_fwd": n_layers, "rmsnorm_fwd": 2 * n_layers + 1}, \
        prefill_counts
    assert decode_counts == {"flash_attention_fwd": 0, "rmsnorm_fwd": (2 * n_layers + 1) * GEN}, \
        decode_counts
    assert logits.shape == (B, cfg.vocab) and tokens.shape == (B, GEN)
    assert tokens.dtype == torch.int32
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    assert all(bool(torch.isfinite(lg_).all()) for lg_ in step_logits), "non-finite decode logits"
    say(f"[serve] first tokens: {tokens[:, :8].tolist()}")
    for rec in records.values():
        rec["launches"] = run_counts[rec["name"]]

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

    # -- records ---------------------------------------------------------------
    kernels_line = [
        {key: rec[key] for key in ("name", "route", "source", "replaces", "launches",
                                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}
        for rec in records.values()
    ]
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    sys.exit(main())
