"""K4's f32 kernel (flash attention on the CUDA cores) on the card at the paths' shapes.

    PYTHONPATH=src python -m repro_torch.launch.profile_flash [--reps 100]

Builds the kernels, prints ptxas's registers and spills of K4's f32 instantiations,
then calls ``kernels.flash_attention.flash_attention_fwd`` on random f32 inputs (a
seed) at each shape of ``SHAPES`` and prints one JSON line a shape: the device ms of
one call by CUDA events with the card held behind the host (``torch.cuda._sleep``)
after an L2 flush, as ``chip_smoke.py`` reads ``kernel_ms``, the host µs a call, the
largest error against the plain version, the share of the operations bound, and
``F.scaled_dot_product_attention`` in f32 read the same way (TF32 off).  It uses only
the wrapper's signature, so one call of the script can time two checkouts in turn
(``PYTHONPATH`` set to each one's ``src``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import flash_attention_fwd

#: (q shape, kv shape, causal, window, return_lse, where the paths call K4 so)
SHAPES = [
    ((8, 8, 256, 64), (8, 2, 256, 64), True, 256, True, "train_e2e local layers"),
    ((8, 8, 256, 64), (8, 2, 256, 64), True, None, True, "train_e2e global layer"),
    ((4, 8, 1024, 128), (4, 4, 1024, 128), True, None, False,
     "internlm2 f32 placed prefill, a 1x2 rank's heads"),
    ((4, 2, 1024, 256), (4, 1, 1024, 256), True, 512, False,
     "gemma3-1b f32 placed prefill, a 1x2 rank's heads, local layers"),
    ((4, 2, 1024, 256), (4, 1, 1024, 256), True, None, False,
     "gemma3-1b f32 placed prefill, a 1x2 rank's heads, global layer"),
    ((4, 4, 24, 16), (4, 1, 24, 16), True, 8, False, "serve_batch gemma3 reduced, local"),
    ((4, 4, 24, 16), (4, 1, 24, 16), True, None, False, "serve_batch gemma3 reduced, global"),
    ((4, 4, 24, 16), (4, 2, 24, 16), True, None, False, "serve_batch grok / Jamba reduced"),
    ((1, 2, 256, 32), (1, 2, 256, 32), True, 64, False, "test shape, head_dim 32, window 64"),
    ((1, 8, 64, 32), (1, 2, 64, 32), True, None, False, "test shape, head_dim 32, GQA 4"),
    ((2, 4, 130, 256), (2, 2, 130, 256), True, None, False, "test shape, head_dim 256, ragged"),
    ((2, 4, 1, 16), (2, 2, 1, 16), False, None, False, "test shape, head_dim 16, one row"),
    # what bounds train_e2e's shape: one block of one 64 x 64 tile; one head whose
    # longest causal block (4 tiles) runs alone on its SM; 64 blocks of 64 tiles, one an SM
    ((1, 1, 64, 64), (1, 1, 64, 64), True, None, True, "probe: one block, one tile"),
    ((1, 1, 256, 64), (1, 1, 256, 64), True, None, True, "probe: a 4-tile block alone"),
    ((1, 1, 4096, 64), (1, 1, 4096, 64), False, None, True, "probe: 64 tiles a block"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    # the timer beside this file, whichever checkout's package PYTHONPATH names
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import devtime
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    log = build.build_log().split("== flash_attention.cu")[-1].split("\n== ")[0]
    for name, regs, stores, loads in devtime.ptxas_entries(log):
        if "fa_fwd_simt" in name:
            print(f"{name}: {regs} registers, {stores} bytes spill stores, {loads} bytes spill "
                  "loads")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cycles_per_ms = devtime.spin_cycles_per_ms()
    for q_shape, kv_shape, causal, window, lse, where in SHAPES:
        q = torch.randn(q_shape, generator=gen, device="cuda")
        k = torch.randn(kv_shape, generator=gen, device="cuda")
        v = torch.randn(kv_shape, generator=gen, device="cuda")
        B, H, Sq, D = q_shape
        Skv = kv_shape[2]
        got = flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        if causal and window is None and Sq == Skv:
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        else:
            mask = ref.attention_mask(Sq, Skv, causal=causal, window=window, device=q.device)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        out = {"q": list(q_shape), "kv": list(kv_shape), "causal": causal, "window": window,
               "lse": lse, "where": where,
               "max_abs_err": (got - want).abs().max().item()}
        for key, fn in (("k4", lambda: flash_attention_fwd(q, k, v, causal=causal, window=window,
                                                           return_lse=lse)),
                        ("sdpa_f32", sdpa)):
            for _ in range(3):
                fn()
            host = devtime.host_us(fn)
            out[f"{key}_ms"] = devtime.kernel_ms(fn, host, args.reps, cycles_per_ms)
            out[f"{key}_host_us"] = host
        flops = 4 * B * H * D * devtime.visible_pairs(Sq, Skv, causal, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4 + (B * H * Sq * 4 if lse else 0)
        out["gflop"] = flops / 1e9
        ops_s, bytes_s = flops / devtime.F32_FLOPS, nbytes / devtime.HBM_BYTES_PER_S
        out["bound_ms"] = max(ops_s, bytes_s) * 1e3
        out["bound_by"] = "operations" if ops_s >= bytes_s else "bytes"
        out["k4_share_of_bound"] = out["bound_ms"] / out["k4_ms"]
        print(json.dumps(out), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
