"""K3 (the rmsnorm backward), or with ``--fwd`` K2, on the card at the paths' shapes.

    PYTHONPATH=src python -m repro_torch.launch.profile_rmsnorm [--fwd] [--reps 100]

Builds the kernels, prints ptxas's registers and spills of the kernel's instantiations,
then calls ``kernels.rmsnorm.rmsnorm_bwd`` (``rmsnorm_fwd`` with ``--fwd``) on random
inputs (a seed) at each shape of ``SHAPES`` (``FWD_SHAPES``) and prints one JSON line
a shape: the device ms of one call by CUDA events with the card held behind the host
(``torch.cuda._sleep``) after an L2 flush, as ``chip_smoke.py`` reads ``kernel_ms``,
the host µs a call, its share of the byte bound, and ``F.rms_norm`` (its backward)
read the same way.  With ``--fwd``, where the tree's wrapper module has
``rmsnorm_fwd_on`` and ``build.K2_ROUTES``, the line also names the route that one call
took and times every route that takes the width, forced.  It uses only the wrappers'
signatures, so one call of the script can time two checkouts in turn (``PYTHONPATH``
set to each one's ``src``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd

#: (shape, dtype, where the paths call K3 so)
SHAPES = [
    ((8, 1024, 2048), "bfloat16", "internlm2 train step"),
    ((4, 1024, 2048), "bfloat16", "a 2x1 rank's rows"),
    ((8, 256, 512), "float32", "train_e2e step"),
    ((64, 2048), "bfloat16", "fewer rows than the grid has blocks"),
    ((4, 24, 64), "float32", "serve_batch's reduced width"),
    ((2, 256, 64), "float32", "chip_smoke phase 7"),
    ((2, 256, 64), "bfloat16", "chip_smoke phase 7"),
    ((120, 96), "float32", "chip_smoke phase 7"),
    ((120, 96), "bfloat16", "chip_smoke phase 7"),
]

#: K2's (shape, dtype, where the paths call it so): the Jamba gate norm's prefill and
#: decode rows, the dry-run archs' widths, the decode and prefill rows at the narrower
#: widths (the warp-per-row kernel's, each also timed on route 1 forced), and row
#: counts of 8192 from a quarter to twice the SMs
FWD_SHAPES = [
    ((4, 1024, 8192), "bfloat16", "Jamba gate norm prefill"),
    ((4, 1, 8192), "bfloat16", "Jamba gate norm decode"),
    ((4, 1024, 8192), "float32", "Jamba gate norm prefill, f32"),
    ((4, 1, 8192), "float32", "Jamba gate norm decode, f32"),
    ((2, 1024, 6144), "bfloat16", "starcoder2-15b / grok-1-314b width"),
    ((4, 1, 7168), "bfloat16", "deepseek-coder-33b / kimi-k2 decode"),
    ((4, 1, 1024), "bfloat16", "whisper decode"),
    ((4, 1, 1152), "bfloat16", "gemma3-1b decode"),
    ((4, 1, 4096), "bfloat16", "vision / Jamba decode"),
    ((4, 1024, 1152), "bfloat16", "gemma3-1b prefill"),
    ((4, 1024, 4096), "bfloat16", "vision / Jamba prefill"),
    ((8, 1024, 2048), "bfloat16", "internlm2 train step"),
    ((4, 24, 64), "float32", "serve_batch prefill, d 64"),
    ((4, 1, 64), "float32", "serve_batch decode, d 64"),
    ((4, 24, 128), "float32", "serve_batch prefill, the Mamba gate norm's 128"),
    ((4, 1, 128), "float32", "serve_batch decode, the Mamba gate norm's 128"),
    ((33, 8192), "bfloat16", "rows: a quarter of the SMs"),
    ((66, 8192), "bfloat16", "rows: half the SMs"),
    ((132, 8192), "bfloat16", "rows: the SMs"),
    ((264, 8192), "bfloat16", "rows: twice the SMs"),
]

#: ``--sweep``: rows by width, where the routes' times cross
SWEEP = [((rows, D), dtype, "sweep") for dtype, widths in (
    ("bfloat16", (64, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)),
    ("float32", (64, 128, 512, 2048, 8192, 16384)))
    for D in widths for rows in (1, 4, 16, 33, 66, 99, 132, 264, 528)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fwd", action="store_true", help="time K2 (the forward) instead of K3")
    ap.add_argument("--sweep", action="store_true",
                    help="with --fwd: time every route at the SWEEP shapes instead")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    # the timer beside this file, whichever checkout's package PYTHONPATH names
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import devtime
    build.load()
    log = build.build_log().split("== rmsnorm.cu")[-1].split("\n== ")[0]
    for name, regs, stores, loads in devtime.ptxas_entries(log):
        if ("rmsnorm_fwd" in name) == args.fwd:
            print(f"{name}: {regs} registers, {stores} bytes spill stores, {loads} bytes spill "
                  "loads")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cycles_per_ms = devtime.spin_cycles_per_ms()

    def timed(out, key, fn):
        for _ in range(3):
            fn()
        host = devtime.host_us(fn)
        out[f"{key}_ms"] = devtime.kernel_ms(fn, host, args.reps, cycles_per_ms)
        out[f"{key}_host_us"] = host

    if args.fwd:
        mod = importlib.import_module("repro_torch.kernels.rmsnorm")
        routes = getattr(mod, "ROUTES", ())
        for shape, dtype_name, where in SWEEP if args.sweep else FWD_SHAPES:
            dtype = getattr(torch, dtype_name)
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
            w_lib = w.to(dtype)
            out = {"shape": list(shape), "dtype": dtype_name, "where": where}
            if hasattr(build, "K2_ROUTES"):
                build.reset_launches()
                rmsnorm_fwd(x, w)
                (out["route"],) = build.K2_ROUTES
            timed(out, "k2", lambda: rmsnorm_fwd(x, w))
            timed(out, "f_rms_norm", lambda: F.rms_norm(x, (shape[-1],), w_lib, 1e-6))
            for r in routes:
                if r == "warp-per-row" and shape[-1] > 4096:
                    continue
                if r == "row-per-block" and shape[-1] > 8192:
                    continue
                timed(out, f"route {r}", lambda: mod.rmsnorm_fwd_on(x, w, r))
            nbytes = 2 * x.numel() * x.element_size() + shape[-1] * 4
            out["bound_ms"] = nbytes / devtime.HBM_BYTES_PER_S * 1e3
            out["k2_share_of_bound"] = out["bound_ms"] / out["k2_ms"]
            print(json.dumps(out), flush=True)
        print(json.dumps({"device": torch.cuda.get_device_name(0)}))
        return 0
    for shape, dtype_name, where in SHAPES:
        dtype = getattr(torch, dtype_name)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        x_lib = x.clone().requires_grad_(True)
        w_lib = w.to(dtype).requires_grad_(True)
        y_lib = F.rms_norm(x_lib, (shape[-1],), w_lib, 1e-6)
        out = {"shape": list(shape), "dtype": dtype_name, "where": where}
        timed(out, "k3", lambda: rmsnorm_bwd(x, w, dy))
        timed(out, "f_rms_norm_bwd",
              lambda: torch.autograd.grad(y_lib, (x_lib, w_lib), dy, retain_graph=True))
        nbytes = 3 * x.numel() * x.element_size() + 2 * shape[-1] * 4
        out["bound_ms"] = nbytes / devtime.HBM_BYTES_PER_S * 1e3
        out["k3_share_of_bound"] = out["bound_ms"] / out["k3_ms"]
        print(json.dumps(out))
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
