"""K3 (the rmsnorm backward) on the card at the shapes the paths give it.

    PYTHONPATH=src python -m repro_torch.launch.profile_rmsnorm [--reps 100]

Builds the kernels, prints ptxas's registers and spills of K3's instantiations, then
calls ``kernels.rmsnorm.rmsnorm_bwd`` on random inputs (a seed) at each shape of
``SHAPES`` and prints one JSON line a shape: the device ms of one call by CUDA
events with the card held behind the host (``torch.cuda._sleep``) after an L2 flush,
as ``chip_smoke.py`` reads ``kernel_ms``, the host µs a call, its share of the byte
bound, and ``F.rms_norm``'s backward read the same way.  It uses only the wrapper's
signature, so one call of the script can time two checkouts in turn (``PYTHONPATH``
set to each one's ``src``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import rmsnorm_bwd

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    # the timer beside this file, whichever checkout's package PYTHONPATH names
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import devtime
    build.load()
    log = build.build_log().split("== rmsnorm.cu")[-1].split("\n== ")[0]
    for name, regs, stores, loads in devtime.ptxas_entries(log):
        print(f"{name}: {regs} registers, {stores} bytes spill stores, {loads} bytes spill loads")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cycles_per_ms = devtime.spin_cycles_per_ms()
    for shape, dtype_name, where in SHAPES:
        dtype = getattr(torch, dtype_name)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        x_lib = x.clone().requires_grad_(True)
        w_lib = w.to(dtype).requires_grad_(True)
        y_lib = F.rms_norm(x_lib, (shape[-1],), w_lib, 1e-6)
        out = {"shape": list(shape), "dtype": dtype_name, "where": where}
        for key, fn in (("k3", lambda: rmsnorm_bwd(x, w, dy)),
                        ("f_rms_norm_bwd", lambda: torch.autograd.grad(
                            y_lib, (x_lib, w_lib), dy, retain_graph=True))):
            for _ in range(3):
                fn()
            host = devtime.host_us(fn)
            out[f"{key}_ms"] = devtime.kernel_ms(fn, host, args.reps, cycles_per_ms)
            out[f"{key}_host_us"] = host
        nbytes = 3 * x.numel() * x.element_size() + 2 * shape[-1] * 4
        out["bound_ms"] = nbytes / devtime.HBM_BYTES_PER_S * 1e3
        out["k3_share_of_bound"] = out["bound_ms"] / out["k3_ms"]
        print(json.dumps(out))
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
