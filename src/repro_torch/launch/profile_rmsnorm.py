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
import statistics
import time

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import rmsnorm_bwd

HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's memory rate
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


def host_us(fn, calls: int = 200) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def kernel_ms(fn, host: float, flush: torch.Tensor, cycles_per_ms: float, reps: int) -> float:
    """Median device ms of one call: the card spins for twice the host time plus 0.2 ms
    before the start event, so the call's launches are queued when it fires."""
    cycles = int((2 * host / 1e3 + 0.2) * cycles_per_ms)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(cycles)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    build.load()
    for line in build.build_log().split("== rmsnorm.cu")[-1].split("\n== ")[0].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(2_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 2_000_000 / s.elapsed_time(e)
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
            host = host_us(fn)
            out[f"{key}_ms"] = kernel_ms(fn, host, flush, cycles_per_ms, args.reps)
            out[f"{key}_host_us"] = host
        nbytes = 3 * x.numel() * x.element_size() + 2 * shape[-1] * 4
        out["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out["k3_share_of_bound"] = out["bound_ms"] / out["k3_ms"]
        print(json.dumps(out))
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
