"""Where K5's time goes on the card: each pass of the SSD scan at a serving shape.

    PYTHONPATH=src python -m repro_torch.launch.profile_ssd [--dtype float32]

Builds the kernels, then calls ``kernels.ssd_scan.ssd_scan_fwd`` on random inputs (a
seed) at mamba2-370m's serving shape (batch 4, prompt 1024: x (4,1024,32,64), B and C
(4,1024,1,128)), the L2 cache flushed before each call.  It prints ptxas's registers
and spills of the SSD kernels, the plan (grids, shared memory, scratch), each pass's
device ms per call from ``torch.profiler``, and the whole call's device ms by CUDA
events with the card held behind the host (``torch.cuda._sleep``), as
``chip_smoke.py`` reads ``kernel_ms``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import plan, ssd_scan_fwd

BATCH, PROMPT_LEN = 4, 1024
CALLS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    dtype = getattr(torch, args.dtype)
    cfg = get_config("mamba2-370m")
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(BATCH, PROMPT_LEN, H, P).to(dtype)
    B, C = randn(BATCH, PROMPT_LEN, 1, N).to(dtype), randn(BATCH, PROMPT_LEN, 1, N).to(dtype)
    dt = 0.01 + 0.19 * torch.rand((BATCH, PROMPT_LEN, H), generator=gen, device=dev)
    A = -torch.exp(0.5 * randn(H))

    build.load()
    for line in build.build_log().split("== ssd_scan.cu")[-1].split("\n== ")[0].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())
    p = plan(BATCH, PROMPT_LEN, H, 1, N, P, dtype)
    scratch = sum(math.prod(shape) * torch.empty((), dtype=d).element_size()
                  for shape, d in filter(None, p.scratch.values()))
    print(json.dumps({"chunk": p.chunk, "n_chunks": p.n_chunks,
                      "heads_per_block": {"state": p.state_heads_per_block,
                                          "output": p.heads_per_block},
                      "passes": [[ps.name, ps.grid, ps.smem] for ps in p.passes],
                      "scratch_bytes": scratch}))

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for _ in range(3):
        ssd_scan_fwd(x, dt, A, B, C)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            flush.zero_()
            ssd_scan_fwd(x, dt, A, B, C)
        torch.cuda.synchronize()
    per_pass = {e.key.split("::")[-1].split("(")[0]: e.self_device_time_total / CALLS / 1e3
                for e in prof.key_averages() if "ssd_" in e.key}

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(2_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles = int(2_000_000 / s.elapsed_time(e))  # about 1 ms of spin, far above the host's
    events = []
    for _ in range(CALLS):
        flush.zero_()
        torch.cuda._sleep(cycles)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        ssd_scan_fwd(x, dt, A, B, C)
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "dtype": args.dtype,
                      "pass_ms": per_pass, "passes_sum_ms": sum(per_pass.values()),
                      "kernel_ms": statistics.median(a.elapsed_time(b) for a, b in events)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
