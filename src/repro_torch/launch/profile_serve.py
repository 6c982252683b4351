"""Where the serving path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch mamba2-370m]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch jamba-v0.1-52b \\
        --n-layers 8

Runs ``--arch`` (default gemma3-1b) at full width in bf16 (random weights from a
seed) on the serving cells of ``chip_smoke.py`` (batch 4, prompt 1024; whisper-medium
1500 encoder frames and a prompt of its decoder context less the 32 tokens the cells
generate), ``--n-layers`` of them (default: all): a warm-up,
then one prefill and ``STEPS`` decode steps, each phase once with host clocks alone
and once under ``torch.profiler``.  For each phase it prints the
wall time, the device's busy time (the sum of its kernels' times, from the
profiler), the device's idle share of the wall time, the number of kernels, and
the kernels that take the most device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS, DEC_CONTEXT, ENC_FRAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_requests, serve_decode, serve_prefill
from repro_torch.models import init_params

BATCH, PROMPT_LEN, GEN = 4, 1024, 32
STEPS = 8  # decode steps profiled
TOP = 14  # kernels listed per phase


def _kernel_rows(prof) -> list[dict]:
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append({"name": e.key, "count": e.count, "us": e.self_device_time_total})
    return sorted(rows, key=lambda r: -r["us"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=sorted(ARCHS))
    ap.add_argument("--n-layers", type=int, default=None, help="cut the depth to this")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    params = init_params(cfg, seed=0, device=dev)
    P = DEC_CONTEXT - GEN if cfg.enc_dec else PROMPT_LEN
    prompts, extras = make_requests(cfg, BATCH, P, dev, enc_frames=ENC_FRAMES)
    max_len = P + STEPS + 2

    def prefill():
        return serve_prefill(cfg, params, prompts, max_len, batch_extras=extras)

    logits, caches = prefill()
    serve_decode(cfg, params, logits, caches, P, 2)
    torch.cuda.synchronize()

    def decode():
        lg, cs = state
        return serve_decode(cfg, params, lg, cs, P, STEPS)

    for phase, fn in (("prefill", prefill), ("decode", decode)):
        state = prefill()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3

        state = prefill()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            prof_wall_ms = (time.monotonic() - t0) * 1e3
        rows = _kernel_rows(prof)
        busy_ms = sum(r["us"] for r in rows) / 1e3
        summary = {
            "arch": args.arch,
            "n_layers": cfg.n_layers,
            "phase": phase,
            "steps": 1 if phase == "prefill" else STEPS,
            "wall_ms": wall_ms,
            "profiled_wall_ms": prof_wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / prof_wall_ms),
            "kernels": sum(r["count"] for r in rows),
        }
        print(json.dumps(summary))
        for r in rows[:TOP]:
            print(f"  {r['us'] / 1e3:9.3f} ms {100 * r['us'] / 1e3 / busy_ms:5.1f}% "
                  f"x{r['count']:<5d} {r['name'][:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
