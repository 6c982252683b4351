"""Where the Myia serving runtime's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve_myia

Serves gemma3-1b's Myia LM (``serve.init_serve_params``: V 262144, D 1152, H 4608,
f32 with TF32 off, random weights from a seed) through ``ServeEngine``: 4 requests
of prompt 1024 and 32 greedy tokens over 4 slots, one bucket of 2048 (the
``serve_myia`` cell of ``chip_smoke.py``).  After that run warms the programs up,
it runs one prefill at the bucket and one decode step of the 4 slots, each once
timed by the host clock around ``torch.cuda.synchronize()`` and once under
``torch.profiler``: the device's busy time, its idle share of the wall time, the
number of kernels, the kernels that take the most device time and the device time
by kind (GEMMs, the rest).  It then times the decode program's first op, ``take``
of 4 embedding rows, alone: its host time a call and its device time.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.primitives import take
from repro_torch.device import resolve_device
from repro_torch.launch.profile_train import TOP, _kernel_rows, _sync_s
from repro_torch.serve import ServeEngine, ServeLMDims, causal_mask, decode_masks
from repro_torch.serve import init_serve_params

ARCH, REQS, PROMPT, GEN, SLOTS, BUCKET = "gemma3-1b", 4, 1024, 32, 4, 2048
GEMM = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def _profiled(fn) -> dict:
    """Wall ms by the host clock, then the same call under ``torch.profiler``."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    wall_s = _sync_s(t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        prof_wall_s = _sync_s(t0)
    rows = _kernel_rows(prof)
    busy_ms = sum(r["us"] for r in rows) / 1e3
    gemm_ms = sum(r["us"] for r in rows if any(k in r["name"].lower() for k in GEMM)) / 1e3
    return {
        "wall_ms": wall_s * 1e3, "profiled_wall_ms": prof_wall_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / (prof_wall_s * 1e3)),
        "kernels": sum(r["count"] for r in rows),
        "device_ms_by_kind": {"GEMM": gemm_ms, "other": busy_ms - gemm_ms},
        "top": [(round(r["us"] / 1e3, 4), r["count"], r["name"][:90]) for r in rows[:TOP]],
    }


def main() -> int:
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    dims = ServeLMDims.from_config(get_config(ARCH))
    params = init_serve_params(dims, torch.Generator(device=dev).manual_seed(0), dev)
    engine = ServeEngine(dims, params, n_slots=SLOTS, min_bucket=32)
    rng = np.random.default_rng(0)
    for _ in range(REQS):
        engine.submit(rng.integers(0, dims.vocab, PROMPT).tolist(), GEN)
    engine.run()  # warms both programs up
    batch = engine._batches[BUCKET]

    tok = torch.zeros((1, BUCKET), dtype=torch.int32, device=dev)
    prefill = _profiled(lambda: engine._prefill_fn(*params, tok, causal_mask(BUCKET, dev)))
    wcol, amask = decode_masks(np.full(SLOTS, PROMPT + 5), BUCKET, dev)
    step_tok = torch.from_numpy(batch.tok).to(dev)
    decode = _profiled(lambda: engine._decode_fn(*params, step_tok, batch.kcache,
                                                  batch.vcache, wcol, amask))

    idx = step_tok.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        take.impl(params[0], idx)
    take_host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            take.impl(params[0], idx)
        torch.cuda.synchronize()
    take_device_us = sum(r["us"] for r in _kernel_rows(prof)) / 20

    summary = {
        "arch": ARCH, "vocab": dims.vocab, "d_model": dims.d_model, "d_hidden": dims.d_hidden,
        "bucket": BUCKET, "slots": SLOTS, "device": torch.cuda.get_device_name(0),
        "prefill": prefill, "decode_step": decode,
        "take_host_us": take_host_us, "take_device_us": take_device_us,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
