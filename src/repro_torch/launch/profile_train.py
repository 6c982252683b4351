"""Where the training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train

Trains internlm2-1.8b at full width in bf16 (random weights from a seed, AdamW,
SyntheticLM batch 8 x 1024: the training cell of ``chip_smoke.py``).  After three
warm-up steps it runs

* one whole step timed by the host clock;
* one whole step under ``torch.profiler``: the device's busy time (the sum of its
  kernels' times), its idle share of the wall time, the number of kernels, the
  kernels that take the most device time, and the device time by kind (the three
  hand-written kernels, GEMMs, the rest);
* the plain chunked flash backward alone at the step's shape, by CUDA events.

The device time of the forward, the backward, the optimizer update and the attention
backward inside a step, by the program's spans (``train.*``, ``attn.bwd``), is
``portbench/tools/spans.py``'s, in the benchmark's training cells.
"""

from __future__ import annotations

import json
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.distributed import make_train_state_fn, make_train_step
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models.model import stacked_layer_groups
from repro_torch.optim import OptConfig, make_optimizer

ARCH, BATCH, SEQ = "internlm2-1.8b", 8, 1024
TOP = 16  # kernels listed

KINDS = (  # (kind, substrings of the kernel's name), first match wins
    ("K4 flash_attention_fwd", ("fa_fwd_tc_kernel", "fa_fwd_simt_kernel")),
    ("K2 rmsnorm_fwd", ("rmsnorm_fwd_kernel",)),
    ("K3 rmsnorm_bwd", ("rmsnorm_bwd_kernel", "rmsnorm_bwd_dw_kernel")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
)


def _kernel_rows(prof) -> list[dict]:
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append({"name": e.key, "count": e.count, "us": e.self_device_time_total})
    return sorted(rows, key=lambda r: -r["us"])


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (elementwise, reductions, copies)"


def _sync_s(t0: float) -> float:
    torch.cuda.synchronize()
    return time.monotonic() - t0


def main() -> int:
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    opt = make_optimizer(OptConfig(lr=3e-4, warmup_steps=2, total_steps=100),
                         layer_groups=stacked_layer_groups(cfg))
    state = make_train_state_fn(cfg, opt, device=dev, seed=0)()
    step_fn = make_train_step(cfg, opt)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
    batches = [to_device(ds.batch(i), dev) for i in range(6)]
    for b in batches[:3]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()

    t0 = time.monotonic()
    state, m = step_fn(state, batches[3])
    float(m["loss"])
    wall_s = _sync_s(t0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, m = step_fn(state, batches[4])
        float(m["loss"])
        prof_wall_s = _sync_s(t0)
    rows = _kernel_rows(prof)
    busy_ms = sum(r["us"] for r in rows) / 1e3
    kinds: dict[str, float] = {}
    for r in rows:
        kinds[_kind(r["name"])] = kinds.get(_kind(r["name"]), 0.0) + r["us"] / 1e3
    del state

    # the plain chunked flash backward alone, at the step's shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((BATCH, cfg.n_heads, SEQ, cfg.hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((BATCH, cfg.n_kv_heads, SEQ, cfg.hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((BATCH, cfg.n_kv_heads, SEQ, cfg.hd), generator=gen, device=dev).bfloat16()
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    do = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    times = []
    for _ in range(6):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        ref.flash_attention_bwd_chunked(q, k, v, o, lse, do, causal=True)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    flash_bwd_ms = statistics.median(times[1:])

    summary = {
        "arch": ARCH, "batch": BATCH, "seq": SEQ, "device": torch.cuda.get_device_name(0),
        "step_wall_ms": wall_s * 1e3, "profiled_wall_ms": prof_wall_s * 1e3,
        "device_busy_ms": busy_ms, "device_idle_share": max(0.0, 1 - busy_ms / (prof_wall_s * 1e3)),
        "kernels": sum(r["count"] for r in rows),
        "device_ms_by_kind": kinds,
        "flash_bwd_chunked_ms_per_call": flash_bwd_ms,
        "flash_bwd_chunked_ms_per_step": flash_bwd_ms * cfg.n_layers,
    }
    print(json.dumps(summary))
    for r in rows[:TOP]:
        print(f"  {r['us'] / 1e3:9.3f} ms {100 * r['us'] / 1e3 / busy_ms:5.1f}% "
              f"x{r['count']:<5d} {r['name'][:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
