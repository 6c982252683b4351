"""Where the Myia-compiled train step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_myia

Trains the Myia LM (``launch/myia_step.py``) at the width ``--compiler myia``
takes from internlm2-1.8b (V 92544, D 2048, H 8192, f32, random weights from a
seed, plain SGD) on SyntheticLM batch 8 x 256: the ``train_myia`` cell of
``chip_smoke.py``.  After two warm-up steps it runs

* one step split into the compiled loss-and-adjoint call and the SGD update,
  each ended by ``torch.cuda.synchronize()`` and timed by the host clock;
* one whole step timed by the host clock;
* one whole step under ``torch.profiler``: the device's busy time, its idle
  share of the wall time, the number of kernels, the kernels that take the most
  device time, and the device time and the number of kernels by kind (K1's
  generated Triton kernels, GEMMs, the rest).
"""

from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.myia_step import MyiaLMDims, make_myia_train_step
from repro_torch.launch.profile_train import TOP, _kernel_rows, _sync_s

ARCH, BATCH, SEQ, LR = "internlm2-1.8b", 8, 256, 3e-4

KINDS = (  # (kind, substrings of the kernel's name), first match wins
    ("K1 fused (Triton)", ("fused_map", "fused_reduce")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (elementwise, reductions, gathers, copies)"


def main() -> int:
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    dims = MyiaLMDims.from_config(get_config(ARCH))
    step_fn, init_fn = make_myia_train_step(dims, BATCH, SEQ, LR, device=dev)
    state = init_fn()
    ds = SyntheticLM(DataConfig(vocab=dims.vocab, seq_len=SEQ, global_batch=BATCH))
    batches = [to_device(ds.batch(i), dev) for i in range(6)]
    for b in batches[:2]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()

    # one step by phases: the compiled loss and adjoint, then the SGD update
    params = state["params"]
    t0 = time.monotonic()
    loss, grads = step_fn.vag(*params, batches[2]["tokens"], batches[2]["labels"])
    vag_s = _sync_s(t0)
    t0 = time.monotonic()
    new_params, _ = step_fn.update(params, grads)
    sgd_s = _sync_s(t0)
    state = {"params": new_params, "step": state["step"] + 1}
    del loss, grads, new_params, params

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
    launches: dict[str, int] = {}
    for r in rows:
        kinds[_kind(r["name"])] = kinds.get(_kind(r["name"]), 0.0) + r["us"] / 1e3
        launches[_kind(r["name"])] = launches.get(_kind(r["name"]), 0) + r["count"]
    summary = {
        "arch": ARCH, "vocab": dims.vocab, "d_model": dims.d_model, "d_hidden": dims.d_hidden,
        "batch": BATCH, "seq": SEQ, "device": torch.cuda.get_device_name(0),
        "loss_and_adjoint_ms": vag_s * 1e3, "sgd_update_ms": sgd_s * 1e3,
        "step_wall_ms": wall_s * 1e3, "profiled_wall_ms": prof_wall_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / (prof_wall_s * 1e3)),
        "kernels": sum(r["count"] for r in rows),
        "device_ms_by_kind": kinds,
        "kernels_by_kind": launches,
    }
    print(json.dumps(summary))
    for r in rows[:TOP]:
        print(f"  {r['us'] / 1e3:9.3f} ms {100 * r['us'] / 1e3 / busy_ms:5.1f}% "
              f"x{r['count']:<5d} {r['name'][:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
