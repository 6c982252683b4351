"""Device timing shared by the kernel profile scripts and ``chip_smoke.py``.

``kernel_ms`` is the card's time for one call with no host time in it: after an L2
flush the card spins (``torch.cuda._sleep``) for twice the call's host time plus
0.2 ms, so the call's launches are queued before the start event fires.  The profile
scripts import this file from their own directory, so that running one of them with
``PYTHONPATH`` set to another checkout's ``src`` times that checkout's kernels with
this timer.
"""

from __future__ import annotations

import re
import statistics
import time

import torch

F32_FLOPS = 67e12  # the H100 SXM's f32 FMA rate, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # its memory rate


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time per call: ``calls`` calls back to back, without a
    synchronise between them, by host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def spin_cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep``'s spin at the card's clock now."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(2_000_000)
    e.record()
    torch.cuda.synchronize()
    return 2_000_000 / s.elapsed_time(e)


def kernel_ms(fn, host: float, reps: int = 30, cycles_per_ms: float | None = None) -> float:
    """Median milliseconds the card spends on one call of ``fn``, by CUDA events, with
    the L2 cache flushed before each call; ``host`` is the call's host µs."""
    if cycles_per_ms is None:
        cycles_per_ms = spin_cycles_per_ms()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
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


def ptxas_entries(log: str) -> list[tuple[str, int, int, int]]:
    """(kernel entry, registers, spill-store bytes, spill-load bytes) of each entry
    function in nvcc's -Xptxas -v output (``build.build_log()``)."""
    out, entry, spills = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = (int(found[1]), int(found[2]))
        elif entry is not None and (used := re.search(r"Used (\d+) registers", line)):
            out.append((entry, int(used[1]), *spills))
            entry, spills = None, (0, 0)
    return out


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave visible: the work attention must do."""
    n = 0
    for i in range(Sq):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n
