"""Device time by the program span that launched it, in a cell of the benchmark.

    python3 -m portbench.tools.spans --workload internlm2-serve-longprompt --seed 7 --seconds 10

Sets the cell up as ``portbench/run.py`` does, then runs its window three times:
with nothing armed, with the program's tracer (``repro_torch.obs.trace``) armed, and
with the tracer and ``torch.profiler`` over the card's activity alone (as a ``--trace 1``
run).  Prints one JSON line: each window's end-to-end metrics (what tracing costs), and
from the last window

* the six per-layer readings the program's spans give (``READINGS``): the optimizer's
  and the attention backward's device ms, launches a train step, and a decode step's
  host ms, device ms and launches;
* every span's host ms, device ms and launches a step, and how much of the device's busy
  time the work launched in ``train.step`` covers;
* the device's idle seconds by the innermost program span the host was in;
* the benchmark's own per-layer metrics, as a ``--trace 1`` run reads them;
* how far the profiler's clock lies from the tracer's.

Each device operation is paired with the CUDA API call that launched it by the
correlation id the two share; the call's start is the operation's launch time, on the
clock of the tracer's ``spans_ns()``.  An operation belongs to every span whose interval
holds its launch time (spans on autograd's device thread and on the main thread both
hold the backward's work).  The readings are the arithmetic of readers the benchmark
lacks (PERF.md §7); this tool goes once they are in ``portbench/metrics/``.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import time
import types
from pathlib import Path
from typing import Iterable, NamedTuple

from portbench.lib.common import ROOT
from portbench.lib.trace import Trace, name_gaps, top

#: reading -> (span, field of ``span_stats``, the span counted as a step)
READINGS = {
    "optimizer_ms.train": ("train.optimizer", "device_ms", "train.step"),
    "attn_bwd_ms.train": ("attn.bwd", "device_ms", "train.step"),
    "launches_per_step.train": ("train.step", "launches", "train.step"),
    "decode_host_ms_per_step.serve": ("serve.decode_step", "host_ms", "serve.decode_step"),
    "decode_device_ms_per_step.serve": ("serve.decode_step", "device_ms", "serve.decode_step"),
    "decode_launches_per_step.serve": ("serve.decode_step", "launches", "serve.decode_step"),
}
MIN_MATCHED = 0.99  # share of the window's device operations that must have a launch
CLOCK_PROBES = 8


class DeviceOp(NamedTuple):
    """One device operation: name, start and end ns on the device trace, and the start
    ns of the runtime call that launched it (None when none was traced)."""

    name: str
    start: int
    end: int
    launch: int | None


def device_ops(events: Iterable) -> list[DeviceOp]:
    """The device operations of a finished ``torch.profiler`` trace
    (``prof.profiler.kineto_results.events()``), each with its launch time: the start
    of the earliest host-side event that shares its correlation id, the CUDA API call
    (CUPTI's ``Command Buffer Full`` and ``Activity Buffer Request`` share it too, and
    start later, inside the call)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    launches: dict[int, int] = {}
    device = []
    for e in events:
        if e.device_type() == cuda:
            device.append(e)
        elif e.correlation_id():
            c = e.correlation_id()
            launches[c] = min(launches.get(c, e.start_ns()), e.start_ns())
    return [DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                     launches.get(e.correlation_id())) for e in device]


def launched_in(ops: list[DeviceOp], spans: list[tuple], name: str) -> list[DeviceOp]:
    """The operations launched inside a span called ``name``.  ``spans`` are
    ``(name, start ns, end ns, ...)``; spans of one name do not overlap."""
    mine = sorted((s[1], s[2]) for s in spans if s[0] == name)
    starts = [a for a, _ in mine]
    out = []
    for op in ops:
        if op.launch is None:
            continue
        i = bisect.bisect_right(starts, op.launch) - 1
        if i >= 0 and op.launch < mine[i][1]:
            out.append(op)
    return out


def device_ns(ops: list[DeviceOp]) -> int:
    """The union of the operations' device time."""
    if not ops:
        return 0
    trace = Trace([(op.name, op.start, op.end) for op in ops])
    return trace.busy_ns(min(op.start for op in ops), max(op.end for op in ops))


def span_stats(ops: list[DeviceOp], spans: list[tuple], name: str, per: int) -> dict:
    """What the spans called ``name`` launched, over ``per`` (steps): their host ms,
    the union of the device time of the operations launched in them, and those
    operations' count."""
    mine = [s for s in spans if s[0] == name]
    got = launched_in(ops, spans, name)
    return {
        "spans": len(mine),
        "host_ms": sum(s[2] - s[1] for s in mine) / 1e6 / per,
        "device_ms": device_ns(got) / 1e6 / per,
        "launches": len(got) / per,
    }


def innermost(spans: list[tuple]) -> list[tuple[str, int, int]]:
    """The time the spans cover, cut wherever one starts or ends, each piece named by
    the shortest span holding it: ``(name, start ns, end ns)`` in order."""
    cuts = sorted({x for s in spans for x in (s[1], s[2])})
    by_start = sorted(spans, key=lambda s: s[1])
    active: list[tuple] = []
    out, i = [], 0
    for x, y in zip(cuts, cuts[1:]):
        while i < len(by_start) and by_start[i][1] <= x:
            active.append(by_start[i])
            i += 1
        active = [s for s in active if s[2] > x]
        if active:
            out.append((min(active, key=lambda s: s[2] - s[1])[0], x, y))
    return out


def readings(ops: list[DeviceOp], spans: list[tuple], lo: int, hi: int) -> dict:
    """The window ``[lo, hi]``'s device operations against the program's spans.  Each
    of ``READINGS`` is None where its step span was not opened or fewer than
    ``MIN_MATCHED`` of the operations have a launch time."""
    inside = [op for op in ops if op.end > lo and op.start < hi]
    trace = Trace([(op.name, op.start, op.end) for op in inside])
    matched = sum(op.launch is not None for op in inside) / len(inside) if inside else 0.0
    count = {n: sum(s[0] == n for s in spans) for n in {s[0] for s in spans}}
    stats = {}
    for name in sorted(count):
        per = count.get("train.step") if name.startswith(("train.", "attn.")) else None
        stats[name] = span_stats(inside, spans, name, per or count[name])
    out = {
        "device_ops": len(inside),
        "launch_matched_share": matched,
        "window_s": (hi - lo) / 1e9,
        "busy_s": trace.busy_ns(lo, hi) / 1e9,
    }
    for reading, (name, field, step) in READINGS.items():
        ok = count.get(step) and matched >= MIN_MATCHED
        out[reading] = stats.get(name, {field: 0.0})[field] if ok else None
    steps = sorted((s for s in spans if s[0] == "train.step"), key=lambda s: s[1])
    if steps and out["busy_s"]:
        out["train_step_device_over_busy"] = (
            device_ns(launched_in(inside, spans, "train.step")) / 1e9 / out["busy_s"])
        out["launches_each_step"] = [len(launched_in(inside, [s], "train.step"))
                                     for s in steps]
    out["spans"] = stats
    out["idle_s_by_span"] = top(name_gaps(trace.gaps(lo, hi), innermost(spans)))
    return out


def clock_offset_us(brackets: list[tuple[int, int]], calls: list[tuple[int, int]]):
    """How far the profiler's host clock lies ahead of ``time.time_ns``, in µs: each
    bracket ``(a, b)`` of ``time.time_ns`` readings holds one traced runtime call
    ``(s, e)``, so the offset lies in ``[e - b, s - a]``.  For each bracket, the middle
    of that interval; and the widest interval.  None when they do not pair up."""
    if not calls or len(brackets) != len(calls):
        return None
    bounds = [((e - b) / 1e3, (s - a) / 1e3) for (a, b), (s, e) in zip(brackets, calls)]
    return {"mid": [round((lo + hi) / 2, 1) for lo, hi in bounds],
            "widest": max(hi - lo for lo, hi in bounds)}


def window(sess, ctx, seconds: float) -> dict:
    """One window of the cell, with harness spans and served batches of its own: the
    end-to-end metrics."""
    ctx.spans.items.clear()
    if hasattr(sess, "served"):
        sess.served.clear()
    return sess.window(seconds)["e2e"]


def profile_cell(workload: str, seed: int, seconds: float, *, root: Path = ROOT,
                 device: str = "cuda") -> dict:
    """The JSON line for one cell.  ``device="cpu"`` runs the windows without the
    profiler (CPU tests, at tiny sizes): no device operations, so no readings."""
    from portbench import run

    run.set_environment(ROOT)
    import torch

    from portbench.lib import common
    from repro_torch.obs import trace as obs_trace

    found = common.find_cell(workload, root)
    conf = found["config"]
    loop = importlib.import_module(f"portbench.loops.{conf['entry']}_{found['traffic']['kind']}")
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = types.SimpleNamespace(seed=seed, device=dev, found=found, spans=common.Spans())
    sess = loop.Cell(ctx)
    sess.setup()
    e2e = {"untraced": window(sess, ctx, seconds)}
    with obs_trace.tracing(obs_trace.Tracer()):
        e2e["tracer"] = window(sess, ctx, seconds)
    tracer = obs_trace.Tracer()
    events, brackets = [], []
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with obs_trace.tracing(tracer):
                e2e["tracer_and_profiler"] = window(sess, ctx, seconds)
            for _ in range(CLOCK_PROBES):
                a = time.time_ns()
                torch.cuda.mem_get_info()
                brackets.append((a, time.time_ns()))
        events = list(prof.profiler.kineto_results.events())
    else:
        with obs_trace.tracing(tracer):
            e2e["tracer_and_profiler"] = window(sess, ctx, seconds)
    calls = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.name() == "cudaMemGetInfo")
    spans = tracer.spans_ns()
    lo, hi = sess.counts["start"], sess.counts["end"]
    ops = device_ops(events)
    traced = types.SimpleNamespace(found=found, trace=Trace([op[:3] for op in ops]),
                                   spans=ctx.spans, counts=sess.counts, window_s=(hi - lo) / 1e9)
    benchmark = {k: v["value"] for k, v in
                 run.read_metrics(found["metrics"]["per_layer"], traced).items()}
    counts = {k: v for k, v in sess.counts.items() if k != "step_s"}
    sess.release()
    return {"workload": workload, "seed": seed,
            "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "e2e": e2e, "counts": counts, **readings(ops, spans, lo, hi),
            "benchmark_per_layer": benchmark, "clock_offset_us": clock_offset_us(brackets, calls)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    print(json.dumps(profile_cell(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
