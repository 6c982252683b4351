"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the window, with
the card's activity only, read once the window has closed.

Each device operation (kernel, copy, set) comes out as (name, start ns, end ns) on the
profiler's clock, which is ``time.time_ns``'s: the harness's spans are taken on it too,
so an idle gap can be named by the span the host was in.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Trace:
    ops: list[tuple[str, int, int]] = field(default_factory=list)

    def in_window(self, lo: int, hi: int) -> list[tuple[str, int, int]]:
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.ops if b > lo and a < hi]

    def busy_intervals(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """The union of the device's operations inside [lo, hi], as disjoint intervals."""
        merged: list[list[int]] = []
        for _, a, b in sorted(self.in_window(lo, hi), key=lambda op: op[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_ns(self, lo: int, hi: int) -> int:
        return sum(b - a for a, b in self.busy_intervals(lo, hi))

    def gaps(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """The idle intervals of [lo, hi]: no operation on the device."""
        out, t = [], lo
        for a, b in self.busy_intervals(lo, hi):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < hi:
            out.append((t, hi))
        return out

    def time_by_name(self, lo: int, hi: int) -> dict[str, float]:
        """Seconds of device time by operation name, inside [lo, hi]."""
        out: dict[str, float] = {}
        for n, a, b in self.in_window(lo, hi):
            out[n] = out.get(n, 0.0) + (b - a) / 1e9
        return out

    def matching(self, keys: tuple[str, ...]) -> list[tuple[str, int, int]]:
        """The traced operations whose name holds one of ``keys``.  The profiler runs
        around the window alone, so these are the window's, whole, whatever the skew
        between the card's clock and the host's."""
        return [op for op in self.ops if any(k in op[0] for k in keys)]


def name_gaps(gaps: list[tuple[int, int]], spans: list[tuple[str, int, int]]) -> dict[str, float]:
    """Seconds of idle device time by the harness span the host was in; time inside no
    span is ``between_spans``."""
    out: dict[str, float] = {}
    spans = sorted(spans, key=lambda s: s[1])
    j = 0
    for a, b in gaps:
        covered = 0
        while j < len(spans) and spans[j][2] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < b:
            n, s, e = spans[k]
            over = min(b, e) - max(a, s)
            if over > 0:
                out[n] = out.get(n, 0.0) + over / 1e9
                covered += over
            k += 1
        if b - a - covered > 0:
            out["between_spans"] = out.get("between_spans", 0.0) + (b - a - covered) / 1e9
    return out


def top(d: dict[str, float], k: int = 10) -> list[list]:
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


class Profiler:
    """``torch.profiler`` with the card's activity alone, around a window."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.prof = None
        self.trace = Trace()

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        import torch

        self.prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                start = e.start_ns()
                self.trace.ops.append((e.name(), start, start + e.duration_ns()))
        self.prof = None
        return False
