"""Runtime profiler: per-launch time + bytes-moved attribution for
lowered programs, against the HBM roofline.

The port of ``repro/obs/profile.py``.  An armed profiler receives one record
per launch — each fused cluster, opaque op, structured loop, and collective —
with the time of that launch and a bytes-moved estimate derived from the
inferred abstracts (inputs + output, the minimum HBM traffic a
perfectly-fused kernel would pay).  From those it derives

    achieved_gbps     = bytes_moved / time_s / 1e9
    roofline_fraction = achieved_gbps / peak_gbps      (3350 GB/s: the
                                                        H100 SXM's HBM3)

per launch site, so "fused" can be judged as "closer to the roofline",
not just "fewer launches".

Arming follows the ``faults.py`` / ``trace.py`` module-global pattern:

    prof = Profiler()
    with profiling(prof):
        f(x)                      # instrumented launches record themselves
    print(prof.attribution_table())
    prof.export_counters(tracer)  # Perfetto counter tracks (GB/s over time)

Disarmed, every hook is one module-global read returning the shared
:data:`NULL_PROBE` singleton — no allocation, no clock read.

Timing semantics: a launch on CUDA tensors is timed on the card — the hook
waits for the card to drain (``torch.cuda.synchronize``), records a CUDA
event, calls the op, records a second event and waits for it, so the time is
the launch's own and never a host reading after an asynchronous launch.  On
CPU tensors the ops run synchronously and the host clock times them.  The
instrumented lowering (``lower_graph(g, profile=True)``) is only executed by
the profiled runner (``CompileOptions.profile``) while a profiler is armed.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any

__all__ = [
    "HBM_PEAK_GBPS",
    "NULL_PROBE",
    "Profiler",
    "active",
    "call_profiled",
    "profiling",
    "timed",
]

#: the bandwidth model profiled launches are judged against: the H100 SXM's
#: 3.35 TB/s of HBM3 (NVIDIA's data sheet; ``chip_smoke.py``'s
#: ``HBM_BYTES_PER_S``)
HBM_PEAK_GBPS = 3350.0

#: launch kinds, in attribution-table order
KINDS = ("fused", "opaque", "loop", "collective")


class LaunchSite:
    """Aggregated stats for one launch site (one emitted kernel / one
    lowered op): call count, total wall, bytes per launch, and the derived
    bandwidth numbers."""

    __slots__ = ("name", "kind", "calls", "total_s", "nbytes", "min_s", "max_s")

    def __init__(self, name: str, kind: str, nbytes: int) -> None:
        self.name = name
        self.kind = kind
        self.calls = 0
        self.total_s = 0.0
        self.nbytes = int(nbytes)  # per launch, from inferred abstracts
        self.min_s = float("inf")
        self.max_s = 0.0

    def add(self, dur_s: float) -> None:
        self.calls += 1
        self.total_s += dur_s
        if dur_s < self.min_s:
            self.min_s = dur_s
        if dur_s > self.max_s:
            self.max_s = dur_s

    @property
    def mean_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0

    def achieved_gbps(self) -> float | None:
        """Bytes over mean launch wall; None when unattributable (no byte
        estimate — e.g. a loop whose body traffic the abstracts can't see)."""
        if not self.calls or not self.nbytes or self.total_s <= 0.0:
            return None
        return self.nbytes * self.calls / self.total_s / 1e9


class Profiler:
    """Bounded per-launch-site aggregation + a per-sample ring for the
    Perfetto counter export.  Thread-safe (one lock on record)."""

    def __init__(
        self, peak_gbps: float = HBM_PEAK_GBPS, max_samples: int = 4096
    ) -> None:
        self.peak_gbps = float(peak_gbps)
        self.max_samples = int(max_samples)
        self.sites: dict[tuple[str, str], LaunchSite] = {}
        #: (monotonic ts, site name, dur_s, gbps | None) — newest-wins ring
        self.samples: list[tuple[float, str, float, float | None]] = []
        self.dropped_samples = 0
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def record(self, name: str, kind: str, dur_s: float, nbytes: int) -> None:
        with self._lock:
            site = self.sites.get((name, kind))
            if site is None:
                site = self.sites[(name, kind)] = LaunchSite(name, kind, nbytes)
            site.add(dur_s)
            gbps = (nbytes / dur_s / 1e9) if (nbytes and dur_s > 0.0) else None
            if len(self.samples) < self.max_samples:
                self.samples.append((time.monotonic(), name, dur_s, gbps))
            else:
                self.dropped_samples += 1

    # -- derived views -----------------------------------------------------
    def roofline_fraction(self, gbps: float | None) -> float | None:
        """Fraction of the HBM roofline, clamped to (0, 1] — a site beating
        the model (cache-resident CPU runs) saturates at 1.0 rather than
        reporting an impossible >1 fraction."""
        if gbps is None or gbps <= 0.0:
            return None
        return min(1.0, gbps / self.peak_gbps)

    def rows(self) -> list[dict]:
        """One JSON-scalar dict per launch site, hottest first."""
        out = []
        for site in sorted(self.sites.values(), key=lambda s: -s.total_s):
            gbps = site.achieved_gbps()
            frac = self.roofline_fraction(gbps)
            out.append({
                "name": site.name,
                "kind": site.kind,
                "calls": site.calls,
                "total_ms": round(site.total_s * 1e3, 4),
                "mean_us": round(site.mean_s * 1e6, 2),
                "bytes_per_launch": site.nbytes,
                "achieved_gbps": round(gbps, 3) if gbps is not None else None,
                # 9 digits: a positive bandwidth must never round to a 0.0 fraction
                "roofline_fraction": round(frac, 9) if frac is not None else None,
            })
        return out

    def aggregate(self, kind: str | None = None) -> dict:
        """Totals over all sites (or one ``kind``): summed bytes over
        summed wall — the workload-level bandwidth the bench rows report."""
        sites = [
            s for s in self.sites.values() if kind is None or s.kind == kind
        ]
        total_s = sum(s.total_s for s in sites)
        total_bytes = sum(s.nbytes * s.calls for s in sites)
        calls = sum(s.calls for s in sites)
        gbps = (total_bytes / total_s / 1e9) if (total_bytes and total_s > 0) else None
        frac = self.roofline_fraction(gbps)
        return {
            "kind": kind or "all",
            "sites": len(sites),
            "calls": calls,
            "total_ms": round(total_s * 1e3, 4),
            "total_bytes": total_bytes,
            "achieved_gbps": round(gbps, 3) if gbps is not None else None,
            "roofline_fraction": round(frac, 9) if frac is not None else None,
        }

    def as_dict(self) -> dict:
        return {
            "peak_gbps": self.peak_gbps,
            "sites": self.rows(),
            "totals": {k: self.aggregate(k) for k in KINDS},
            "dropped_samples": self.dropped_samples,
        }

    # -- exporters ---------------------------------------------------------
    def attribution_table(self, top: int = 20) -> str:
        """The terminal view: hottest launch sites with bandwidth columns.

        ``—`` marks sites without a byte estimate (no array abstracts to
        cost, e.g. a whole structured loop); their wall time still counts."""
        lines = [
            f"{'launch site':<40} {'kind':<10} {'calls':>6} {'total_ms':>9} "
            f"{'mean_us':>9} {'GB/s':>8} {'roofline':>9}"
        ]
        for r in self.rows()[:top]:
            gbps = "—" if r["achieved_gbps"] is None else f"{r['achieved_gbps']:.1f}"
            frac = (
                "—"
                if r["roofline_fraction"] is None
                else f"{r['roofline_fraction'] * 100:.1f}%"
            )
            lines.append(
                f"{r['name']:<40} {r['kind']:<10} {r['calls']:>6} "
                f"{r['total_ms']:>9.2f} {r['mean_us']:>9.1f} {gbps:>8} {frac:>9}"
            )
        agg = self.aggregate()
        gbps = agg["achieved_gbps"]
        lines.append(
            f"{'TOTAL':<40} {'':<10} {agg['calls']:>6} {agg['total_ms']:>9.2f} "
            f"{'':>9} {gbps if gbps is not None else '—':>8} "
            f"{'' if gbps is None else format(agg['roofline_fraction'] * 100, '.1f') + '%':>9}"
        )
        if self.dropped_samples:
            lines.append(
                f"[{self.dropped_samples} samples dropped at "
                f"max_samples={self.max_samples}; aggregates unaffected]"
            )
        return "\n".join(lines)

    def export_counters(self, tracer: Any) -> int:
        """Replay the per-launch samples into ``tracer`` as Perfetto
        counter tracks: one ``profile.gbps.<site>`` series per launch site
        plus the per-launch ``profile.launch_ms`` series.  Returns the
        number of counter events emitted."""
        n = 0
        for ts, name, dur_s, gbps in self.samples:
            tracer.counter("profile.launch_ms", dur_s * 1e3, ts=ts, site=name)
            n += 1
            if gbps is not None:
                tracer.counter(f"profile.gbps.{name}", gbps, ts=ts)
                n += 1
        return n


# ---------------------------------------------------------------------------
# Module-global arming (the faults.py / trace.py pattern)
# ---------------------------------------------------------------------------

_ACTIVE: Profiler | None = None


def active() -> Profiler | None:
    """The armed profiler, or None (the production disarmed state)."""
    return _ACTIVE


@contextlib.contextmanager
def profiling(profiler: Profiler | None):
    """Arm ``profiler`` process-wide for the dynamic extent of the block.
    ``profiling(None)`` is a no-op block (mirrors ``tracing(None)``)."""
    global _ACTIVE
    prev = _ACTIVE
    if profiler is not None:
        _ACTIVE = profiler
    try:
        yield profiler
    finally:
        _ACTIVE = prev


class _NullProbe:
    """The disarmed fast path: a shared, stateless no-op probe.
    ``probe(...)`` returns this singleton without allocating anything —
    the structural-zero-overhead contract, pinned by identity in tests."""

    __slots__ = ()

    def __enter__(self) -> "_NullProbe":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_PROBE = _NullProbe()


class _LiveProbe:
    """Times one launch on the armed profiler: the card is drained on entry
    and on exit (when CUDA is in use), so the host clock sees the launch's
    whole device time."""

    __slots__ = ("_prof", "_name", "_kind", "_nbytes", "_t0")

    def __init__(self, prof: Profiler, name: str, kind: str, nbytes: int) -> None:
        self._prof = prof
        self._name = name
        self._kind = kind
        self._nbytes = nbytes
        self._t0 = time.perf_counter()

    def __enter__(self) -> "_LiveProbe":
        _drain()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            _drain()
            self._prof.record(
                self._name, self._kind, time.perf_counter() - self._t0, self._nbytes
            )
        return False


def probe(name: str, kind: str = "opaque", nbytes: int = 0):
    """A context manager timing one launch: :data:`NULL_PROBE` disarmed
    (one global read, no allocation), a live probe when armed."""
    p = _ACTIVE
    if p is None:
        return NULL_PROBE
    return _LiveProbe(p, name, kind, nbytes)


def _drain() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _on_cuda(args: tuple) -> bool:
    import torch

    stack = list(args)
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            if a.device.type == "cuda":
                return True
        elif isinstance(a, (tuple, list)):
            stack.extend(a)
    return False


def timed(fn: Any, *args: Any) -> tuple[Any, float]:
    """``(fn(*args), seconds)``.  On CUDA arguments the seconds are the card's,
    between two CUDA events around the call after the card has drained; on
    the CPU the host clock's around the (synchronous) call."""
    if _on_cuda(args):
        import torch

        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def call_profiled(fn: Any, name: str, kind: str, nbytes: int, *args: Any) -> Any:
    """The hook the instrumented lowering emits around every launch:
    disarmed it is a single global None-check and a tail call; armed it
    times ``fn(*args)`` to completion (:func:`timed`) and records one
    launch."""
    p = _ACTIVE
    if p is None:
        return fn(*args)
    out, dur = timed(fn, *args)
    p.record(name, kind, dur, nbytes)
    return out
