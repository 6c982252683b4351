"""Process-wide tracing: nested spans over the compile pipeline and the
serving runtime, exportable to Chrome trace-event JSON (loads directly in
Perfetto / ``chrome://tracing``) or a text phase summary.

The ROADMAP's compile-time item starts with "profile and fix the
superlinear costs" — impossible while timing exists only as scattered,
schema-incompatible counters.  This module gives every pipeline phase
(parse → AD → infer → optimize → closure-elim → fuse → lower) and
every serve-request lifecycle step one shared, structured instrument:

    tracer = Tracer()
    with tracing(tracer):
        f(x)                        # compile spans recorded as a side effect
    tracer.write_chrome_trace("out.json")   # open in https://ui.perfetto.dev
    print(tracer.phase_summary())

Design rules (the pattern of the reference's ``serve.faults``):

* **module-global hook, None-check fast path** — instrumentation sites
  call ``span("optimize")`` unconditionally; when no tracer is armed the
  call is one global read returning a shared singleton null span, and the
  hot paths (worklist pops, decode steps) do **zero** buffer work.  The
  disarmed-overhead test in ``tests/obs/test_trace.py`` pins this.
* **exception safety** — ``span`` is a context manager; the record is
  closed (with an ``error`` attr) even when the body raises, so a failing
  compile phase still shows up with its true duration.
* **bounded buffer** — the tracer keeps at most ``max_events`` records
  (drops counted in ``dropped``, peak occupancy in ``high_water``), so an
  armed long-running server cannot leak memory through its telemetry.

Span taxonomy: see ``docs/observability.md`` for the full table mapping
each pipeline stage to its span name.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any

__all__ = [
    "MARK_NAMES",
    "NULL_SPAN",
    "SPAN_NAMES",
    "SpanRecord",
    "Tracer",
    "active",
    "mark",
    "span",
    "tracing",
]

#: The span-name taxonomy: every legal ``span(...)`` name, one place.
#:
#: ``check_bench.py`` gates metrics derived from these exact strings
#: (``pipeline_phase_ms.optimize`` descends by span name), so a renamed
#: or ad-hoc span silently un-arms a CI gate.  Both the registry test
#: (``tests/obs/test_trace.py``) and the ``scripts/lint.py`` AST check
#: fail on a ``span("...")`` literal that is not listed here — add new
#: names HERE first, then use them.
SPAN_NAMES = frozenset({
    # compile pipeline (see docs/observability.md for the stage mapping)
    "parse",
    "ad.grad",
    "specialize",
    "compile_pipeline",
    "clone",
    "infer",
    "optimize",
    "opt.rules",
    "opt.inline_wave",
    "opt.defunctionalize",
    "closure.lower_loops",
    "closure.analyze_blockers",
    "fuse.partition",
    "lower",
    "xla.compile",
    "xla.tier0_compile",
    # cache tiers (AOT executables + optimized graphs)
    "cache.lookup",
    "cache.write",
    "cache.graph_lookup",
    "cache.graph_write",
    # serving runtime
    "serve.prefill",
    "serve.decode_step",
    # runtime profiler / explain layer
    "explain.report",
})

#: Every legal ``mark(...)`` (instant event) name — same contract as
#: :data:`SPAN_NAMES` (``serve.engine.request_telemetry`` reconstructs
#: request lifecycles from these exact strings).
MARK_NAMES = frozenset({
    "serve.submit",
    "serve.admitted",
    "serve.first_token",
    "serve.terminal",
})


class SpanRecord:
    """One closed (or still-open) span: name, wall-clock interval, nesting
    depth, thread, and structured attributes.  ``t0``/``t1`` are
    ``time.monotonic()`` timestamps (the same clock the serve engine uses
    for TTFT/deadlines, so span math and engine telemetry agree exactly);
    instant marks have ``t1 == t0``."""

    __slots__ = ("name", "t0", "t1", "depth", "tid", "attrs", "kind")

    def __init__(
        self, name: str, t0: float, depth: int, tid: int, attrs: dict, kind: str = "span"
    ) -> None:
        self.name = name
        self.t0 = t0
        self.t1: float | None = None
        self.depth = depth
        self.tid = tid
        self.attrs = attrs
        self.kind = kind  # "span" (duration) | "mark" (instant) | "counter" (sample)

    @property
    def dur_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "dur_ms": round(self.dur_s * 1e3, 4),
            "depth": self.depth,
            "tid": self.tid,
            "kind": self.kind,
            "attrs": dict(self.attrs),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SpanRecord({self.name!r}, dur={self.dur_s * 1e3:.2f}ms, {self.attrs!r})"


class _LiveSpan:
    """Context manager for one armed span.  Closes its record exactly once
    — on normal exit or on raise (the exception type lands in the record's
    ``error`` attr and propagates)."""

    __slots__ = ("_tracer", "_rec")

    def __init__(self, tracer: "Tracer", rec: SpanRecord) -> None:
        self._tracer = tracer
        self._rec = rec

    def set(self, **attrs: Any) -> "_LiveSpan":
        """Attach attributes discovered mid-span (counts, cache verdicts)."""
        self._rec.attrs.update(attrs)
        return self

    @property
    def dur_s(self) -> float:
        """Duration once closed (0.0 while open) — lets a call site feed a
        histogram from the span it already paid the clock reads for."""
        return self._rec.dur_s

    def __enter__(self) -> "_LiveSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self._rec
        rec.t1 = time.monotonic()
        if exc_type is not None:
            rec.attrs["error"] = exc_type.__name__
        self._tracer._close(rec)
        return False  # never swallow


class _NullSpan:
    """The disarmed fast path: a shared, stateless, reusable no-op span.
    ``span(...)`` returns this singleton without allocating anything."""

    __slots__ = ()

    dur_s = 0.0

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """A bounded in-memory span buffer plus export/aggregation helpers.

    Thread-aware (per-thread depth tracking, a lock only on record append)
    but cheap: one armed span costs two ``time.monotonic()`` calls, one
    small object, and one list append."""

    def __init__(self, max_events: int = 100_000) -> None:
        self.max_events = int(max_events)
        self.events: list[SpanRecord] = []
        self.dropped = 0
        #: peak buffer occupancy — benches record this next to wall time so
        #: a trajectory diff can tell "bench got slower" from
        #: "instrumentation got heavier"
        self.high_water = 0
        self._lock = threading.Lock()
        self._depth = threading.local()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, attrs: dict) -> _LiveSpan:
        depth = getattr(self._depth, "d", 0)
        self._depth.d = depth + 1
        rec = SpanRecord(
            name, time.monotonic(), depth, threading.get_ident(), attrs
        )
        return _LiveSpan(self, rec)

    def _close(self, rec: SpanRecord) -> None:
        self._depth.d = max(getattr(self._depth, "d", 1) - 1, 0)
        self._append(rec)

    def mark(self, name: str, attrs: dict, ts: float | None = None) -> None:
        """Record an instant event (``ts`` defaults to now; pass an
        explicit timestamp to pin the mark to an externally measured
        moment, e.g. the engine's ``submitted_at``)."""
        t = time.monotonic() if ts is None else ts
        rec = SpanRecord(
            name, t, getattr(self._depth, "d", 0), threading.get_ident(), attrs,
            kind="mark",
        )
        rec.t1 = t
        self._append(rec)

    def counter(self, name: str, value: float, ts: float | None = None, **attrs) -> None:
        """Record one sample of a counter track (a time series, e.g. the
        profiler's achieved-GB/s per launch).  Exports as a Chrome ``C``
        (counter) event, which Perfetto renders as a stacked track."""
        t = time.monotonic() if ts is None else ts
        rec = SpanRecord(
            name, t, 0, threading.get_ident(),
            {"value": float(value), **attrs}, kind="counter",
        )
        rec.t1 = t
        self._append(rec)

    def _append(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(rec)
            if len(self.events) > self.high_water:
                self.high_water = len(self.events)

    # -- queries -----------------------------------------------------------
    def find(self, name: str) -> list[SpanRecord]:
        return [e for e in self.events if e.name == name]

    def total_s(self, name: str) -> float:
        return sum(e.dur_s for e in self.find(name))

    def phase_totals_ms(self, parent: str | None = None) -> dict[str, float]:
        """Aggregate span durations by name, in ms.

        With ``parent`` given, only spans strictly one level below the
        first ``parent`` span's depth AND inside its interval are counted
        — the direct-child phase breakdown whose sum approximates the
        parent's own duration (the ``pipeline_phase_ms`` bench metric)."""
        out: dict[str, float] = {}
        if parent is None:
            for e in self.events:
                if e.kind == "span":
                    out[e.name] = out.get(e.name, 0.0) + e.dur_s * 1e3
            return {k: round(v, 3) for k, v in out.items()}
        roots = self.find(parent)
        if not roots:
            return {}
        p = roots[0]
        for e in self.events:
            if (
                e.kind == "span"
                and e.depth == p.depth + 1
                and e.t0 >= p.t0
                and (e.t1 or e.t0) <= (p.t1 or float("inf"))
            ):
                out[e.name] = out.get(e.name, 0.0) + e.dur_s * 1e3
        return {k: round(v, 3) for k, v in out.items()}

    # -- exporters ---------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The buffer as a Chrome trace-event JSON object (the ``X``
        complete-event / ``i`` instant-event flavor) — loads unmodified in
        Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``.
        Timestamps are rebased to the earliest event so the viewer opens
        at t=0."""
        if self.events:
            base = min(e.t0 for e in self.events)
        else:
            base = 0.0
        evs = []
        for e in self.events:
            args = {k: _jsonable(v) for k, v in e.attrs.items()}
            row: dict[str, Any] = {
                "name": e.name,
                "cat": e.name.split(".", 1)[0],
                "pid": 1,
                "tid": e.tid % 1_000_000,
                "ts": round((e.t0 - base) * 1e6, 1),
                "args": args,
            }
            if e.kind == "mark":
                row["ph"] = "i"
                row["s"] = "t"  # thread-scoped instant
            elif e.kind == "counter":
                row["ph"] = "C"  # Perfetto counter track: args are series
                row["args"] = {"value": args.get("value", 0.0)}
            else:
                row["ph"] = "X"
                row["dur"] = round(e.dur_s * 1e6, 1)
            evs.append(row)
        return {
            "traceEvents": evs,
            "displayTimeUnit": "ms",
            "otherData": {"dropped": self.dropped, "high_water": self.high_water},
        }

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)

    def phase_summary(self, top: int = 20) -> str:
        """A text flame-ish summary: per-name total / count / mean,
        sorted by total time — the terminal-friendly first look before
        opening the full trace in Perfetto."""
        agg: dict[str, tuple[float, int]] = {}
        for e in self.events:
            if e.kind != "span":
                continue
            tot, n = agg.get(e.name, (0.0, 0))
            agg[e.name] = (tot + e.dur_s, n + 1)
        lines = [f"{'span':<32} {'total_ms':>10} {'count':>7} {'mean_ms':>9}"]
        for name, (tot, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]:
            lines.append(f"{name:<32} {tot * 1e3:>10.2f} {n:>7} {tot * 1e3 / n:>9.3f}")
        if self.dropped:
            lines.append(f"[{self.dropped} events dropped at max_events={self.max_events}]")
        return "\n".join(lines)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


# ---------------------------------------------------------------------------
# Module-global arming (the faults.py pattern: None-check fast path)
# ---------------------------------------------------------------------------

_ACTIVE: Tracer | None = None


def active() -> Tracer | None:
    """The armed tracer, or None (the production disarmed state)."""
    return _ACTIVE


@contextlib.contextmanager
def tracing(tracer: Tracer | None):
    """Arm ``tracer`` process-wide for the dynamic extent of the block.
    ``tracing(None)`` is a no-op block, so call sites can thread an
    optional tracer without branching."""
    global _ACTIVE
    prev = _ACTIVE
    if tracer is not None:
        _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


def span(name: str, **attrs: Any):
    """Open a span named ``name`` on the armed tracer.

    Disarmed, this is the hot-path fast exit: one global read, return the
    shared :data:`NULL_SPAN` — no allocation, no clock read, no buffer
    work (pinned by the disarmed-overhead test)."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.span(name, attrs)


def mark(name: str, ts: float | None = None, **attrs: Any) -> None:
    """Record an instant event on the armed tracer (no-op disarmed)."""
    t = _ACTIVE
    if t is None:
        return
    t.mark(name, attrs, ts=ts)
