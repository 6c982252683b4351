"""Unified metrics: counters / gauges / fixed-bucket histograms behind one
flat, dotted-key ``snapshot()`` schema.

The port of ``repro/obs/metrics.py`` (pure Python, unchanged in behaviour):
the same schema, so the port's ``snapshot()`` and Prometheus exposition carry
the reference's metric names.  The port's ``CacheStats`` names its compile
counter ``programs_built`` where the reference's says ``xla_compiles``.

The repo grew three incompatible counter surfaces — ``OptStats.as_dict()``
(nested rule-hit dicts), ``CacheStats.as_dict()`` (flat but its own
names), and the serve engine's ad-hoc stats dict — so every bench writer
invented its own JSON keys and ``check_bench.py`` had to know all of
them.  This module is the single schema:

    snapshot(opt=opt_stats, cache=cache.stats, serve=engine_stats)
    # -> {"opt.rule_hits.gadd_zero": 31, "opt.inlined_calls": 12,
    #     "cache.hits": 4, "serve.statuses.ok": 8, ...}

Rules of the schema:

* keys are dotted paths, prefix = the subsystem argument name,
* every leaf is a JSON scalar (int / float / str / None); nested dicts
  flatten into further dotted segments; lists of scalars stay lists,
* anything exposing ``as_dict()`` (OptStats, CacheStats) is absorbed
  as-is — the legacy surfaces keep working and gain one canonical view.

Histograms use fixed bucket boundaries (no deps, no reservoir): ``p50``/
``p90``/``p99`` are upper-bound estimates from the first bucket whose
cumulative count crosses the quantile — exactly the Prometheus
``histogram_quantile`` contract, coarse but monotone and mergeable.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "flatten",
    "snapshot",
    "to_prometheus",
]

#: default bucket upper bounds for latency histograms, in milliseconds —
#: ~log-spaced from sub-ms decode steps to multi-second cold compiles
DEFAULT_MS_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class Counter:
    """A monotone counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max and quantile bounds.

    ``buckets`` are upper bounds (an implicit +inf bucket is appended).
    ``observe`` is O(log B) (bisect); no per-sample storage, so an armed
    serve engine can observe every decode step forever in O(B) memory."""

    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Iterable[float] = DEFAULT_MS_BUCKETS) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        import bisect

        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float | None:
        """Upper bound of the bucket where the ``q``-quantile falls (the
        true max for the overflow bucket), or None when empty."""
        if not self.count:
            return None
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.buckets[i] if i < len(self.buckets) else self.max
        return self.max

    def as_dict(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": round(self.sum, 4),
            "mean": round(self.sum / self.count, 4),
            "min": round(self.min, 4),
            "max": round(self.max, 4),
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named metrics, created on first touch.

    One registry per subsystem instance (a serve engine, a bench run);
    ``snapshot(m=registry)`` flattens it into the shared schema."""

    def __init__(self) -> None:
        self._metrics: dict[str, Any] = {}

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets: Iterable[float] = DEFAULT_MS_BUCKETS) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(buckets)
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, not Histogram")
        return m

    def _get(self, name: str, cls: type) -> Any:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, not {cls.__name__}")
        return m

    def as_dict(self) -> dict:
        out: dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
            else:
                out[name] = m.as_dict()
        return out


def flatten(value: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten nested dicts into dotted keys; scalars and scalar lists are
    leaves; objects exposing ``as_dict()`` are absorbed through it."""
    if hasattr(value, "as_dict"):
        value = value.as_dict()
    out: dict[str, Any] = {}
    if isinstance(value, dict):
        for k, v in value.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            out.update(flatten(v, key))
        return out
    if isinstance(value, (list, tuple)):
        out[prefix] = [x if _scalar(x) else repr(x) for x in value]
        return out
    out[prefix] = value if _scalar(value) else repr(value)
    return out


def _scalar(v: Any) -> bool:
    return v is None or isinstance(v, (str, int, float, bool))


def _prom_name(name: str) -> str:
    """A legal Prometheus metric name: dotted keys become underscores,
    anything outside ``[a-zA-Z0-9_:]`` is replaced, leading digits get a
    prefix."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if not out or out[0].isdigit():
        out = "m_" + out
    return out


def to_prometheus(registry: "MetricsRegistry | None" = None, *, extra: Any = None) -> str:
    """Prometheus text exposition (format 0.0.4) of ``registry`` plus an
    optional ``extra`` source of scalars (a dict / anything ``flatten``
    absorbs, e.g. ``snapshot(serve=engine.stats())``).

    Counters and gauges emit one sample each; histograms emit the full
    ``_bucket{le="..."}`` cumulative series (including ``+Inf``) plus
    ``_sum`` and ``_count`` — exactly what ``histogram_quantile`` needs.
    Non-numeric extra leaves are skipped (exposition is numbers-only)."""
    lines: list[str] = []
    if registry is not None:
        for name, m in sorted(registry._metrics.items()):
            pname = _prom_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                acc = 0
                for ub, c in zip(m.buckets, m.counts):
                    acc += c
                    lines.append(f'{pname}_bucket{{le="{ub:g}"}} {acc}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {m.sum}")
                lines.append(f"{pname}_count {m.count}")
    if extra is not None:
        for key, v in sorted(flatten(extra).items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue  # exposition carries numbers only
            pname = _prom_name(key)
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {v}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot(**sources: Any) -> dict[str, Any]:
    """The one metrics surface: flatten every named source into a single
    flat dotted-key dict.

        snapshot(opt=OptStats(), cache=CacheStats(), serve=engine.stats())

    Sources may be ``OptStats`` / ``CacheStats`` / ``MetricsRegistry``
    (anything with ``as_dict()``), plain dicts, or None (skipped) —
    benches and ``check_bench.py`` read this instead of each subsystem's
    private counter names."""
    out: dict[str, Any] = {}
    for prefix, src in sorted(sources.items()):
        if src is None:
            continue
        out.update(flatten(src, prefix))
    return out
