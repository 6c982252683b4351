"""Process-wide observability, the port of ``repro.obs``.

* ``repro_torch.obs.trace`` — nested ``span()`` context managers over a
  bounded in-memory buffer, armed via ``tracing(tracer)``, exported as
  Chrome trace-event JSON (Perfetto) or a text phase summary; the same span
  taxonomy as the reference.
* ``repro_torch.obs.metrics`` — counters / gauges / fixed-bucket histograms
  and the flat dotted-key ``snapshot()`` schema, plus the Prometheus text
  exposition (``to_prometheus``).
* ``repro_torch.obs.profile`` — the runtime profiler: per-launch time (CUDA
  events on the card) and bytes-moved attribution against the H100's HBM
  roofline, armed via ``profiling(profiler)``.
* ``repro_torch.obs.explain`` — the compile-decision explain layer:
  ``MyiaFunction.explain()`` reports, per-stage IR dumps.
"""

from .explain import ExplainReport, explain_function, explain_graph
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    flatten,
    snapshot,
    to_prometheus,
)
from .profile import NULL_PROBE, Profiler, profiling
from .trace import (
    MARK_NAMES,
    NULL_SPAN,
    SPAN_NAMES,
    SpanRecord,
    Tracer,
    active,
    mark,
    span,
    tracing,
)

__all__ = [
    "Counter",
    "ExplainReport",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "explain_function",
    "explain_graph",
    "flatten",
    "snapshot",
    "to_prometheus",
    "MARK_NAMES",
    "NULL_PROBE",
    "NULL_SPAN",
    "Profiler",
    "profiling",
    "SPAN_NAMES",
    "SpanRecord",
    "Tracer",
    "active",
    "mark",
    "span",
    "tracing",
]
