"""Observability: tracing spans (``trace``), the port of ``repro.obs.trace``
with the same span taxonomy.  The metrics schema, the runtime profiler and
the explain layer wait for ROADMAP item A6."""

from .trace import (
    MARK_NAMES, NULL_SPAN, SPAN_NAMES, SpanRecord, Tracer, active, mark, span, tracing,
)

__all__ = [
    "MARK_NAMES", "NULL_SPAN", "SPAN_NAMES", "SpanRecord", "Tracer", "active", "mark", "span",
    "tracing",
]
