"""Observability helpers (scheduler counters, profiler spans) and the
benchmark corpus."""

from .metrics import Metrics, trace_span  # noqa: F401
