"""Unified observability for the compression→serve pipeline
(DESIGN.md §6): tracing spans (``obs.trace``), the typed metrics
registry (``obs.metrics``) and the flight recorder (``obs.flightrec``).

The three share one philosophy: **near-zero cost when off, one schema
when on**. Tracing is a module-global switch — every ``span(...)`` call
sites throughout ``core/`` and ``serve/`` collapse to a shared no-op
singleton until a tracer is installed. Metrics are always on (bounded:
counters and fixed-size reservoirs, never per-request lists). The
flight recorder is always on too (a ring buffer) but only writes an
artifact when something goes wrong and a dump directory is configured.
"""
from repro_torch.obs import flightrec, metrics, trace  # noqa: F401

__all__ = ["trace", "metrics", "flightrec"]
