"""Lightweight tracing spans emitting Chrome-trace / Perfetto JSON
(DESIGN.md §6.1).

The whole pipeline is instrumented with ``span("name", key=value)``
context managers — calibrate capture/fold, compress decompose buckets,
AOT warm/compile/deserialize, admission→prefill→decode per engine step,
elastic rung transitions. The contract that makes it safe to leave the
call sites in hot loops:

* **disabled is the default and costs one global read** — ``span()``
  returns a shared module-level no-op singleton when no tracer is
  installed: no object allocation, no timestamp, no lock
  (tests assert the singleton identity).
* **enabled is append-only under a lock** — events are plain dicts in
  insertion order with a monotonic sequence number, so a single engine
  thread produces a *deterministic* event order (asserted under a
  seeded ``FaultPlan``); concurrent client threads interleave safely.
* **the export is standard** — ``Tracer.to_chrome()`` emits the Chrome
  trace-event format (``{"traceEvents": [...]}`` with ``X`` complete
  spans, ``i`` instants, ``C`` counters, ``b``/``e`` async request
  spans, ``M`` thread names) that chrome://tracing and
  https://ui.perfetto.dev load directly.

Usage::

    from repro_torch.obs import trace
    with trace.tracing(out="runs/serve.trace.json"):
        with trace.span("decode_step", step=i):
            ...
    # or explicitly: t = trace.enable(); ...; trace.disable().write(path)

Device-level capture: :func:`device_trace` runs ``torch.profiler``
around a block when a log dir is given (a Chrome trace of the host ops
and the card's kernels lands there); it is a no-op otherwise.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

SCHEMA = "repro.trace/v1"

# Chrome trace event phases used here (the subset Perfetto renders):
# X complete span, i instant, C counter, b/e async begin/end, M metadata.


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path. A single
    module-level instance is returned by every ``span()`` call while
    tracing is off, so a disabled call allocates no span object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One live ``X`` (complete) event: enter stamps ``ts``, exit stamps
    ``dur`` and appends the finished event to the tracer."""

    __slots__ = ("_tracer", "_event", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self._event = {"name": name, "ph": "X", "args": args}

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        ev = self._event
        tr = self._tracer
        ev["ts"] = (self._t0 - tr.epoch_ns) / 1e3     # Chrome wants µs
        ev["dur"] = (t1 - self._t0) / 1e3
        tr._append(ev)
        return False


class Tracer:
    """Thread-safe in-memory trace buffer with a Chrome-trace exporter.

    Events keep insertion order plus a monotonic ``seq`` (stable across
    identical runs on a single engine thread — wall-clock timestamps are
    attached but never used for ordering). ``max_events`` bounds memory;
    overflow drops the *newest* events and counts them, so a runaway
    loop can't OOM the process it is meant to debug.
    """

    def __init__(self, max_events: int = 1_000_000):
        self.epoch_ns = time.perf_counter_ns()
        self.max_events = max_events
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._seq = 0
        self._pid = os.getpid()
        self._named_tids: set = set()

    # ---- event sinks (called from any thread) ----------------------------
    def _append(self, ev: Dict[str, Any]) -> None:
        tid = threading.get_ident()
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            ev["pid"] = self._pid
            ev["tid"] = tid
            ev["seq"] = self._seq
            self._seq += 1
            if tid not in self._named_tids:
                self._named_tids.add(tid)
                self.events.append(
                    {"name": "thread_name", "ph": "M", "pid": self._pid,
                     "tid": tid, "seq": -1,
                     "args": {"name": threading.current_thread().name}})
            self.events.append(ev)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        self._append({"name": name, "ph": "i", "s": "t",
                      "ts": self._now_us(), "args": args})

    def counter(self, name: str, **values) -> None:
        """A ``C`` event: Perfetto renders each kwarg as a counter track
        (used for queue depth and the elastic rung)."""
        self._append({"name": name, "ph": "C",
                      "ts": self._now_us(), "args": values})

    def async_begin(self, name: str, aid, **args) -> None:
        """Open an async span (``b``): lifetimes that cross engine steps,
        e.g. one serve request from admission to its terminal state."""
        self._append({"name": name, "ph": "b", "cat": name, "id": aid,
                      "ts": self._now_us(), "args": args})

    def async_end(self, name: str, aid, **args) -> None:
        self._append({"name": name, "ph": "e", "cat": name, "id": aid,
                      "ts": self._now_us(), "args": args})

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self.epoch_ns) / 1e3

    # ---- export ----------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (loadable by Perfetto)."""
        with self._lock:
            events = [dict(ev) for ev in self.events]
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"schema": SCHEMA,
                              "dropped_events": self.dropped}}

    def write(self, path: str) -> str:
        """Atomically write the Chrome-trace JSON to ``path``."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# Module-global switch
# ---------------------------------------------------------------------------
_tracer: Optional[Tracer] = None


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Install ``tracer`` (or a fresh one) as the global trace sink."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def disable() -> Optional[Tracer]:
    """Remove the global tracer and return it (for export)."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def current() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


def span(name: str, **args):
    """A timed span context manager, or the shared no-op singleton when
    tracing is disabled (the hot-loop fast path)."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, **args)


def instant(name: str, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **args)


def counter(name: str, **values) -> None:
    t = _tracer
    if t is not None:
        t.counter(name, **values)


def async_begin(name: str, aid, **args) -> None:
    t = _tracer
    if t is not None:
        t.async_begin(name, aid, **args)


def async_end(name: str, aid, **args) -> None:
    t = _tracer
    if t is not None:
        t.async_end(name, aid, **args)


@contextlib.contextmanager
def tracing(out: Optional[str] = None, tracer: Optional[Tracer] = None):
    """Enable tracing for a block; on exit restore the previous tracer
    and (with ``out``) write the Chrome-trace JSON there."""
    global _tracer
    prev = _tracer
    t = enable(tracer)
    try:
        yield t
    finally:
        _tracer = prev
        if out:
            t.write(out)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Optional device-level capture: runs ``torch.profiler`` (CPU
    activities, plus CUDA when a card is present) around the block when
    ``logdir`` is set and writes its Chrome trace to
    ``<logdir>/device_trace.json`` on exit; a no-op when ``logdir`` is
    falsy."""
    if not logdir:
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "device_trace.json"))


# ---------------------------------------------------------------------------
# Schema check (shared by tests and the CI chaos drill)
# ---------------------------------------------------------------------------
_PHASES = {"X", "i", "C", "M", "b", "e"}


def validate_chrome_trace(obj: Dict) -> List[str]:
    """Validate a Chrome-trace JSON object; returns a list of problems
    (empty = valid). Checks exactly what Perfetto needs to load the
    file: a ``traceEvents`` list whose members carry name/ph/pid/tid,
    known phases, µs timestamps, non-negative durations on ``X`` spans
    and ids on async events."""
    errs: List[str] = []
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errs.append(f"{where}: bad name {ev.get('name')!r}")
        ph = ev.get("ph")
        if ph not in _PHASES:
            errs.append(f"{where}: unknown phase {ph!r}")
            continue
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errs.append(f"{where}: {k} not an int")
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"{where}: ts missing")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X span with bad dur {dur!r}")
        if ph in ("b", "e") and "id" not in ev:
            errs.append(f"{where}: async event without id")
    return errs
