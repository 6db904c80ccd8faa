"""Typed metrics registry: counters, gauges and bounded-reservoir
histograms behind one versioned snapshot schema (DESIGN.md §6.2).

Serving stats used to live in three ad-hoc shapes —
``ServeMetrics.snapshot()``, ``ContinuousBatcher.stats`` and the AOT
``aot_*`` counters — and the latency samples behind the percentile
helpers grew one float per request, forever. This module gives them one
home:

* **Counter / Gauge / Histogram** are the only metric types. A
  histogram is a *bounded reservoir* (Vitter's Algorithm R with a
  deterministic per-name seed): memory is O(capacity) no matter how
  many samples arrive, every sample still updates exact ``n``/``sum``/
  ``min``/``max``, and percentiles come from the uniform reservoir.
* **MetricsRegistry.snapshot()** emits the versioned schema
  ``{"schema": "repro.serve.metrics/v2", "counters": ..., "gauges":
  ..., "histograms": ...}`` — the one shape ``--stats-json``, the
  periodic exporter and the tests all consume.
* **Exposition**: :func:`prometheus_text` renders a snapshot in the
  Prometheus text format (served by :class:`MetricsServer` on
  ``--metrics-port``); :class:`MetricsExporter` writes snapshot JSON to
  a path on a fixed cadence (``--metrics-json``).
"""
from __future__ import annotations

import json
import os
import random
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional

SCHEMA = "repro.serve.metrics/v2"

DEFAULT_RESERVOIR = 1024


class Counter:
    """Monotonic int counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins value; ``set_max`` keeps the peak."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def add(self, delta: float) -> None:
        self.value += delta

    def set_max(self, v: float) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Bounded uniform reservoir (Algorithm R).

    The first ``capacity`` samples are kept verbatim; sample ``i`` (>
    capacity) replaces a uniformly-chosen slot with probability
    ``capacity/i``. The RNG is seeded from the metric name, so two runs
    observing the same sample stream keep identical reservoirs —
    deterministic percentiles under the chaos suite's seeded plans.
    ``n``/``sum``/``min``/``max`` are exact over ALL samples regardless
    of capacity.
    """

    __slots__ = ("name", "capacity", "samples", "n", "sum",
                 "min", "max", "_rng")

    def __init__(self, name: str, capacity: int = DEFAULT_RESERVOIR):
        if capacity < 1:
            raise ValueError(f"reservoir capacity must be >= 1: {capacity}")
        self.name = name
        self.capacity = capacity
        self.samples: List[float] = []
        self.n = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._rng = random.Random(name)

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self.samples) < self.capacity:
            self.samples.append(v)
        else:
            j = self._rng.randrange(self.n)
            if j < self.capacity:
                self.samples[j] = v

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile of the reservoir; 0.0 when no
        samples have been observed (``n == 0`` disambiguates a true 0ms
        from "no data" — the old ``_pcts`` helper conflated them)."""
        s = sorted(self.samples)
        if not s:
            return 0.0
        if len(s) == 1:
            return s[0]
        pos = (q / 100.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def summary(self, scale: float = 1.0, round_to: int = 3
                ) -> Dict[str, Any]:
        """The stable summary shape: p50/p95/mean (scaled, e.g. 1e3 for
        s→ms) plus exact n. Safe on 0 and 1 samples."""
        if self.n == 0:
            return {"p50": 0.0, "p95": 0.0, "mean": 0.0, "n": 0,
                    "min": 0.0, "max": 0.0}
        return {"p50": round(self.percentile(50) * scale, round_to),
                "p95": round(self.percentile(95) * scale, round_to),
                "mean": round(self.sum / self.n * scale, round_to),
                "n": self.n,
                "min": round(self.min * scale, round_to),
                "max": round(self.max * scale, round_to)}


class MetricsRegistry:
    """Get-or-create home for every metric; one versioned snapshot out."""

    def __init__(self, reservoir: int = DEFAULT_RESERVOIR):
        self.reservoir = reservoir
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  capacity: Optional[int] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(
                name, capacity or self.reservoir)
        return h

    def snapshot(self, extra: Optional[Dict] = None,
                 hist_scales: Optional[Dict[str, float]] = None
                 ) -> Dict[str, Any]:
        """The versioned snapshot: every counter/gauge value and every
        histogram summary, JSON-serializable as-is. ``hist_scales`` maps
        histogram name → multiplier applied in its summary (seconds
        histograms export as ms). ``extra`` merges additional top-level
        sections (e.g. the deprecated legacy aliases)."""
        scales = hist_scales or {}
        out: Dict[str, Any] = {
            "schema": SCHEMA,
            "counters": {n: c.value for n, c in sorted(
                self.counters.items())},
            "gauges": {n: g.value for n, g in sorted(self.gauges.items())},
            "histograms": {n: h.summary(scale=scales.get(n, 1.0))
                           for n, h in sorted(self.histograms.items())},
        }
        if extra:
            out.update(extra)
        return out


# ---------------------------------------------------------------------------
# Exposition
# ---------------------------------------------------------------------------
def _prom_name(name: str) -> str:
    out = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
    return out if not out[:1].isdigit() else "_" + out


def prometheus_text(snapshot: Dict[str, Any], prefix: str = "repro",
                    labels: Optional[Dict[str, str]] = None) -> str:
    """Render a (v2) snapshot in the Prometheus text exposition format:
    counters/gauges verbatim, histogram summaries as
    ``<name>{quantile=...}`` plus ``_sum``-less ``_count``/``_mean``
    series. Works on any snapshot dict — including one replica's from a
    router — so the server can merge several registries."""
    lab = dict(labels or {})

    def fmt(extra: Optional[Dict[str, str]] = None) -> str:
        items = {**lab, **(extra or {})}
        if not items:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
        return "{" + inner + "}"

    lines: List[str] = []
    for name, v in snapshot.get("counters", {}).items():
        m = f"{prefix}_{_prom_name(name)}_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{fmt()} {v}")
    for name, v in snapshot.get("gauges", {}).items():
        m = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{fmt()} {v}")
    for name, s in snapshot.get("histograms", {}).items():
        m = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# TYPE {m} summary")
        lines.append(f'{m}{fmt({"quantile": "0.5"})} {s["p50"]}')
        lines.append(f'{m}{fmt({"quantile": "0.95"})} {s["p95"]}')
        lines.append(f"{m}_count{fmt()} {s['n']}")
        lines.append(f"{m}_mean{fmt()} {s['mean']}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Daemon thread writing snapshot JSON to a path every
    ``interval_s`` (atomic replace), plus once on ``stop()`` so short
    runs still leave a final snapshot. ``supplier`` returns the object
    to serialize — one registry snapshot, or a merged multi-replica
    shape; the exporter doesn't care."""

    def __init__(self, path: str, supplier: Callable[[], Any],
                 interval_s: float = 1.0):
        self.path = path
        self.supplier = supplier
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write_once(self) -> str:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self.supplier(), f, indent=1)
        os.replace(tmp, self.path)
        return self.path

    def start(self) -> "MetricsExporter":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="metrics-exporter", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write_once()
            except Exception:
                # a racing engine thread can mutate mid-snapshot; the
                # next tick writes a clean one — never kill the cadence
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.write_once()


class MetricsServer:
    """Minimal Prometheus scrape endpoint: ``GET /metrics`` returns
    ``supplier()`` rendered through :func:`prometheus_text` per replica.
    ``supplier`` returns a list of snapshot dicts (one per replica —
    labeled ``replica="i"``). ``port=0`` binds an ephemeral port
    (``.port`` reports the bound one — tests use this)."""

    def __init__(self, supplier: Callable[[], List[Dict]], port: int = 0,
                 host: str = "127.0.0.1"):
        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):                      # noqa: N802 (stdlib API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                snaps = outer.supplier()
                body = "".join(
                    prometheus_text(s, labels={"replica": str(i)})
                    for i, s in enumerate(snaps)).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):              # silence per-request spam
                pass

        self.supplier = supplier
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="metrics-server",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
