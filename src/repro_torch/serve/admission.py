"""Admission control for the continuous batcher (DESIGN.md §5).

The batcher's intake used to be an unbounded list: every ``submit``
succeeded, nothing ever aged out, and an operator had no signal before
the process OOMed or latency SLOs silently died. This module makes the
intake an explicit, deterministic policy object:

* **bounded queue with backpressure** — ``offer`` accepts or rejects
  against ``max_queue``; the caller (router, load balancer) sees the
  reject immediately and can spill to another replica.
* **per-request deadlines** — a request carries ``deadline_s`` (relative
  to submit). ``take`` sheds overdue requests *at admission time*, in
  FIFO order, before they waste a prefill: shedding work that already
  missed its SLO is the deterministic policy (no sampling, no load
  heuristics — two identical runs shed identical sets).
* **serve metrics** — one structured snapshot (queue depth/peak, shed
  and poison counters, TTFT and queue-wait percentiles, rank-bucket
  residency) shared by the engine, the degradation benchmark, the chaos
  tests and ``launch/serve.py --stats-json``, so tests assert on exactly
  the counters operators watch. The samples
  behind the percentiles live in **bounded reservoirs**
  (``obs.metrics.Histogram`` — the old per-request ``ttft_s`` lists grew
  one float per request forever) and the snapshot is the versioned
  ``repro.serve.metrics/v2`` schema, with every pre-v2 top-level key
  kept as a deprecated alias for one release.

Typed request terminal states live here too: a request ends exactly one
of ``done`` / ``shed_queue_full`` / ``shed_deadline`` / ``failed_poison``
(the poisoned path raises/records ``PoisonedRequestError``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import Histogram, MetricsRegistry

# Terminal request statuses (Request.status)
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
SHED_QUEUE_FULL = "shed_queue_full"
SHED_DEADLINE = "shed_deadline"
SHED_OVERLONG = "shed_overlong"
FAILED_POISON = "failed_poison"


class PoisonedRequestError(RuntimeError):
    """A request kept producing non-finite logits after exhausting its
    quarantine retry budget (persistent content poison or a persistently
    faulty engine)."""


@dataclass(frozen=True)
class AdmissionConfig:
    max_queue: int = 0           # queued-request bound; 0 = unbounded
    default_deadline_s: Optional[float] = None  # applied when a request
    #                              carries no deadline of its own
    max_retries: int = 2         # poison-quarantine re-queue budget
    reject_overlong: bool = False  # shed prompts > max_len - 1 instead of
    #                              silently truncating to the newest tokens
    # --- elastic-rank degradation ladder ---------------------------------
    elastic: bool = False        # enable serve-time rank degradation
    elastic_levels: int = 2      # degraded pow2 buckets below full rank
    degrade_above: int = 4       # queue depth that drops one rank level
    restore_below: int = 1       # queue depth that restores one level


class ServeMetrics:
    """Counters + latency reservoirs behind ``ContinuousBatcher.metrics()``.

    Backed by an ``obs.metrics.MetricsRegistry``: counters are typed,
    latency samples go into bounded reservoirs (fixed memory no matter
    how many requests pass through — the pre-v2 ``ttft_s``/
    ``queue_wait_s`` lists grew unboundedly), and ``snapshot()`` emits
    the versioned v2 schema with the legacy keys preserved as a
    deprecated alias for one release.
    """

    COUNTER_KEYS = ("submitted", "accepted", "completed",
                    "shed_queue_full", "shed_deadline", "shed_overlong",
                    "poison_events", "poison_retries", "poison_failures",
                    "slot_purges", "steps", "prompt_truncations",
                    "prefix_hits", "prefix_misses", "prefix_evictions",
                    "cow_forks")

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        for k in self.COUNTER_KEYS:
            self.registry.counter(k)
        self.registry.gauge("queue_depth")
        self.registry.gauge("peak_queue_depth")
        self.registry.gauge("rank_level")
        self._ttft = self.registry.histogram("ttft_ms")
        self._queue_wait = self.registry.histogram("queue_wait_ms")
        self._step = self.registry.histogram("step_ms")
        self.rank_residency: Dict[int, int] = {}   # level -> steps spent

    def bump(self, key: str, n: int = 1) -> None:
        self.registry.counter(key).inc(n)

    def count(self, key: str) -> int:
        return self.registry.counter(key).value

    @property
    def counters(self) -> Dict[str, int]:
        """Legacy read surface (pre-v2 callers indexed a plain dict)."""
        out = {k: c.value for k, c in self.registry.counters.items()}
        out["peak_queue_depth"] = int(
            self.registry.gauges["peak_queue_depth"].value)
        return out

    def observe_queue_depth(self, depth: int) -> None:
        self.registry.gauge("queue_depth").set(depth)
        self.registry.gauge("peak_queue_depth").set_max(depth)

    def observe_ttft(self, seconds: float) -> None:
        self._ttft.observe(seconds * 1e3)

    def observe_queue_wait(self, seconds: float) -> None:
        self._queue_wait.observe(seconds * 1e3)

    def observe_step_ms(self, ms: float) -> None:
        self._step.observe(ms)

    def step_at_level(self, level: int) -> None:
        self.registry.counter("steps").inc()
        self.registry.gauge("rank_level").set(level)
        self.rank_residency[level] = self.rank_residency.get(level, 0) + 1

    @staticmethod
    def _pcts(hist: Histogram) -> Dict[str, float]:
        """Legacy ``{p50_ms, p95_ms, mean_ms, n}`` block from a
        millisecond reservoir. Exact on 0 samples (all-zero with
        ``n == 0``, so "no data" is distinguishable from a measured
        0 ms) and on 1 sample (that sample at every percentile)."""
        s = hist.summary()
        return {"p50_ms": s["p50"], "p95_ms": s["p95"],
                "mean_ms": s["mean"], "n": s["n"]}

    def snapshot(self, queue_depth: int, rank_level: int,
                 engine_stats: Optional[Dict[str, int]] = None) -> Dict:
        """The serve-metrics snapshot: everything an operator would
        watch, as the versioned ``repro.serve.metrics/v2`` schema
        (``schema`` / ``counters`` / ``gauges`` / ``histograms`` /
        ``rank_residency``). ``engine_stats`` folds the batcher's
        jit-retrace and AOT counters into the same ``counters`` block —
        one surface for all three historical stats shapes.

        Every pre-v2 top-level key (``submitted``, ``ttft`` with
        ``*_ms`` percentiles, ``engine``, ...) is still present as a
        **deprecated alias** for one release; consumers should move to
        the typed blocks."""
        self.registry.gauge("queue_depth").set(queue_depth)
        self.registry.gauge("rank_level").set(rank_level)
        residency = {str(k): v for k, v in
                     sorted(self.rank_residency.items())}
        out = self.registry.snapshot(
            extra={"rank_residency": residency})
        if engine_stats:
            out["counters"].update(engine_stats)
        # ---- deprecated legacy aliases (one release) ----------------------
        out.update(self.counters)
        out["queue_depth"] = queue_depth
        out["rank_level"] = rank_level
        out["ttft"] = self._pcts(self._ttft)
        out["queue_wait"] = self._pcts(self._queue_wait)
        if engine_stats:
            out["engine"] = dict(engine_stats)
        return out


class AdmissionController:
    """Owns the wait queue; all accept/shed decisions happen here.

    Determinism contract: decisions depend only on (submission order,
    queue bound, request deadlines, the ``now`` values the engine passes
    in). Two runs that submit the same requests in the same order against
    the same config shed/reject the same rids — asserted by the chaos
    suite.
    """

    def __init__(self, cfg: AdmissionConfig, metrics: ServeMetrics):
        self.cfg = cfg
        self.metrics = metrics
        self.queue: List = []          # waiting Requests, FIFO
        self.rejected: List = []       # shed at submit (queue full)
        self.shed: List = []           # shed while queued (deadline)

    def depth(self) -> int:
        return len(self.queue)

    def offer(self, req, now: float) -> bool:
        """Admit ``req`` to the wait queue or reject it (backpressure).
        Returns True iff accepted; a reject marks the request
        ``shed_queue_full`` and keeps it in ``rejected``."""
        self.metrics.bump("submitted")
        req.t_submit = now
        if req.deadline_s is None:
            req.deadline_s = self.cfg.default_deadline_s
        if self.cfg.max_queue and len(self.queue) >= self.cfg.max_queue:
            req.status = SHED_QUEUE_FULL
            self.metrics.bump("shed_queue_full")
            self.rejected.append(req)
            return False
        req.status = QUEUED
        self.metrics.bump("accepted")
        self.queue.append(req)
        self.metrics.observe_queue_depth(len(self.queue))
        return True

    def requeue(self, req) -> None:
        """Put a quarantined request back at the head of the queue (it
        already waited its turn; retrying behind the backlog would let
        one transient fault double a request's latency)."""
        req.status = QUEUED
        self.queue.insert(0, req)
        self.metrics.observe_queue_depth(len(self.queue))

    def take(self, n: int, now: float) -> Tuple[List, List]:
        """Dequeue up to ``n`` admissible requests; shed overdue ones.

        Walks the queue in FIFO order: a request whose deadline has
        already passed while waiting is shed (``shed_deadline``) — it can
        no longer meet its SLO, and prefilling it would only push the
        requests behind it over theirs. Returns (admitted, shed)."""
        admitted: List = []
        shed: List = []
        keep: List = []
        for req in self.queue:
            overdue = (req.deadline_s is not None
                       and now - req.t_submit > req.deadline_s)
            if overdue:
                req.status = SHED_DEADLINE
                shed.append(req)
            elif len(admitted) < n:
                req.status = RUNNING
                req.t_admit = now
                self.metrics.observe_queue_wait(now - req.t_submit)
                admitted.append(req)
            else:
                keep.append(req)
        self.queue[:] = keep
        if shed:
            self.metrics.bump("shed_deadline", len(shed))
            self.shed.extend(shed)
        return admitted, shed
