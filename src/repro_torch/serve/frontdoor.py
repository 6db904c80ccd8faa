"""Serving front door: async request intake decoupled from the step
loop, per-token streaming output, and a multi-replica router
(counterpart of ``repro/serve/frontdoor.py``; DESIGN.md §5.6).

``ContinuousBatcher`` is a synchronous object: callers submit, then
somebody drives ``step()``. The front door turns it into a service:

* **FrontDoor** owns one engine thread that drives the step loop and a
  bounded *intake* queue that any number of client threads write into
  (``submit`` is non-blocking: a full intake queue is immediate
  backpressure, before the admission queue is even consulted). Each
  accepted request gets a :class:`TokenStream` — tokens arrive on it as
  the engine emits them, not when the request completes.
* **Router** fronts N replicas (one ``FrontDoor`` + engine each) behind
  a single ``submit``: requests route to the least-loaded replica using
  the resilience layer's signals — intake depth, admission-queue depth,
  busy slots — and spill to the next replica when one pushes back. The
  routing logic only reads those metrics, so the same policy fronts
  in-process replicas here or engine processes behind a socket transport.

On the card the engine thread is the only thread that touches the device:
it runs the batcher's steps, and with an ``AotRegistry`` replays its CUDA
graphs (``serve.api.load_engine`` captures them at boot, before the thread
starts); client threads only ever touch the intake queue.

Streaming semantics under the resilience layer: a poison-quarantine
requeue *rewinds* a request (its emitted prefix is discarded and
regenerated), so a ``TokenStream`` exposes ``rewinds`` and its
``tokens()`` after completion is authoritative (always equals the
request's final output). Terminal states mirror
``serve.admission``: done / shed_queue_full / shed_deadline /
failed_poison.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.engine import (ContinuousBatcher, DrainResult,
                                      Request)

_END = object()          # stream sentinel
_REWIND = object()


class TokenStream:
    """Per-request streaming handle. The engine thread pushes tokens as
    they are emitted; consumers iterate (blocking) or poll.

    >>> # iter(stream) yields ints until the request reaches a terminal
    >>> # state; stream.result(timeout) waits and returns the Request.
    """

    def __init__(self, request: Request):
        self.request = request
        self.rewinds = 0           # poison-quarantine restarts observed
        self._q: "queue.Queue" = queue.Queue()
        self._terminal = threading.Event()

    # ---- engine-thread side ---------------------------------------------
    def _push(self, tok: int) -> None:
        self._q.put(tok)

    def _rewind(self) -> None:
        self.rewinds += 1
        self._q.put(_REWIND)

    def _finish(self) -> None:
        self._terminal.set()
        self._q.put(_END)

    # ---- consumer side ---------------------------------------------------
    def __iter__(self):
        """Yield tokens as they stream in. On a quarantine rewind the
        already-yielded prefix is superseded — ``tokens()`` at the end is
        the authoritative output."""
        while True:
            item = self._q.get()
            if item is _END:
                return
            if item is _REWIND:
                continue
            yield item

    def result(self, timeout: Optional[float] = None) -> Request:
        """Block until the request reaches a terminal state."""
        if not self._terminal.wait(timeout):
            raise TimeoutError(
                f"rid={self.request.rid} not terminal after {timeout}s "
                f"(status={self.request.status})")
        return self.request

    @property
    def status(self) -> str:
        return self.request.status

    def tokens(self) -> List[int]:
        return list(self.request.out)


class FrontDoor:
    """One engine replica behind an async intake.

    The engine thread alternates: drain the intake queue into the
    batcher's admission controller, then run one engine step. Client
    threads only ever touch the thread-safe intake queue — the batcher
    itself stays single-threaded, so every resilience invariant
    (deterministic shed sets, quarantine bisection, retrace bounds) holds
    unchanged.
    """

    def __init__(self, batcher: ContinuousBatcher, intake_bound: int = 256,
                 idle_sleep_s: float = 0.001):
        self.batcher = batcher
        self.intake_bound = intake_bound
        self.idle_sleep_s = idle_sleep_s
        self._intake: "queue.Queue" = queue.Queue(maxsize=intake_bound)
        self._streams: Dict[int, TokenStream] = {}     # id(Request) -> stream
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._idle = threading.Event()
        batcher.on_token = self._on_token
        batcher.on_terminal = self._on_terminal
        batcher.on_rewind = self._on_rewind

    # ---- engine-thread hooks ---------------------------------------------
    def _on_token(self, req: Request, tok: int) -> None:
        s = self._streams.get(id(req))
        if s is not None:
            s._push(tok)

    def _on_terminal(self, req: Request) -> None:
        s = self._streams.pop(id(req), None)
        if s is not None:
            s._finish()

    def _on_rewind(self, req: Request) -> None:
        s = self._streams.get(id(req))
        if s is not None:
            s._rewind()

    # ---- client side -----------------------------------------------------
    def start(self) -> "FrontDoor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="serve-engine",
                                            daemon=True)
            self._thread.start()
        return self

    def submit(self, tokens: np.ndarray, n_new: int,
               deadline_s: Optional[float] = None,
               rid: int = -1) -> Optional[TokenStream]:
        """Offer a request. Returns a :class:`TokenStream`, or ``None``
        when the intake queue is full (backpressure at the door — the
        caller/router spills to another replica immediately instead of
        queueing behind a busy engine)."""
        req = Request(rid=rid, tokens=np.asarray(tokens, dtype=np.int32),
                      n_new=n_new, deadline_s=deadline_s)
        stream = TokenStream(req)
        self._streams[id(req)] = stream
        try:
            self._intake.put_nowait(req)
        except queue.Full:
            self._streams.pop(id(req), None)
            return None
        self._idle.clear()
        return stream

    def load(self) -> int:
        """Routing signal: work queued at the door + work queued/running
        in the engine (intake depth, admission-queue depth, busy slots)."""
        busy = sum(1 for s in self.batcher.slots if s is not None)
        return self._intake.qsize() + len(self.batcher.queue) + busy

    def pending(self) -> int:
        return self.load()

    # ---- engine loop -----------------------------------------------------
    def _pump_intake(self) -> int:
        moved = 0
        while True:
            try:
                req = self._intake.get_nowait()
            except queue.Empty:
                return moved
            if not self.batcher.submit(req):
                # admission backpressure (max_queue): terminal immediately
                self._on_terminal(req)
            moved += 1

    def _loop(self) -> None:
        while True:
            moved = self._pump_intake()
            stepped = self.batcher.step()
            busy = (moved or stepped or self.batcher.queue
                    or any(s is not None for s in self.batcher.slots)
                    or not self._intake.empty())
            if not busy:
                self._idle.set()
                if self._stop.is_set():
                    return
                time.sleep(self.idle_sleep_s)
            else:
                self._idle.clear()

    def drain(self, timeout: Optional[float] = None) -> DrainResult:
        """Wait until the intake, admission queue and slots are all empty
        (or ``timeout`` elapses), then assemble the same
        :class:`DrainResult` ``run_until_drained`` returns."""
        deadline = None if timeout is None else time.monotonic() + timeout
        status = "drained"
        while not self._idle.is_set():
            wait = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            if not self._idle.wait(timeout=wait or 0.05) \
                    and deadline is not None and time.monotonic() > deadline:
                status = "timeout"
                break
        cb = self.batcher
        undrained = ([r for r in cb.slots if r is not None]
                     + list(cb.queue) + list(self._intake.queue))
        if status == "timeout" and not undrained:
            status = "drained"
        if status != "drained":
            cb.dump_flight(status, {"intake_depth": self._intake.qsize(),
                                    "undrained_rids": [r.rid
                                                       for r in undrained]})
        return DrainResult(cb.done, status, undrained,
                           shed=list(cb.admission.shed),
                           rejected=list(cb.admission.rejected),
                           failed=list(cb.failed))

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def metrics(self) -> Dict:
        out = self.batcher.metrics()
        out["intake_depth"] = self._intake.qsize()
        return out


def merge_drain_results(results: Sequence[DrainResult]) -> DrainResult:
    """Fold per-replica drains into one fleet-level result: lists
    concatenate; the status is the worst across replicas (stalled >
    timeout > drained)."""
    rank = {"drained": 0, "timeout": 1, "stalled": 2}
    worst = max((r.status for r in results), key=lambda s: rank.get(s, 2),
                default="drained")
    done: List[Request] = []
    undrained: List[Request] = []
    shed: List[Request] = []
    rejected: List[Request] = []
    failed: List[Request] = []
    for r in results:
        done.extend(r)
        undrained.extend(r.undrained)
        shed.extend(r.shed)
        rejected.extend(r.rejected)
        failed.extend(r.failed)
    return DrainResult(done, worst, undrained, shed, rejected, failed)


class Router:
    """One submit surface over N replicas.

    Routing is deterministic given the observed loads: replicas are
    tried least-loaded-first (ties broken by replica index), and a
    replica that pushes back (full intake) is skipped for the next one —
    the admission layer's explicit backpressure contract is exactly what
    makes spilling safe. A submit returns ``None`` only when *every* replica
    pushed back."""

    def __init__(self, doors: Sequence[FrontDoor]):
        if not doors:
            raise ValueError("Router needs at least one FrontDoor")
        self.doors = list(doors)
        self._rid = 0
        self._lock = threading.Lock()

    def start(self) -> "Router":
        for d in self.doors:
            d.start()
        return self

    def submit(self, tokens: np.ndarray, n_new: int,
               deadline_s: Optional[float] = None,
               rid: Optional[int] = None) -> Optional[TokenStream]:
        with self._lock:
            if rid is None:
                rid = self._rid
            self._rid = max(self._rid, rid) + 1
        order = sorted(range(len(self.doors)),
                       key=lambda i: (self.doors[i].load(), i))
        for i in order:
            stream = self.doors[i].submit(tokens, n_new,
                                          deadline_s=deadline_s, rid=rid)
            if stream is not None:
                return stream
        return None

    def drain_all(self, timeout: Optional[float] = None) -> DrainResult:
        return merge_drain_results([d.drain(timeout=timeout)
                                    for d in self.doors])

    def close(self) -> None:
        for d in self.doors:
            d.close()

    def metrics(self) -> List[Dict]:
        return [d.metrics() for d in self.doors]
