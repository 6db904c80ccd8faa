"""Flight recorder: a bounded ring of recent engine events, dumped to a
JSON artifact when something goes wrong (DESIGN.md §6.3).

A drain timeout or a poison bisection used to leave nothing to debug
from — the process exited and the evidence died with it. The recorder
is *always on* (a ``deque(maxlen=...)`` of small dicts costs nothing
measurable next to a decode step) and *only writes* when a trigger
fires and a dump directory is configured:

* a request fails typed (``failed_poison``),
* the drain watchdog trips (``stalled``),
* ``run_until_drained`` returns non-``drained``.

The artifact (``flightrec-<reason>-<n>.json``, schema
``repro.flightrec/v1``) carries everything needed to reproduce the
failure: the armed ``FaultPlan`` (seed included), queue/slot state at
dump time, the elastic rung, the last-N step wall times and the event
ring itself — the chaos suite asserts a poisoned request's rid and the
rung it failed at are recoverable from the dump alone.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
from typing import Any, Deque, Dict, List, Optional

SCHEMA = "repro.flightrec/v1"

DEFAULT_EVENTS = 512
DEFAULT_TIMINGS = 64


class FlightRecorder:
    """Ring buffer of recent events + step timings, with triggered dumps.

    ``dump_dir=None`` keeps recording but never writes (the in-memory
    ring is still inspectable — tests and the REPL read ``events``).
    Dumps are atomic and fsync-free (an artifact torn by a crash is
    re-creatable; the *engine* must never block on one).
    """

    def __init__(self, dump_dir: Optional[str] = None,
                 max_events: int = DEFAULT_EVENTS,
                 max_timings: int = DEFAULT_TIMINGS):
        self.dump_dir = dump_dir or None
        self.events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max_events)
        self.step_timings: Deque[Dict[str, float]] = collections.deque(
            maxlen=max_timings)
        self.dumps: List[str] = []        # paths written this process
        self._seq = 0
        self._lock = threading.Lock()

    # ---- recording (engine thread) ---------------------------------------
    def note(self, kind: str, **fields) -> None:
        """Append one event to the ring. ``kind`` is the event taxonomy
        key (``admit``/``shed``/``poison``/``rung``/``fail``/...);
        fields must be JSON-serializable scalars or small lists."""
        with self._lock:
            ev = {"seq": self._seq, "kind": kind}
            self._seq += 1
            ev.update(fields)
            self.events.append(ev)

    def step_timing(self, step: int, wall_ms: float, live: int) -> None:
        with self._lock:
            self.step_timings.append(
                {"step": step, "wall_ms": round(wall_ms, 3), "live": live})

    # ---- dumping ---------------------------------------------------------
    def dump(self, reason: str, context: Optional[Dict[str, Any]] = None
             ) -> Optional[str]:
        """Write the artifact for ``reason`` and return its path, or
        ``None`` when no dump dir is configured. Never raises — a failed
        dump is reported in-band (the engine must keep serving)."""
        if self.dump_dir is None:
            return None
        with self._lock:
            payload = {
                "schema": SCHEMA,
                "reason": reason,
                "context": context or {},
                "step_timings": list(self.step_timings),
                "events": list(self.events),
            }
            n = len(self.dumps)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"flightrec-{reason}-{n}.json")
            fd, tmp = tempfile.mkstemp(dir=self.dump_dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            return None
        self.dumps.append(path)
        return path


def validate_dump(obj: Dict[str, Any]) -> List[str]:
    """Validate a flight-recorder artifact; returns problems (empty =
    valid). Shared by tests and the CI chaos drill."""
    errs: List[str] = []
    if obj.get("schema") != SCHEMA:
        errs.append(f"bad schema {obj.get('schema')!r} (want {SCHEMA})")
    if not isinstance(obj.get("reason"), str) or not obj.get("reason"):
        errs.append("missing reason")
    if not isinstance(obj.get("context"), dict):
        errs.append("context missing or not an object")
    evs = obj.get("events")
    if not isinstance(evs, list):
        errs.append("events missing or not a list")
    else:
        for i, ev in enumerate(evs):
            if not isinstance(ev, dict) or "kind" not in ev \
                    or "seq" not in ev:
                errs.append(f"events[{i}]: missing kind/seq")
                break
        seqs = [ev.get("seq") for ev in evs if isinstance(ev, dict)]
        if seqs != sorted(seqs):
            errs.append("event seqs not monotonic")
    if not isinstance(obj.get("step_timings"), list):
        errs.append("step_timings missing or not a list")
    return errs
