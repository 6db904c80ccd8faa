"""Fault tolerance (counterpart of ``repro/dist/ft.py``, numpy only;
DESIGN.md §5): file-based worker heartbeats with stall detection, and
deterministic row sharding with a speculative-execution variant (a
healthy worker re-derives a straggler's shard without any coordination —
both sides compute the same rows from the same counters).

Stall detection comes in two flavors:

* ``detect_stalled`` — stateless wall-clock scan. A heartbeat whose
  recorded wall time is older than the deadline is stalled. Unreadable
  payloads (a torn write that raced the scan, a corrupted disk block)
  fall back to the FILE MTIME rather than treating the worker as dead —
  mtime is written by the same ``os.replace`` that publishes the payload,
  so it is a faithful lower bound on liveness even when the bytes are not.
* ``StallDetector`` — stateful progress scan for long-lived monitors.
  Workers publish a monotonic ``seq`` counter with every beat; the
  detector remembers the last counter it saw per worker and flags a
  worker only when its counter has not advanced for ``deadline_s`` of the
  READER's monotonic clock. Wall-clock skew between writer and reader
  (NTP steps, container clock drift) cannot misclassify a worker, because
  no cross-host timestamps are ever compared.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


class HeartbeatError(RuntimeError):
    """A heartbeat file exists but its payload cannot be trusted
    (torn/corrupt JSON, vanished mid-read)."""


class Heartbeat:
    """One JSON heartbeat file per worker; ``beat`` is atomic (tmp+rename)
    so a reader never sees a torn write. Every beat carries a
    monotonically increasing ``seq`` counter (progress signal for
    ``StallDetector``) alongside the wall-clock ``time`` (human-readable
    and used by the stateless ``detect_stalled`` scan).

    ``fault`` (optional) is a fault-injection plan
    (``dist.faultinject.FaultPlan``): per-beat it may suppress the write
    (simulating a wedged worker) or tear it (a non-atomic partial write,
    which the atomic rename path can never produce on its own).
    """

    def __init__(self, path: str, worker_id: int = 0, fault=None):
        self.path = path
        self.worker_id = worker_id
        self.fault = fault
        self.seq = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def beat(self, step: int) -> None:
        self.seq += 1
        mode = (self.fault.heartbeat_mode(self.seq)
                if self.fault is not None else "ok")
        if mode == "skip":          # wedged worker: no write at all
            return
        payload = {"worker_id": self.worker_id, "step": int(step),
                   "seq": self.seq, "time": time.time()}
        if mode == "torn":          # simulated torn write: truncated JSON,
            raw = json.dumps(payload)[:13]      # written IN PLACE (no
            with open(self.path, "w") as f:     # tmp+rename atomicity)
                f.write(raw)
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def read(self) -> Dict:
        """Read back the last payload. Raises ``HeartbeatError`` (not a
        raw ``JSONDecodeError``) when the file is torn or unreadable, so
        callers can distinguish 'worker never started' (FileNotFoundError)
        from 'worker is writing garbage'."""
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            raise
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            raise HeartbeatError(
                f"heartbeat {self.path} unreadable: {e}") from e


def _payload_or_none(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError, UnicodeDecodeError):
        return None


def detect_stalled(root: str, deadline_s: float) -> List[str]:
    """Names of heartbeat files under `root` older than `deadline_s`.

    Unreadable payloads (torn writes) fall back to the file mtime — the
    old behavior of treating them as ``t=0`` misclassified a live worker
    as stalled the instant a scan raced a (simulated) torn write.
    In-flight ``.tmp`` files are ignored: they are the atomic-rename
    staging area, never the published heartbeat."""
    stalled = []
    now = time.time()
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if not os.path.isfile(path) or name.endswith(".tmp"):
            continue
        payload = _payload_or_none(path)
        if payload is not None and "time" in payload:
            t = float(payload["time"])
        else:
            try:
                t = os.path.getmtime(path)
            except OSError:
                continue            # vanished mid-scan: next scan decides
        if now - t > deadline_s:
            stalled.append(name)
    return stalled


class StallDetector:
    """Progress-based stall detection, immune to wall-clock skew.

    ``poll()`` scans the heartbeat directory; a worker is stalled when its
    ``seq`` counter (falling back to ``step``, then file mtime for torn
    payloads) has not advanced for ``deadline_s`` measured on the
    READER's ``time.monotonic()`` clock. First sight of a worker starts
    its grace window — a worker is never declared stalled on the very
    first scan."""

    def __init__(self, root: str, deadline_s: float):
        self.root = root
        self.deadline_s = deadline_s
        # name -> (last progress marker, reader-monotonic time it changed)
        self._seen: Dict[str, tuple] = {}

    def _marker(self, path: str):
        payload = _payload_or_none(path)
        if payload is not None:
            return (payload.get("seq"), payload.get("step"))
        try:
            return ("mtime", os.path.getmtime(path))
        except OSError:
            return None

    def poll(self) -> List[str]:
        now = time.monotonic()
        stalled = []
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if not os.path.isfile(path) or name.endswith(".tmp"):
                continue
            marker = self._marker(path)
            if marker is None:
                continue
            last = self._seen.get(name)
            if last is None or last[0] != marker:
                self._seen[name] = (marker, now)
                continue
            if now - last[1] > self.deadline_s:
                stalled.append(name)
        return stalled


def shard_rows(n_rows: int, num_shards: int, shard_id: int) -> np.ndarray:
    """Strided row assignment: disjoint across shards, covers [0, n_rows)."""
    return np.arange(shard_id, n_rows, num_shards)


def speculative_shard(n_rows: int, num_shards: int, shard_id: int,
                      spare: int = 0) -> np.ndarray:
    """Rows worker `shard_id` computes when speculating `spare` hops ahead:
    spare=0 is its own shard; spare=k re-derives the shard of the worker k
    positions over (used to cover a straggler detected via heartbeats)."""
    return shard_rows(n_rows, num_shards, (shard_id + spare) % num_shards)
