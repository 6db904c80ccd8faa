"""Deterministic fault injection for the serving stack (DESIGN.md §5).

A ``FaultPlan`` is a declarative, seed-deterministic description of the
faults a run should experience. The engine (``serve.engine``), the
heartbeat writer (``dist.ft.Heartbeat``) and the launcher
(``launch/serve.py --fault-plan``) all consult the SAME plan object, so a
chaos test can replay a faulted run bit-for-bit: every injector fires at
a configured step counter (never from wall clock or ambient randomness),
and any randomized choice (which slot to poison) derives from
``numpy.random.default_rng(seed + step)``.

Injector classes:

* **NaN logits** — ``nan_decode_step`` poisons the decode logits of
  selected rows at one engine step; ``nan_prefill_admission`` poisons
  admitted rows of the Nth batched prefill. ``nan_rows="all"`` poisons
  every live row (exercises the quarantine bisector — row attribution is
  ambiguous). ``poison_rids`` marks requests as PERSISTENTLY poisonous:
  their logits rows are corrupted at every decode/prefill/probe, modeling
  content that reliably breaks the model (these must exhaust the retry
  budget and fail typed, never stall the engine).
* **Slow / wedged step** — ``slow_step``+``slow_s`` sleeps inside one
  engine step (latency spike); ``wedge_from_step`` makes every later step
  a no-op that sleeps ``wedge_s`` (a hung engine: the drain watchdog must
  classify the run as *stalled*, not loop forever).
* **Heartbeat faults** — ``hb_skip_from``/``hb_torn_at`` are consumed by
  ``ft.Heartbeat`` (suppressed beat / torn in-place write).
* **Checkpoint corruption** — ``corrupt_artifact`` flips one
  seed-deterministic bit of (or truncates) a saved artifact's array blob,
  which the sha256 manifest verification must catch at load time.
* **Queue flood** — ``flood_requests`` builds a seed-deterministic burst
  of requests to slam past the admission bound.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class FaultPlan:
    seed: int = 0

    # --- NaN-logit injectors ---------------------------------------------
    nan_decode_step: int = -1      # engine step index to poison (-1 = off)
    nan_rows: Tuple[int, ...] | str = ()   # slot rows; () = one seeded row;
    #                                        "all" = every live row
    nan_prefill_admission: int = -1   # Nth batched prefill (0-based)
    poison_rids: Tuple[int, ...] = ()  # rids poisoned at EVERY opportunity

    # --- timing injectors -------------------------------------------------
    slow_step: int = -1
    slow_s: float = 0.0
    wedge_from_step: int = -1      # from this step on, step() does nothing
    wedge_s: float = 0.01          # per-wedged-step sleep

    # --- heartbeat injectors ----------------------------------------------
    hb_skip_from: int = -1         # suppress beats from this seq on
    hb_torn_at: int = -1           # tear exactly this beat (in-place write)

    # bookkeeping: which injectors actually fired (assertable in tests)
    fired: List[str] = field(default_factory=list, repr=False)

    # ---- (de)serialization (launch/serve.py --fault-plan) ----------------
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("fired")
        return json.dumps(d)

    @staticmethod
    def from_json(spec: str) -> "FaultPlan":
        """Parse a plan from a JSON string, or from a file via ``@path``."""
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                spec = f.read()
        d = json.loads(spec)
        for k in ("nan_rows", "poison_rids"):
            if isinstance(d.get(k), list):
                d[k] = tuple(d[k])
        return FaultPlan(**d)

    def _note(self, what: str) -> None:
        self.fired.append(what)

    # ---- engine hooks ----------------------------------------------------
    def decode_rows_to_poison(self, step_idx: int,
                              live_rows: Sequence[int]) -> List[int]:
        """Rows of this decode step's logits to corrupt. Deterministic:
        the one-shot injector fires exactly at ``nan_decode_step``; the
        row choice (when not pinned) is seeded by (seed, step)."""
        rows: List[int] = []
        if step_idx == self.nan_decode_step and live_rows:
            if self.nan_rows == "all":
                rows = list(live_rows)
            elif self.nan_rows:
                rows = [r for r in self.nan_rows if r in live_rows]
            else:
                rng = np.random.default_rng(self.seed + step_idx)
                rows = [int(rng.choice(np.asarray(live_rows)))]
            if rows:
                self._note(f"nan_decode@{step_idx}:{rows}")
        return rows

    def prefill_rows_to_poison(self, admission_idx: int,
                               n_rows: int) -> List[int]:
        """Rows of the ``admission_idx``-th batched prefill to corrupt."""
        rows: List[int] = []
        if admission_idx == self.nan_prefill_admission and n_rows:
            if self.nan_rows == "all":
                rows = list(range(n_rows))
            elif self.nan_rows:
                rows = [r for r in self.nan_rows if r < n_rows]
            else:
                rng = np.random.default_rng(self.seed + 7919 + admission_idx)
                rows = [int(rng.integers(n_rows))]
            if rows:
                self._note(f"nan_prefill@{admission_idx}:{rows}")
        return rows

    def rid_is_poison(self, rid: int) -> bool:
        """Persistent content poison: fires on every decode, prefill and
        quarantine probe touching this rid."""
        return rid in self.poison_rids

    def stall_for(self, step_idx: int) -> float:
        if step_idx == self.slow_step and self.slow_s > 0:
            self._note(f"slow@{step_idx}:{self.slow_s}s")
            return self.slow_s
        return 0.0

    def wedged(self, step_idx: int) -> bool:
        if self.wedge_from_step >= 0 and step_idx >= self.wedge_from_step:
            self._note(f"wedge@{step_idx}")
            time.sleep(self.wedge_s)
            return True
        return False

    # ---- heartbeat hook (ft.Heartbeat) -----------------------------------
    def heartbeat_mode(self, seq: int) -> str:
        if self.hb_skip_from >= 0 and seq >= self.hb_skip_from:
            self._note(f"hb_skip@{seq}")
            return "skip"
        if seq == self.hb_torn_at:
            self._note(f"hb_torn@{seq}")
            return "torn"
        return "ok"


# ---------------------------------------------------------------------------
# Checkpoint corruption (operates on a saved store.save_pytree artifact)
# ---------------------------------------------------------------------------
def corrupt_artifact(artifact_dir: str, kind: str = "bitflip",
                     seed: int = 0) -> str:
    """Corrupt the array blob of a saved artifact in a seed-deterministic
    way. ``kind``:

    * ``bitflip`` — flip one bit at a seeded offset in the back half of
      ``arrays.npz`` (array data, not the zip header — the file still
      opens, one tensor's bytes change; only the sha256 manifest check
      can catch it)
    * ``truncate`` — drop the final 25% of the file (a torn copy; numpy
      fails to open it, or opens with missing members)

    Returns the path of the file it corrupted.
    """
    path = os.path.join(artifact_dir, "arrays.npz")
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    if kind == "bitflip":
        rng = np.random.default_rng(seed)
        lo = len(blob) // 2
        off = int(rng.integers(lo, len(blob)))
        blob[off] ^= 1 << int(rng.integers(8))
        with open(path, "wb") as f:
            f.write(blob)
    elif kind == "truncate":
        with open(path, "wb") as f:
            f.write(bytes(blob[:max(1, (len(blob) * 3) // 4)]))
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return path


# ---------------------------------------------------------------------------
# Queue flood
# ---------------------------------------------------------------------------
def flood_requests(n: int, vocab_size: int, prompt_len: int = 8,
                   n_new: int = 4, seed: int = 0, rid_base: int = 10_000,
                   deadline_s: Optional[float] = None) -> List:
    """A seed-deterministic burst of requests for flooding the admission
    queue past its bound (imported lazily to keep dist/ free of a serve/
    dependency at module import)."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=rid_base + i,
                    tokens=rng.integers(0, vocab_size, size=(prompt_len,),
                                        dtype=np.int32),
                    n_new=n_new, deadline_s=deadline_s)
            for i in range(n)]
