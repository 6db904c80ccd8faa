"""Trainer: the train step + deterministic sharded data + async checkpoints
+ SIGTERM-safe shutdown + resume (counterpart of ``repro/train/loop.py``;
DESIGN.md §5):

  * checkpoint every `ckpt_every` steps on a worker thread (the loop only
    copies the state to the host);
  * SIGTERM/SIGINT triggers one final synchronous checkpoint before exit
    (preemption-safe on managed clusters);
  * restart resumes from LATEST — and because the data pipeline is
    counter-based in (seed, step, global_row), a restart on a *different*
    data-parallel topology replays the exact same global batches (elastic);
  * a heartbeat file (``repro_torch.dist.ft``) lets an external supervisor
    detect stalled workers.

It runs on ``device`` (the card by default). ``Trainer.state`` may be
replaced before ``run()`` (a bridged state, say), as in the JAX package.
"""
from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.ckpt import store
from repro_torch.config import ModelConfig
from repro_torch.data.synthetic import DataConfig, ShardedLoader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.ft import Heartbeat
from repro_torch.train import step as TS


@dataclass
class LoopConfig:
    total_steps: int = 1000
    ckpt_dir: str = ""
    ckpt_every: int = 200
    log_every: int = 20
    keep_last: int = 3
    shard_id: int = 0
    num_shards: int = 1
    heartbeat_path: str = ""


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TS.TrainConfig,
                 dcfg: DataConfig, lcfg: LoopConfig,
                 seed: int = 0, *, device: DeviceLike = None):
        self.cfg, self.tcfg, self.dcfg, self.lcfg = cfg, tcfg, dcfg, lcfg
        self.device = resolve_device(device)
        self.loader = ShardedLoader(dcfg, lcfg.shard_id, lcfg.num_shards)
        self.state, self.specs = TS.init_train_state(cfg, seed=seed,
                                                     device=self.device)
        self.step_fn = TS.make_train_step(cfg, tcfg)
        self.start_step = 0
        self.history: List[Dict] = []
        self._stop = False
        self._ckpt: Optional[store.AsyncCheckpointer] = None
        self._hb = (Heartbeat(lcfg.heartbeat_path)
                    if lcfg.heartbeat_path else None)
        if lcfg.ckpt_dir:
            os.makedirs(lcfg.ckpt_dir, exist_ok=True)
            if store.latest_step(lcfg.ckpt_dir) is not None:
                s, self.state = store.restore(lcfg.ckpt_dir, self.state)
                self.start_step = s
            self._ckpt = store.AsyncCheckpointer(lcfg.ckpt_dir,
                                                 lcfg.keep_last)

    # -- signals ------------------------------------------------------------
    def _install_signals(self):
        def handler(signum, frame):
            self._stop = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass        # non-main thread (tests)

    def run(self) -> Dict:
        self._install_signals()
        lcfg = self.lcfg
        t0 = time.time()
        s = self.start_step
        while s < lcfg.total_steps and not self._stop:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.loader.batch(s).items()}
            self.state, m = self.step_fn(self.state, batch)
            s += 1
            if self._hb:
                self._hb.beat(s)
            if s % lcfg.log_every == 0 or s == lcfg.total_steps:
                row = {k: float(v) for k, v in m.items()}
                row["step"] = s
                row["wall_s"] = time.time() - t0
                self.history.append(row)
            if self._ckpt and s % lcfg.ckpt_every == 0:
                self._ckpt.submit(s, self.state, {"loss": float(m["loss"])})
        # final checkpoint: synchronous (covers SIGTERM preemption)
        if lcfg.ckpt_dir:
            if self._ckpt:
                self._ckpt.close()
            store.save(lcfg.ckpt_dir, s, self.state,
                       {"final": True, "interrupted": self._stop},
                       keep_last=lcfg.keep_last)
        # the JAX loop calls ``self._hb.close()`` here, which its Heartbeat
        # does not have (an AttributeError after the final save); a
        # heartbeat holds nothing open, so there is nothing to close
        return {"final_step": s, "interrupted": self._stop,
                "history": self.history}
