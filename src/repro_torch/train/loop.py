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

Under a process group (``dist.comm.init``) with ``num_shards`` equal to
the world, the Trainer trains data-parallel: rank r reads shard r of
every global batch, the grads are reduced over the ``data`` group before
AdamW (``step.reduce_data_parallel``), rank 0 alone writes checkpoints,
and each rank beats its own heartbeat (``<heartbeat_path>.rank<r>``).
Without a process group ``num_shards > 1`` keeps JAX's meaning: this
process trains on its shard alone, with no reduce.
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
from repro_torch.dist import comm
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
        group = self._data_group(lcfg)
        self.rank = lcfg.shard_id if group is not None else 0
        self.loader = ShardedLoader(dcfg, lcfg.shard_id, lcfg.num_shards)
        self.state, self.specs = TS.init_train_state(cfg, seed=seed,
                                                     device=self.device)
        self.step_fn = TS.make_train_step(cfg, tcfg, group=group)
        self.start_step = 0
        self.history: List[Dict] = []
        self._stop = False
        self._ckpt: Optional[store.AsyncCheckpointer] = None
        hb_path = lcfg.heartbeat_path
        if hb_path and group is not None:
            hb_path = f"{hb_path}.rank{self.rank}"
        self._hb = (Heartbeat(hb_path, worker_id=self.rank)
                    if hb_path else None)
        if lcfg.ckpt_dir:
            if self.rank == 0:
                os.makedirs(lcfg.ckpt_dir, exist_ok=True)
            if group is not None:
                comm.barrier()
            if store.latest_step(lcfg.ckpt_dir) is not None:
                s, self.state = store.restore(lcfg.ckpt_dir, self.state)
                self.start_step = s
            if self.rank == 0:
                self._ckpt = store.AsyncCheckpointer(lcfg.ckpt_dir,
                                                     lcfg.keep_last)
        self._group = group

    @staticmethod
    def _data_group(lcfg: LoopConfig):
        """The data-parallel group: the world, when a process group is up
        and ``num_shards`` is its size (then ``shard_id`` must be this
        rank); None otherwise."""
        if not comm.is_initialized() or lcfg.num_shards <= 1:
            return None
        c = comm.current()
        if lcfg.num_shards != c.world or lcfg.shard_id != c.rank:
            raise ValueError(
                f"data-parallel training under a process group of "
                f"{c.world} ranks: num_shards must be {c.world} and "
                f"shard_id this rank ({c.rank}); got {lcfg.num_shards} / "
                f"{lcfg.shard_id}")
        import torch.distributed as dist
        return None if c.world == 1 else dist.group.WORLD

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
        if lcfg.ckpt_dir and self.rank == 0:
            if self._ckpt:
                self._ckpt.close()
            store.save(lcfg.ckpt_dir, s, self.state,
                       {"final": True, "interrupted": self._stop},
                       keep_last=lcfg.keep_last)
        if self._group is not None:
            comm.barrier()
        # the JAX loop calls ``self._hb.close()`` here, which its Heartbeat
        # does not have (an AttributeError after the final save); a
        # heartbeat holds nothing open, so there is nothing to close
        return {"final_step": s, "interrupted": self._stop,
                "history": self.history}
