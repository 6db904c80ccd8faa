"""Training launcher (counterpart of ``repro/launch/train.py``, with its
flags exactly). It runs on the card:

    python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --global-batch 8 --seq-len 256 --ckpt-dir runs/smollm

then serve the last checkpoint with ``python -m repro_torch.launch.serve
--arch smollm-360m --ckpt runs/smollm``. From Python,
``Trainer(..., device="cpu")`` trains on the CPU.

Under ``torchrun --standalone --nproc-per-node N -m
repro_torch.launch.train ...`` (``WORLD_SIZE`` N > 1) every rank joins the
process group (``dist.comm.init``: NCCL when every rank owns a card, gloo
through pinned host memory when the ranks share one) and trains
data-parallel on shard ``RANK`` of N; rank 0 prints the history and
writes the checkpoints.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--heartbeat", default="")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config of the arch")
    ap.add_argument("--override", default="",
                    help="JSON dict of ModelConfig field overrides")
    ap.add_argument("--history-out", default="")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train import step as TS
    from repro_torch.train.loop import LoopConfig, Trainer

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        from repro_torch.dist import comm
        c = comm.init(world, int(os.environ["RANK"]), "cuda")
        args.shard_id, args.num_shards = c.rank, world
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.override:
        cfg = cfg.replace(**json.loads(args.override))

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=args.data_seed)
    tcfg = TS.TrainConfig(
        microbatches=args.microbatches,
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=args.warmup,
                                  total_steps=args.steps))
    lcfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=args.log_every,
                      shard_id=args.shard_id, num_shards=args.num_shards,
                      heartbeat_path=args.heartbeat)
    trainer = Trainer(cfg, tcfg, dcfg, lcfg, seed=args.seed)
    result = trainer.run()
    if world > 1:
        from repro_torch.dist import comm
        result["comm"] = comm.current().report()
        comm.shutdown()
        if args.shard_id != 0:
            return 0
    for row in result["history"]:
        print(json.dumps(row))
    if args.history_out:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(result, f, indent=1)
    print(f"done: step={result['final_step']} "
          f"interrupted={result['interrupted']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
