#!/usr/bin/env python3
"""Host ms and peak memory of the port's eager steps that call the kernel
wrappers most, to hold two checkouts of the port against each other.

    python3 scripts/torch_eager_steps.py [--src DIR] [--decode-reps N]
                                         [--train-reps N]

SmolLM-360M at full size on the card, random weights from seed 0:

* the decode step at ``chip_smoke.py``'s batcher shape (batch 8, max_len
  256, live lengths 73-80), bf16, every linear replaced by random factors
  at uniform 20% (``chip_smoke.random_factors``): one ``lowrank_gemv``
  call a linear and one ``decode_attention`` a layer;
* the train step at ``chip_smoke.py``'s training-path shape (8 x 256
  tokens in 2 microbatches, remat "block", float32 params).

Each is timed on the host clock between syncs (``chip_smoke.host_ms``,
the mean of the runs after a warm one); then, Python's cyclic garbage
collected, one more run gives ``torch.cuda.max_memory_allocated`` less
the memory allocated before it (the step's own peak). ``--src`` names the
``src`` directory that ``repro_torch`` is imported from (default: this
checkout's), so that one call on one card can run parent, change, change,
parent. Prints the card's name and power limit, then one JSON line.
"""
import argparse
import gc
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def own_peak(torch, fn) -> int:
    """Bytes allocated at the peak of one run of ``fn``, beyond what was
    allocated before it (after a collection of Python's cyclic garbage)."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    top = torch.cuda.max_memory_allocated()
    del out
    return top - before


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--decode-reps", type=int, default=50)
    ap.add_argument("--train-reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_eager_steps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.core import capture
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.serve import engine
    from repro_torch.train import step as TS
    import repro_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    cfg = get_config(CS.ARCH)
    res = {"src": str(Path(repro_torch.__file__).resolve().parents[1]),
           "card": CS.card_line()}

    # the D-Rank decode step
    params, _ = T.init_model(cfg, seed=0, device=dev)
    lp, _ = CS.random_factors(types.SimpleNamespace(
        torch=torch, capture=capture), params, cfg, 0.2, seed=0)
    del params
    lp = engine.place_params(lp, T.dtype_of(cfg.dtype), dev)
    cache = T.init_cache(cfg, CS.CB_BATCH, CS.CB_MAX_LEN, device=dev)
    cache["pos"].copy_(torch.arange(72, 72 + CS.CB_BATCH, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (CS.CB_BATCH, 1), generator=gen,
                        device=dev, dtype=torch.int32)

    def decode():
        with torch.no_grad():
            return T.decode_step(lp, cfg, cache, tok)[0]

    res["decode_ms"] = CS.host_ms(torch, decode, args.decode_reps)
    res["decode_own_peak_bytes"] = own_peak(torch, decode)
    del lp, cache

    # the train step
    tcfg = TS.TrainConfig(microbatches=CS.TRAIN_MICRO,
                          optimizer=adamw.OptimizerConfig(
                              lr=CS.TRAIN_LR, warmup_steps=2,
                              total_steps=CS.TRAIN_STEPS))
    state, _ = TS.init_train_state(cfg, seed=0, device=dev)
    loader = synthetic.ShardedLoader(synthetic.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=CS.TRAIN_SEQ,
        global_batch=CS.TRAIN_BATCH))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in loader.batch(0).items()}
    step = TS.make_train_step(cfg, tcfg)
    res["train_ms"] = CS.host_ms(torch, lambda: step(state, batch),
                                 args.train_reps)
    res["train_own_peak_bytes"] = own_peak(torch, lambda: step(state, batch))
    print(res["card"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
