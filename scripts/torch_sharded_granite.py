#!/usr/bin/env python3
"""The sharded granite step against one process on the card: why
``chip_smoke.py``'s sharded phase runs granite at lr 1e-4 and holds it to
one process with one microbatch a data shard.

    python3 scripts/torch_sharded_granite.py

granite-moe-1b-a400m at full width on 2 layers, ``chip_smoke.py``'s
"granite float32" case (capacity factor 8: no assignment drops) and its
two global batches of 4 x 128 tokens. World 4 = (data 2, model 2) is
spawned on the one card (gloo through pinned host memory), and this
process runs one process beside it:

* the first step's gradients, the sharded step's (every rank's blocks
  gathered) against one process's with one microbatch a data shard (the
  same function: the MoE aux statistic of each data shard, as in JAX's
  expert-parallel body), each leaf's max |a - b| over its largest entry;
  and two one-process runs against each other;
* two steps' losses and grad norms at lr 1e-3 and 1e-4: sharded, one
  process with one microbatch a data shard, one process on the whole
  batch (the aux statistic of the global batch).

Prints the card's name and power limit, then one JSON line.
"""
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS                              # noqa: E402

LRS = (1e-3, 1e-4)
OUT = ROOT / "build" / "torch_sharded_granite"


def case(port, lr):
    """The granite case at learning rate ``lr``."""
    cfg, batches, tcfg, _ = CS.sharded_cases(port)["granite float32"]
    return cfg, batches, dataclasses.replace(
        tcfg, optimizer=dataclasses.replace(tcfg.optimizer, lr=lr))


def rank_main(rank: int, init_method: str) -> None:
    """One rank: the first step's gradient blocks, gathered, and the
    sharded steps at each learning rate."""
    import torch
    sys.path.insert(0, str(CS.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port = CS.Port()
    from repro_torch.dist import comm
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    TS = port.TS
    c = comm.init(4, rank, "cuda", init_method=init_method)
    try:
        mesh = make_host_mesh(*CS.SH_MESH)
        cfg, batches, _ = case(port, LRS[0])
        state, specs = TS.init_train_state(cfg, seed=0, device=c.device)
        blocks, shd = SH.shard_tree(state.params, specs, mesh)
        del state
        pl = TS.placement(cfg, mesh)
        rows = CS.DP_ROWS // mesh.shape["data"]
        d = mesh.coord("data")
        batch = {"tokens": torch.as_tensor(batches[0][d * rows:(d + 1) * rows],
                                           device=c.device)}
        n = T.loss_labels(cfg, batch, c.device)[1].sum()
        total = comm.all_reduce_sum(n, pl.batch_group)

        def fn(p):
            ce, term, m = T.lm_loss_terms(p, cfg, batch, placement=pl)
            return ce * n / total + term / pl.batch_size, m
        _, _, g = TS.value_and_grad_of(fn, blocks)
        g = pl.reduce_grads(g)
        whole = SH.gather_tree(g, shd)
        del blocks, g
        runs = {}
        for lr in LRS:
            cfg, b, tcfg = case(port, lr)
            o = CS.sharded_run(port, c.device, cfg, b, tcfg, mesh)
            runs[str(lr)] = {"losses": o["losses"],
                             "grad_norms": o["grad_norms"]}
    finally:
        comm.shutdown()
    if rank == 0:
        torch.save(port.pytree.tree_map(lambda t: t.cpu(), whole),
                   str(OUT / "grads.pt"))
        (OUT / "runs.json").write_text(json.dumps(runs))


def main() -> int:
    import shutil

    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("torch_sharded_granite: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(CS.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = CS.card_line()
    port = CS.Port()
    CS.build_kernels(port)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    ctx = mp.spawn(rank_main, args=(f"file://{OUT / 'pg'}",),
                   nprocs=4, join=False)
    try:
        cfg, batches, _ = case(port, LRS[0])
        state, _ = port.TS.init_train_state(cfg, seed=0, device=dev)
        tok = {"tokens": torch.as_tensor(batches[0], device=dev)}
        ones = [port.TS.loss_and_grads(state.params, cfg, tok,
                                       CS.SH_MESH[0])[2] for _ in range(2)]
        del state
        one = {}
        for lr in LRS:
            cfg, b, tcfg = case(port, lr)
            for micro in (CS.SH_MESH[0], 1):
                o = CS.sharded_run(port, dev, cfg, b, dataclasses.replace(
                    tcfg, microbatches=micro))
                one[f"{lr} microbatches {micro}"] = {
                    "losses": o["losses"], "grad_norms": o["grad_norms"]}
        while not ctx.join():
            pass
        sharded = torch.load(str(OUT / "grads.pt"))
        runs = json.loads((OUT / "runs.json").read_text())
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        shutil.rmtree(OUT, ignore_errors=True)
    leaves = {}
    for (p, a), b1, b2 in zip(port.pytree.flatten_with_path(sharded),
                              port.pytree.leaves(ones[0]),
                              port.pytree.leaves(ones[1])):
        b1, b2 = b1.cpu(), b2.cpu()
        top = float(b1.abs().max())
        leaves[port.pytree.keystr(p)] = {
            "sharded_vs_one": float((a - b1).abs().max()) / top,
            "one_vs_one": float((b2 - b1).abs().max()) / top}
    print(card)
    print(json.dumps({"card": card, "first_step_grads": leaves,
                      "sharded": runs, "one_process": one}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
