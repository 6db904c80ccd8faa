#!/usr/bin/env python3
"""The spread of the train-step parity margin over JAX inits, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/torch_train_parity_spread.py \\
        [--seeds 0-7] [--hash-seeds 1-15] [--trace SEED --hash-seed H]

Runs the comparison of ``tests/test_torch_train.py::
test_train_step_matches_jax_for_five_steps`` (five steps at lr 1e-4, 1 and
2 microbatches, the port's step on JAX's bridged init) for every
``PRNGKey(seed)``, once under each ``PYTHONHASHSEED`` (one process each:
JAX's ``Builder.sub`` folds Python's salted ``hash(name)`` into the key,
so the init differs between processes), and prints each run's params
margin (the largest leaf's max |port - JAX| / max |JAX|, the test's 1e-5
tier) and loss margin as JSON lines, then their spread. ``--trace`` prints,
for one init, the worst param entry's grads in both packages at every step
beside the leaf's grad error.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _range(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def runs(seeds, trace: bool) -> None:
    """In this process: each seed at 1 and 2 microbatches (``trace``: the
    first seed at 1 microbatch, traced)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_train as M
    from repro_torch import bridge, pytree

    def flat(tree, of_jax: bool) -> dict:
        if of_jax:
            return {jax.tree_util.keystr(p): np.asarray(b, np.float64)
                    for p, b in jax.tree_util.tree_flatten_with_path(
                        tree)[0]}
        return {pytree.keystr(p): a.detach().double().numpy()
                for p, a in pytree.flatten_with_path(tree)}

    ocfg = dict(lr=1e-4, warmup_steps=2, total_steps=5)
    for mb in ((1,) if trace else (1, 2)):
        for seed in (seeds[:1] if trace else seeds):
            jstate, _ = M.JTS.init_train_state(M.JCFG,
                                               jax.random.PRNGKey(seed))
            state = bridge.from_numpy(M.np_tree(jstate), device=M.CPU)
            jstep = jax.jit(M.JTS.make_train_step(M.JCFG, M.JTS.TrainConfig(
                optimizer=M.JA.OptimizerConfig(**ocfg), microbatches=mb)))
            step = M.TS.make_train_step(M.CFG, M.TS.TrainConfig(
                optimizer=M.A.OptimizerConfig(**ocfg), microbatches=mb))
            loader = M.JLoader(M.JDataConfig(
                vocab_size=M.SMALL["vocab_size"], seq_len=32,
                global_batch=4, seed=3))
            loss, grads = 0.0, []
            for s in range(5):
                b = loader.batch(s)
                jb = {k: jnp.asarray(v) for k, v in b.items()}
                tb = {k: torch.as_tensor(v) for k, v in b.items()}
                if trace:
                    _, _, jg = M.JTS.loss_and_grads(jstate.params, M.JCFG,
                                                    jb, mb)
                    _, _, tg = M.TS.loss_and_grads(state.params, M.CFG, tb,
                                                   mb)
                    grads.append((flat(jg, True), flat(tg, False)))
                jstate, jm = jstep(jstate, jb)
                state, m = step(state, tb)
                loss = max(loss, M.rel(float(m["loss"]), float(jm["loss"])))
            jp, tp = flat(jstate.params, True), flat(state.params, False)
            errs = {k: float(np.abs(tp[k] - jp[k]).max()
                             / np.abs(jp[k]).max()) for k in jp}
            worst = max(errs, key=errs.get)
            print(json.dumps(dict(
                hash_seed=os.environ.get("PYTHONHASHSEED"), seed=seed,
                microbatches=mb, params=errs[worst], leaf=worst,
                loss=loss)), flush=True)
            if trace:
                i = np.unravel_index(np.abs(tp[worst] - jp[worst]).argmax(),
                                     jp[worst].shape)
                for s, (jg, tg) in enumerate(grads):
                    g = jg[worst]
                    print(f"step {s}: grad at {tuple(int(x) for x in i)} "
                          f"JAX {g[i]:.6e} port {tg[worst][i]:.6e}; the "
                          f"leaf's grads within "
                          f"{np.abs(tg[worst] - g).max() / np.abs(g).max():.3e}"
                          f" of its largest")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--hash-seeds", default="1-15")
    ap.add_argument("--trace", type=int)
    ap.add_argument("--hash-seed", type=int)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        runs(_range(args.seeds), trace=args.trace is not None)
        return 0
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    if args.trace is not None:
        env["PYTHONHASHSEED"] = str(args.hash_seed or 0)
        return subprocess.call([sys.executable, __file__, "--child",
                                "--seeds", str(args.trace), "--trace",
                                str(args.trace)], env=env)
    rows = []
    for h in _range(args.hash_seeds):
        env["PYTHONHASHSEED"] = str(h)
        out = subprocess.run([sys.executable, __file__, "--child",
                              "--seeds", args.seeds], env=env, check=True,
                             capture_output=True, text=True).stdout
        for line in out.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    margins = sorted(r["params"] for r in rows)
    over = [(r["hash_seed"], r["seed"], r["microbatches"]) for r in rows
            if r["params"] > 1e-5]
    print(json.dumps(dict(
        runs=len(rows), params_min=margins[0],
        params_median=margins[len(margins) // 2],
        params_max=margins[-1], over_1e5=over,
        loss_max=max(r["loss"] for r in rows))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
