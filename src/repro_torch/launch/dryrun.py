"""The launch accounting: per-rank memory, model and counted FLOPs, bytes,
collectives and the H100 roofline of every (architecture × input shape ×
mesh) cell (counterpart of ``repro/launch/dryrun.py``).

JAX lowers and compiles each cell on 512 fake host devices and reads the
compiled artifact. The port runs one process a rank, so a cell here is one
rank's train step, prefill or decode step, run once on ``meta`` tensors
under the op counter (``launch.op_analysis``), with its collectives
counted by ``dist.comm.counting`` on a mesh without process groups. Nothing
is allocated on any device: this is the counterpart of the compile on fake
devices, not a CPU fallback.

The rank holds what the port places on it. A train cell runs the sharded
step (``train.step.sharded_train_step``): the rank holds its block of every
parameter and of AdamW's moments under the rules (FSDP over ``pod`` ×
``data``, tensor, vocab and expert parallelism over ``model``: what JAX's
dry-run places, ``memory.rule_state_bytes``), its block of the batch over
the data axes, and the step's gathers on use, reduce-scatters and
all-reduces are counted. A prefill or decode cell holds the parameters
whole but a Mixture-of-Experts expert stack (E/``model`` experts: expert
parallelism); serving with sharded parameters is not ported.
``memory.rule_argument_bytes`` gives the per-rank bytes of every argument
under the sharding rules (``dist.sharding.shape_aware_spec``); in a train
cell it differs from ``argument_bytes`` by the batch alone, whose
sequence the rules also lay over ``model`` (sequence parallelism, not
ported).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --arch smollm-360m --shape decode_32k
Results go to experiments/dryrun_torch/<mesh>/<cell>.json (``--force``
recounts a cell that has one).
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch import pytree
from repro_torch.config import SHAPES, ModelConfig, ShapeConfig, \
    shape_applicable
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import sharding as SH
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptimizerConfig, adamw_init
from repro_torch.train import step as TS


@dataclass(frozen=True)
class Card:
    """A card's data-sheet rates (dense) and memory."""
    name: str
    peak_ops_per_s: Dict[str, float]     # by compute dtype
    hbm_bytes_per_s: float
    link_bytes_per_s: float              # one direction
    hbm_bytes: float

    @property
    def peak_flops(self) -> float:       # bf16, the roofline's
        return self.peak_ops_per_s["bfloat16"]


# NVIDIA H100 SXM data sheet: dense bf16 and float32, HBM3, NVLink 4 per
# direction, 80 GB
H100_SXM = Card(name="NVIDIA H100 SXM",
                peak_ops_per_s={"bfloat16": 989e12, "float32": 67e12},
                hbm_bytes_per_s=3.35e12, link_bytes_per_s=450e9,
                hbm_bytes=80e9)

RESULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                with_labels: bool) -> Dict[str, torch.Tensor]:
    """The global batch of a cell, as JAX's ``batch_specs``."""
    gb, S = shape.global_batch, shape.seq_len
    dt = T.dtype_of(cfg.dtype)
    b: Dict[str, torch.Tensor] = {}
    if cfg.is_encoder_decoder:
        b["enc_embeds"] = _meta((gb, S, cfg.d_model), dt)
        b["tokens"] = _meta((gb, S), torch.int32)
    elif cfg.frontend:
        b["embeds"] = _meta((gb, S, cfg.d_model), dt)
        if with_labels:
            b["labels"] = _meta((gb, S), torch.int32)
        if cfg.rope_kind == "mrope":
            b["positions"] = _meta((3, gb, S), torch.int32)
    else:
        b["tokens"] = _meta((gb, S), torch.int32)
    return b


def batch_axes(name: str, t: torch.Tensor) -> tuple:
    """The logical axes of a batch entry (JAX's ``batch_shardings``)."""
    if name == "positions" and t.dim() == 3:
        return (None, "batch", "seq")
    return ("batch", "seq") + (None,) * (t.dim() - 2)


CACHE_AXES = {
    # kv cache (n, B, L, K, hd): batch over dp, cache seq over model
    5: ("layer_stack", "batch", "kv_seq_model", None, None),
    4: ("layer_stack", "batch", None, None),
    3: ("layer_stack", "batch", None),
    2: ("layer_stack", "batch"),
}


def cache_axes(t: torch.Tensor) -> tuple:
    """The logical axes of a cache leaf (JAX's ``cache_shardings``)."""
    nd = t.dim()
    if nd == 1:                       # pos (B,)
        return ("batch",)
    return CACHE_AXES.get(nd, ("layer_stack", "batch") + (None,) * (nd - 2))


def decode_cache(cfg: ModelConfig, shape: ShapeConfig, batch: int):
    """The decode cache of a cell as JAX builds it: ``seq_len`` slots and,
    for an encoder-decoder model, ``min(seq_len, 4096)`` encoder rows."""
    return T.init_cache(cfg, batch, shape.seq_len, device="meta",
                        enc_len=min(shape.seq_len, 4096))


# ---------------------------------------------------------------------------
# Model-FLOPs accounting (6·N·D train / 2·N·D inference, N = active matmul
# params; MoE counts the routed fraction top_k/E)
# ---------------------------------------------------------------------------
def active_matmul_params(cfg: ModelConfig, params) -> float:
    total = 0.0
    moe_scale = (cfg.moe.top_k / cfg.moe.num_experts
                 if cfg.moe.num_experts else 1.0)

    def walk(node, path):
        nonlocal total
        if isinstance(node, torch.Tensor):
            if node.dim() < 2 or path[-1] in ("embed",):
                return
            scale = moe_scale if ("moe" in path and path[-1] in (
                "w_gate", "w_up", "w_down")) else 1.0
            # stacked runs carry their layer count in dim 0
            total += float(node.numel()) * scale
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(params, ())
    if cfg.tie_embeddings:
        total += float(cfg.vocab_size * cfg.d_model)   # logits matmul
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig, params) -> float:
    n = active_matmul_params(cfg, params)
    tokens = shape.global_batch * (shape.seq_len if shape.mode in
                                   ("train", "prefill") else 1)
    per_tok = 6.0 if shape.mode == "train" else 2.0
    return per_tok * n * tokens


# ---------------------------------------------------------------------------
# Synthetic compressed-deploy shapes (uniform rank, tile-aligned)
# ---------------------------------------------------------------------------
_COMPRESSIBLE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "w_in", "w_z", "w_out", "w_bc", "ff_gate", "ff_up",
                 "ff_down"}


def factorized_shapes(tree, specs, ratio: float, multiple: int = 128):
    """Map dense linear {w} meta tensors to factorized {B, C} at a uniform
    parameter ratio (shape-level plan for counting the deploy form)."""
    def walk(node, spec, path):
        if isinstance(node, dict):
            if "w" in node and isinstance(node["w"], torch.Tensor) \
                    and path and path[-1] in _COMPRESSIBLE \
                    and ("decoder" in path or "encoder" in path):
                w = node["w"]
                *stack, d1, d2 = w.shape
                r = int((1 - ratio) * d1 * d2 / (d1 + d2))
                r = max(multiple, r // multiple * multiple)
                r = min(r, d1, d2)
                wspec = spec["w"]
                st = tuple(wspec[:-2])
                new = {"B": _meta((*stack, d1, r), w.dtype),
                       "C": _meta((*stack, r, d2), w.dtype)}
                nspec = {"B": st + (wspec[-2], "rank"),
                         "C": st + ("rank", wspec[-1])}
                if "b" in node:
                    new["b"] = node["b"]
                    nspec["b"] = spec["b"]
                return new, nspec
            out_n, out_s = {}, {}
            for k in node:
                out_n[k], out_s[k] = walk(node[k], spec[k], path + (k,))
            return out_n, out_s
        return node, spec

    return walk(tree, specs, ())


# ---------------------------------------------------------------------------
# What a rank holds
# ---------------------------------------------------------------------------
def _shard_shape(shape, spec, mesh) -> tuple:
    """A leaf's block on one rank under ``spec`` (every dim divides: the
    spec is shape-aware)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = SH._axes_of(entry)
        out.append(dim // SH.axis_group_size(mesh, axes) if axes else dim)
    return tuple(out)


def _block_bytes(t: torch.Tensor, axes, mesh) -> int:
    spec = SH.shape_aware_spec(tuple(t.shape), axes, mesh)
    n = t.element_size()
    for d in _shard_shape(tuple(t.shape), spec, mesh):
        n *= d
    return n


def _local(t: torch.Tensor, axes, mesh, keep=("pod", "data", "model")):
    """This rank's meta block of ``t`` along the axes the port places:
    ``keep`` names the mesh axes that split it (others replicate)."""
    spec = SH.shape_aware_spec(tuple(t.shape), axes, mesh)
    spec = [tuple(a for a in SH._axes_of(e) if a in keep) for e in spec]
    return _meta(_shard_shape(tuple(t.shape), spec, mesh), t.dtype)


def _with_axes(params, specs) -> list:
    """[(tensor, logical axes)] of every leaf of a params tree, the axes
    from its spec tree."""
    out = []
    for path, v in pytree.flatten_with_path(params):
        axes = specs
        for _, k in path:
            axes = axes[k]
        out.append((v, axes))
    return out


def local_params(params, specs, mesh):
    """The rank's parameters when it serves: every leaf whole but a
    Mixture-of-Experts expert stack, which holds E/``model`` experts
    (expert parallelism)."""
    return pytree.unflatten(params, [
        _local(v, axes, mesh, keep=("model",)) if "experts" in axes else v
        for v, axes in _with_axes(params, specs)])


def rule_argument_bytes(args_axes, mesh) -> int:
    """Per-rank bytes of (tensor, logical axes) pairs under the sharding
    rules: what JAX's dry-run places on a device."""
    return sum(_block_bytes(t, axes, mesh) for t, axes in args_axes)


# ---------------------------------------------------------------------------
# Per-cell accounting
# ---------------------------------------------------------------------------
def roofline(counted_flops: float, counted_bytes: float,
             coll_bytes: float, model_flops_: float, n_dev: int) -> Dict:
    rf = {"compute_s": counted_flops / H100_SXM.peak_flops,
          "memory_s": counted_bytes / H100_SXM.hbm_bytes_per_s,
          "collective_s": coll_bytes / H100_SXM.link_bytes_per_s,
          "useful_flops_ratio": model_flops_ / max(counted_flops * n_dev,
                                                   1.0)}
    rf["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                         key=lambda k: rf[k])
    return rf


def account_cell(arch: str, shape_name: str, mesh: Mesh, *,
                 compressed: float = 0.0, microbatches: int = 1,
                 overrides: Optional[Dict] = None,
                 rules: Optional[Dict] = None,
                 resident: bool = False) -> Dict:
    """One rank's step of a cell, counted on ``meta`` (see the module's
    note); ``resident`` counts the kernels' intermediates on chip (JAX's
    ``pallas_flash``). The result has JAX's keys where the meaning carries;
    ``cost.counted_*`` replace ``hlo_*``, ``count_s`` the lower and compile
    seconds."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": why}
    if mesh.rank is None:
        mesh = Mesh(tuple(mesh.shape.values()), mesh.axis_names, rank=0,
                    build_groups=False)
    params, specs = T.init_model(cfg, device="meta")
    if compressed > 0:
        params, specs = factorized_shapes(params, specs, compressed)
    mf = model_flops(cfg, shape, params)
    dp = ("pod", "data")
    with SH.use_rules(rules or {}, mesh=mesh):
        p_axes = _with_axes(params, specs)
        lp = local_params(params, specs, mesh)
        gbatch = batch_specs(cfg, shape, with_labels=shape.mode == "train")
        b_axes = [(v, batch_axes(k, v)) for k, v in gbatch.items()]
        batch = {k: _local(v, batch_axes(k, v), mesh, keep=dp)
                 for k, v in gbatch.items()}
        if shape.mode == "train":
            # the state: params, AdamW's step and float32 mu, nu (sharded
            # as the params), each rank holding its blocks
            moments = [(_meta(t.shape, torch.float32), a) for t, a in p_axes]
            state_axes = (p_axes + [(_meta((), torch.int32), ())]
                          + moments + moments)
            args_axes = state_axes + b_axes
            rule_state = rule_argument_bytes(state_axes, mesh)
            tcfg = TS.TrainConfig(microbatches=microbatches,
                                  optimizer=OptimizerConfig(
                                      total_steps=10 ** 5))
            fn = TS.make_train_step(cfg, tcfg, mesh=mesh)
            # the step's own placement of the state, on meta
            state, _ = TS.shard_state(TS.TrainState(
                params=params, opt=adamw_init(params)), specs, mesh)
            args = (state, batch)
        elif shape.mode == "prefill":
            args_axes = p_axes + b_axes

            def fn(p, b):
                with torch.no_grad():
                    return T.prefill(p, cfg, b, max_len=shape.seq_len + 128)
            args = (lp, batch)
        else:
            gb = shape.global_batch
            tok = _meta((gb, 1), torch.int32)
            args_axes = (p_axes + [(t, cache_axes(t)) for t in
                                   pytree.tensors(decode_cache(cfg, shape,
                                                               gb))]
                         + [(tok, ("batch", None))])
            tok = _local(tok, ("batch", None), mesh, keep=dp)

            def fn(p, c, t):
                with torch.no_grad():
                    return T.decode_step(p, cfg, c, t)
            args = (lp, decode_cache(cfg, shape, tok.shape[0]), tok)
        rule_bytes = rule_argument_bytes(args_axes, mesh)
        res = op_analysis.count(fn, *args, resident=resident,
                                world=mesh.size)
    n_dev = mesh.size
    coll = res["collectives"]
    memory = dict(res["memory"], rule_argument_bytes=rule_bytes)
    if shape.mode == "train":
        memory["rule_state_bytes"] = rule_state
        memory["state_bytes"] = sum(t.numel() * t.element_size()
                                    for t in pytree.tensors(args[0]))
    result = {
        "arch": arch, "shape": shape_name, "mesh": list(mesh.shape.values()),
        "mesh_axes": list(mesh.axis_names), "devices": n_dev,
        "mode": shape.mode, "compressed": compressed,
        "microbatches": microbatches, "resident": resident,
        "overrides": overrides or {}, "rules": rules or {},
        "count_s": round(res["count_s"], 2),
        "memory": memory,
        "fits": memory["peak_bytes"] <= H100_SXM.hbm_bytes,
        "cost": {"counted_flops": res["flops"],
                 "counted_bytes": res["bytes"]},
        "kernels": res["kernels"],
        "collectives": {"total_bytes": coll["total_bytes"],
                        "per_op": coll["per_op"]},
        "model_flops": mf,
        "roofline": roofline(res["flops"], res["bytes"],
                             coll["total_bytes"], mf, n_dev),
        "card": H100_SXM.name,
    }
    return result


def cell_path(mesh_name: str, arch: str, shape: str, tag: str = "") -> str:
    d = os.path.join(RESULT_DIR, mesh_name)
    os.makedirs(d, exist_ok=True)
    sfx = f"__{tag}" if tag else ""
    return os.path.join(d, f"{arch}__{shape}{sfx}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Count every (arch x shape) cell of a production mesh "
                    "for one rank, on meta tensors (nothing is allocated "
                    "on any device).")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--compressed", type=float, default=0.0,
                    help="also count the factorized deploy form at this "
                         "ratio")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--override", default="",
                    help='JSON ModelConfig overrides, e.g. {"remat":"dots"}')
    ap.add_argument("--rules", default="",
                    help='JSON logical-axis rule overrides, '
                         'e.g. {"seq":"model"}')
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--resident", action="store_true",
                    help="count the kernels' intermediates (low-rank t, "
                         "the flash score tile) as kept on chip")
    args = ap.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None
    rules = json.loads(args.rules) if args.rules else None
    if rules:
        rules = {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in rules.items()}

    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    archs = [a for a in archs if a != "llama-mini"]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            out = cell_path(args.mesh, arch, shape, args.tag)
            if os.path.exists(out) and not args.force:
                print(f"[cached] {arch} x {shape}")
                continue
            try:
                res = account_cell(arch, shape, mesh,
                                   compressed=args.compressed,
                                   microbatches=args.microbatches,
                                   overrides=overrides, rules=rules,
                                   resident=args.resident)
            except Exception as e:
                res = {"arch": arch, "shape": shape, "error":
                       f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
            if res.get("skipped"):
                n_skip += 1
                print(f"[skip]   {arch} x {shape}: {res['reason']}")
            elif "error" in res:
                n_fail += 1
                print(f"[FAIL]   {arch} x {shape}: {res['error'][:200]}")
            else:
                n_ok += 1
                r = res["roofline"]
                m = res["memory"]
                print(f"[ok]     {arch} x {shape} dominant={r['dominant']} "
                      f"compute={r['compute_s']:.4f}s "
                      f"memory={r['memory_s']:.4f}s "
                      f"coll={r['collective_s']:.4f}s peak="
                      f"{m['peak_bytes'] / 1e9:.2f} GB fits={res['fits']} "
                      f"(count {res['count_s']}s)")
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
