"""Enumerate compressible weight matrices and build cross-layer groups.

Matrix inventory follows the model substrate's block structure
(``repro.models.transformer``); each entry records where the weight lives in
the list-form params tree, its matrix *type* (q/k/v/o/gate/up/down + family
analogues), its global layer index, and the capture tag that holds its
calibration Gram.

Grouping policy (paper §3.1/§3.4):
  * groupable types (q, k, v, up, gate + analogues) are concatenated across
    `group_size` consecutive layers and share one basis;
  * W_down / W_O are never grouped;
  * GQA models use group_size = 1 (paper's LLaMA-3 finding) — applied when
    ``gqa_group_one`` and cfg.n_kv_heads < cfg.n_heads;
  * routed MoE experts are each their own group (n = 1) but participate in
    the global rank allocation (beyond-paper extension, DESIGN.md §4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


from repro_torch.config import ModelConfig
from repro_torch.models.params import Params

# type -> groupable across layers
GROUPABLE = {
    "q": True, "k": True, "v": True, "o": False,
    "gate": True, "up": True, "down": False,
    "cq": True, "ck": True, "cv": True, "co": False,
    "eq": True, "ek": True, "ev": True, "eo": False,
    "egate": True, "eup": True, "edown": False,
    "sgate": True, "sup": True, "sdown": False,          # MoE shared experts
    "mup": True, "mgate": True, "mq": True, "mk": True, "mdown": False,
    "lin": True, "lfgate": True, "lfup": True, "lfdown": False,  # sLSTM
    "ssm_in": True, "ssm_z": True, "ssm_bc": False, "ssm_out": False,
    "xgate": False, "xup": False, "xdown": False,        # routed experts
}

# β-rebalance donor/receiver types (paper: W^Q, W^K -> W^V), per stack
BETA_MAP = [
    (("q", "k"), "v"),
    (("cq", "ck"), "cv"),
    (("eq", "ek"), "ev"),
]


@dataclass
class MatrixRef:
    path: Tuple                  # keys into list-form params, ending at the
    #                              linear dict (e.g. ("decoder","run0",0,"attn","wq"))
    mtype: str
    layer: int                   # global layer index (enc layers offset +1000)
    tag: str                     # Gram key in the Collector
    d_in: int = 0
    d_out: int = 0
    expert: Optional[int] = None  # routed-expert index (array-slice member)


@dataclass
class Group:
    gid: str
    mtype: str
    members: List[MatrixRef]

    @property
    def n(self) -> int:
        return len(self.members)

    @property
    def d_in(self) -> int:
        return self.members[0].d_in

    @property
    def d_out(self) -> int:
        return self.members[0].d_out

    @property
    def omega(self) -> int:
        return self.d_in + self.n * self.d_out

    @property
    def dense_params(self) -> int:
        return self.n * self.d_in * self.d_out

    @property
    def max_rank(self) -> int:
        return min(self.d_in, self.n * self.d_out)

    @property
    def cost_cap(self) -> int:
        """Largest k at which the factorized form is no bigger than dense."""
        return min(self.max_rank, self.dense_params // self.omega)


_BLOCK_TABLE = {
    # sub-module -> {param name -> type}
    "attn": {"wq": "q", "wk": "k", "wv": "v", "wo": "o"},
    "cross": {"wq": "cq", "wk": "ck", "wv": "cv", "wo": "co"},
    "mlp": {"w_gate": "gate", "w_up": "up", "w_down": "down"},
    "moe_shared": {"w_gate": "sgate", "w_up": "sup", "w_down": "sdown"},
    "mlstm": {"w_up": "mup", "w_gate": "mgate", "wq": "mq", "wk": "mk",
              "w_down": "mdown"},
    "slstm": {"w_in": "lin", "ff_gate": "lfgate", "ff_up": "lfup",
              "ff_down": "lfdown"},
    "ssm": {"w_in": "ssm_in", "w_z": "ssm_z", "w_bc": "ssm_bc",
            "w_out": "ssm_out"},
}

_ENC_TABLE = {
    "attn": {"wq": "eq", "wk": "ek", "wv": "ev", "wo": "eo"},
    "mlp": {"w_gate": "egate", "w_up": "eup", "w_down": "edown"},
}


def _linear_dims(d: Dict) -> Tuple[int, int]:
    w = d["w"]
    return int(w.shape[-2]), int(w.shape[-1])


def enumerate_matrices(list_params: Params, cfg: ModelConfig,
                       include_experts: bool = True) -> List[MatrixRef]:
    refs: List[MatrixRef] = []

    def walk_stack(stack: Dict, runs, table, base_path, layer0: int):
        layer = layer0
        for r, (_kind, n) in enumerate(runs):
            layers = stack[f"run{r}"]
            assert isinstance(layers, list), "enumerate needs list-form params"
            for i, lp in enumerate(layers):
                for sub, names in table.items():
                    if sub not in lp:
                        continue
                    for pname, mtype in names.items():
                        if pname not in lp[sub]:
                            continue
                        d = lp[sub][pname]
                        if "w" not in d:
                            continue       # already factorized
                        din, dout = _linear_dims(d)
                        path = base_path + (f"run{r}", i, sub, pname)
                        refs.append(MatrixRef(
                            path=path, mtype=mtype, layer=layer,
                            tag="/".join(map(str, path)),
                            d_in=din, d_out=dout))
                # routed experts: stacked arrays under lp["moe"]
                if include_experts and "moe" in lp and "w_gate" in lp["moe"]:
                    moe_tag = "/".join(map(str, base_path
                                           + (f"run{r}", i, "moe")))
                    E = int(lp["moe"]["w_gate"].shape[0])
                    dd = int(lp["moe"]["w_gate"].shape[1])
                    ff = int(lp["moe"]["w_gate"].shape[2])
                    for e in range(E):
                        base = base_path + (f"run{r}", i, "moe")
                        refs.append(MatrixRef(
                            path=base + ("w_gate",), mtype="xgate",
                            layer=layer, expert=e,
                            tag=f"{moe_tag}/in/expert{e}",
                            d_in=dd, d_out=ff))
                        refs.append(MatrixRef(
                            path=base + ("w_up",), mtype="xup",
                            layer=layer, expert=e,
                            tag=f"{moe_tag}/in/expert{e}",
                            d_in=dd, d_out=ff))
                        refs.append(MatrixRef(
                            path=base + ("w_down",), mtype="xdown",
                            layer=layer, expert=e,
                            tag=f"{moe_tag}/mid/expert{e}",
                            d_in=ff, d_out=dd))
                layer += 1

    walk_stack(list_params["decoder"], cfg.layer_runs(), _BLOCK_TABLE,
               ("decoder",), 0)
    if cfg.is_encoder_decoder and "encoder" in list_params:
        enc_cfg = cfg.replace(n_layers=cfg.n_encoder_layers,
                              sliding_window=0, local_global_pattern=(0, 0))
        walk_stack(list_params["encoder"], enc_cfg.layer_runs(), _ENC_TABLE,
                   ("encoder",), 1000)
    return refs


def build_groups(refs: Sequence[MatrixRef], cfg: ModelConfig,
                 group_size: int, gqa_group_one: bool = True) -> List[Group]:
    n = group_size
    if gqa_group_one and cfg.n_kv_heads < cfg.n_heads:
        n = 1          # paper §3.4: GQA models use per-layer compression
    by_type: Dict[str, List[MatrixRef]] = {}
    for ref in refs:
        by_type.setdefault(ref.mtype, []).append(ref)
    groups: List[Group] = []
    for mtype, items in by_type.items():
        items = sorted(items, key=lambda r: (r.layer, r.expert or 0))
        if mtype.startswith("x"):        # routed experts: one group each
            for ref in items:
                groups.append(Group(
                    gid=f"{mtype}:L{ref.layer}e{ref.expert}",
                    mtype=mtype, members=[ref]))
            continue
        size = n if GROUPABLE.get(mtype, False) else 1
        for j in range(0, len(items), size):
            chunk = items[j:j + size]
            groups.append(Group(
                gid=f"{mtype}:g{j // size}", mtype=mtype, members=chunk))
    return groups
