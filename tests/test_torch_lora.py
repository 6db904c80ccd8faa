"""The port's LoRA recovery path (``repro_torch.train.lora``) against the
JAX package's on a D-Rank compressed model: the adapters cover the same
linears with the same shapes, merging leaves the base tree alone and a
group's shared basis one tensor, and four ``lora_finetune`` steps from
bridged adapters give JAX's losses (1e-5) and a merged model whose loss
on a held-out batch is JAX's (1e-5). Also: the
low-rank product's backward computes only the grads asked for."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.models import transformer as JT
from repro.train import lora as JL
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.train import lora as L
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
# MHA (kv = heads), so D-Rank groups two layers behind one shared basis
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab_size=256)
CFG = get_config("llama-mini").replace(**SMALL)
JCFG = jget_config("llama-mini").replace(**SMALL)


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _compressed():
    """(JAX D-Rank 30% list-form params, bridged, batches as numpy)."""
    jp, _ = JT.init_model(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, SMALL["vocab_size"], (2, 16), dtype=np.int32)
            for _ in range(4)]
    jc, _ = JC.build_plan_and_params(
        jp, JCFG, JC.CompressionConfig(method="drank", ratio=0.3),
        [{"tokens": jnp.asarray(toks[0])}], streaming=False)
    return jc, bridge.from_numpy(jax.tree.map(np.asarray, jc),
                                 device=CPU), toks


def test_adapters_cover_jaxs_linears_and_merge_non_destructively():
    jc, tc, _ = _compressed()
    jad = JL.init_lora(jc, JCFG, jax.random.PRNGKey(0), rank=4, alpha=8.0)
    gen = torch.Generator().manual_seed(0)
    ad = L.init_lora(tc, CFG, gen, rank=4, alpha=8.0)
    assert sorted(ad) == sorted(jad)
    for k in ad:
        for leaf in ("lora_A", "lora_B", "lora_scale"):
            assert tuple(ad[k][leaf].shape) == tuple(jad[k][leaf].shape)
            assert ad[k][leaf].dtype == torch.float32
        assert float(ad[k]["lora_scale"]) == 2.0
        assert not ad[k]["lora_B"].any()
    merged = L.merge_lora(tc, ad)
    run = tc["decoder"]["run0"]
    assert "lora_A" not in run[0]["attn"]["wq"]             # base untouched
    assert merged["decoder"]["run0"][1]["mlp"]["w_up"]["lora_A"] is \
        ad["decoder/run0/1/mlp/w_up"]["lora_A"]
    # a group's shared basis stays one tensor through the merge
    shared = [(i, m) for m in ("w_gate", "w_up", "w_down")
              for i in (0, 1)]
    bs = {(i, m): merged["decoder"]["run0"][i]["mlp"][m]["B"]
          for i, m in shared}
    for (i, m), b in bs.items():
        assert b is run[i]["mlp"][m]["B"]
    assert any(bs[(0, m)] is bs[(1, m)] for m in ("w_gate", "w_up",
                                                  "w_down"))


def test_lora_finetune_matches_jax_for_four_steps(monkeypatch):
    jc, tc, toks = _compressed()
    kw = dict(steps=4, rank=8, alpha=32.0, lr=1e-3, seed=0)
    jad = JL.init_lora(jc, JCFG, jax.random.PRNGKey(0), 8, 32.0)
    seen = []

    def from_jax(params, cfg, gen, rank, alpha):
        seen.append((rank, alpha))
        return bridge.from_numpy(jax.tree.map(np.asarray, jad), device=CPU)
    monkeypatch.setattr(L, "init_lora", from_jax)
    jmerged, jhist = JL.lora_finetune(
        jc, JCFG, [{"tokens": jnp.asarray(t)} for t in toks], **kw)
    merged, hist = L.lora_finetune(
        tc, CFG, [{"tokens": torch.as_tensor(t)} for t in toks], **kw)
    assert seen == [(8, 32.0)]
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 3]
    for h, jh in zip(hist, jhist):
        assert rel(h["loss"], jh["loss"]) <= 1e-5, (h, jh)
    # the merged models agree on a held-out batch (Adam's normalization
    # amplifies the grads' last bits in single adapter entries, so the
    # adapters are held by what they compute)
    held = np.random.default_rng(9).integers(0, SMALL["vocab_size"], (2, 16),
                                             dtype=np.int32)
    jloss, _ = JT.lm_loss(jmerged, JCFG, {"tokens": jnp.asarray(held)})
    loss, _ = T.lm_loss(merged, CFG, {"tokens": torch.as_tensor(held)})
    assert rel(float(loss), float(jloss)) <= 1e-5
    for path in jad:
        node, base = merged, tc
        for k in path.split("/"):
            k = int(k) if k.isdigit() else k
            node, base = node[k], base[k]
        assert node["lora_A"].shape == jad[path]["lora_A"].shape
        for leaf in ("B", "C", "w"):       # the base is never trained
            if leaf in base:
                assert node[leaf] is base[leaf]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lowrank_backward_computes_only_the_grads_asked_for(dtype):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 70, 48, generator=g).to(dtype)
    B = torch.randn(48, 12, generator=g).to(dtype)
    C = torch.randn(12, 40, generator=g).to(dtype)
    dy = torch.randn(3, 70, 40, generator=g).to(dtype)

    def grads(need_bc):
        xs = x.clone().requires_grad_()
        Bs = B.clone().requires_grad_(need_bc)
        Cs = C.clone().requires_grad_(need_bc)
        ops.lowrank_matmul(xs, Bs, Cs).backward(dy)
        return xs.grad, Bs.grad, Cs.grad

    dx_all, dB, dC = grads(True)
    dx_x, dB_none, dC_none = grads(False)
    assert torch.equal(dx_x, dx_all)
    assert dB_none is None and dC_none is None
    assert dB.shape == B.shape and dC.shape == C.shape
    # B and C alone: no dx
    Bs = B.clone().requires_grad_()
    ops.lowrank_matmul(x, Bs, C).backward(dy)
    assert torch.equal(Bs.grad, dB)
