"""The port's Mixture-of-Experts layer and MoE models against the JAX
package's, on the CPU, on weights bridged through numpy.

``apply_moe`` on granite-moe-1b-a400m and qwen2-moe-a2.7b reduced (the
latter with three real experts padded to four, one shared expert and a
capacity factor of 1.0, so the padding is masked and rows are dropped),
dense and factorized experts: output and aux loss within 1e-5, and the
dispatches' slots and kept masks identical. Then the model: prefill plus
decode against the full forward (2e-3, the tier of
``tests/test_decode_consistency.py``) and against JAX's logits, and
``lm_loss`` with its grads against ``jax.value_and_grad`` (loss 1e-5,
grads 1e-4 of each leaf's largest), stacked with remat and as a D-Rank
list-form model with factorized experts."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoEConfig
from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch import bridge, pytree
from repro_torch.config import MoEConfig
from repro_torch.configs import get_config
from repro_torch.models import mlp as M
from repro_torch.models import transformer as T
from repro_torch.train import step as TS
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
GRANITE = "granite-moe-1b-a400m"
QWEN = "qwen2-moe-a2.7b"
# qwen2-moe reduced with a padding expert, a shared expert and real drops
QWEN_MOE = dict(num_experts=3, top_k=2, d_expert=32, num_shared=1,
                d_shared=32, capacity_factor=1.0, pad_to=4)


def configs(arch):
    """(JAX config, port config), reduced; qwen2-moe with QWEN_MOE."""
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    if arch == QWEN:
        jc = jc.replace(moe=JMoEConfig(**QWEN_MOE))
        tc = tc.replace(moe=MoEConfig(**QWEN_MOE))
    return jc, tc


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def np_tree(t):
    return jax.tree.map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def model(arch):
    """(JAX params, port params bridged from them)."""
    jc, _ = configs(arch)
    jp, _ = JT.init_model(jc, jax.random.PRNGKey(0))
    return jp, bridge.from_numpy(np_tree(jp), device=CPU)


def layer0(arch, factorized: bool):
    """Layer 0 of run 0 as a numpy tree; with ``factorized`` the expert
    stacks are seeded random factors {"B": (E, d, R), "C": (E, R, f)}."""
    jp, _ = model(arch)
    lp = jax.tree.map(lambda a: np.asarray(a[0]), jp["decoder"]["run0"])
    if factorized:
        rng = np.random.default_rng(5)
        for k in ("w_gate", "w_up", "w_down"):
            E, d, f = lp["moe"][k].shape
            r = 12
            lp["moe"][k] = {
                "B": (rng.standard_normal((E, d, r)) * r ** -0.5
                      ).astype(np.float32),
                "C": (rng.standard_normal((E, r, f)) * 0.02
                      ).astype(np.float32)}
    return lp


class Dispatches:
    """Records (slot, kept) of every ``_dispatch_to_buffers`` call of one
    package's MoE layer."""

    def __init__(self, module, monkeypatch):
        self.calls = []
        inner = module._dispatch_to_buffers

        def spy(*args):
            buf, slot, kept = inner(*args)
            self.calls.append((np.asarray(slot), np.asarray(kept)))
            return buf, slot, kept
        monkeypatch.setattr(module, "_dispatch_to_buffers", spy)


@pytest.mark.parametrize("factorized", [False, True],
                         ids=["dense", "factorized"])
@pytest.mark.parametrize("arch", [GRANITE, QWEN])
def test_apply_moe_matches_jax(arch, factorized, monkeypatch):
    jc, tc = configs(arch)
    lp = layer0(arch, factorized)
    x = np.random.default_rng(1).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    jd, td = Dispatches(JM, monkeypatch), Dispatches(M, monkeypatch)
    jout, jaux = JM.apply_moe(jax.tree.map(jnp.asarray, lp), jc,
                              jnp.asarray(x))
    tout, taux = M.apply_moe(bridge.from_numpy(lp, device=CPU), tc,
                             torch.as_tensor(x))
    assert tout.shape == x.shape
    assert np.abs(tout.numpy() - np.asarray(jout)).max() <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-5
    # first level, its meta buffer, second level: same slots, same drops
    assert len(td.calls) == len(jd.calls) == 3
    for (ts, tk), (js, jk) in zip(td.calls, jd.calls):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tk, jk)
    if arch == QWEN:
        assert not td.calls[2][1].all(), "capacity 1.0 dropped no row"


def test_dispatch_drops_past_capacity_onto_the_sentinel():
    x = torch.arange(1, 7, dtype=torch.float32)[:, None].repeat(1, 2)
    dest = torch.tensor([0, 1, 0, 0, 5, 1])      # 5 >= n_dest: dropped
    buf, slot, kept = M._dispatch_to_buffers(x, dest, 2, 2)
    assert slot.tolist() == [0, 0, 1, 2, 0, 1]
    assert kept.tolist() == [True, True, True, False, False, True]
    assert buf[:, :, 0].tolist() == [[1.0, 3.0], [2.0, 6.0]]
    back = M._undispatch(buf, dest, slot, kept)
    assert back[:, 0].tolist() == [1.0, 2.0, 3.0, 0.0, 0.0, 6.0]
    assert [M.capacity(n, e, f) for n, e, f in
            ((64, 1, 1.25), (80, 32, 1.25), (8192, 1, 1.25),
             (10240, 32, 1.25))] == [80, 8, 10240, 400]


# ---------------------------------------------------------------------------
# the model: prefill + decode, logits
# ---------------------------------------------------------------------------
def test_granite_prefill_decode_matches_forward_and_jax():
    """The torch twin of tests/test_decode_consistency.py's granite case."""
    jc, tc = configs(GRANITE)
    jp, tp = model(GRANITE)
    S, split = 24, 12
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, S),
                                             dtype=np.int32)
    full, aux = T.forward(tp, tc, {"tokens": torch.as_tensor(toks)})
    jfull, jaux = JT.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    assert np.abs(full.numpy() - np.asarray(jfull)).max() <= 2e-3
    assert abs(float(aux["moe_aux"]) - float(jaux["moe_aux"])) <= 1e-5
    assert float(aux["moe_aux"]) > 0
    with torch.no_grad():
        lg, cache = T.prefill(tp, tc, {"tokens": torch.as_tensor(
            toks[:, :split])}, max_len=S + 8)
        outs = [lg]
        for t in range(split, S):
            lg, cache = T.decode_step(tp, tc, cache,
                                      torch.as_tensor(toks[:, t:t + 1]))
            outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full[:, split - 1:S]).abs().max()) < 2e-3


# ---------------------------------------------------------------------------
# lm_loss and grads
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def loss_params(form):
    """(JAX params, port params) of reduced granite: stacked, or D-Rank
    30% list form with factorized experts."""
    jc, _ = configs(GRANITE)
    jp, tp = model(GRANITE)
    if form == "drank":
        toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 16),
                                                 dtype=np.int32)
        jp, _ = JC.build_plan_and_params(
            jp, jc, JC.CompressionConfig(ratio=0.3),
            [{"tokens": jnp.asarray(toks)}], streaming=False)
        tp = bridge.from_numpy(np_tree(jp), device=CPU)
    return jp, tp


@pytest.mark.parametrize("form", ["stacked", "drank"])
def test_lm_loss_and_grads_match_jax(form):
    jc, tc = configs(GRANITE)
    if form == "stacked":   # remat on a stacked MoE run, both packages
        jc, tc = jc.replace(remat="block"), tc.replace(remat="block")
    jp, tp = loss_params(form)
    toks = np.random.default_rng(4).integers(0, tc.vocab_size, (2, 16),
                                             dtype=np.int32)
    (jloss, jm), jg = jax.value_and_grad(
        functools.partial(JT.lm_loss, cfg=jc), has_aux=True)(
        jp, batch={"tokens": jnp.asarray(toks)})
    loss, m, grads = TS.value_and_grad(tp, tc,
                                       {"tokens": torch.as_tensor(toks)})
    assert rel(float(loss), float(jloss)) <= 1e-5
    assert sorted(m) == sorted(jm) and "moe_aux" in m
    assert rel(float(m["moe_aux"]), float(jm["moe_aux"])) <= 1e-5
    g = pytree.flatten_with_path(grads)
    w, _ = jax.tree_util.tree_flatten_with_path(jg)
    assert [pytree.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w]
    router = 0
    for (p, a), (_, b) in zip(g, w):
        assert rel(a.detach().numpy(), np.asarray(b)) <= 1e-4, \
            pytree.keystr(p)
        router += "router" in pytree.keystr(p)
    assert router, "the router took no grad"
