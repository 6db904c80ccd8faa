"""The port's recurrent families against the JAX package's, on the CPU, on
weights bridged through numpy: hymba-1.5b (attention and a Mamba-2 head in
parallel, windowed and global layers) and xlstm-350m (mLSTM and sLSTM), at
``reduced()`` sizes in float32.

The param and cache trees' paths, shapes and dtypes equal JAX's; forward
logits within atol 2e-3; ``lm_loss`` within 1e-5 and its grads within 1e-4
of each leaf's largest entry (stacked runs with remat); prefill plus 12
decode steps reproduces the full forward within 2e-3 (the tier of
``tests/test_decode_consistency.py``; hymba's 8-slot rings wrap) and JAX's
decode logits. The sLSTM cache leaves own their storage, and the paths
that would corrupt recurrent state (the paged pool, right-padded
``generate``) refuse these stacks."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E
from repro_torch.train import step as TS
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCHS = ("hymba-1.5b", "xlstm-350m")
S, SPLIT = 24, 12          # 12 prompt tokens, then 12 decode steps


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def tree_sig(flat, keystr):
    return [(keystr(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in flat]


@functools.lru_cache(maxsize=None)
def model(arch):
    """(JAX cfg, port cfg, JAX params, port params bridged from them,
    tokens)."""
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    jp, _ = JT.init_model(jc, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, S),
                                             dtype=np.int32)
    return jc, tc, jp, tp, toks


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_match_jax(arch):
    jc, tc, jp, _, _ = model(arch)
    tp, specs = T.init_model(tc, seed=0, device=CPU)
    js = jax.tree_util.tree_flatten_with_path
    assert tree_sig(pytree.flatten_with_path(tp), pytree.keystr) == \
        tree_sig(js(jp)[0], jax.tree_util.keystr)
    assert T.param_count(tp) == JT.param_count(jp)
    tcache = T.init_cache(tc, 3, 20, device=CPU)
    jcache = JT.init_cache(jc, 3, 20)
    assert tree_sig(pytree.flatten_with_path(tcache), pytree.keystr) == \
        tree_sig(js(jcache)[0], jax.tree_util.keystr)
    # every leaf its own storage: a cache written in place must not alias
    ptrs = [t.data_ptr() for t in pytree.tensors(tcache)]
    assert len(set(ptrs)) == len(ptrs)
    assert int(tcache["pos"].min()) == -1


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    jc, tc, jp, tp, toks = model(arch)
    with torch.no_grad():
        full, _ = T.forward(tp, tc, {"tokens": torch.as_tensor(toks)})
    jfull, _ = JT.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    assert np.abs(full.numpy() - np.asarray(jfull)).max() <= 2e-3

    jdec = jax.jit(lambda p, c, t: JT.decode_step(p, jc, c, t))
    jlg, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :SPLIT])},
                             max_len=S + 4)
    jouts = [np.asarray(jlg)]
    for t in range(SPLIT, S):
        jlg, jcache = jdec(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        jouts.append(np.asarray(jlg))
    with torch.no_grad():
        lg, cache = T.prefill(tp, tc, {"tokens": torch.as_tensor(
            toks[:, :SPLIT])}, max_len=S + 4)
        outs = [lg]
        for t in range(SPLIT, S):
            lg, cache = T.decode_step(tp, tc, cache,
                                      torch.as_tensor(toks[:, t:t + 1]))
            outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full[:, SPLIT - 1:S]).abs().max()) < 2e-3
    assert np.abs(dec.numpy() - np.concatenate(jouts, axis=1)).max() < 2e-3
    assert cache["pos"].tolist() == [S] * 2
    # the decode wrote its state into the cache it was given (in place)
    final = pytree.tensors(cache["runs"])
    jfinal = jax.tree.leaves(jcache["runs"])
    assert len(final) == len(jfinal)
    for a, b in zip(final, jfinal):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    jc, tc, jp, tp, toks = model(arch)
    assert tc.remat == "block" and tc.scan_layers     # remat'd stacked runs
    batch = toks[:, :16]
    (jloss, jm), jg = jax.value_and_grad(
        functools.partial(JT.lm_loss, cfg=jc), has_aux=True)(
        jp, batch={"tokens": jnp.asarray(batch)})
    loss, m, grads = TS.value_and_grad(tp, tc,
                                       {"tokens": torch.as_tensor(batch)})
    assert rel(float(loss), float(jloss)) <= 1e-5
    assert sorted(m) == sorted(jm)
    g = pytree.flatten_with_path(grads)
    w, _ = jax.tree_util.tree_flatten_with_path(jg)
    assert [pytree.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert rel(a.detach().numpy(), np.asarray(b)) <= 1e-4, \
            pytree.keystr(p)


def test_slstm_cache_leaves_do_not_share_storage():
    """JAX's ``init_slstm_cache`` hands one zeros array to c, n and m; the
    port writes its cache in place, so each must be its own tensor."""
    _, tc, _, _, _ = model("xlstm-350m")
    cache = T.init_cache(tc, 2, 8, device=CPU)
    sl = cache["runs"]["run1"]["slstm"]
    assert sorted(sl) == ["c", "h", "m", "n"]
    ptrs = {k: v.untyped_storage().data_ptr() for k, v in sl.items()}
    assert len(set(ptrs.values())) == 4, ptrs
    sl["c"][0, 0, 0, 0] = 1.0
    assert float(sl["n"].abs().sum() + sl["m"].abs().sum()) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_pool_and_padded_generate_refuse_recurrent_stacks(arch):
    _, tc, _, tp, toks = model(arch)
    with pytest.raises(ValueError, match="pure-attention"):
        T.init_cache_paged(tc, 2, 9, 4, device=CPU)
    with pytest.raises(ValueError, match="pure-attention"):
        E.ContinuousBatcher(tp, tc, E.ServeConfig(batch=2, max_len=16,
                                                  kv_block=4), device=CPU)
    eng = E.Engine(tp, tc, E.ServeConfig(), device=CPU)
    with pytest.raises(ValueError, match="recurrent"):
        eng.generate(toks[:, :6], 2, lengths=np.array([6, 4]))
    assert eng.generate(toks[:, :6], 2).shape == (2, 2)
