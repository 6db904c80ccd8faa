"""The port's model (``repro_torch.models.transformer``) against the JAX
package's on the same weights: JAX ``init_model`` params, dense and D-Rank
compressed, bridged into torch on the CPU. Logits of ``forward``,
``prefill`` and a few ``decode_step``s agree within atol 2e-3
(tests/test_kernels.py:141). Inputs are numpy, made from a seed."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ATOL = 2e-3
CPU = torch.device("cpu")

# (port config, JAX config): llama-mini reduced kept MHA; SmolLM reduced
# with 6 query heads over 2 KV heads (GQA G = 3, tied embeddings); Gemma-3
# reduced, cut to one sliding-window (ring cache) and one global layer,
# also at its full head_dim of 256.
CONFIGS = {
    "llama-mini-mha": ("llama-mini", dict(n_kv_heads=4)),
    "smollm-gqa3": ("smollm-360m", dict(n_heads=6, n_kv_heads=2)),
    "gemma3-swa": ("gemma3-12b", dict(n_layers=2)),
    "gemma3-hd256": ("gemma3-12b", dict(n_layers=2, head_dim=256)),
}


def _cfgs(name):
    arch, kw = CONFIGS[name]
    return get_config(arch).reduced(**kw), jget_config(arch).reduced(**kw)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _models(name, compressed):
    """(port cfg, JAX cfg, JAX params, port params on the CPU)."""
    cfg, jcfg = _cfgs(name)
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    if compressed:
        rng = np.random.default_rng(1)
        calib = [{"tokens": jnp.asarray(rng.integers(
            0, jcfg.vocab_size, (2, 16), dtype=np.int32))}]
        jp, _ = JC.build_plan_and_params(
            jp, jcfg, JC.CompressionConfig(method="drank", ratio=0.3),
            calib, streaming=False)
    return cfg, jcfg, jp, bridge.from_numpy(_np_tree(jp), device=CPU)


def _close(a, b):
    a = a.detach().float().numpy()
    b = np.asarray(b, dtype=np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < ATOL, err


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("name,compressed", [
    ("llama-mini-mha", False), ("llama-mini-mha", True),
    ("smollm-gqa3", False), ("smollm-gqa3", True),
    ("gemma3-swa", False), ("gemma3-hd256", False),
])
def test_forward_prefill_decode_match_jax(name, compressed):
    cfg, jcfg, jp, tp = _models(name, compressed)
    if compressed:
        assert isinstance(tp["decoder"]["run0"], list)
        assert "B" in tp["decoder"]["run0"][0]["attn"]["wq"]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)

    logits, _ = T.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    jlogits, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(logits, jlogits)

    # ragged prompts: row 1 is live for 9 of its 12 positions
    lengths = np.asarray([12, 9], dtype=np.int32)
    max_len = 20            # > gemma3 reduced's window of 8: the ring wraps
    tl, cache = T.prefill(tp, cfg, {"tokens": torch.as_tensor(toks),
                                    "lengths": torch.as_tensor(lengths)},
                          max_len=max_len)
    jl, jcache = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                       "lengths": jnp.asarray(lengths)},
                            max_len=max_len)
    _close(tl, jl)
    for _ in range(3):
        tok = np.array(jnp.argmax(jl[:, -1:], -1), dtype=np.int32)
        tl, cache = T.decode_step(tp, cfg, cache, torch.as_tensor(tok))
        jl, jcache = JT.decode_step(jp, jcfg, jcache, jnp.asarray(tok))
        _close(tl, jl)
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def test_dead_slot_decodes_exact_zero_attention():
    """A slot with pos = -1 stays dead through decode: its position does not
    advance and it never disturbs the live rows (they match a batch that
    holds the live row alone)."""
    cfg, _, _, tp = _models("smollm-gqa3", False)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 6),
                                        dtype=np.int32))
    _, cache = T.prefill(tp, cfg, {"tokens": toks}, max_len=10)
    cache["pos"] = torch.tensor([-1, 6], dtype=torch.int32)
    _, solo = T.prefill(tp, cfg, {"tokens": toks[1:]}, max_len=10)
    nxt = torch.tensor([[3], [5]], dtype=torch.int32)
    lg, cache = T.decode_step(tp, cfg, cache, nxt)
    ls, solo = T.decode_step(tp, cfg, solo, nxt[1:])
    assert cache["pos"].tolist() == [-1, 7]
    torch.testing.assert_close(lg[1:], ls, atol=1e-5, rtol=1e-5)


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """With no card and no explicit device, an entry point raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama-mini").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_model(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 2, 8)
    params, _ = T.init_model(cfg, seed=0, device="cpu")
    assert params["embed"].device.type == "cpu"
