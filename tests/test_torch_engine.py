"""The port's ``Engine`` against the JAX package's: the same D-Rank
compressed weights (JAX's plan, bridged) give identical greedy tokens."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serve.engine import Engine, ServeConfig
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CONFIGS = {
    "llama-mini-mha": ("llama-mini", dict(n_kv_heads=4)),
    "smollm-gqa3": ("smollm-360m", dict(n_heads=6, n_kv_heads=2)),
}


@functools.lru_cache(maxsize=None)
def _compressed(name):
    arch, kw = CONFIGS[name]
    cfg, jcfg = get_config(arch).reduced(**kw), jget_config(arch).reduced(**kw)
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    calib = [{"tokens": jnp.asarray(rng.integers(
        0, jcfg.vocab_size, (4, 16), dtype=np.int32))}]
    jlp, _ = JC.build_plan_and_params(
        jp, jcfg, JC.CompressionConfig(method="drank", ratio=0.2), calib,
        streaming=False)
    return cfg, jcfg, jlp


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_matches_jax_engine(name):
    cfg, jcfg, jlp = _compressed(name)
    tlp = bridge.from_numpy(jax.tree.map(np.asarray, jlp), device="cpu")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 10), dtype=np.int32)
    eng = Engine(tlp, cfg, ServeConfig(), device="cpu")
    out = eng.generate(prompts, 8)
    jout = JEngine(jlp, jcfg, JServeConfig()).generate(prompts, 8)
    assert out.shape == (3, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(jout))
    if name == "llama-mini-mha":        # MHA: groups of 2 share one basis
        for tree in (tlp, eng.params):
            run = tree["decoder"]["run0"]
            assert run[0]["attn"]["wq"]["B"] is run[1]["attn"]["wq"]["B"]


def test_generate_right_padded_prompts_matches_jax_prefill():
    """``lengths`` gives each row its own prompt length, as ``prefill``
    takes it: the tokens equal a greedy loop over the JAX package's
    ``prefill`` (with the same lengths) and ``decode_step``."""
    cfg, jcfg, jlp = _compressed("smollm-gqa3")
    tlp = bridge.from_numpy(jax.tree.map(np.asarray, jlp), device="cpu")
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 12), dtype=np.int32)
    lengths = np.asarray([12, 4, 9], dtype=np.int32)
    out = Engine(tlp, cfg, ServeConfig(), device="cpu").generate(
        prompts, 6, lengths=lengths)
    logits, cache = JT.prefill(jlp, jcfg, {
        "tokens": jnp.asarray(prompts), "lengths": jnp.asarray(lengths)},
        max_len=12 + 6 + 1)
    want = []
    for _ in range(6):
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, cache = JT.decode_step(jlp, jcfg, cache, tok)
    np.testing.assert_array_equal(out, np.concatenate(want, axis=1))


def test_measure_decode_throughput_reports_rates():
    cfg, _, jlp = _compressed("smollm-gqa3")
    tlp = bridge.from_numpy(jax.tree.map(np.asarray, jlp), device="cpu")
    r = Engine(tlp, cfg, ServeConfig(), device="cpu"
               ).measure_decode_throughput(batch=2, prompt_len=4, n_new=2,
                                           warmup=0)
    assert r["tokens_per_s"] > 0 and r["ms_per_step"] > 0


def test_engine_without_device_raises_on_a_machine_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama-mini").reduced()
    from repro_torch.models import transformer as T
    params, _ = T.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.from_numpy({"w": np.zeros(2, np.float32)})
