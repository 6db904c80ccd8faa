"""The port's ``pytree_v1`` artifact (``ckpt/store.py``) and
``Engine.from_compressed``, alone and across packages: an artifact saved by
either package boots in the other with token-identical greedy decode, and
both packages saving the same params write the same content hashes."""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import store as jstore
from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.ckpt import store
from repro_torch.configs import get_config
from repro_torch.core import compress as CC
from repro_torch.serve import engine as E
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

CPU = torch.device("cpu")
_KW = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
           d_ff=64, vocab_size=128, rank_multiple=1, dtype="float32")
PROMPTS = (np.arange(16, dtype=np.int32).reshape(2, 8) * 7) % 128


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------
def test_round_trip_bf16_lists_tuples_and_shared_basis(tmp_path):
    g = torch.Generator().manual_seed(0)
    B = torch.randn(8, 3, generator=g)
    tree = {"layers": [{"B": B, "C": torch.randn(3, 5, generator=g)},
                       {"B": B, "C": torch.randn(3, 5, generator=g)}],
            "pair": (torch.randn(4, generator=g).to(torch.bfloat16),
                     torch.arange(6, dtype=torch.int32)),
            "scale": torch.ones((), dtype=torch.float32)}
    path = store.save_pytree(str(tmp_path), tree, {"note": "x"}, name="a")
    man = _manifest(path)
    pair = man["structure"]["items"]["pair"]
    assert pair["kind"] == "tuple"
    assert pair["items"][0]["dtype"] == "bfloat16"       # numpy's name
    assert "alias" in man["structure"]["items"]["layers"]["items"][1][
        "items"]["B"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert len(z.files) == 6                         # B stored once
        assert z["pair␟0"].dtype == np.float32           # bf16 widened
    back, meta = store.load_pytree(str(tmp_path), name="a", verify=True,
                                   device="cpu")
    assert meta == {"note": "x"}
    assert isinstance(back["layers"], list) and isinstance(back["pair"],
                                                           tuple)
    assert back["layers"][0]["B"] is back["layers"][1]["B"]
    assert back["pair"][0].dtype == torch.bfloat16
    assert torch.equal(back["pair"][0], tree["pair"][0])
    assert back["pair"][1].dtype == torch.int32
    for i in range(2):
        assert torch.equal(back["layers"][i]["C"], tree["layers"][i]["C"])
    # the JAX package reads the same artifact to the same values
    jback, _ = jstore.load_pytree(str(tmp_path), name="a", verify=True)
    assert jback["pair"][0].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(jback["pair"][0], np.float32),
                          tree["pair"][0].float().numpy())


def test_verify_catches_a_flipped_array_and_an_unhashed_manifest(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    path = store.save_pytree(str(tmp_path), tree, name="a")
    w = tree["w"].numpy().copy()
    w[1, 2] = -w[1, 2]
    np.savez(os.path.join(path, "arrays.npz"), w=w)
    store.load_pytree(str(tmp_path), name="a", device="cpu")  # unverified
    with pytest.raises(store.IntegrityError, match="integrity"):
        store.load_pytree(str(tmp_path), name="a", verify=True, device="cpu")
    man = _manifest(path)
    del man["hashes"]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="no content hashes"):
        store.load_pytree(str(tmp_path), name="a", verify=True, device="cpu")


def test_resilient_load_quarantines_a_corrupt_artifact(tmp_path):
    store.save_pytree(str(tmp_path), {"w": torch.ones(4)}, name="a")
    fp = store.artifact_fingerprint(str(tmp_path), name="a")
    with open(os.path.join(tmp_path, "a", "arrays.npz"), "r+b") as f:
        f.truncate(10)
    with pytest.raises(store.IntegrityError, match="quarantined"):
        store.load_pytree_resilient(str(tmp_path), name="a", retries=1,
                                    backoff_s=0.0, device="cpu")
    assert not os.path.exists(os.path.join(tmp_path, "a"))
    assert os.path.isdir(os.path.join(tmp_path, "a.quarantined"))
    with pytest.raises(FileNotFoundError):
        store.load_pytree_resilient(str(tmp_path), name="a", device="cpu")
    store.save_pytree(str(tmp_path), {"w": torch.ones(4)}, name="a")
    assert store.artifact_fingerprint(str(tmp_path), name="a") == fp


# ---------------------------------------------------------------------------
# compressed artifacts across packages
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _setup():
    """JAX-compressed params and the port's bridged copy of them, plus the
    port's own compression of the same weights."""
    cfg = get_config("llama-mini").replace(**_KW)
    jcfg = jget_config("llama-mini").replace(**_KW)
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, 128, (2, 16), dtype=np.int32)
    jlp, jplan = JC.build_plan_and_params(
        jp, jcfg, JC.CompressionConfig(ratio=0.3), [{"tokens": toks}],
        streaming=False)
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    tlp, tplan = CC.build_plan_and_params(
        tp, cfg, CC.CompressionConfig(ratio=0.3),
        [{"tokens": torch.as_tensor(toks)}])
    bridged = bridge.from_numpy(jax.tree.map(np.asarray, jlp), device=CPU)
    return cfg, jcfg, jlp, jplan, bridged, tlp, tplan


def test_jax_artifact_boots_in_the_port_token_identically(tmp_path):
    cfg, jcfg, jlp, jplan, _, _, _ = _setup()
    JC.save_plan(str(tmp_path), jlp, jplan, jcfg)
    jeng = JEngine.from_compressed(str(tmp_path), jcfg, JServeConfig(),
                                   verify=True)
    eng = E.Engine.from_compressed(str(tmp_path), cfg, E.ServeConfig(),
                                   verify=True, device="cpu")
    assert eng.plan.to_json() == jplan.to_json()
    wq = [eng.params["decoder"]["run0"][i]["attn"]["wq"]["B"]
          for i in range(2)]
    assert wq[0] is wq[1]                        # shared basis re-aliased
    assert (eng.generate(PROMPTS, 8)
            == np.asarray(jeng.generate(PROMPTS, n_new=8))).all()


def test_port_artifact_boots_in_jax_token_identically(tmp_path):
    cfg, jcfg, _, _, _, tlp, tplan = _setup()
    CC.save_plan(str(tmp_path), tlp, tplan, cfg)
    eng = E.Engine.from_compressed(str(tmp_path), cfg, E.ServeConfig(),
                                   verify=True, device="cpu")
    jeng = JEngine.from_compressed(str(tmp_path), jcfg, JServeConfig(),
                                   verify=True)
    assert jeng.plan.to_json() == tplan.to_json()
    toks = eng.generate(PROMPTS, 8)
    assert (toks == np.asarray(jeng.generate(PROMPTS, n_new=8))).all()
    inmem = E.Engine(tlp, cfg, E.ServeConfig(), device=CPU)
    assert (toks == inmem.generate(PROMPTS, 8)).all()


def test_both_packages_write_the_same_hashes(tmp_path):
    cfg, jcfg, jlp, jplan, bridged, _, _ = _setup()
    jpath = JC.save_plan(str(tmp_path / "jax"), jlp, jplan, jcfg)
    tpath = CC.save_plan(str(tmp_path / "port"), bridged, jplan, cfg)
    jm, tm = _manifest(jpath), _manifest(tpath)
    assert tm["hashes"] == jm["hashes"]
    assert tm["structure"] == jm["structure"]
    assert tm["meta"] == jm["meta"]
    assert (store.artifact_fingerprint(str(tmp_path / "port"), "compressed")
            == jstore.artifact_fingerprint(str(tmp_path / "jax"),
                                           "compressed"))


def test_wrong_config_fingerprint_is_rejected(tmp_path):
    cfg, _, _, _, _, tlp, tplan = _setup()
    CC.save_plan(str(tmp_path), tlp, tplan, cfg)
    with pytest.raises(ValueError, match="built for"):
        CC.load_plan(str(tmp_path), cfg=cfg.replace(n_layers=3),
                     device="cpu")
    lp, plan = CC.load_plan(str(tmp_path), cfg=cfg, verify=True, retries=1,
                            device="cpu")
    assert plan.to_json() == tplan.to_json()
    assert CC.compressed_param_count(lp) == CC.compressed_param_count(tlp)


def test_from_compressed_batcher_and_retries_spelling(tmp_path):
    cfg, _, _, _, _, tlp, tplan = _setup()
    CC.save_plan(str(tmp_path), tlp, tplan, cfg)
    cb = E.from_compressed(str(tmp_path), cfg, device="cpu")
    assert isinstance(cb, E.ContinuousBatcher)      # the default, as in JAX
    assert cb.plan.to_json() == tplan.to_json()
    with pytest.warns(DeprecationWarning):
        eng = E.Engine.from_compressed(str(tmp_path), cfg, E.ServeConfig(),
                                       retries=1, device="cpu")
    assert eng.plan is not None
