"""The port's serve surface (``repro_torch.serve.api``,
``repro_torch.launch.serve``), twin of the surface tests of
``tests/test_serve_api.py``: ``ServeOptions`` has the JAX package's fields,
defaults and validation messages; both launchers take the same flags and
every golden argv parses to equal options in both; ``--slots`` is
deprecated; and ``serve(opts, device="cpu")`` on one JAX ``save_plan``
artifact gives the JAX ``serve``'s tokens and report counts."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.launch import serve as jlaunch
from repro.models import transformer as JT
from repro.serve import api as japi
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import api
from test_serve_api import GOLDEN, SPECIAL
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256, rank_multiple=1)
JCFG = jget_config("llama-mini").replace(**SMALL)


def _small(monkeypatch):
    """Both packages' ``get_config`` give llama-mini at the artifact's
    small size (the serve entry points resolve ``arch`` by name)."""
    import repro.configs
    import repro_torch.configs
    for mod in (repro.configs, repro_torch.configs):
        full = mod.get_config
        monkeypatch.setattr(mod, "get_config",
                            lambda arch, full=full: full(arch).replace(
                                **SMALL))


def _asdict(opts) -> dict:
    return dataclasses.asdict(opts)


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------
def test_api_surface_is_jaxs_but_the_disk_cache():
    """``AotCache`` has no counterpart: a CUDA graph cannot be persisted."""
    assert sorted(api.__all__) == sorted(set(japi.__all__) - {"AotCache"})
    for name in api.__all__:
        assert getattr(api, name) is not None


def test_serve_options_have_jaxs_fields_and_defaults():
    jf = {f.name: (f.default, f.type) for f in
          dataclasses.fields(japi.ServeOptions)}
    tf = {f.name: (f.default, f.type) for f in
          dataclasses.fields(api.ServeOptions)}
    assert list(tf) == list(jf)
    assert tf == jf
    assert _asdict(api.ServeOptions(arch="x")) == \
        _asdict(japi.ServeOptions(arch="x"))


def _flags(parser) -> dict:
    return {a.option_strings[0]: (a.dest, a.default, a.type, a.nargs,
                                  a.required, type(a).__name__,
                                  tuple(a.choices or ()))
            for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def test_both_launchers_take_the_same_flags():
    assert _flags(tlaunch.build_parser()) == _flags(jlaunch.build_parser())


# the flags that validate only beside another
NEEDS = {"--save-compressed": ["--compress", "drank"],
         "--prefix-cache": ["--kv-block", "16"]}


@pytest.mark.parametrize("frag", [frag for frag, _, _ in GOLDEN]
                         + [["--slots", "3"], ["--whiten-stream"],
                            ["--eager-capture"],
                            ["--compressed-ckpt", "runs/cc"]],
                         ids=lambda frag: frag[0])
def test_golden_argv_parses_to_equal_options(frag):
    argv = frag if frag[0] == "--arch" else ["--arch", "llama-mini", *frag]
    argv += NEEDS.get(frag[0], [])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = tlaunch.parse_serve_options(argv)
        want = jlaunch.parse_serve_options(argv)
    assert type(got) is api.ServeOptions
    assert _asdict(got) == _asdict(want)


def test_every_golden_flag_together():
    argv = [tok for frag, _, _ in GOLDEN for tok in frag]
    opts = tlaunch.parse_serve_options(argv)
    for _, field, want in GOLDEN:
        assert getattr(opts, field) == want, field
    assert _asdict(opts) == _asdict(jlaunch.parse_serve_options(argv))
    assert set(SPECIAL.values()) <= set(_asdict(opts))


def test_slots_is_a_deprecated_alias_of_batch():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        opts = tlaunch.parse_serve_options(["--arch", "llama-mini",
                                            "--slots", "3"])
    assert opts.batch == 3
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        opts = tlaunch.parse_serve_options(["--arch", "llama-mini",
                                            "--slots", "3", "--batch", "5"])
    assert opts.batch == 5


BAD = [
    dict(compress="zip"),
    dict(compress="drank", compressed_ckpt="runs/cc"),
    dict(save_compressed="runs/cc"),
    dict(whiten_stream=True, eager_capture=True),
    dict(calib_mesh_shards=2, eager_capture=True),
    dict(calib_mesh_shards=3),
    dict(calib_mesh_shards=2, calib_samples=12),
    dict(batch=0),
    dict(kv_block=-8),
    dict(kv_block=12),
    dict(kv_block=24, max_len=64),
    dict(prefix_cache=True),
    dict(replicas=0),
    dict(metrics_port=70000),
    dict(metrics_interval_s=0.0),
]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: "-".join(kw))
def test_validation_messages_equal_jaxs(kw):
    with pytest.raises(ValueError) as want:
        japi.ServeOptions(arch="llama-mini", **kw)
    with pytest.raises(ValueError) as got:
        api.ServeOptions(arch="llama-mini", **kw)
    assert str(got.value) == str(want.value)


def test_cli_rejects_bad_combinations_as_parse_errors():
    with pytest.raises(SystemExit):
        tlaunch.parse_serve_options(["--arch", "llama-mini",
                                     "--whiten-stream", "--eager-capture"])


def test_options_are_frozen():
    opts = api.ServeOptions(arch="llama-mini")
    assert opts.serve_config().batch == opts.batch
    assert opts.admission_config().max_retries == opts.max_retries
    with pytest.raises(dataclasses.FrozenInstanceError):
        opts.batch = 9


# ---------------------------------------------------------------------------
# serve() on a JAX artifact
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_api_artifact"))
    params, _ = JT.init_model(JCFG, jax.random.PRNGKey(0))
    calib = [{"tokens": jax.random.randint(
        jax.random.PRNGKey(1), (2, 16), 0, JCFG.vocab_size)}]
    comp, plan = JC.build_plan_and_params(
        params, JCFG, JC.CompressionConfig(ratio=0.4), calib)
    JC.save_plan(d, comp, plan, JCFG)
    return d


@pytest.fixture(scope="module")
def jax_runs(artifact):
    """The JAX ``serve`` of each pool's options, run once per module."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _small(mp)
        for kv_block in (0, 8):
            opts = japi.ServeOptions(
                arch="llama-mini", compressed_ckpt=artifact, verify=True,
                batch=2, max_len=32, kv_block=kv_block, requests=4,
                prompt_len=9, n_new=4)
            res = japi.serve(opts)
            out[kv_block] = ({r.rid: list(r.out) for r in res}, res.report)
    return out


COUNTS = ("drain_status", "requests", "accepted", "submitted", "shed",
          "rejected", "failed", "generated_tokens")


@pytest.mark.parametrize("aot", [False, True], ids=["eager", "aot"])
@pytest.mark.parametrize("stream", [False, True], ids=["direct", "stream"])
@pytest.mark.parametrize("kv_block", [0, 8], ids=["contiguous", "paged"])
def test_serve_on_a_jax_artifact_gives_jaxs_tokens(
        monkeypatch, artifact, jax_runs, kv_block, stream, aot):
    _small(monkeypatch)
    opts = api.ServeOptions(
        arch="llama-mini", compressed_ckpt=artifact, verify=True, batch=2,
        max_len=32, kv_block=kv_block, requests=4, prompt_len=9, n_new=4,
        aot=aot, stream=stream)
    lines = []
    res = api.serve(opts, device="cpu", echo=lines.append)
    jtokens, jreport = jax_runs[kv_block]
    assert {r.rid: list(r.out) for r in res} == jtokens
    assert {k: res.report[k] for k in COUNTS} == \
        {k: jreport[k] for k in COUNTS}
    assert res.report["tokens_digest"] == api.tokens_digest(res)
    stats = res.report["engine_stats"]
    stats = stats[0] if stream else stats
    if aot:
        assert stats["aot_compiles"] > 0 and stats["aot_fallbacks"] == 0
        assert any("never persisted" in ln for ln in lines)
    else:
        # through the front door the engine thread may admit in more rounds
        want = dict(jreport["engine_stats"])
        if stream:
            want.pop("admissions")
            stats = {k: v for k, v in stats.items() if k != "admissions"}
        assert stats == want


def test_a_training_checkpoint_boots(tmp_path, monkeypatch):
    """``ckpt=`` (once refused as needing the training state) restores a
    step checkpoint into a template on the meta device and serves its
    params."""
    import repro_torch.configs
    from repro_torch.ckpt import store
    from repro_torch.train import step as TS
    _small(monkeypatch)
    cfg = repro_torch.configs.get_config("llama-mini")
    state, _ = TS.init_train_state(cfg, seed=4, device="cpu")
    store.save(str(tmp_path), 9, state)
    cb = api.load_engine(api.ServeOptions(arch="llama-mini",
                                          ckpt=str(tmp_path)), device="cpu")
    assert torch.equal(cb.params["embed"], state.params["embed"])
    assert cb.params["embed"].device.type == "cpu"


def test_mesh_calibration_raises():
    """Without a process group of calib_mesh_shards ranks the option
    raises and names torchrun; it never runs single-process quietly (the
    mesh run: tests/test_torch_mesh_calib.py)."""
    with pytest.raises(ValueError, match="torchrun"):
        api.load_engine(api.ServeOptions(arch="llama-mini", compress="drank",
                                         calib_mesh_shards=2),
                        device="cpu")


def test_cli_runs_on_the_card(monkeypatch):
    """``python -m repro_torch.launch.serve`` has JAX's flags only, so it
    runs where the port's entry points run by default: on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "llama-mini", "--requests", "1"])


def test_random_init_compress_and_heartbeat_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """The compress-at-boot path (streaming calibration, D-Rank, the
    decomposition on the device) and the heartbeat, end to end."""
    _small(monkeypatch)
    opts = api.ServeOptions(
        arch="llama-mini", compress="drank", ratio=0.4, calib_samples=8,
        calib_seq=16, device_compress=True, batch=2, max_len=32,
        requests=3, prompt_len=5, n_new=3, aot=True,
        heartbeat_dir=str(tmp_path / "hb"),
        save_compressed=str(tmp_path / "art"))
    res = api.serve(opts, device="cpu")
    assert res.status == "drained" and res.report["generated_tokens"] == 9
    from repro_torch.dist.ft import Heartbeat
    beat = Heartbeat(str(tmp_path / "hb" / "worker0.json")).read()
    assert beat["step"] >= 3 and beat["seq"] >= 4
    again = api.serve(dataclasses.replace(
        opts, compress="", save_compressed="",
        compressed_ckpt=str(tmp_path / "art")), device="cpu")
    assert api.tokens_digest(again) == res.report["tokens_digest"]
    assert np.all([len(r.out) == 3 for r in again])
