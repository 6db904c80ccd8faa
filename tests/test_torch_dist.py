"""The port's mesh layer against the JAX package: the sharding rules on
fake meshes, the tree reduction of whitening factors, every ``comm``
wrapper at world 4 over gloo against numpy, ``restore(shardings=)``
against JAX's spec slices and ``cross_pod_mean`` at pod = 2 against JAX's
``compress_decompress`` under ``jax.vmap(..., axis_name="pod")``.

The ranks (``tests/torch_mesh_ranks.py``, job ``dist``) run once for the
module. JAX's slices and its ``combined_axis_index`` need a real
four-device mesh, so they come from one subprocess with
``--xla_force_host_platform_device_count=4``, as ``tests/test_dist.py``
runs its sharded step."""
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.core import numerics_jax as numj
from repro.dist import sharding as JSH
from repro.optim import powersgd as JPS
from repro_torch.ckpt import store
from repro_torch.core import numerics_device as numd
from repro_torch.dist import comm
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as LM

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


# (mesh shape, array shape or None for logical_spec only, logical axes):
# tests/test_dist.py's cases, then pod folding, duplicate axes and
# divisibility drops from the right
SPEC_CASES = [
    ({"data": 16, "model": 16}, None, ("batch", None, "mlp")),
    ({"pod": 2, "data": 16, "model": 16}, None, ("batch",)),
    ({"data": 16, "model": 16}, None, ("batch", "fsdp")),
    ({"data": 16, "model": 16}, (32, 1024, 8, 128),
     ("batch", "kv_seq", "kv_heads", None)),
    ({"pod": 2, "data": 16, "model": 1}, (8, 64), ("batch", None)),
    ({"pod": 2, "data": 16, "model": 16}, (64, 4096), ("fsdp", "mlp")),
    ({"pod": 2, "data": 16, "model": 16}, (2, 96), ("batch", "vocab")),
    ({"pod": 2, "data": 4, "model": 2}, (48,), ("group_batch",)),
    ({"pod": 2, "data": 4, "model": 2}, (6, 10), ("group_batch", "heads")),
    ({"data": 4}, (6, 10), ("gram_rows", "experts")),
    ({"pod": 2, "data": 2, "model": 2}, (4, 4, 4),
     ("calib_shard", "heads", "embed")),
    ({"data": 8, "model": 2}, (16, 3, 5, 7),
     ("experts", "layer_stack", "conv", "no_such_name")),
    ({"pod": 4, "data": 2}, (4, 6), ("fsdp", "batch")),
]


@pytest.mark.parametrize("mesh_shape,shape,axes", SPEC_CASES)
def test_sharding_rules_match_jax(mesh_shape, shape, axes):
    mesh = FakeMesh(mesh_shape)
    assert tuple(SH.logical_spec(axes, mesh)) == \
        tuple(JSH.logical_spec(axes, mesh))
    if shape is not None:
        assert tuple(SH.shape_aware_spec(shape, axes, mesh)) == \
            tuple(JSH.shape_aware_spec(shape, axes, mesh))
    for a in (("data",), ("pod", "data"), tuple(mesh_shape)):
        if all(x in mesh_shape for x in a):
            assert SH.axis_group_size(mesh, a) == \
                JSH.axis_group_size(mesh, a)
    assert SH.DEFAULT_RULES == JSH.DEFAULT_RULES


def test_use_rules_and_production_meshes():
    mesh = LM.make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16}
    assert LM.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert SH.current_mesh() is None
    with SH.use_rules({"mlp": ()}, mesh=mesh):
        assert SH.current_mesh() is mesh
        assert tuple(SH.logical_spec(("batch", "mlp"), mesh)) == \
            ("data", None)
    assert SH.current_mesh() is None
    assert tuple(SH.logical_spec(("batch", "mlp"), mesh)) == \
        ("data", "model")
    x = torch.ones(2)
    assert SH.constrain(x, "batch") is x


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
def test_tree_reduce_factors_matches_jax(m):
    rng = np.random.default_rng(m)
    d = 12
    Rs = np.stack([np.linalg.qr(rng.normal(size=(20, d)), mode="r")
                   for _ in range(m)]).astype(np.float32)
    got = numd.tree_reduce_factors(torch.as_tensor(Rs)).numpy()
    want = np.asarray(numj.tree_reduce_factors(jnp.asarray(Rs)))
    gram = sum(r.astype(np.float64).T @ r for r in Rs)

    def fix(r):
        s = np.sign(np.diag(r))
        s[s == 0] = 1
        return s[:, None] * r

    assert np.abs(fix(got) - fix(want)).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got.T @ got - gram).max() <= 1e-10 * np.abs(gram).max()


def test_comm_refuses_without_a_process_group():
    assert not comm.is_initialized()
    with pytest.raises(RuntimeError, match="comm.init"):
        comm.all_reduce_sum(torch.ones(2))
    assert comm.choose_backend(4, torch.device("cpu"), 0) == ("gloo", "host")
    assert comm.choose_backend(1, torch.device("cuda"), 1) == \
        ("nccl", "nccl")
    assert comm.choose_backend(2, torch.device("cuda"), 1) == \
        ("gloo", "pinned-host")
    assert comm.choose_backend(8, torch.device("cuda"), 8) == \
        ("nccl", "nccl")


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
CKPT_SPECS = {"emb": ("vocab", "embed"), "w": ("embed", "mlp"),
              "b": ("mlp",), "odd": ("fsdp", "mlp"), "rep": (None,)}
CKPT_SHAPES = {"emb": (16, 8), "w": (8, 12), "b": (12,), "odd": (6, 5),
               "rep": (3,)}
PSGD_CFG = dict(rank=4, min_dim=16, ef=True)


def _psgd_grads(pod, step):
    rng = np.random.default_rng(100 * pod + step)
    return {"w": rng.normal(size=(48, 40)).astype(np.float32),
            "b": rng.normal(size=(40,)).astype(np.float32),
            "v": rng.normal(size=(32, 24)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def jax_psgd():
    """JAX's rounds for both pods under ``vmap`` over the pod axis."""
    cfg = JPS.PowerSGDConfig(**PSGD_CFG)
    st = JPS.init_state({k: jnp.asarray(v)
                         for k, v in _psgd_grads(0, 0).items()}, cfg)
    stack = lambda t: jax.tree.map(lambda a: jnp.stack([a, a]), t)
    err, q = stack(st.error), stack(st.q)

    def one(g, e, qq):
        o, s, stats = JPS.compress_decompress(
            g, JPS.PowerSGDState(error=e, q=qq), cfg,
            reduce_fn=lambda x: jax.lax.pmean(x, "pod"))
        return o, s.error, s.q
    f = jax.vmap(one, axis_name="pod")
    rounds = []
    for step in range(2):
        g = {k: jnp.stack([jnp.asarray(_psgd_grads(p, step)[k])
                           for p in range(2)]) for k in _psgd_grads(0, 0)}
        o, err, q = f(g, err, q)
        rounds.append(jax.tree.map(np.asarray, (o, err)))
    return st, rounds


JAX_MESH_PROG = textwrap.dedent("""
    import os
    os.nice(10)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.dist import sharding as SH
    from repro.launch.mesh import make_host_mesh

    specs, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    mesh = make_host_mesh(2, 2)
    pos = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
           for d in mesh.devices.flat}
    out = {"slices": {}, "specs": {}, "index": {}}
    for k, spec in specs.items():
        ps = SH.shape_aware_spec(shapes[k], tuple(spec), mesh)
        out["specs"][k] = [list(e) if isinstance(e, tuple) else e
                           for e in ps]
        idx = NamedSharding(mesh, ps).devices_indices_map(tuple(shapes[k]))
        out["slices"][k] = {
            "%d,%d" % pos[d.id]: [[s.start or 0,
                                   n if s.stop is None else s.stop]
                                  for s, n in zip(sl, shapes[k])]
            for d, sl in idx.items()}
    for axes in (["data"], ["model"], ["data", "model"], ["model", "data"]):
        def body(x, axes=tuple(axes)):
            i = SH.combined_axis_index(axes, mesh)
            return jnp.zeros((1, 1), jnp.int32) + i
        got = SH.shard_map(body, mesh=mesh, in_specs=P("data", "model"),
                           out_specs=P("data", "model"))(
            jnp.zeros((2, 2)))
        out["index"][",".join(axes)] = np.asarray(got).tolist()
    print(json.dumps(out))
""")


_JAX_MESH = {}


def _start_jax_mesh():
    """JAX's four-device run, in a subprocess (started beside the ranks by
    the ``ranks`` fixture)."""
    if "proc" not in _JAX_MESH:
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
        _JAX_MESH["proc"] = subprocess.Popen(
            [sys.executable, "-c", JAX_MESH_PROG, json.dumps(CKPT_SPECS),
             json.dumps(CKPT_SHAPES)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)


@functools.lru_cache(maxsize=None)
def jax_mesh():
    _start_jax_mesh()
    proc = _JAX_MESH["proc"]
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _inputs(tmp):
    rng = np.random.default_rng(0)
    x = [torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32))
         for _ in range(R.WORLD)]
    a2a = [torch.as_tensor(rng.normal(size=(R.WORLD, 2, 3)).astype(
        np.float32)) for _ in range(R.WORLD)]
    tree = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
            for k, s in CKPT_SHAPES.items()}
    ckpt = os.path.join(tmp, "ckpt")
    store.save(ckpt, 1, tree)
    st, _ = jax_psgd()
    err = {k: torch.as_tensor(np.array(v)) for k, v in st.error.items()}
    q = {k: torch.as_tensor(np.array(v)) for k, v in st.q.items()}
    grads = [[{k: torch.as_tensor(v) for k, v in _psgd_grads(p, s).items()}
              for s in range(2)] for p in range(2)]
    return dict(x=x, a2a=a2a, ckpt_dir=ckpt, ckpt_tree=tree,
                ckpt_specs=CKPT_SPECS, psgd_cfg=PSGD_CFG,
                psgd_err=[err, err], psgd_q=[q, q], psgd_grads=grads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The world-4 job, with JAX's four-device run beside it."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    _start_jax_mesh()
    try:
        inp = _inputs(tmp)
        return inp, R.run("dist", tmp, inp)
    except BaseException:
        _JAX_MESH["proc"].kill()
        _JAX_MESH["proc"].wait()
        raise


def _group_members(name, rank):
    """The ranks of (data 2, model 2)'s group ``name`` holding ``rank``, in
    group order."""
    d, m = divmod(rank, 2)
    return {"world": [0, 1, 2, 3], "both": [0, 1, 2, 3],
            "data": [m, 2 + m], "model": [2 * d, 2 * d + 1]}[name]


def test_every_comm_wrapper_matches_numpy(ranks):
    inp, outs = ranks
    xs = [t.numpy() for t in inp["x"]]
    for r, out in enumerate(outs):
        for name in ("world", "data", "model", "both"):
            mem = _group_members(name, r)
            s = sum(xs[i] for i in mem)
            np.testing.assert_allclose(out[f"sum/{name}"].numpy(), s,
                                       rtol=1e-6)
            np.testing.assert_allclose(out[f"mean/{name}"].numpy(),
                                       s / len(mem), rtol=1e-6)
            np.testing.assert_array_equal(
                out[f"gather/{name}"].numpy(),
                np.concatenate([xs[i] for i in mem]))
            me = mem.index(r)
            np.testing.assert_array_equal(
                out[f"a2a/{name}"].numpy(),
                np.stack([inp["a2a"][i][me].numpy() for i in mem]))
            np.testing.assert_array_equal(out[f"bcast/{name}"].numpy(),
                                          xs[mem[-1]])
        assert out["ints"] == [6, 4]
        assert out["comm"]["backend"] == "gloo"
        assert out["comm"]["transport"] == "host"
        assert out["comm"]["staged_bytes"] == 0


def test_combined_axis_index_matches_jax(ranks):
    _, outs = ranks
    want = jax_mesh()["index"]
    for r, out in enumerate(outs):
        d, m = out["coords"]
        assert (d, m) == divmod(r, 2)
        assert out["index"] == want["data,model"][d][m]
        mesh = LM.Mesh((2, 2), ("data", "model"), rank=r,
                       build_groups=False)
        for key, grid in want.items():
            assert SH.combined_axis_index(tuple(key.split(",")), mesh) == \
                grid[d][m], key


def test_restore_onto_the_mesh_takes_jax_spec_slices(ranks):
    inp, outs = ranks
    jm = jax_mesh()
    for r, out in enumerate(outs):
        d, m = out["coords"]
        for k, t in inp["ckpt_tree"].items():
            spec = [tuple(e) if isinstance(e, list) else e
                    for e in jm["specs"][k]]
            assert out["restore_specs"][k] == tuple(spec), k
            sl = tuple(slice(a, b) for a, b in jm["slices"][k][f"{d},{m}"])
            np.testing.assert_array_equal(out["restore"][k].numpy(),
                                          t.numpy()[sl])
    # a replicated spec (or None) gives the whole leaf, in one process
    tmp = inp["ckpt_dir"]
    _, whole = store.restore(tmp, {"b": torch.zeros(12)},
                             shardings={"b": None})
    np.testing.assert_array_equal(whole["b"].numpy(),
                                  inp["ckpt_tree"]["b"].numpy())


def test_cross_pod_mean_matches_jax_pmean_under_vmap(ranks):
    _, outs = ranks
    _, rounds = jax_psgd()
    for out in outs:
        pod = out["pod"]
        for (o, err, q, stats), (jo, jerr) in zip(out["psgd"], rounds):
            for k in jo:
                np.testing.assert_allclose(o[k].numpy(), jo[k][pod],
                                           rtol=1e-5, atol=1e-5 * np.abs(
                                               jo[k][pod]).max())
            for k in jerr:
                np.testing.assert_allclose(
                    err[k].numpy(), jerr[k][pod], rtol=1e-5,
                    atol=1e-5 * np.abs(jerr[k][pod]).max())
    # the two pods end equal, as JAX's do
    for a, b in zip(outs[0]["psgd"], outs[2]["psgd"]):
        assert outs[0]["pod"] != outs[2]["pod"]
        for k in a[0]:
            np.testing.assert_allclose(a[0][k].numpy(), b[0][k].numpy(),
                                       rtol=1e-6, atol=1e-6)
