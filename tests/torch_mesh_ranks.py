"""The rank side of the port's mesh twins: ``python tests/torch_mesh_ranks.py
JOB WORKDIR`` spawns a gloo process group of ``WORLD`` ranks on the CPU,
each running ``JOB`` on the inputs in ``WORKDIR/inputs.pt`` and writing
``WORKDIR/out_rank{r}.pt``. It imports nothing of JAX: the test modules
(``tests/test_torch_dist.py``, ``tests/test_torch_mesh_calib.py``,
``tests/test_torch_mesh_train_moe.py``) build the inputs, run this once
and hold the ranks' outputs against the JAX package.

World 4, one intra-op and one BLAS thread a rank, at a lower priority
(``os.nice``): a spawn of four ranks costs ~4-5 s of the test's budget,
and the twins run on a few cores beside the rest of the suite."""
import os
import sys
import traceback

import torch
import torch.multiprocessing as mp

WORLD = 4


def _init_method(workdir: str, name: str) -> str:
    """A ``file://`` rendezvous at ``workdir/name``: no port to pick, so
    nothing else on the host can take it between the pick and the bind (a
    picked free port was taken under the full suite: EADDRINUSE at the
    second group's ``init_process_group``)."""
    return "file://" + os.path.join(os.path.abspath(workdir), name)


# ---------------------------------------------------------------------------
# jobs: (rank, inputs) -> outputs, inside the process group
# ---------------------------------------------------------------------------
def job_dist(rank, inp):
    from repro_torch.ckpt import store
    from repro_torch.dist import comm
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import powersgd as PS

    out = {}
    mesh = make_host_mesh(data=2, model=2)
    x = inp["x"][rank]
    groups = {"world": None, "data": mesh.group("data"),
              "model": mesh.group("model"),
              "both": mesh.group(("data", "model"))}
    for name, g in groups.items():
        out[f"sum/{name}"] = comm.all_reduce_sum(x, g)
        out[f"mean/{name}"] = comm.all_reduce_mean(x, g)
        out[f"gather/{name}"] = comm.all_gather_rows(x, g)
        n = comm.group_size(g)
        out[f"a2a/{name}"] = comm.all_to_all(
            inp["a2a"][rank][:n].contiguous(), g)
        out[f"bcast/{name}"] = comm.broadcast(x, src=n - 1, group=g)
    out["ints"] = comm.all_reduce_ints([rank, 1])
    out["coords"] = (mesh.coord("data"), mesh.coord("model"))
    out["index"] = SH.combined_axis_index(("data", "model"), mesh)
    # restore onto the mesh: each rank's block of every leaf
    shards = SH.shardings_for_tree(inp["ckpt_tree"], inp["ckpt_specs"], mesh)
    _, blocks = store.restore(inp["ckpt_dir"], inp["ckpt_tree"],
                              shardings=shards)
    out["restore"] = blocks
    out["restore_specs"] = {k: tuple(v.spec) for k, v in shards.items()}
    comm.shutdown()

    # PowerSGD between pods: (pod 2, data 2, model 1)
    comm.init(WORLD, rank, "cpu", init_method=inp["init_method2"])
    pmesh = make_host_mesh(data=2, model=1, pod=2)
    pod = pmesh.coord("pod")
    cfg = PS.PowerSGDConfig(**inp["psgd_cfg"])
    st = PS.PowerSGDState(error=dict(inp["psgd_err"][pod]),
                          q=dict(inp["psgd_q"][pod]))
    res = []
    for g in inp["psgd_grads"][pod]:
        o, st, stats = PS.compress_decompress(
            g, st, cfg, reduce_fn=PS.cross_pod_mean(pmesh))
        res.append((o, dict(st.error), dict(st.q), stats))
    out["psgd"] = res
    out["pod"] = pod
    return out


def job_calib(rank, inp):
    from repro_torch.core import capture as Cap
    from repro_torch.core import compress as CC
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import api

    cfg, lp, bs = inp["cfg"], inp["lp"], inp["batches"]
    mesh = make_host_mesh(data=WORLD, model=1)
    out = {}
    # [1] per-shard factors, tree-reduced
    out["col_w"] = Cap.streaming_calibrate(lp, cfg, bs, mesh=mesh,
                                           whiten_tags=True)
    # [2] every tag row-sharded
    cal = Cap.StreamingCalibrator(lp, cfg, mesh=mesh, shard_grams_above=1)
    for b in bs:
        cal.ingest(b)
    out["routes"] = cal.routes
    out["acc_shapes"] = {t: tuple(a["gram"].shape)
                         for t, a in cal.accumulators.items()}
    out["col_sh"] = cal.finalize()
    out["col_rep"] = Cap.streaming_calibrate(lp, cfg, bs, mesh=mesh)
    # [3] flush cadence
    out["col_f1"] = Cap.streaming_calibrate(lp, cfg, bs, mesh=mesh,
                                            flush_every=1,
                                            shard_grams_above=1)
    # [4] a mesh-captured (sharded + whitened) plan on the host
    ccfg = CC.CompressionConfig(**inp["ccfg"])
    col_m = Cap.streaming_calibrate(
        lp, cfg, bs, mesh=mesh, shard_grams_above=1,
        whiten_tags={t for t in inp["tags"] if "/wq" in t})
    comp, plan = CC.build_plan_and_params(inp["params"], cfg, ccfg, bs,
                                          collector=col_m)
    out["plan_m"] = plan.to_json()
    out["comp_m"] = comp if rank == 0 else None
    # the device decomposition spread over the ranks, on a given collector
    comp_d, plan_d = CC.build_plan_and_params(
        inp["params"], cfg, ccfg, bs, collector=inp["ref_col"], device=True,
        mesh=mesh)
    out["plan_d"] = plan_d.to_json()
    out["comp_d"] = comp_d
    # the whole path from batches, with refine, on the mesh
    ccfg_r = CC.CompressionConfig(**dict(inp["ccfg"], refine=True))
    _, plan_r = CC.build_plan_and_params(inp["params"], cfg, ccfg_r, bs,
                                         device=True, mesh=mesh)
    out["plan_r"] = plan_r.to_json()
    # JAX's errors: data axes the mesh lacks, a batch that does not split
    try:
        Cap.StreamingCalibrator(lp, cfg, mesh=mesh, data_axes=("pod",))
    except ValueError as e:
        out["no_axes"] = str(e)
    try:
        Cap.streaming_calibrate(lp, cfg, [{"tokens": bs[0]["tokens"][:6]}],
                                mesh=mesh)
    except ValueError as e:
        out["bad_split"] = str(e)
    # the serve surface: calib_mesh_shards = world, and a wrong world
    try:
        api.mesh_compress(api.ServeOptions(**dict(inp["serve"],
                                                  calib_mesh_shards=2)),
                          device="cpu")
    except ValueError as e:
        out["wrong_world"] = str(e)
    opts = api.ServeOptions(**dict(inp["serve"], calib_mesh_shards=WORLD))
    if rank == 0:
        res = api.serve(opts, device="cpu")
        out["report"] = res.report
    else:
        api.mesh_compress(opts, device="cpu")
    return out


def _bytes_of(fn):
    """(fn's result, the result bytes per collective family that it moved,
    from ``Comm.report()``)."""
    from repro_torch.dist import comm
    before = comm.current().report()["bytes"]
    res = fn()
    after = comm.current().report()["bytes"]
    return res, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def job_train_moe(rank, inp):
    import torch.distributed as dist

    from repro_torch.core.capture import Collector
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import op_analysis as OA
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models import mlp as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import step as TS
    from repro_torch.train.loop import LoopConfig, Trainer

    out = {}
    # data-parallel training, data = 4
    lcfg = LoopConfig(**dict(inp["lcfg"], shard_id=rank, num_shards=WORLD))
    tr = Trainer(inp["cfg"], TS.TrainConfig(**inp["tcfg"]),
                 DataConfig(**inp["dcfg"]), lcfg, device="cpu")
    out["dp"] = tr.run()["history"]
    # one step's reduced grads, the ranks' shards holding unequal token
    # counts (padded rows masked out)
    g = inp["dp_grad"]
    rows = g["tokens"].shape[0] // WORLD
    shard = {k: v[rank * rows:(rank + 1) * rows] for k, v in g.items()}
    loss, metrics, grads = TS.loss_and_grads(inp["dp_params"], inp["cfg"],
                                             shard)
    out["dp_local"] = (loss, metrics["tokens"], grads)
    out["dp_reduced"] = TS.reduce_data_parallel(loss, metrics, grads, None)
    # one DP step, run and counted (on meta, by the counting comm)
    step = TS.make_train_step(inp["cfg"], TS.TrainConfig(**inp["tcfg"]),
                              group=dist.group.WORLD)
    state = TS.TrainState(params=inp["dp_params"],
                          opt=adamw_init(inp["dp_params"]))
    _, out["dp_step_bytes"] = _bytes_of(lambda: step(state, shard))
    out["dp_step_count"] = OA.count(step, OA.to_meta(state),
                                    OA.to_meta(shard),
                                    world=WORLD)["collectives"]
    # expert parallelism, (data 2, model 2)
    mesh = make_host_mesh(data=2, model=2)
    mcfg, p, x = inp["moe_cfg"], inp["moe_p"], inp["moe_x"]
    spec = SH.P("model")
    local = {"moe": {
        "router": p["moe"]["router"],
        **{k: SH.local_block(p["moe"][k], spec, mesh).contiguous()
           for k in ("w_gate", "w_up", "w_down")}}}
    b = x.shape[0] // 2
    xs = x[mesh.coord("data") * b:(mesh.coord("data") + 1) * b]
    calls = []
    orig = M._dispatch_to_buffers

    def rec(xx, dest, n_dest, cap):
        buf, slot, kept = orig(xx, dest, n_dest, cap)
        calls.append((xx.shape[-1], n_dest, cap, slot.clone(), kept.clone()))
        return buf, slot, kept

    M._dispatch_to_buffers = rec
    try:
        with torch.no_grad(), SH.use_rules(mesh=mesh):
            (o, aux), out["ep_bytes"] = _bytes_of(
                lambda: M.apply_moe(local, mcfg, xs))
    finally:
        M._dispatch_to_buffers = orig
    out["moe"] = (o, aux, calls, mesh.coord("data"), mesh.coord("model"))
    # the same forward counted on a shapes-only mesh
    shapes_only = Mesh((2, 2), ("data", "model"), rank=rank,
                       build_groups=False)
    with torch.no_grad(), SH.use_rules(mesh=shapes_only):
        out["ep_count"] = OA.count(
            lambda p, x: M.apply_moe(p, mcfg, x), OA.to_meta(local),
            OA.to_meta(xs), world=WORLD)["collectives"]
    # a tagged layer under EP captures no expert statistic, as in JAX
    tagged = {"moe": dict(local["moe"], _tag="layer/moe")}
    with torch.no_grad(), SH.use_rules(mesh=mesh), Collector() as col:
        M.apply_moe(tagged, mcfg, xs)
    out["ep_capture"] = sorted(col.gram)
    # sharded training over (data 2, model 2), and the EP backward
    out.update(_sharded_cases(rank, mesh, inp))
    return out


def _sharded_run(rank, mesh, case):
    """A sharded train step of ``case["cfg"]`` for each global batch of
    ``case["batches"]`` (each rank taking its data shard), from the whole
    initial ``case["params"]``. Returns (what the test reads, the final
    blocks, their shardings)."""
    from repro_torch import pytree
    from repro_torch.dist import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import step as TS

    cfg = case["cfg"]
    _, specs = T.init_model(cfg, device="meta")
    state = TS.TrainState(params=case["params"],
                          opt=adamw_init(case["params"]))
    blocks, shd = TS.shard_state(state, specs, mesh)
    res = {"held": {pytree.keystr(p): tuple(t.shape) for p, t in
                    pytree.flatten_with_path(blocks)},
           "metrics": []}
    step = TS.make_train_step(cfg, TS.TrainConfig(**case["tcfg"]),
                              mesh=mesh)
    n, d = mesh.shape["data"], mesh.coord("data")
    for b in case["batches"]:
        rows = next(iter(b.values())).shape[0] // n
        blocks, m = step(blocks, {k: v[d * rows:(d + 1) * rows]
                                  for k, v in b.items()})
        res["metrics"].append({k: float(v) for k, v in m.items()})
    whole = SH.gather_tree(blocks.params, shd.params)
    if rank == 0:
        res["params"] = whole
    return res, blocks, shd


def _one_process(case):
    """The port's one-process steps of a case on the whole global batches
    (``case["one_micro"]`` microbatches): (metrics, params)."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import step as TS
    step = TS.make_train_step(case["cfg"], TS.TrainConfig(
        microbatches=case["one_micro"], **case["tcfg"]))
    state = TS.TrainState(params=case["params"],
                          opt=adamw_init(case["params"]))
    metrics = []
    for b in case["batches"]:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state.params


def _peak_gathered(SH, fn) -> int:
    """Runs ``fn`` and returns the most bytes of whole leaves from
    ``SH.gather_leaf`` alive at once in it."""
    import weakref
    live, peak, inner = {}, [0], SH.gather_leaf

    def spy(t, s):
        w = inner(t, s)
        live[id(w)] = w.numel() * w.element_size()
        weakref.finalize(w, live.pop, id(w), None)
        peak[0] = max(peak[0], sum(live.values()))
        return w
    SH.gather_leaf = spy
    try:
        fn()
    finally:
        SH.gather_leaf = inner
    return peak[0]


def _sharded_cases(rank, mesh, inp):
    """Cases (a)-(e) of ``tests/test_torch_mesh_train_moe.py``."""
    from repro_torch import pytree
    from repro_torch.ckpt import store
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import mlp as M
    from repro_torch.train import step as TS

    out = {}
    for name in ("llama", "smollm", "moe", "hymba"):
        out[f"sh_{name}"], blocks, shd = _sharded_run(rank, mesh,
                                                      inp["sharded"][name])
        if name == "llama":
            ck_blocks, ck_shd = blocks, shd
    # the EP body's gradient blocks: sum(out * w) + aux of the MoE layer,
    # its router and expert stacks placed by the rules
    e = inp["ep_grad"]
    blocks, shd = SH.shard_tree(e["p"], e["specs"], mesh)
    pl = SH.Placement(mesh, pytree.tree_map(lambda s: s.spec, shd))
    b = e["x"].shape[0] // mesh.shape["data"]
    rows = slice(mesh.coord("data") * b, (mesh.coord("data") + 1) * b)

    def fn(bl):
        o, aux = M.apply_moe(pl.materialize(bl, pl.specs, lambda path: True),
                             e["cfg"], e["x"][rows])
        return (o * e["w"][rows]).sum() + aux / pl.batch_size, None
    _, _, g = TS.value_and_grad_of(fn, blocks)
    out["ep_grads"] = pl.reduce_grads(g)
    # (e) a checkpoint of the sharded state, saved at (2, 2), restored onto
    # (4, 1) and onto one process
    ck = inp["ckpt_dir"]
    out["ckpt_peak_gathered"] = _peak_gathered(
        SH, lambda: store.save(ck, 3, ck_blocks, shardings=ck_shd))
    whole = SH.gather_tree(ck_blocks, ck_shd)       # every rank takes part
    out["ckpt_whole"] = whole if rank == 0 else None
    mesh41 = make_host_mesh(data=4, model=1)
    cfg = inp["sharded"]["llama"]["cfg"]
    meta_state, specs = TS.init_train_state(cfg, device="meta")
    shd41 = SH.shardings_for_tree(meta_state, TS.state_specs(specs), mesh41)
    _, out["ckpt_41"] = store.restore(ck, meta_state, shardings=shd41,
                                      device="cpu")
    if rank == 0:
        _, out["ckpt_one"] = store.restore(ck, meta_state, device="cpu")
    # the references, one process on the same global batches: each rank
    # runs every WORLD-th case
    out["one"] = {name: _one_process(c) for i, (name, c) in
                  enumerate(inp["sharded"].items()) if i % WORLD == rank}
    return out


JOBS = {"dist": job_dist, "calib": job_calib, "train_moe": job_train_moe}


def _rank_main(rank, job, workdir, init_method):
    torch.set_num_threads(1)
    from repro_torch.dist import comm
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         weights_only=False)
        comm.init(WORLD, rank, "cpu", init_method=init_method)
        if job == "dist":
            # the second group's rendezvous file, beside the first's
            inp["init_method2"] = _init_method(workdir, "pg2")
        out = JOBS[job](rank, inp)
        if comm.is_initialized():
            out["comm"] = comm.current().report()
            comm.shutdown()
        torch.save(out, os.path.join(workdir, f"out_rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        raise


def start(job: str, workdir: str, inputs: dict):
    """Write ``inputs`` and start ``job`` on WORLD ranks in a child process
    (the test side: it may import JAX, the ranks do not); the test goes on
    while they run. Returns what :func:`collect` takes."""
    import subprocess
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    here = os.path.dirname(os.path.abspath(__file__))
    # one BLAS thread a rank too: four ranks of host LAPACK on all cores
    # each ran the host decomposition ~5x slower
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(os.path.dirname(here), "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), job,
                             workdir], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return job, workdir, proc


def collect(started, timeout: float = 900):
    """The ranks' outputs of a job from :func:`start`. ``timeout`` only
    catches a hang: niced under a full suite, a job that takes ~25 s alone
    has taken ~280 s."""
    job, workdir, proc = started
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"ranks of {job!r} failed ({proc.returncode}):\n"
                           + err[-6000:])
    return [torch.load(os.path.join(workdir, f"out_rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def run(job: str, workdir: str, inputs: dict, timeout: float = 900):
    """Write ``inputs``, run ``job`` on WORLD ranks in a child process and
    return the ranks' outputs."""
    return collect(start(job, workdir, inputs), timeout)


def main(job: str, workdir: str) -> None:
    # below the suite's other workers: the ranks are four more processes
    # on cores that the longest test module needs
    os.nice(10)
    for name in ("pg", "pg2"):        # a rendezvous file starts absent
        path = os.path.join(workdir, name)
        if os.path.exists(path):
            os.remove(path)
    mp.spawn(_rank_main, args=(job, workdir, _init_method(workdir, "pg")),
             nprocs=WORLD, join=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
