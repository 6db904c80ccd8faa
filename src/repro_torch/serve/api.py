"""Typed public serving API (counterpart of ``repro/serve/api.py``;
DESIGN.md §5.6).

The stable, importable surface over the serving stack:
:class:`ServeOptions` (a frozen dataclass holding every knob the CLI
exposes, with the JAX package's fields, defaults and validation messages),
:func:`load_engine` (options → a ready engine) and :func:`serve` (options →
a drained workload with a structured report). ``repro_torch.launch.serve``
is a thin argparse shim over these.

    from repro_torch.serve.api import ServeOptions, serve
    res = serve(ServeOptions(arch="smollm-360m",
                             compressed_ckpt="runs/smollm_drank20",
                             aot=True, requests=16, n_new=32))
    assert res.status == "drained"
    print(res.report["tokens_per_s"])

The device is a keyword of :func:`load_engine` and :func:`serve`, not an
option field, so the options stay JAX's: by default the card
(``device.resolve_device``); ``device="cpu"`` runs the plain PyTorch path.

``aot=True`` swaps the engine's eager dispatch for an
:class:`~repro_torch.serve.aot.AotRegistry`, warmed at boot: one CUDA graph
per decode and prefill signature, captured in this process and never
persisted (a graph cannot be serialized; ``aot_cache_dir`` is accepted and
stores nothing, see ``serve/aot.py``).

Departures from the JAX package:

* ``calib_mesh_shards = n > 1`` runs under a process group of n ranks
  (``dist.comm.init``), not over n local devices: start it with
  ``torchrun --standalone --nproc-per-node n -m repro_torch.launch.serve
  ...``. Every rank calibrates and compresses on a (data = n) mesh
  (``mesh_compress``); rank 0 writes the artifact and serves, and its
  report carries ``world`` and ``comm`` (the backend, its transport and
  the bytes staged). Any other world raises. A random
  model comes from ``init_model``'s torch seed, so its weights are not
  JAX's; an artifact or a step checkpoint (``ckpt=``) of either package
  boots the same weights in both.
* the report also carries ``tokens_digest``, a sha256 over every finished
  request's rid and tokens, so two runs (a CLI run and a Python call, say)
  can be held token for token.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import flightrec as frec
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricsExporter, MetricsServer
from repro_torch.serve import admission as adm
from repro_torch.serve import aot as aotlib
from repro_torch.serve.aot import AotRegistry, TracedRegistry
from repro_torch.serve.engine import (ContinuousBatcher, DrainResult, Engine,
                                      Request, ServeConfig, from_compressed)
from repro_torch.serve.frontdoor import FrontDoor, Router, TokenStream

__all__ = [
    "ServeOptions", "load_engine", "serve",
    "from_compressed", "Engine", "ContinuousBatcher",
    "Request", "DrainResult", "ServeConfig",
    "FrontDoor", "Router", "TokenStream",
    "AotRegistry", "TracedRegistry",
]

_CALIB_BATCH = 8          # rows per calibration batch (matches launch CLI)


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Everything the serving stack can be asked to do, as one frozen
    value. Field names are the CLI flags with ``-`` → ``_`` (the one
    rename: ``--slots`` is the deprecated alias of ``batch``).
    Cross-field validation runs at construction.

    >>> opts = ServeOptions(arch="llama-mini", n_new=8)
    >>> (opts.batch, opts.aot, opts.replicas)
    (4, False, 1)
    >>> ServeOptions(arch="llama-mini", compress="nope")
    Traceback (most recent call last):
        ...
    ValueError: unknown compression method 'nope'
    """

    arch: str
    # --- model / artifact sources ----------------------------------------
    ckpt: str = ""
    compress: str = ""              # one of core.compress.METHODS, or ""
    ratio: float = 0.3
    group_size: int = 2
    beta: float = 0.3
    compressed_ckpt: str = ""       # boot from a save_plan artifact
    save_compressed: str = ""       # after compress, persist here
    verify: bool = False            # re-hash artifact against manifest
    load_retries: int = 0           # transient-load retry budget
    # --- calibration (only with compress=) -------------------------------
    eager_capture: bool = False
    whiten_stream: bool = False
    calib_mesh_shards: int = 0
    shard_grams_above: int = 4096
    calib_samples: int = 16
    calib_seq: int = 128
    device_compress: bool = False
    rsvd_threshold: int = 0
    # --- engine shape -----------------------------------------------------
    batch: int = 4                  # decode slots (CLI: --batch / --slots)
    max_len: int = 256
    kv_block: int = 0               # paged KV block size; 0 = contiguous
    prefix_cache: bool = False      # share prompt-prefix blocks (paged)
    # --- synthetic workload (serve()) -------------------------------------
    requests: int = 8
    prompt_len: int = 16
    n_new: int = 32
    seed: int = 0
    # --- resilience (DESIGN.md §5) ----------------------------------------
    max_queue: int = 0
    deadline_s: Optional[float] = None
    max_retries: int = 2
    reject_overlong: bool = False   # shed over-long prompts typed instead
    #                                 of truncating to the newest tokens
    elastic: bool = False
    elastic_levels: int = 2
    watchdog_s: Optional[float] = None
    heartbeat_dir: str = ""
    fault_plan: str = ""
    stats_json: str = ""
    # --- front door -------------------------------------------------------
    aot: bool = False               # CUDA graphs captured at boot
    aot_cache_dir: str = ""         # accepted for parity; stores nothing
    replicas: int = 1               # N engines behind one Router
    stream: bool = False            # drive through FrontDoor even for N=1
    # --- observability (DESIGN.md §6) -------------------------------------
    trace_out: str = ""             # Chrome-trace JSON path (Perfetto)
    device_trace_dir: str = ""      # torch.profiler trace directory
    metrics_json: str = ""          # periodic v2 metrics snapshot JSON
    metrics_interval_s: float = 1.0  # exporter cadence for metrics_json
    metrics_port: int = -1          # Prometheus /metrics; -1 off, 0 ephemeral
    flightrec_dir: str = ""         # flight-recorder dump directory

    def __post_init__(self):
        from repro_torch.core.compress import METHODS
        if self.compress and self.compress not in METHODS:
            raise ValueError(
                f"unknown compression method '{self.compress}'")
        if self.compress and self.compressed_ckpt:
            raise ValueError(
                "compress= and compressed_ckpt= conflict: an artifact "
                "is already compressed")
        if self.save_compressed and not self.compress:
            raise ValueError("save_compressed= needs compress=")
        if self.whiten_stream and self.eager_capture:
            raise ValueError("whiten_stream needs the streaming capture; "
                             "drop eager_capture")
        if self.calib_mesh_shards > 1:
            if self.eager_capture:
                raise ValueError("calib_mesh_shards needs the streaming "
                                 "capture; drop eager_capture")
            if _CALIB_BATCH % self.calib_mesh_shards != 0:
                raise ValueError(
                    f"calib_mesh_shards {self.calib_mesh_shards} must "
                    f"divide the calibration batch of {_CALIB_BATCH} rows")
            if self.calib_samples % _CALIB_BATCH != 0:
                raise ValueError(
                    f"calib_samples {self.calib_samples} must be a "
                    f"multiple of {_CALIB_BATCH} with calib_mesh_shards "
                    f"(a ragged final batch cannot split over the mesh)")
        if self.batch < 1 or self.max_len < 1:
            raise ValueError("batch and max_len must be >= 1")
        if self.kv_block < 0:
            raise ValueError("kv_block must be >= 0 (0 = contiguous)")
        if self.kv_block:
            if self.kv_block % 8:
                raise ValueError("kv_block must be a multiple of 8 "
                                 "(TPU sublane alignment)")
            if self.max_len % self.kv_block:
                raise ValueError(
                    f"kv_block {self.kv_block} must divide max_len "
                    f"{self.max_len}")
        if self.prefix_cache and not self.kv_block:
            raise ValueError("prefix_cache requires kv_block > 0")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if not -1 <= self.metrics_port <= 65535:
            raise ValueError("metrics_port must be -1 (off), 0 "
                             "(ephemeral) or a valid TCP port")
        if self.metrics_interval_s <= 0:
            raise ValueError("metrics_interval_s must be > 0")

    def serve_config(self) -> ServeConfig:
        return ServeConfig(batch=self.batch, max_len=self.max_len,
                           kv_block=self.kv_block,
                           prefix_cache=self.prefix_cache)

    def admission_config(self) -> "adm.AdmissionConfig":
        return adm.AdmissionConfig(max_queue=self.max_queue,
                                   default_deadline_s=self.deadline_s,
                                   max_retries=self.max_retries,
                                   reject_overlong=self.reject_overlong,
                                   elastic=self.elastic,
                                   elastic_levels=self.elastic_levels)


def _echo(echo: Optional[Callable[[str], None]], msg: str) -> None:
    if echo is not None:
        echo(msg)


def _resilience_kwargs(opts: ServeOptions, replica: int = 0,
                       echo=None) -> Dict:
    faults = None
    if opts.fault_plan:
        from repro_torch.dist.faultinject import FaultPlan
        faults = FaultPlan.from_json(opts.fault_plan)
        _echo(echo, f"fault plan armed: {faults.to_json()}")
    heartbeat = None
    if opts.heartbeat_dir:
        from repro_torch.dist.ft import Heartbeat
        heartbeat = Heartbeat(os.path.join(opts.heartbeat_dir,
                                           f"worker{replica}.json"),
                              fault=faults)
    flight = frec.FlightRecorder(dump_dir=opts.flightrec_dir or None)
    return dict(admission=opts.admission_config(), faults=faults,
                heartbeat=heartbeat, flight=flight)


def _compress_in_process(opts: ServeOptions, params, cfg, device,
                         echo=None):
    """The compress-at-boot path: calibrate on synthetic data on
    ``device``, build the plan (the decomposition on the device with
    ``device_compress``), optionally persist the artifact. Returns
    (params, plan)."""
    import torch

    from repro_torch.core import compress as CC
    from repro_torch.data.synthetic import DataConfig, calibration_batches

    mesh = (_calib_mesh(opts.calib_mesh_shards)
            if opts.calib_mesh_shards > 1 else None)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=opts.calib_seq,
                      global_batch=_CALIB_BATCH)
    calib = [{"tokens": torch.as_tensor(b["tokens"], device=device)}
             for b in calibration_batches(dcfg, opts.calib_samples,
                                          _CALIB_BATCH)]
    ccfg = CC.CompressionConfig(method=opts.compress, ratio=opts.ratio,
                                group_size=opts.group_size, beta=opts.beta,
                                rsvd_threshold=opts.rsvd_threshold)
    params, plan = CC.build_plan_and_params(
        params, cfg, ccfg, calib,
        streaming=not opts.eager_capture,
        device=opts.device_compress,
        mesh=mesh,
        whiten_tags=(True if opts.whiten_stream else None),
        shard_grams_above=opts.shard_grams_above)
    _echo(echo, f"compressed with {opts.compress}: "
                f"{plan.summary['achieved_ratio']:.1%} removed")
    if opts.save_compressed and (mesh is None or mesh.rank == 0):
        path = CC.save_plan(opts.save_compressed, params, plan, cfg)
        _echo(echo, f"saved compressed artifact to {path}")
    if mesh is not None:
        from repro_torch.dist import comm
        comm.barrier()          # the artifact is on disk for every rank
    return params, plan


def _calib_mesh(n: int):
    """The (data = n) mesh of mesh calibration: the process group this
    process joined must hold exactly n ranks."""
    from repro_torch.dist import comm
    world = comm.current().world if comm.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"calib_mesh_shards={n} calibrates over a process group of {n} "
            f"ranks, and this process is in "
            + (f"one of {world}" if comm.is_initialized() else "none")
            + f": start it with torchrun --standalone --nproc-per-node {n} "
              f"-m repro_torch.launch.serve ...")
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(data=n, model=1)


def _registry_for(opts: ServeOptions, cfg, scfg, fingerprint: str):
    if not opts.aot:
        return None                       # engine defaults to traced
    return AotRegistry(cfg, scfg, fingerprint,
                       cache_dir=opts.aot_cache_dir or None)


def _source_params(opts: ServeOptions, cfg, dev, echo=None):
    """The dense params to serve or compress: a training checkpoint's, or
    a random model from ``opts.seed``."""
    from repro_torch.models import transformer as T
    if opts.ckpt:
        from repro_torch.ckpt import store
        from repro_torch.train import step as TS
        # the template holds no memory: restore reads its structure and
        # dtypes only. Its npz keys are the TrainState's "params␟…", so
        # only the params reach the device, not the optimizer's moments
        state, _ = TS.init_train_state(cfg, seed=0, device="meta")
        step, tree = store.restore(opts.ckpt, {"params": state.params},
                                   device=dev)
        _echo(echo, f"loaded {opts.ckpt} @ step {step}")
        return tree["params"]
    params, _ = T.init_model(cfg, seed=opts.seed, device=dev)
    _echo(echo, "serving a randomly initialized model (no ckpt)")
    return params


def mesh_compress(opts: ServeOptions, *, device: DeviceLike = None):
    """What a rank other than 0 runs under ``calib_mesh_shards``: the same
    model source, calibration and compression as rank 0's
    ``load_engine`` (every collective needs every rank), without an
    engine. Returns (params, plan)."""
    from repro_torch.configs import get_config
    if not opts.compress or opts.calib_mesh_shards <= 1:
        raise ValueError("mesh_compress needs compress= and "
                         "calib_mesh_shards > 1")
    cfg = get_config(opts.arch)
    dev = resolve_device(device)
    return _compress_in_process(opts, _source_params(opts, cfg, dev), cfg,
                                dev)


def load_engine(opts: ServeOptions, *, replica: int = 0,
                echo: Optional[Callable[[str], None]] = None,
                device: DeviceLike = None) -> ContinuousBatcher:
    """Options → a ready :class:`ContinuousBatcher` on ``device`` (the card
    by default).

    Resolves the model source (compressed artifact, else a training
    checkpoint's params, else random init), runs compress-at-boot
    if asked, wires the resilience layer and, with ``aot=True``, attaches
    an :class:`AotRegistry` keyed on the artifact fingerprint and warms the
    whole serving surface, so the returned engine only replays graphs in
    steady state. ``echo`` receives human-readable boot progress lines
    (the CLI passes ``print``)."""
    from repro_torch.configs import get_config

    cfg = get_config(opts.arch)
    scfg = opts.serve_config()
    dev = resolve_device(device)
    resil = _resilience_kwargs(opts, replica=replica, echo=echo)

    if opts.compressed_ckpt:
        from repro_torch.ckpt.store import artifact_fingerprint
        from repro_torch.core.compress import ARTIFACT_NAME
        fp = artifact_fingerprint(opts.compressed_ckpt, name=ARTIFACT_NAME)
        reg = _registry_for(opts, cfg, scfg, fp)
        cb = from_compressed(opts.compressed_ckpt, cfg, scfg,
                             verify=opts.verify,
                             load_retries=opts.load_retries,
                             executables=reg, device=dev, **resil)
        _echo(echo, f"booted from compressed checkpoint "
                    f"{opts.compressed_ckpt} "
                    f"({cb.plan.summary['achieved_ratio']:.1%} removed, "
                    f"method={cb.plan.config.method}"
                    + (", integrity verified" if opts.verify else "") + ")")
    else:
        params = _source_params(opts, cfg, dev, echo)
        plan = None
        if opts.compress:
            params, plan = _compress_in_process(opts, params, cfg, dev,
                                                echo=echo)
        reg = _registry_for(opts, cfg, scfg,
                            aotlib.live_fingerprint(params, cfg))
        cb = ContinuousBatcher(params, cfg, scfg, executables=reg,
                               device=dev, **resil)
        cb.plan = plan
    if opts.aot:
        t0 = time.perf_counter()
        cb.warm_executables()
        s = cb.stats
        _echo(echo, f"AOT warm in {time.perf_counter() - t0:.2f}s: "
                    f"{s['aot_compiles']} entries, "
                    f"{len(cb.exec.graph_bytes())} CUDA graphs captured, "
                    f"{s['aot_cache_hits']} cache hits (graphs live in "
                    f"this process and are never persisted; "
                    f"aot_cache_dir stores nothing)")
    return cb


def _workload(opts: ServeOptions, vocab_size: int) -> List[Request]:
    rng = np.random.default_rng(opts.seed)
    return [Request(rid=i, n_new=opts.n_new,
                    tokens=rng.integers(0, vocab_size,
                                        size=(opts.prompt_len,),
                                        dtype=np.int32))
            for i in range(opts.requests)]


def tokens_digest(result: DrainResult) -> str:
    """sha256 over every finished request's rid and tokens, in rid order."""
    outs = sorted((int(r.rid), [int(t) for t in r.out]) for r in result)
    return hashlib.sha256(json.dumps(outs).encode()).hexdigest()


def _report(result: DrainResult, stats, accepted: int, requests: int,
            dt: float) -> Dict:
    toks = sum(len(r.out) for r in result)
    lat = [r.t_done - r.t_submit for r in result]
    return {
        "drain_status": result.status,   # drained | timeout | stalled
        "requests": len(result),
        "accepted": accepted,
        "submitted": requests,
        "shed": len(result.shed),
        "rejected": len(result.rejected),
        "failed": len(result.failed),
        "generated_tokens": toks,
        "tokens_per_s": round(toks / dt, 1) if toks else 0.0,
        "mean_latency_s": round(float(np.mean(lat)), 3) if lat else 0.0,
        "p95_latency_s": (round(float(np.percentile(lat, 95)), 3)
                          if lat else 0.0),
        "engine_stats": stats,           # retrace/AOT counters, admissions
        "tokens_digest": tokens_digest(result),
    }


def serve(opts: ServeOptions, *,
          echo: Optional[Callable[[str], None]] = None,
          device: DeviceLike = None) -> DrainResult:
    """Run the synthetic workload described by ``opts`` to drain on
    ``device`` (the card by default) and return the :class:`DrainResult`,
    with the structured report attached as ``result.report``.

    ``replicas == 1`` and ``stream=False`` drives the engine directly
    (``run_until_drained``); ``replicas > 1`` or ``stream=True`` goes
    through the front door: N engines behind a :class:`Router` that places
    each request on the least-loaded replica and spills on backpressure.

    Observability (DESIGN.md §6): ``trace_out`` records the whole run as
    Chrome-trace JSON; ``device_trace_dir`` adds a ``torch.profiler``
    capture (``obs.trace.device_trace``); ``metrics_json``/``metrics_port``
    export the live v2 metrics snapshot as periodic JSON / a Prometheus
    scrape endpoint; ``flightrec_dir`` arms per-engine flight-recorder
    dumps."""
    if opts.trace_out or opts.device_trace_dir:
        with trace.tracing(out=opts.trace_out or None):
            with trace.device_trace(opts.device_trace_dir or None):
                result = _serve_inner(opts, echo=echo, device=device)
        if opts.trace_out:
            _echo(echo, f"trace written to {opts.trace_out} "
                        f"(load in https://ui.perfetto.dev)")
        return result
    return _serve_inner(opts, echo=echo, device=device)


def _serve_inner(opts: ServeOptions, *,
                 echo: Optional[Callable[[str], None]] = None,
                 device: DeviceLike = None) -> DrainResult:
    from repro_torch.configs import get_config

    cfg = get_config(opts.arch)
    t0 = time.perf_counter()
    engines = [load_engine(opts, replica=i,
                           echo=echo if i == 0 else None, device=device)
               for i in range(opts.replicas)]
    reqs = _workload(opts, cfg.vocab_size)

    multi = opts.replicas > 1 or opts.stream
    exporter = server = None
    if opts.metrics_json:
        supplier = ((lambda: [e.metrics() for e in engines]) if multi
                    else engines[0].metrics)
        exporter = MetricsExporter(opts.metrics_json, supplier,
                                   interval_s=opts.metrics_interval_s
                                   ).start()
    if opts.metrics_port >= 0:
        server = MetricsServer(lambda: [e.metrics() for e in engines],
                               port=opts.metrics_port).start()
        _echo(echo, f"metrics: http://127.0.0.1:{server.port}/metrics")
    try:
        if multi:
            router = Router([FrontDoor(e) for e in engines]).start()
            accepted = 0
            for r in reqs:
                st = router.submit(r.tokens, r.n_new,
                                   deadline_s=opts.deadline_s, rid=r.rid)
                accepted += st is not None
            result = router.drain_all(timeout=opts.watchdog_s)
            router.close()
            stats = [e.stats for e in engines]
            metrics = [d.metrics() for d in router.doors]
        else:
            cb = engines[0]
            accepted = 0
            for r in reqs:
                accepted += cb.submit(r)
            result = cb.run_until_drained(watchdog_s=opts.watchdog_s)
            stats = cb.stats
            metrics = cb.metrics()
    finally:
        if exporter is not None:
            exporter.stop()
            _echo(echo, f"metrics snapshot written to {opts.metrics_json}")
        if server is not None:
            server.stop()
    if accepted < opts.requests:
        _echo(echo, f"backpressure: {opts.requests - accepted}/"
                    f"{opts.requests} requests rejected at submit "
                    f"(max_queue={opts.max_queue})")
    dumped = [p for e in engines for p in e.flight.dumps]
    if dumped:
        _echo(echo, "flight-recorder artifacts: " + ", ".join(dumped))
    dt = time.perf_counter() - t0
    result.report = _report(result, stats, accepted, opts.requests, dt)
    from repro_torch.dist import comm
    if comm.is_initialized():
        result.report["world"] = comm.current().world
        result.report["comm"] = comm.current().report()
    if opts.stats_json:
        with open(opts.stats_json, "w") as f:
            json.dump(metrics, f, indent=1)
        _echo(echo, f"serve metrics written to {opts.stats_json}")
    return result
