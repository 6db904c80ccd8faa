"""Serving launcher (counterpart of ``repro/launch/serve.py``): a thin
argparse front over the typed public API in ``repro_torch.serve.api``
(ServeOptions / load_engine / serve — DESIGN.md §5.6). The flags are the
JAX package's, one for one; every flag maps onto a :class:`ServeOptions`
field, and all validation and behavior lives in the API module. The CLI
runs on the card; from Python, ``serve(opts, device="cpu")`` runs the same
options on the CPU.

    # boot a compressed artifact of either package and serve it, every
    # decode and prefill signature captured as a CUDA graph at boot
    python -m repro_torch.launch.serve --arch smollm-360m \
        --compressed-ckpt runs/smollm_drank20 --verify --aot \
        --batch 8 --max-len 256 --requests 16 --prompt-len 64 --n-new 32

    # compress at boot on the card, then serve through the front door
    python -m repro_torch.launch.serve --arch smollm-360m \
        --compress drank --ratio 0.2 --device-compress --stream

    # serve a training checkpoint (``launch.train --ckpt-dir``, of either
    # package) at its last step
    python -m repro_torch.launch.serve --arch smollm-360m --ckpt runs/smollm

    # calibrate and compress on a (data = 2) mesh of two ranks; rank 0
    # writes the artifact and serves
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch smollm-360m --compress drank --ratio 0.2 --device-compress \
        --calib-mesh-shards 2

``--aot`` captures the graphs at boot; they live in the process and are
never persisted (``--aot-cache-dir`` is accepted and stores nothing).
Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank joins the process group
(``dist.comm.init``: NCCL when every rank owns a card, gloo through pinned
host memory when the ranks share one); ranks other than 0 calibrate and
compress (``api.mesh_compress``) and exit.
"""
from __future__ import annotations

import argparse
import json
import warnings


def build_parser() -> argparse.ArgumentParser:
    """Flags mirror ``ServeOptions`` fields (``-`` ↔ ``_``); deprecated
    spellings keep working via ``parse_serve_options``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--ckpt", default="",
                    help="a training checkpoint directory (its LATEST step)")
    from repro_torch.core.compress import METHODS
    ap.add_argument("--compress", default="", choices=["", *METHODS])
    ap.add_argument("--ratio", type=float, default=0.3)
    ap.add_argument("--group-size", type=int, default=2)
    ap.add_argument("--beta", type=float, default=0.3)
    ap.add_argument("--compressed-ckpt", default="",
                    help="boot from a compress.save_plan artifact "
                         "(skips --ckpt/--compress)")
    ap.add_argument("--save-compressed", default="",
                    help="after --compress, persist the artifact here")
    ap.add_argument("--verify", action="store_true",
                    help="with --compressed-ckpt: re-hash the stored "
                         "arrays against the manifest content hashes "
                         "before booting")
    ap.add_argument("--eager-capture", action="store_true",
                    help="calibrate with the eager host oracle instead of "
                         "the streaming device capture")
    ap.add_argument("--whiten-stream", action="store_true",
                    help="stream whitening Cholesky factors instead of "
                         "Grams during calibration (QR updates; the Gram "
                         "is never materialized — DESIGN.md §1.5/§1.6)")
    ap.add_argument("--calib-mesh-shards", type=int, default=0,
                    help="calibrate over a (data=N) mesh of N ranks: run "
                         "under torchrun --standalone --nproc-per-node N "
                         "(sharded batch and accumulators, the device "
                         "decomposition spread over the ranks; rank 0 "
                         "serves); 0 = single-device capture")
    ap.add_argument("--shard-grams-above", type=int, default=4096,
                    help="with --calib-mesh-shards: feature dim at which "
                         "calibration (D,D) accumulators shard row-wise "
                         "over the mesh data axes instead of replicating")
    ap.add_argument("--calib-samples", type=int, default=16,
                    help="calibration samples for --compress")
    ap.add_argument("--calib-seq", type=int, default=128,
                    help="calibration sequence length for --compress")
    ap.add_argument("--device-compress", action="store_true",
                    help="run the compression math (whitening/SVD/refine) "
                         "on the card via the batched float64 "
                         "numerics_device backend instead of the host fp64 "
                         "loop")
    ap.add_argument("--rsvd-threshold", type=int, default=0,
                    help="with --device-compress: min-side size above "
                         "which the exact eigh switches to randomized SVD")
    ap.add_argument("--batch", type=int, default=None,
                    help="decode slots (continuous-batching width)")
    ap.add_argument("--slots", type=int, default=None,
                    help=argparse.SUPPRESS)   # deprecated alias of --batch
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--kv-block", type=int, default=0,
                    help="paged KV cache: block size in tokens (multiple "
                         "of 8, divides --max-len); 0 = the contiguous "
                         "per-slot pool (DESIGN.md §5.7)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="with --kv-block: requests sharing a prompt "
                         "prefix refcount the same immutable KV blocks; "
                         "admission prefills only the unshared tail "
                         "(copy-on-write fork at the divergence block)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--n-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    # --- resilience (DESIGN.md §5) ----------------------------------------
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the wait queue; submits past the bound "
                         "are rejected with backpressure (0 = unbounded)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline; requests still "
                         "queued past it are deterministically shed")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="poison-quarantine re-queue budget before a "
                         "request fails typed")
    ap.add_argument("--reject-overlong", action="store_true",
                    help="shed prompts longer than max_len - 1 with a "
                         "typed shed_overlong status instead of "
                         "truncating them to their newest tokens")
    ap.add_argument("--elastic", action="store_true",
                    help="serve-time elastic rank: degrade factorized "
                         "decode rank to pow2 buckets under queue "
                         "pressure, restore when drained")
    ap.add_argument("--elastic-levels", type=int, default=2,
                    help="with --elastic: degraded rank buckets below "
                         "full rank")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="drain watchdog: report the run as stalled "
                         "after this long without forward progress")
    ap.add_argument("--heartbeat-dir", default="",
                    help="beat a liveness heartbeat file here every "
                         "engine step (dist.ft; readable by "
                         "detect_stalled / StallDetector)")
    ap.add_argument("--fault-plan", default="",
                    help="inject deterministic faults: a JSON FaultPlan "
                         "or @path/to/plan.json (dist.faultinject; "
                         "chaos drills only)")
    ap.add_argument("--load-retries", type=int, default=0,
                    help="with --compressed-ckpt: retry a transiently "
                         "failing load with backoff, quarantining the "
                         "artifact if it keeps failing integrity")
    ap.add_argument("--stats-json", default="",
                    help="write the structured serve-metrics dict "
                         "(queue/shed/retry counters, TTFT percentiles, "
                         "rank-bucket residency) to this path")
    # --- front door -------------------------------------------------------
    ap.add_argument("--aot", action="store_true",
                    help="capture the serving surface at boot: one CUDA "
                         "graph per decode and prefill signature, replayed "
                         "in steady state (serve/aot.py); the graphs live "
                         "in this process and are never persisted")
    ap.add_argument("--aot-cache-dir", default="",
                    help="accepted for parity with the JAX launcher; a "
                         "CUDA graph cannot be persisted, so nothing is "
                         "stored")
    ap.add_argument("--replicas", type=int, default=1,
                    help="run N engine replicas behind one router that "
                         "places requests on the least-loaded replica "
                         "and spills on backpressure")
    ap.add_argument("--stream", action="store_true",
                    help="drive the workload through the async front "
                         "door (token streaming) even with --replicas 1")
    # --- observability (DESIGN.md §6) -------------------------------------
    ap.add_argument("--trace-out", default="",
                    help="record the run as Chrome-trace JSON here "
                         "(load in https://ui.perfetto.dev or "
                         "chrome://tracing)")
    ap.add_argument("--device-trace-dir", default="",
                    help="with --trace-out or alone: capture a "
                         "torch.profiler device timeline into this "
                         "directory")
    ap.add_argument("--metrics-json", default="",
                    help="write the live v2 metrics snapshot here on a "
                         "fixed cadence (plus once at the end)")
    ap.add_argument("--metrics-interval-s", type=float, default=1.0,
                    help="cadence for --metrics-json")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve Prometheus text metrics on this port "
                         "(0 = ephemeral; -1 = off)")
    ap.add_argument("--flightrec-dir", default="",
                    help="arm the flight recorder: dump a debug artifact "
                         "here whenever a request fails typed or a drain "
                         "ends non-drained")
    return ap


def parse_serve_options(argv=None):
    """argv → :class:`repro.serve.api.ServeOptions`. Deprecated flags
    are translated here (with a ``DeprecationWarning``) so the options
    object only ever sees canonical names."""
    from repro_torch.serve.api import ServeOptions

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.slots is not None:
        warnings.warn("--slots is deprecated; use --batch",
                      DeprecationWarning, stacklevel=2)
        if args.batch is None:
            args.batch = args.slots
    if args.batch is None:
        args.batch = 4
    fields = {f.name for f in ServeOptions.__dataclass_fields__.values()}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    try:
        return ServeOptions(**kw)
    except ValueError as e:
        ap.error(str(e))


def main(argv=None) -> int:
    import os

    from repro_torch.serve.api import mesh_compress, serve

    opts = parse_serve_options(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        from repro_torch.dist import comm
        c = comm.init(world, int(os.environ["RANK"]), "cuda")
        try:
            if c.rank != 0:
                mesh_compress(opts)
                return 0
            return _serve_and_print(serve, opts)
        finally:
            comm.shutdown()
    return _serve_and_print(serve, opts)


def _serve_and_print(serve, opts) -> int:
    res = serve(opts, echo=print)
    print(json.dumps(res.report, indent=1))
    if res.status != "drained":
        undone = [r.rid for r in res.undrained]
        print(f"WARNING: drain ended '{res.status}' with "
              f"{len(undone)} requests unfinished: {undone[:8]}")
    for r in res.failed:
        print(f"FAILED rid={r.rid}: {r.error}")
    return 0 if res.status == "drained" else 1


if __name__ == "__main__":
    raise SystemExit(main())
