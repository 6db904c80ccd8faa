"""Where the time of the decode product ``lowrank_gemv`` goes, on one
NVIDIA GPU.

    PYTHONPATH=src python3 -m repro_torch.kernels.gemv_profile

Times the two-launch kernel (``"mma"``, bf16) as the wrapper plans it
beside the same kernel with every launch aimed at all the blocks the card
holds at once (``full``) or at half of them (``half``): the wrapper takes
the half for a weight under ``GEMV_BIG_BYTES``, the whole above. Each is
first held to the plain version (``kernels.ref``) at the bf16 tolerance,
2e-2. It times one decode step's worth of SmolLM-360M-shaped compressed
linears (32 layers of seven, at D-Rank 20%-like ranks) at 8 and 64 rows,
in the order plan, full, half, half, full, plan, beside the earlier
three-launch design (``variant="splitk"``) and ``torch.linalg.multi_dot``;
SmolLM-360M's w_up and gemma3-12b's MLP and attention linears one at a
time at 2 and 64 rows the same way; and,
from a ``torch.profiler`` trace of the planned kernel, each launch's device
time and how the launches of consecutive linears overlap. The first two
lines are the card's name and power limit and the versions.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import lowrank_matmul as lm

OUT = _build.BUILD_DIR.parent / "gemv_profile"
RULES = ("plan", "full", "half")
# one layer's seven compressed linears (K, R, N) of SmolLM-360M at ranks
# such as D-Rank 20% gives (ragged: B's rows by 16-byte copies, 4-byte
# copies and raw words), 32 layers
LAYER = ((960, 300, 960), (960, 120, 320), (960, 121, 320), (960, 298, 960),
         (960, 698, 2560), (960, 697, 2560), (2560, 600, 960))
LAYERS = 32
# linears timed one at a time: SmolLM-360M's w_up at rank 698, and
# gemma3-12b's at uniform 20%: the MLP's w_up and w_down, and wq
SINGLE = (("SmolLM-360M w_up", (960, 698, 2560)),
          ("gemma3-12b w_up", (3840, 2457, 15360)),
          ("gemma3-12b w_down", (15360, 2457, 3840)),
          ("gemma3-12b wq", (3840, 1585, 4096)))
TOL = 2e-2


def device_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms, a sleep kernel holding the
    stream while the host enqueues it."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def launch_overlap(fn, n: int) -> str:
    """From a profiler trace of ``fn`` (n linears, two launches each): the
    mean device us of launch 1 and launch 2 (from their first block's start
    to their last block's end, any wait inside included), how far launch 2
    starts and ends after launch 1, and where the next linear's launch 1
    starts against this one's launch 2's end."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(200_000_000)     # the host enqueues ahead
        fn()
        torch.cuda.synchronize()
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                 if e.get("cat") == "kernel"
                 and "gemv_stream" in e.get("name", "")),
                key=lambda e: e["ts"])
    if len(ev) != 2 * n:
        return f"the trace holds {len(ev)} gemv launches, not {2 * n}"
    l1, l2 = ev[0::2], ev[1::2]

    def end(e):
        return e["ts"] + e["dur"]
    d1 = np.mean([e["dur"] for e in l1])
    d2 = np.mean([e["dur"] for e in l2])
    starts = np.mean([b["ts"] - a["ts"] for a, b in zip(l1, l2)])
    ends = np.mean([end(b) - end(a) for a, b in zip(l1, l2)])
    early = np.mean([end(b) - a["ts"] for a, b in zip(l1[1:], l2)])
    gap = (end(ev[-1]) - ev[0]["ts"]) / n
    return (f"launch 1 {d1:.2f} us, launch 2 {d2:.2f}; launch 2 starts "
            f"{starts:.2f} us after launch 1 and ends {ends:.2f} after it; "
            f"the next linear's launch 1 starts {early:.2f} us before this "
            f"one's launch 2 ends; {gap:.2f} us a linear")


def main() -> int:
    if not torch.cuda.is_available():
        print("gemv_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    bf = torch.bfloat16
    card = lm.card(dev)
    print(f"card: {card[0]} SMs, {card[1]} bytes of shared memory an SM")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(bf)

    st = torch.cuda.current_stream().cuda_stream

    def blocks(M, K, R, N, rule):
        if rule == "plan":
            return lm._gemv_blocks(M, K, R, N, 2, card)
        held = lm._gemv_target_blocks(2, lm._rows_tile(M),
                                      lm.GEMV_BIG_BYTES, card)
        return (held, held) if rule == "full" else (held // 2, held // 2)

    def gemv(rule, x, B, C):
        M, K = x.shape
        R, N = C.shape
        y = torch.empty((M, N), dtype=bf, device=dev)
        t = torch.empty((M, lm._t_stride(R, bf)), dtype=bf, device=dev)
        _build.check_rc(lm._fn("drt_lowrank_gemv_stream")(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            t.data_ptr(), M, K, R, N, *blocks(M, K, R, N, rule), 1, st),
            f"gemv ({rule})")
        return y

    lins = [(rnd((K, R), K ** -0.5), rnd((R, N), R ** -0.5))
            for _ in range(LAYERS) for K, R, N in LAYER]
    single = [(rnd((K, R), K ** -0.5), rnd((R, N), R ** -0.5))
              for _, (K, R, N) in SINGLE]
    for rule in RULES:
        for M in (1, 8, 64):
            for B, C in lins[:len(LAYER)] + single:
                x = rnd((M, B.shape[0]))
                want = ref.lowrank_matmul(x, B, C).float()
                err = float((gemv(rule, x, B, C).float() - want).abs().max()
                            / (want.abs().max() + 1e-6))
                assert err <= TOL, (rule, M, tuple(B.shape), err)
    print(f"block rules {RULES} agree with the plain version (bf16, "
          f"{TOL:.0e}) at 1, 8 and 64 rows")

    for M in (8, 64):
        xs = [rnd((M, B.shape[0])) for B, _ in lins]
        nbytes = sum(2 * (M * B.shape[0] + B.numel() + C.numel()
                          + M * C.shape[1]) for B, C in lins)
        times = {}
        for rule in RULES + RULES[::-1]:
            times.setdefault(rule, []).append(device_ms(
                lambda: [gemv(rule, x, B, C) for x, (B, C) in zip(xs, lins)]))
        times["splitk"] = [device_ms(lambda: [
            lm.lowrank_gemv(x, B, C, variant="splitk")
            for x, (B, C) in zip(xs, lins)])]
        times["multi_dot"] = [device_ms(lambda: [
            torch.linalg.multi_dot([x, B, C]) for x, (B, C) in zip(xs, lins)])]
        print(f"{len(lins)} linears at {M} rows, device ms (bound "
              f"{nbytes / 3.35e12 * 1e3:.4f}, bytes): " + ", ".join(
                  f"{c} " + " / ".join(f"{t:.4f}" for t in v)
                  for c, v in times.items()))
        print(f"  plan, {M} rows: " + launch_overlap(
            lambda: [gemv("plan", x, B, C)
                     for x, (B, C) in zip(xs, lins)], len(lins)))
    for (name, (K, R, N)), (B, C) in zip(SINGLE, single):
        for M in (2, 64):
            x = rnd((M, K))
            r = {}
            for rule in RULES + RULES[::-1]:
                r.setdefault(rule, []).append(device_ms(
                    lambda: [gemv(rule, x, B, C) for _ in range(10)]) / 10)
            r["splitk"] = [device_ms(lambda: [
                lm.lowrank_gemv(x, B, C, variant="splitk")
                for _ in range(10)]) / 10]
            r["multi_dot"] = [device_ms(lambda: [
                torch.linalg.multi_dot([x, B, C]) for _ in range(10)]) / 10]
            print(f"{name} ({K}, {R}, {N}) at {M} rows, ms a linear (bound "
                  f"{2 * (K * R + R * N) / 3.35e12 * 1e3:.4f}; blocks "
                  f"planned {blocks(M, K, R, N, 'plan')}): " + ", ".join(
                      f"{c} " + " / ".join(f"{t:.4f}" for t in v)
                      for c, v in r.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
