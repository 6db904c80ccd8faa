"""Where the time of the tensor-core kernels goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 -m repro_torch.kernels.tc_profile [--against DIR]

Builds ``csrc/lowrank_matmul.cu`` and ``csrc/gram.cu`` through ``_build`` in
copies that differ only in their build switches (``COPIES``; one ``nvcc``
per library, all started together, into ``build/tc_profile/``):

* ``default``: no switch, the library the wrappers load;
* ``stamps`` (``DRT_PROFILE``): each block of ``lowrank_2d_wgmma_kernel``
  records ``%globaltimer`` at its phase boundaries (start, after the
  cluster barrier, end of phase 1, before the wait for the peers' chunks of
  t, end), each block of ``gram_wgmma_kernel`` at the end of its mainloop
  and of its epilogue;
* ``shallow`` (``DRT_WG_S2=3``): the 2-D kernel's phase-2 ring at 3 slots,
  not 6;
* ``no_mma2`` (``DRT_PROFILE_NO_MMA2``): the 2-D kernel's phase-2 wgmma
  left out (its results are wrong; it is only timed);
* ``b_raw`` (``DRT_B_RAW``): B at every rank that TMA cannot take staged
  as raw words, also at the even ranks where ``default`` makes 4-byte
  copies.

``stamps``, ``shallow`` and ``no_mma2`` also set ``DRT_MBAR_TRAP``, so a
copy that never lands traps instead of hanging the call. ``--against DIR``
also builds the two sources of another checkout's ``csrc`` directory
without switches. Each of ``b_raw`` and ``against`` is timed beside
``default`` in the order it, default, default, it, at the same shapes, in
the same process.

It runs the 2-D kernel at 512 rows on SmolLM-360M-shaped linears (x 512 x
K, B K x R, C R x N, bf16; B at rank 698 by 4-byte copies, at 697 as raw
words, at 600 and 704 by TMA) and the Gram at D 960 and 2560 over 1024
rows, and prints per-phase microseconds (min / mean / max over blocks), the
bytes a block stages in each phase over the phase's time, and each copy's
device time a call. The ``default``, ``b_raw`` and ``against`` copies' 2-D
outputs are held to the plain version (``kernels.ref``) at the bf16
tolerance, 2e-2. The first two lines are the card's name and power limit
and the versions.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref

OUT = _build.BUILD_DIR.parent / "tc_profile"
SOURCES = ("lowrank_matmul", "gram")
COPIES = {"default": (),
          "stamps": ("DRT_PROFILE", "DRT_MBAR_TRAP"),
          "shallow": ("DRT_WG_S2=3", "DRT_MBAR_TRAP"),
          "no_mma2": ("DRT_PROFILE_NO_MMA2", "DRT_MBAR_TRAP"),
          "b_raw": ("DRT_B_RAW",)}
PAIRED = ("against", "b_raw")   # copies timed beside default
# (K, R, N) of the 2-D kernel's linears
LINEARS = ((960, 698, 2560), (960, 697, 2560), (2560, 600, 960),
           (960, 704, 2560))
ROWS, GRAM_ROWS, CLUSTER, ROW_SLOTS = 512, 1024, 8, 16
TILE, RAW = 64 * 64 * 2, 64 * 9 * 16   # bytes of a tile; of a raw B tile
TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int


def jobs(against=None) -> dict:
    """{(copy, source): (.cu, .so, defines)} of every library to build."""
    out = {}
    for copy, defines in COPIES.items():
        d = _build.BUILD_DIR if copy == "default" else OUT / copy
        for n in SOURCES:
            out[copy, n] = (_build.CSRC / f"{n}.cu",
                            _build.target(n, out_dir=d, defines=defines),
                            defines)
    if against is not None:
        for n in SOURCES:
            out["against", n] = (Path(against) / f"{n}.cu",
                                 _build.target(n, Path(against),
                                               OUT / "against"), ())
    return out


def load(built: dict) -> dict:
    """{copy: (2-D library, Gram library)} with their argument types."""
    libs = {}
    for copy in dict.fromkeys(c for c, _ in built):
        lm = ctypes.CDLL(str(built[copy, "lowrank_matmul"][1]))
        lm.drt_lowrank_matmul_2d_wgmma.argtypes = [P] * 4 + [I] * 4 + [P]
        gm = ctypes.CDLL(str(built[copy, "gram"][1]))
        gm.drt_gram_wgmma.argtypes = [P, P, I, I, I, P]
        for lib in (lm, gm):
            if hasattr(lib, "drt_prof_read"):
                lib.drt_prof_read.argtypes = [P]
        libs[copy] = (lm, gm)
    return libs


def device_us(fn, reps: int = 7) -> float:
    """Median device time of ``fn`` in us, a sleep kernel holding the
    stream while the host enqueues it."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) * 1e3)
    return float(np.median(ts))


def stamps(lib, nb: int, ni: int) -> np.ndarray:
    buf = np.zeros((8192, 6), dtype=np.uint64)
    _build.check_rc(lib.drt_prof_read(buf.ctypes.data), "drt_prof_read")
    return buf[:nb, :ni].astype(np.int64)


def span(t: np.ndarray, i: int, j: int) -> str:
    d = (t[:, j] - t[:, i]) / 1e3
    return f"{d.min():.2f} / {d.mean():.2f} / {d.max():.2f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's csrc directory to time beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tc_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    built = jobs(args.against)
    secs = _build.compile_sources({k: v for k, v in built.items()
                                   if not v[1].exists()})
    print(f"built {len(secs)} libraries in {max(secs.values(), default=0):.1f}"
          f" s")
    libs = load(built)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).bfloat16()

    st = torch.cuda.current_stream().cuda_stream
    ops = [(rnd((ROWS, K)), rnd((K, R), K ** -0.5), rnd((R, N), R ** -0.5))
           for K, R, N in LINEARS]
    ys = [torch.empty(ROWS, N, device=dev, dtype=torch.bfloat16)
          for _, _, N in LINEARS]

    def run2d(lib, i):
        x, B, C = ops[i]
        K, R, N = LINEARS[i]
        _build.check_rc(lib.drt_lowrank_matmul_2d_wgmma(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), ys[i].data_ptr(), ROWS,
            K, R, N, st), "lowrank_matmul_2d (wgmma)")

    for copy in ("default", "b_raw", "against"):
        if copy not in libs:
            continue
        for i, lin in enumerate(LINEARS):
            run2d(libs[copy][0], i)
            want = ref.lowrank_matmul(*ops[i]).float()
            err = float((ys[i].float() - want).abs().max()
                        / (want.abs().max() + 1e-6))
            print(f"2-D {copy} {ROWS}x{lin}: max-relative error {err:.2e}")
            assert err <= TOL, (copy, lin, err)

    lm = libs["stamps"][0]
    nrt = -(-ROWS // 64)
    rows = [r * ROW_SLOTS + c for r in range(nrt) for c in range(CLUSTER)]
    for i, (K, R, N) in enumerate(LINEARS):
        run2d(lm, i)
        torch.cuda.synchronize()
        t = stamps(lm, ROW_SLOTS * nrt, 5)[rows]
        nrc, nk, nnc = -(-R // 64), -(-K // 64), -(-N // 64)
        steps1 = -(-nrc // (2 * CLUSTER)) * nk
        steps2 = -(-nnc // (2 * CLUSTER)) * nrc
        how = ("TMA" if R % 8 == 0 else "4-byte copies" if R % 2 == 0
               else "raw words")
        step1 = TILE + 2 * (RAW if how == "raw words" else TILE)
        p1 = (t[:, 2] - t[:, 1]).max() / 1e3
        p2 = (t[:, 4] - t[:, 3]).max() / 1e3
        print(f"2-D {ROWS}x{K}, rank {R} (B by {how}), N {N} (one call, "
              f"{nrt * CLUSTER} blocks; us min / mean / max over blocks):")
        print(f"  cluster barrier {span(t, 0, 1)}; phase 1 {span(t, 1, 2)} "
              f"({steps1} steps, <= {steps1 * step1 / 1e3:.0f} KB staged a "
              f"block: {steps1 * step1 / p1 / 1e3:.1f} GB/s); wait for t "
              f"{span(t, 2, 3)}; phase 2 {span(t, 3, 4)} ({steps2} steps, "
              f"<= {steps2 * 2 * TILE / 1e3:.0f} KB a block: "
              f"{steps2 * 2 * TILE / p2 / 1e3:.1f} GB/s); whole "
              f"{(t[:, 4].max() - t[:, 0].min()) / 1e3:.2f}")
    gmlib = libs["stamps"][1]
    for D in (960, 2560):
        x = rnd((GRAM_ROWS, D))
        out = torch.zeros(D, D, device=dev)
        _build.check_rc(gmlib.drt_gram_wgmma(x.data_ptr(), out.data_ptr(),
                                             GRAM_ROWS, D, 1, st),
                        "gram_blocked (wgmma)")
        torch.cuda.synchronize()
        nt = -(-D // 64)
        nb = nt * (nt + 1) // 2
        t = stamps(gmlib, nb, 3)
        steps = -(-GRAM_ROWS // 64)
        staged = sum((1 if i == j else 2) * steps * TILE
                     for i in range(nt) for j in range(i, nt))
        whole = (t[:, 2].max() - t[:, 0].min()) / 1e3
        print(f"Gram {GRAM_ROWS}x{D} ({nb} blocks): mainloop "
              f"{span(t, 0, 1)}, epilogue {span(t, 1, 2)} us; whole "
              f"{whole:.2f} us, panels staged {staged / 1e6:.1f} MB "
              f"({staged / whole / 1e6:.2f} TB/s over the whole call)")

    order = [c for p in PAIRED if p in libs
             for c in (p, "default", "default", p)]
    times = {}
    for copy in order + ["stamps", "shallow", "no_mma2"]:
        lib = libs[copy][0]
        times.setdefault(copy, []).append(
            [device_us(lambda i=i: run2d(lib, i))
             for i in range(len(LINEARS))])
    for copy, runs in times.items():
        print(f"2-D device us a call, copy {copy!r}: " + ", ".join(
            f"{K}x{R}x{N} " + " / ".join(f"{r[i]:.1f}" for r in runs)
            for i, (K, R, N) in enumerate(LINEARS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
