"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into a shared
library with a plain C interface (``extern "C"`` functions that take device
pointers, sizes and a stream, and return ``cudaGetLastError()``), and loaded
with ``ctypes``. All sources build in parallel at first use, for ``sm_90a``
(Hopper), into ``build/torch_kernels/`` at the root of the checkout; a
library is named after a hash of its sources and flags, so an unchanged
source is never rebuilt. Nothing here runs at import time: this module is
imported on machines without a CUDA toolkit, where only the plain PyTorch
versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("lowrank_matmul", "flash_attention", "decode_attention", "gram")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a source's own flags: the decode source's 50 kernel instantiations build
# in parallel (49.7 s in one thread on the card's machine, 22.4 s split),
# and so do the flash source's 30 (LSE doubled them: 40.0 s in one thread)
SOURCE_FLAGS = {"decode_attention": ("-split-compile", "0"),
                "flash_attention": ("-split-compile", "0")}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0: already built)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def flags(defines=(), name: str = "") -> tuple:
    """The nvcc flags of a build of ``csrc/<name>.cu``, with ``-D`` for
    each of ``defines``."""
    return (NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
            + tuple(f"-D{d}" for d in defines))


def target(name: str, csrc: Path = CSRC, out_dir: Path = BUILD_DIR,
           defines=()) -> Path:
    """The library ``csrc/<name>.cu`` builds into: named after a hash of
    the flags, the source and every header beside it."""
    h = hashlib.sha256(" ".join(flags(defines, name)).encode())
    for src in sorted(Path(csrc).glob("*.cuh")) + [Path(csrc) / f"{name}.cu"]:
        h.update(src.read_bytes())
    return Path(out_dir) / f"{name}-{h.hexdigest()[:16]}.so"


def compile_sources(jobs: dict) -> Dict[object, float]:
    """Compile ``jobs`` ({key: (source .cu, output .so, defines)}), one
    ``nvcc`` each, all started together; each library's compiler output
    goes beside it (``.log``). Returns {key: seconds}. Raises with the
    compiler's output if any build fails."""
    if not jobs:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for key, (src, out, defines) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags(defines, Path(src).stem), "-o", str(tmp),
               str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT,
                                       text=True), tmp, out)
    secs, failed = {}, []
    for key, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[key] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- {key} (exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def build_all() -> Dict[str, float]:
    """Compile every source that is not built yet, one ``nvcc`` each, all
    started together. Returns {name: build seconds}. Raises with the
    compiler's output if any build fails."""
    with _lock:
        todo = {n: (CSRC / f"{n}.cu", target(n), ()) for n in SOURCES
                if n not in build_seconds and not target(n).exists()}
        for n in SOURCES:
            if n not in todo:
                build_seconds.setdefault(n, 0.0)
        build_seconds.update(compile_sources(todo))
        return dict(build_seconds)


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name`` in this checkout."""
    p = target(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    so = _libs.get(name)
    if so is None:
        build_all()
        with _lock:
            so = _libs.get(name)
            if so is None:
                so = ctypes.CDLL(str(target(name)))
                _libs[name] = so
    return so


# ---------------------------------------------------------------------------
# Launch helpers shared by the wrappers
# ---------------------------------------------------------------------------
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(what: str, *tensors: torch.Tensor) -> int:
    """Validate the operands a kernel takes (one CUDA device, one dtype of
    float32/bfloat16 for the float operands, contiguous) and return the
    dtype code the C interface expects."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: kernel operands must be CUDA tensors, "
                         f"got {dev}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: operands disagree in device/dtype: "
                             f"{t.device}/{t.dtype} vs {dev}/{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operand of shape {tuple(t.shape)} is "
                             f"not contiguous")
    return _DTYPE_CODES[dtype]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
