#!/usr/bin/env python3
"""Device ms of the port's two decode attention kernels at the main path's
and at long-cache shapes, to hold two checkouts of the kernels against each
other on one card.

    python3 scripts/torch_decode_attention.py [--src DIR] [--reps N]
                                              [--define NAME=VALUE ...]

bf16, random values from seed 1, every row beside its plain version,
masked ``scaled_dot_product_attention`` and its bound (bytes: each live
K/V row, q and o once):

* ``decode_attention_bkgh`` at SmolLM-360M's main path: one decode step of
  ``chip_smoke.py``'s ``time_kernels`` (32 layers, B 8, 15 q heads over 5,
  hd 64, a pool of 97 rows, 80 live a slot);
* ``decode_attention_paged_bkgh`` at one decode step of the batcher's
  path (32 layers, B 8, blocks of 16): the live lengths and block table
  that ``chip_smoke.py``'s batcher snapshot takes right after the
  staggered admissions (they follow from the seeded requests alone);
* ``decode_attention_bkgh`` over ``chip_smoke.LONG_DECODE``'s caches at
  mistral-nemo-12b's widths (32 q heads over 8, hd 128), past the 50 MB
  L2: B 8 at 4096 live rows, 2 layers (268 MB of K/V), and B 1 at 32768, 1
  layer (134 MB).

Each row also gives the kernel's largest absolute difference from the
plain version on the same inputs. ``--src`` names the ``src`` directory
that ``repro_torch`` is imported from (default: this checkout's), so that
one call on one card can run parent, change, change, parent. Only
``csrc/decode_attention.cu`` is built. Each ``--define NAME=VALUE`` also
times a copy of the kernel built with that switch (``DRT_DA_CL=16``,
``DRT_DA_NO_PDL``: the design's alternatives) on the same inputs, in the
same process. Prints the build's seconds and registers, the card's
name and power limit, then one JSON line.
"""
import argparse
import contextlib
import ctypes
import json
import re
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# chip_smoke.py's batcher snapshot (CB_BATCH 8, CB_MAX_LEN 256, CB_BLOCK
# 16, the requests of cb_requests): each slot's pos + 1 and its blocks
PAGED_LENGTHS = [155, 42, 115, 150, 143, 118, 139, 67]
PAGED_FIRST_BLOCK = [128, 116, 111, 102, 90, 79, 69, 58]
PAGED_HELD = [12, 5, 9, 12, 11, 10, 11, 6]      # blocks a slot holds
PAGED_BLOCK, PAGED_NB, PAGED_P = 16, 16, 129
MAIN_PATH = ("main path", 32, 8, 15, 5, 64, 97, 80)


def paged_table(torch, dev):
    """The snapshot's table: slot b's blocks count down from its first;
    unused entries 0, the null block."""
    t = torch.zeros((len(PAGED_LENGTHS), PAGED_NB), dtype=torch.int32)
    for b, (first, n) in enumerate(zip(PAGED_FIRST_BLOCK, PAGED_HELD)):
        t[b, :n] = torch.arange(first, first - n, -1)
    return t.to(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--define", action="append", default=[])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as da
    # build the decode source alone
    for name in _build.SOURCES:
        if name != "decode_attention":
            _build.build_seconds.setdefault(name, 0.0)
    default_lib = _build.lib("decode_attention")
    built = {"default": _build.build_seconds["decode_attention"]}
    copies = []
    if args.define:
        jobs = {d: (_build.CSRC / "decode_attention.cu",
                    _build.target("decode_attention", defines=(d,)), (d,))
                for d in args.define}
        built.update(_build.compile_sources(jobs))

        @contextlib.contextmanager
        def swapped(so):
            _build._libs["decode_attention"] = so
            try:
                yield
            finally:
                _build._libs["decode_attention"] = default_lib
        copies = [(d, lambda so=ctypes.CDLL(str(out)): swapped(so))
                  for d, (_, out, _) in jobs.items()]
    text = _build.build_log("decode_attention")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
    print(f"build seconds {built}; {len(regs)} entry points, registers "
          f"{min(regs or [0])}-{max(regs or [0])}, {sum(spills)} bytes of "
          f"spill stores")
    for entry in text.split("Compiling entry function '")[1:]:
        reg = re.search(r"Used (\d+) registers", entry)
        print(f"  {CS.kernel_name(entry.split(chr(39), 1)[0])}: "
              f"{reg.group(1) if reg else '?'} registers")
    port = types.SimpleNamespace(torch=torch, da=da, ref=ref)
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = [dict(CS.decode_row(port, dev, gen, MAIN_PATH, args.reps,
                               copies), kernel="decode_attention_bkgh")]

    # paged: one decode step of the batcher's path
    nl, Bb, H, KV, hd = 32, 8, 15, 5, 64
    lp = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    tp = paged_table(torch, dev)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    qs = [rnd((Bb, KV, H // KV, hd)) for _ in range(nl)]
    arenas = [(rnd((PAGED_P, PAGED_BLOCK, KV, hd)),
               rnd((PAGED_P, PAGED_BLOCK, KV, hd))) for _ in range(nl)]

    def kernel():
        return [da.decode_attention_paged_bkgh(q, k, v, lp, tp)
                for q, (k, v) in zip(qs, arenas)]

    def plain():
        return [ref.decode_attention_paged(q.reshape(Bb, H, hd), k, v, lp,
                                           tp).reshape(q.shape)
                for q, (k, v) in zip(qs, arenas)]
    r = dict(name="batcher step", kernel="decode_attention_paged_bkgh",
             work=f"{nl} layers, B {Bb}, {H} q heads over {KV}, hd {hd}, "
                  f"blocks of {PAGED_BLOCK}, live lengths {PAGED_LENGTHS}",
             ms=CS.device_ms(torch, kernel, args.reps),
             max_abs_err=max(CS.abs_err(a, b)
                             for a, b in zip(kernel(), plain())))
    for label, ctx in copies:
        with ctx():
            r[f"ms {label}"] = CS.device_ms(torch, kernel, args.reps)
    Lc = PAGED_NB * PAGED_BLOCK
    gathered = [(k[tp.long()].reshape(Bb, Lc, KV, hd).transpose(1, 2)
                 .contiguous(),
                 v[tp.long()].reshape(Bb, Lc, KV, hd).transpose(1, 2)
                 .contiguous()) for k, v in arenas]
    pmask = (torch.arange(Lc, device=dev)[None, :] < lp[:, None]
             )[:, None, None, :]
    live = int(lp.sum())
    r["plain_ms"] = CS.device_ms(torch, plain, args.reps)
    r["library_ms"] = CS.device_ms(torch, lambda: [
        F.scaled_dot_product_attention(
            q.reshape(Bb, H, 1, hd), k, v, attn_mask=pmask,
            enable_gqa=True) for q, (k, v) in zip(qs, gathered)], args.reps)
    r["bound_ms"], r["bound_by"] = CS.bound_ms(
        nl * (2 * 2 * Bb * H * hd + 2 * 2 * live * KV * hd
              + 4 * tp.numel()), nl * 4 * H * hd * live, "bfloat16")
    rows.append(r)
    del qs, arenas, gathered
    for spec in CS.LONG_DECODE:
        torch.cuda.empty_cache()
        rows.append(dict(CS.decode_row(port, dev, gen, spec, args.reps,
                                       copies),
                         kernel="decode_attention_bkgh"))

    card = CS.card_line()
    print(card)
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
              f"SDPA {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of "
              f"it), max |kernel - plain| {r['max_abs_err']:.3e}"
              + "".join(f", {k} {v:.4f}" for k, v in r.items()
                        if k.startswith("ms ")) + f" -- {r['work']}")
    print(json.dumps({"src": str(Path(repro_torch.__file__).resolve()
                                 .parents[1]), "card": card,
                      "torch": torch.__version__, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
