"""Counted collective bytes of a launch-accounting cell by the mesh axes
they cross, on ``meta`` tensors (nothing is allocated on any device).

``launch.dryrun.account_cell`` reports a cell's collective bytes by family
(all-gather, all-reduce, ...). This script runs the same count and splits
each family's bytes by the group its wrapper was called with (``model``,
``data``, the world), so that what crosses the ``model`` axis, the one the
tensor-parallel compute moves, reads apart from the FSDP traffic over
``data``. ``--src`` counts another checkout's port (e.g. the parent's,
unpacked with ``git archive`` into a git-ignored directory) with the same
cells, for a before-and-after.

    PYTHONPATH=src python3 scripts/torch_model_axis_bytes.py \\
        --arch hymba-1.5b xlstm-350m --shape train_4k --layers 2
"""
import argparse
import inspect
import json
import os
import sys


def count_by_axes(arch: str, shape: str, overrides: dict) -> dict:
    """{family: {axes: bytes}} of one rank's step of the cell on the
    production (16, 16) mesh."""
    from repro_torch.dist import comm
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_production_mesh

    by_axes: dict = {}
    record = comm.Count.record

    def spy(self, name, shape_, dtype):
        out = record(self, name, shape_, dtype)
        group = inspect.currentframe().f_back.f_locals.get("group")
        axes = ("world",) if group is None else getattr(group, "axes",
                                                        ("?",))
        fam = by_axes.setdefault(name, {})
        key = "+".join(axes)
        fam[key] = fam.get(key, 0) + out.numel() * out.element_size()
        return out

    comm.Count.record = spy
    try:
        cell = DR.account_cell(arch, shape, make_production_mesh(),
                               overrides=overrides)
    finally:
        comm.Count.record = record
    return {"arch": arch, "shape": shape, "overrides": overrides,
            "per_op": cell["collectives"]["per_op"], "by_axes": by_axes,
            "count_s": cell["count_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src",
                    help="the port's source tree to count (its src dir)")
    ap.add_argument("--arch", nargs="+", default=["hymba-1.5b",
                                                  "xlstm-350m"])
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--override", default="",
                    help="JSON ModelConfig overrides beside n_layers")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    extra = json.loads(args.override) if args.override else {}
    for arch in args.arch:
        res = count_by_axes(arch, args.shape,
                            dict(extra, n_layers=args.layers))
        res["src"] = args.src
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
