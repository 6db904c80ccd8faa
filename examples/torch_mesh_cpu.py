"""The port's mesh on the CPU: every rank of a gloo process group
calibrates and compresses a model on a (data = world) mesh, and rank 0
serves it. Run it under torchrun, which sets WORLD_SIZE and RANK:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        examples/torch_mesh_cpu.py

On the card the CLI does the same: ``torchrun --standalone
--nproc-per-node N -m repro_torch.launch.serve ... --calib-mesh-shards N``.
"""
import json
import os

import torch

from repro_torch.dist import comm
from repro_torch.serve import api


def main() -> None:
    torch.set_num_threads(1)
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    comm.init(world, rank, "cpu")
    try:
        opts = api.ServeOptions(
            arch="llama-mini", compress="drank", ratio=0.2,
            device_compress=True, calib_mesh_shards=world, calib_samples=8,
            calib_seq=32, batch=2, max_len=32, requests=2, prompt_len=5,
            n_new=4)
        if rank == 0:
            report = api.serve(opts, device="cpu").report
            print(json.dumps({k: report[k] for k in (
                "drain_status", "generated_tokens", "world", "comm")},
                indent=1))
        else:
            api.mesh_compress(opts, device="cpu")
    finally:
        comm.shutdown()


if __name__ == "__main__":
    main()
