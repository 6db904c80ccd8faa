"""The attention's tiled FlashAttention-2 backward on the card, alone: builds
``csrc/flash_attention.cu`` only and runs ``chip_smoke.flash_tiled`` (one
SmolLM-360M attention layer at B 1, S 4096, causal, bf16 and float32: the
flash kernel's LSE flag against the plain version's lse, the tiled
backward's grads against the dense plain version's, both backwards' own
peaks, and device ms of each), then ``chip_smoke.long_train`` (SmolLM-360M
at 2 layers, one train step on 1 x 4096 tokens in bf16 and float32: the
LSE launches, loss and every grad against the dense backward's, peaks and
``train_step``'s host ms, tiled and dense). About two minutes on an H100,
most of it the build.

    python3 scripts/torch_flash_tiled.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_tiled: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.log(CS.card_line())
    port = CS.Port()
    t0 = time.perf_counter()
    port.build.lib("flash_attention")
    CS.log(f"flash_attention build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    CS.flash_tiled(port, dev)
    out = CS.long_train(port, dev)
    CS.log("launches of the long-sequence step: " + ", ".join(
        f"{k} {v}" for k, v in out["launches"].items()))
    CS.log(CS.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
