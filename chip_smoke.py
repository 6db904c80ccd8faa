#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

What it does, in order, printing the seconds of each phase:

1. environment: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, and the build of every CUDA kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all in parallel);
2. the main path, compress on the card and serve, with every kernel's
   launch count set to 0 just before and read just after: SmolLM-360M at
   full width and depth from random weights (seed 0); streaming calibration
   (``CC.calibrate``, its default) on 16 synthetic samples of 256 tokens in
   4 batches, Grams through the ``gram_blocked`` kernel, folded into fp64
   on the host every 2 batches; D-Rank at 20% with the decomposition on the
   card (``device=True``, float64 ``torch.linalg``); ``save_plan`` into a
   ``pytree_v1`` artifact; ``Engine.from_compressed(verify=True)``;
   ``generate`` on 8 prompts of 64
   tokens with 32 new tokens each, which must equal the tokens of an
   ``Engine`` on the in-memory compressed params. Every kernel must have
   launched. The seconds of each ingest and of the device decomposition
   are taken inside this one run;
2a. the mesh (``mesh_phase``), with the main path's batches, Collector and
   plan as references. The card's ranks share it over gloo through pinned
   host memory (NCCL refuses two ranks on one device). World 2, spawned
   (``mesh_rank``, each rank reporting through a file under ``build/``):
   SmolLM-360M's mesh calibration on the main path's batches, the
   2560-wide ``w_down`` inputs row-sharded (a (1280, 2560) block a rank,
   asserted) and the wq tags whitened per shard and tree-reduced: every
   Gram within 1e-5 relative of the main path's, every wq factor within
   1e-6 of the single-shard QR chain after the sign fix, ``gram_blocked``
   launched on each rank; ``build_plan_and_params(device=True, mesh=)``:
   the main plan's integer ranks, and against one process on the same
   Collector σ within 1e-5 and B·C within 1e-4, the same factors on both
   ranks; ``generate`` on the mesh-compressed model; data-parallel
   training on the training path's float32 cut (2 layers, 3 steps of 4 x
   128 tokens), losses within 1e-5 relative of the single-process
   ``Trainer``, ms/step and the all-reduce's ms; expert parallelism on
   granite-moe-1b-a400m at full width and 2 layers (data 1, model 2):
   bf16 ``generate`` with the same tokens on both ranks and the drops
   counted, float32 card against CPU as in 10. Beside it, the serve CLI
   under ``torchrun --standalone --nproc-per-node 2`` with
   ``--calib-mesh-shards 2`` (8 calibration samples) must exit 0,
   drained, its report showing
   world 2 and the gloo backend. Then every ``comm`` wrapper on NCCL at
   world 1, equal to its definition;
2a'. sharded training (``sharded_phase``): world 4 = (data 2, model 2),
   spawned (``sharded_rank``), the ranks sharing the card over gloo through
   pinned host memory, each holding its block of every parameter and AdamW
   moment under the sharding rules (``train.step.shard_state``) and running
   ``make_train_step(mesh=)`` with its launch counts set to 0 just before
   and read just after: SmolLM-360M at full width on 4 layers (FSDP over
   d_model, the MLP tensor-parallel, tied vocab-parallel logits, its 15
   heads replicated), 3 steps of 4 x 128 tokens in float32 and in bf16;
   granite-moe-1b-a400m at full width on 2 layers (16 q / 8 kv heads split
   8 / 4 a rank, 32 experts 16 a rank with a backward through the
   ``all_to_all``s, vocab 49155 replicated by the fallback), 2 float32
   steps at lr 1e-4 and a capacity factor of 8 at which no assignment may
   drop. Meanwhile this process runs the same steps on one process
   (granite's with one microbatch a data shard: its aux statistic is each
   shard's, as under JAX's EP body) and counts each step on meta
   (``account_cell``). Every rank's losses and first-step grad norm must
   be within 1e-5 relative of one process's in float32 and 5e-3 in bf16,
   its state's bytes must equal ``rule_state_bytes`` exactly, and its
   flash launches must run on its local heads; ms/step, seconds per
   collective family and ``max_memory_allocated`` beside the accounting's
   peak are printed;
2b. the continuous batcher's path on the same artifact, with the counts
   set to 0 again just before it and read just after:
   ``ContinuousBatcher.from_compressed(verify=True)``, batch 8, max_len
   256, 24 seeded requests of 17-160 prompt tokens (12 of them over one
   shared 64-token prefix) and 32 new tokens each, submitted 8 at a time
   with a ``step()`` between, then ``run_until_drained``. bfloat16: the
   contiguous pool and the paged pool (``kv_block=16``) give identical
   tokens, and so does the paged pool under two NaN fault plans (one row,
   every row with bisection), draining with every block returned; a
   paged run with the elastic rank ladder must step down under the
   stagger's queue pressure and drain; float32: contiguous, paged and
   paged with prefix reuse give identical tokens. At most ⌈log2 256⌉
   prefill signatures and one decode signature per rank level in each
   run; every kernel of the path must have launched, the paged decode
   kernel included. The batcher's tokens/s and ms/step are printed;
2c. gemma3-12b at full width (d_model 3840, 16 heads over 8 KV heads of
   256, d_ff 15360, vocab 262144), depth cut to 6 layers (one whole 5 local
   : 1 global pattern), random weights from seed 5 with every linear
   replaced by seeded random factors at ``uniform_allocate``'s 20% ranks
   (1585 for wq/wo, 2457 for the MLP): ``Engine.generate`` in bf16 on one
   1200-token prompt (past the 1024-token window: the ring cache wraps) and
   one 100-token prompt, 16 new tokens each, with the counts set to 0 just
   before and read just after: the 2-D products through "split", flash
   through "wgmma" at hd 256, decode attention on the ring and the full
   layout, no "simt" launch; then every kernel call of that run (the
   first of each operand signature, its operands kept) again through every
   variant that takes it, against the plain version on the same operands;
   then the same params and prompts in float32 on the card, whose kernel
   calls are held the same way, and on the CPU, 8 new tokens: identical
   greedy tokens, prefill logits within atol 2e-3;
2d. the same batcher path through ``serve.aot.AotRegistry``, with the
   counts set to 0 just before it and read just after: every decode and
   prefill signature captured as a CUDA graph when ``warm_executables``
   runs on the empty pool, then replayed. bf16 contiguous, paged, paged
   with prefix reuse and paged elastic, float32 contiguous and paged, on
   2b's 24 requests: tokens identical to the eager runs (2b's, and an
   eager bf16 prefix run made here), the warm set the JAX registry's, no
   entry made after warm but the elastic run's late low-rung prefills,
   every decode step a replay; ms/step and tokens/s beside the eager
   runs'. Then one graph step under ``torch.profiler`` on each pool
   (printed beside the eager step of phase 7), dense against D-Rank with
   graphs (in turns, on the same requests), and the serve CLI itself:
   ``python -m repro_torch.launch.serve --aot`` on the artifact as three
   subprocesses (contiguous, paged + prefix, ``--stream``), each exiting 0,
   drained, with the tokens of an eager ``serve()`` of the same options,
   and ``load_engine``'s boot to first token with and without ``--aot``;
   then two replicas on the card with graphs (``serve(ServeOptions(
   replicas=2, aot=True, elastic=True))``, 48 requests): each replica's
   thread captures its elastic ladder's low-rung prefills late, beside the
   other replica serving; every request must finish;
3. the streaming Grams against the eager fp64 ``Collector`` on the card,
   every tag: Gram and mean |x| within 1e-4 relative, equal row counts;
4. the device decomposition against the host fp64 oracle at full width and
   2 layers (one group of every type), model in float32: identical integer ranks, σ heads within 1e-5
   relative, every group's B·C within 1e-4 relative;
5. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (the plan's ranks, the calibration's activations) and
   ragged ones, the dense configs' ranks 1585-3018 at 65, 512 and 2048
   rows, every head_dim the attention kernels take (and flash
   non-causal at 200 and 300 rows, hd 64 and 128: an encoder's), decode
   lengths within
   one 32-row chunk and across many, in bfloat16 and float32, each variant
   of ``lowrank_gemv`` (the two-launch weight stream, "mma" in bf16 and
   "fma" in float32, and the earlier "splitk"; at 1, 8 and 64 rows, with
   B and C, and x, at an odd element offset; two calls and two replays of
   a captured CUDA graph giving the same bits),
   ``lowrank_matmul_2d`` (tensor-core "wgmma", CUDA-core "simt",
   two-launch "split"), ``flash_attention`` and ``gram_blocked`` on every
   shape it takes: max-relative error within 2e-5 (float32; and the Gram
   in both dtypes) and 2e-2 (bfloat16); the paged decode kernel also bit
   for bit against the contiguous one on the gathered layout; and under
   autograd at the training path's shapes, through ``ops``: flash at (8,
   256, 15, 64) and the 2-D product over 2048 rows, from non-contiguous
   views that require grad, outputs and input grads against autograd
   through the plain versions;
6. each kernel's device time for the work it does in one prefill, one
   decode step or one calibration batch of the main path (the paged decode
   kernel: one decode step of the batcher's path, at its live lengths; the
   gemv also at 64 rows, the larger throughput batch), beside its plain
   version's time, one PyTorch library call's time and the bound the
   card's peak rates set; the kernels with variants also in their earlier
   variant (the gemv: "splitk"; the 2-D product and flash: the CUDA-core
   design);
   gemma3-12b's shapes: flash at hd 256 per gemma prefill, the 2-D
   product's variants at its ranks at 512 and 2048 rows; and the 2-D
   product's two float32 variants at the parity run's, the batcher's and
   the gemma3 path's rows;
7. decode throughput of the dense and the D-Rank model at batch 8 and 64,
   and a ``torch.profiler`` view of one D-Rank decode step of the
   ``Engine`` and of the batcher on each pool: host time, device-busy
   time, launches per step, beside the graph step of 2d;
8. the whole slice in float32 on the card (kernels) against the CPU (plain
   versions): identical greedy tokens, prefill logits within atol 2e-3;
8a. the launch accounting (``launch/op_analysis.py``,
   ``launch/dryrun.py``): a D-Rank decode step of the batcher's shape
   (batch 8, max_len 256) and one 512-row prefill (8 x 64), each counted
   once on the card and once on meta under the op counter, with identical
   FLOPs, bytes and argument bytes required; the step's own bytes at its
   peak, predicted on meta, against ``torch.cuda.max_memory_allocated``
   less ``memory_allocated`` over an uncounted run of the same step (after
   ``reset_peak_memory_stats``), held to 10% (the allocator's largest live
   blocks at its peak printed before a miss fails the run), and the whole
   peak (the arguments plus those bytes) against its prediction; model
   and counted FLOPs over the step's measured ms as shares of 989 TFLOP/s;
   the roofline's dominant term against the measured ms; then
   qwen2-vl-72b at ``prefill_32k`` and ``decode_32k`` and SmolLM-360M at
   ``train_4k``, counted on meta alone on a (1, 1) mesh: whether each fits
   80 GB and the seconds of each count. The training path (9) does the
   same for its train step, whose model-FLOPs share is
   ``launch/dryrun.model_flops``'s (6·N·D), with the attention's
   QKᵀ and PV printed apart from the counter; the mesh phase (2a) holds one
   world-2 DP step's counted collective bytes against the bytes per
   family that ``Comm.report()`` shows for it;
9. the training path, with the counts set to 0 just before and read just
   after: SmolLM-360M at full size (float32 params, bf16 compute, remat
   "block", seed 0) through ``Trainer``: 4 steps of 8 x 256 tokens in 2
   microbatches, an async checkpoint at step 2 and the final save, every
   loss finite; a second ``Trainer`` resumes from step 2 and its step-4
   loss is the continuous run's within 1e-4 relative; the step alone
   (ms/step, tokens/s, its model-FLOPs share by
   ``launch/dryrun.model_flops``, one profiled step's idle share, flash
   launches a step: twice a layer and microbatch under remat; the launch
   accounting of 8a on the step); one float32 step of a 2-layer SmolLM on the card and on the
   CPU from the same weights (loss within 1e-5, params within 1e-4
   relative); D-Rank and fwsvd 20% of the trained model on the card, and
   fwsvd at 2 layers in float32 on the host and the card (identical
   ranks, B·C within 1e-4); 4 LoRA steps on the D-Rank model (rank 8,
   alpha 32, lr 1e-4; every 2-D launch ``"wgmma"``); the perplexities on
   4 held-out batches; then ``python -m repro_torch.launch.train`` (2
   steps) and ``python -m repro_torch.launch.serve --ckpt`` on its
   checkpoint as subprocesses, whose tokens must equal an in-process
   ``serve(ServeOptions(ckpt=...))``. Flash, the 2-D product and the Gram
   must have launched.
10. the MoE path, after the earlier paths' memory is freed, with the
   counts set to 0 just before granite's calibration and read after its
   graph runs: granite-moe-1b-a400m at full width (d_model 1024, 32
   experts top-8, d_expert 512, vocab 49155, tied), depth cut to 4 of its
   24 identical MoE layers (random weights, seed 0): streaming calibration
   as in 2 with every expert's Gram (the experts' Grams from their
   400-row capacity buffers) through ``gram_blocked``; D-Rank 20% on the
   card (an expert group per expert and matrix, the expert buckets in
   chunks sized to the card's free memory); ``save_plan``; ``from_compressed(verify=True)``;
   ``generate`` equal to an in-memory ``Engine``'s tokens. Then the
   batcher on that artifact (2b's 24 requests, bf16): eager on the
   contiguous, paged and paged + prefix pools with the dropped top-k
   assignments counted (``DropCounter``); contiguous equals paged, and
   prefix reuse equals contiguous where neither dropped; then the
   contiguous and paged pools through ``AotRegistry`` (tokens equal
   eager, every decode a replay), a profiled graph step, dense against
   D-Rank with graphs. Every kernel call of the path (the first of each
   operand signature) is held to its plain version through every
   variant. Then float32 card against CPU at 4 layers (teacher-forced
   logits and greedy tokens, held up to the first routing flip, which
   is allowed only where the CPU's k-th and (k+1)-th probabilities are
   within 1e-6); streaming against eager Grams and host against device
   decomposition at 1 layer (every granite layer holds the same seven
   group types), expert tags and groups included; a float32 train step
   at 1 layer against the CPU; and qwen2-moe-a2.7b at full
   width (60 experts padded to 64, 4 shared experts, MHA 16 of 128),
   depth cut to 2 layers, seeded random factors at uniform 20%: bf16
   ``generate`` on a 200- and a 64-token prompt, every kernel call held,
   float32 card against CPU, and no assignment to a padding expert.
   Every kernel must have launched on the MoE path.
11. the recurrent families, each after the earlier paths' memory is
   freed and with the counts set to 0 just before its calibration and
   read after its batcher runs: hymba-1.5b at full width (d_model 1600, 25
   heads over 5 KV of 64 beside a Mamba-2 head, d_ff 5504, window 1024),
   depth cut to 8 of its 32 layers (global at 0, 4 and 7, the 5 others
   windowed), and xlstm-350m at full width, depth cut to 8 of its 24
   layers (d_model 1024, 7 mLSTM layers of 4 heads of 512, the sLSTM at
   layer 7 with a 1365-wide FFN), random weights from seed 0: streaming
   calibration, D-Rank
   20% on the card, ``save_plan``, ``from_compressed(verify=True)``,
   ``generate`` equal to an in-memory ``Engine``'s tokens (hymba also one
   1200-token prompt, past its window); the batcher through exact-length
   admission (one single-row prefill per request at its prompt's length)
   on 2b's 24 requests, eager from the artifact and through
   ``AotRegistry`` (tokens equal, every decode a replay, the warm set
   JAX's, one prefill graph per distinct prompt length), one NaN fault
   plan on row 1 (the quarantined slot's every state leaf zero after its
   purge, every request the clean run's tokens), a profiled graph step,
   dense against D-Rank decode steps with graphs; every launch of a
   kernel with variants counted by operand widths and the variant its
   wrapper counted (``census``: xLSTM's 1365-wide FFN takes ``splitk``
   and ``simt``/``split``), its operands 16-byte aligned; every
   kernel call held against its plain version; xLSTM's sLSTM loop's share
   of a prefill; float32 card against CPU on the D-Rank model cut to 4
   (hymba) or 8 (xlstm) layers; streaming against eager, host against
   device at 1 layer (hymba's first, global) and 2 (xlstm, with an sLSTM
   period of 2); a float32 train step at 4 layers (hymba: g, h, g, g) and
   2 (xlstm).
12. the encoder-decoder path, after the earlier paths' memory is freed,
   with the counts set to 0 just before its calibration and read after
   its last bf16 run: seamless-m4t-medium at full size (12 encoder and 12
   decoder layers, d_model 1024, 16 heads of 64, GELU d_ff 4096, vocab
   256206; random weights, seed 0), its encoder fed seeded 0.02·N(0, 1)
   frames (the audio stub): streaming calibration on 2's 16 samples, each
   with 300 frames, every encoder, decoder and cross Gram through
   ``gram_blocked`` (the cross wk/wv over the encoder's rows); D-Rank 20%
   on the card (126 groups of 16 types); ``save_plan``;
   ``from_compressed(verify=True)``; ``generate`` on 8 prompts of 64
   tokens with 200 frames each, equal to an in-memory ``Engine``'s
   tokens; dense against D-Rank ``measure_decode_throughput`` at batch 8;
   the batcher's ``ValueError`` for the model. The encoder's non-causal
   flash launches are counted apart and must be > 0, the paged kernel's
   count 0. Every kernel call of the path (non-causal flash included) is
   held to its plain version through every variant; then float32 card
   against CPU on the D-Rank model cut to 2 + 2 layers (teacher-forced
   logits within atol 2e-3, 8 greedy tokens identical, its kernel calls
   held too); streaming against eager Grams and host against device
   decomposition at 1 + 1 layers, every tag and group type; a float32
   train step at 1 + 1 layers against the CPU;
13. the M-RoPE path: qwen2-vl-72b at full width (d_model 8192, 64 heads
   over 8 KV heads of 128, SwiGLU d_ff 29568, vocab 152064, M-RoPE
   sections (16, 24, 24), qkv bias), depth cut to 2 of its 80 layers,
   random weights from seed 7 with the qkv biases set to seeded
   0.02·N(0, 1) values and every linear replaced by seeded random factors
   at uniform 20% (ranks 3276, 728 and 5131; each bias kept), with the
   counts set to 0 just before its bf16 runs and read just after: a
   vision-stub prefill of one row (8 text tokens, 16 x 16 seeded patch
   embeddings at one t with h and w along the grid, 64 text tokens: 328
   explicit (3, 1, 328) positions) and 16 decode steps; ``generate`` on a
   200-token prompt; the batcher on 2b's 24 requests, contiguous and paged
   eager (identical tokens) and contiguous through ``AotRegistry`` (tokens
   equal, the warm set JAX's, every decode a replay); prefix reuse
   refused. gemv, the 2-D product (``split`` > 0, no bf16 ``simt``),
   flash, decode and paged decode must have launched, every gemv the
   two-launch kernel; every kernel call held to its plain version; then
   the vision-stub row in float32 on the card against the CPU (logits
   within atol 2e-3, 8 greedy tokens identical).

The build phase logs the registers and spills of the tensor-core, gemv
and chunked entry points and the clusters the card holds at once, and
holds the gemv's Python launch geometry (``gemv_plan``) against the
compiled one; the main path, the batcher's path and the gemma3 path assert
that their bf16 calibration and prefills ran the tensor-core variants and
that every gemv took the two-launch kernel, never "splitk" (per-variant
launch counts, ``launches_by_variant``). The line before the last is one
JSON object ``{"kernels": [...]}`` (the kernels with variants also carry
the variant the main path ran and the earlier variant's time, ``simt_ms``
or, for the gemv, ``splitk_ms`` and its 64-row times, ``rows_64``; the 2-D
product also its two-launch variant's, ``split_ms``; every kernel its
launches on the training path, ``train_launches``, and on the MoE path,
``moe_launches``, and on the recurrent paths, ``hymba_launches`` and
``xlstm_launches``, and on the encoder-decoder and M-RoPE paths,
``seamless_launches`` and ``qwen2vl_launches``, and by rank on the mesh
paths, ``mesh_launches``); the last
is ``{"ok": true, "device": {...}}``. Any failure raises, so the script
exits non-zero and prints no result; so it does with no CUDA device, or
without the repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import contextlib
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py:15
GRAM_TOL = 2e-5          # fp32 sums of exactly widened inputs, both dtypes
LOGITS_ATOL = 2e-3                            # tests/test_kernels.py:141
CALIB_RTOL = 1e-4                          # tests/test_calib_capture.py:26
SIG_TOL, FACTOR_TOL = 1e-5, 1e-4       # tests/test_compress_device.py:35-36

ARCH = "smollm-360m"
CALIB_SAMPLES, CALIB_SEQ, CALIB_BATCH = 16, 256, 4
FLUSH_EVERY = 2                  # the fp64 host fold runs mid-stream
# depth of the host-vs-device phase: 2 layers hold one group of every
# type. The float32 train step, the fwsvd oracle and DP training keep 4:
# a float32 step's error grows with depth
ORACLE_LAYERS = 2
TRAIN_PARITY_LAYERS = 4
ARTIFACT_DIR = ROOT / "build" / "chip_smoke_artifact"
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 64, 32
PARITY_BATCH, PARITY_PROMPT, PARITY_STEPS = 4, 32, 16
# the batcher's path: 24 requests of 17-160 prompt tokens, half of them
# over one shared 64-token prefix (4 blocks of 16), submitted 8 at a time
CB_BATCH, CB_MAX_LEN, CB_BLOCK = 8, 256, 16
CB_REQUESTS, CB_NEW, CB_STAGGER, CB_PREFIX = 24, 32, 8, 64
CB_CHAOS = (dict(nan_decode_step=3, nan_rows=(1,)),
            dict(nan_decode_step=5, nan_rows="all"))
# gemma3-12b at full width, cut to one 5 local : 1 global pattern; one
# prompt past the 1024-token window, one short
GEMMA, GEMMA_LAYERS, GEMMA_SEED, GEMMA_RATIO = "gemma3-12b", 6, 5, 0.2
GEMMA_PROMPTS, GEMMA_NEW, GEMMA_NEW_F32 = (1200, 100), 16, 8
# the 2-D product at the dense configs' uniform-20% ranks (K, R, N):
# qwen3-4b's MLP, gemma3-12b's MLP, mistral-nemo-12b's w_up, gemma3's wq
LARGE_RANKS = ((2560, 1621, 9728), (3840, 2457, 15360), (5120, 3018, 14336),
               (3840, 1585, 4096))

KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "lowrank_gemv": ("src/repro_torch/csrc/lowrank_matmul.cu",
                     "src/repro/kernels/lowrank_matmul.py:73"),
    "lowrank_matmul_2d": ("src/repro_torch/csrc/lowrank_matmul.cu",
                          "src/repro/kernels/lowrank_matmul.py:115"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:74"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:94"),
    "gram_blocked": ("src/repro_torch/csrc/gram.cu",
                     "src/repro/kernels/gram.py:38"),
    "decode_attention_paged": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:192"),
}
# kernels with a tensor-core ("wgmma") and a CUDA-core ("simt") variant; the
# main path's bf16 work must take the first
TC_KERNELS = ("lowrank_matmul_2d", "gram_blocked", "flash_attention")
# kernels the batcher's path runs (it calibrates nothing)
CB_KERNELS = ("lowrank_gemv", "lowrank_matmul_2d", "flash_attention",
              "decode_attention", "decode_attention_paged")
# the gemv variant every decode step must take, by dtype ("splitk", the
# earlier design, only where this script forces it)
GEMV_VARIANT = {"bfloat16": "mma", "float32": "fma"}
GEMV_ROWS_WIDE = 64             # the larger throughput batch: gemv rows
# the training path: SmolLM-360M at full size, 4 steps of 8 x 256 tokens in
# 2 microbatches (cut from 6 to make room for the sharded phase), an async
# checkpoint at step 2; the float32 card-vs-CPU
# step at TRAIN_PARITY_LAYERS layers on 2 x 128 tokens; held-out and LoRA batches
# from loader steps far past the training ones
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_LR = 8, 256, 2, 4, 1e-3
PARITY_TRAIN_ROWS, PARITY_TRAIN_SEQ = 2, 128
PPL_STEP0, LORA_STEP0, LORA_STEPS = 1000, 2000, 4
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
CLI_TRAIN_DIR = ROOT / "build" / "chip_smoke_cli_train"
# kernels the training path runs: flash in every step, the 2-D product in
# perplexity and LoRA on the compressed models, the Gram in calibration
TRAIN_KERNELS = ("flash_attention", "lowrank_matmul_2d", "gram_blocked")
# the MoE path: granite-moe-1b-a400m at MOE_LAYERS (calibration, D-Rank
# 20% on the card, artifact, generate, the batcher eager and with graphs);
# the float32 card-vs-CPU check at 4 layers; host-vs-device,
# streaming-vs-eager and the train step at 1; qwen2-moe-a2.7b at full
# width, 2 of its 24 layers, random factors at uniform 20%. A routing flip
# between card and CPU is allowed where the CPU's k-th and (k+1)-th
# probabilities are within ROUTE_GAP
MOE, MOE_SEED, MOE_RATIO = "granite-moe-1b-a400m", 0, 0.2
# granite's depth on the MoE path, cut from 24 to make room for the later
# paths in the run's time (the 24 layers are identical MoE layers)
MOE_LAYERS = 4
# the oracles at 1 layer: every granite layer holds the same seven group
# types
MOE_PARITY_LAYERS, MOE_ORACLE_LAYERS, ROUTE_GAP = 4, 1, 1e-6
MOE_TRAIN_LAYERS = 2            # the MoE float32 train step
MOE_ARTIFACT_DIR = ROOT / "build" / "chip_smoke_moe_artifact"
QWEN_MOE, QWEN_LAYERS, QWEN_SEED = "qwen2-moe-a2.7b", 2, 6
# the mesh phase (ROADMAP Queue 1, item 11): two ranks share the one card
# over gloo through pinned host memory (NCCL refuses two ranks on one
# device; it runs here at world 1 only). SmolLM's mesh calibration on the
# main path's batches with w_down's 2560-wide input row-sharded and the wq
# tags whitened per shard, held to tests/mesh_parity_main.py's bars
# (checks [1] and [2]); data-parallel training on the training path's
# float32 cut; expert parallelism on granite at full width, EP_LAYERS
# layers; the serve CLI under torchrun with --calib-mesh-shards 2
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
MESH_WORLD, MESH_SHARD_ABOVE = 2, 2048
MESH_FACTOR_REL, MESH_GRAM_REL = 1e-6, 1e-5
DP_ROWS, DP_SEQ, DP_STEPS = 4, 128, 3
EP_LAYERS, EP_BATCH, EP_PROMPT, EP_NEW, EP_PARITY_STEPS = 2, 4, 32, 8, 4
# sharded training (ROADMAP Queue 1, item 11, second part): world 4 =
# (data 2, model 2) on the one card over gloo through pinned host memory,
# each rank holding its block of every parameter and AdamW moment;
# SmolLM-360M at full width on TRAIN_PARITY_LAYERS layers, DP_STEPS steps
# of DP_ROWS x DP_SEQ tokens in float32 and in its configured bf16;
# granite at full width on SH_MOE_LAYERS layers, SH_MOE_STEPS float32
# steps at a capacity factor at which no assignment drops (under EP the
# drops differ across model ranks by JAX's design). Losses against one
# process on the same global batches: 1e-5 relative in float32 (the DP
# bar), 5e-3 in bf16 (tests/test_dist.py's)
SH_MESH = (2, 2)
SH_MOE_LAYERS, SH_MOE_STEPS, SH_MOE_CAPACITY = 2, 2, 8.0
# granite's learning rate: Adam's first step moves an entry by ~lr whatever
# the size of its grad, so the sharded step's last-bit differences in
# reduction order (first-step grads within 1.8e-6 of each leaf's largest
# entry on the card) reach the second step's loss at ~lr·1e-2; at 1e-3
# that was 1.945e-05 (tests/test_torch_train.py takes 1e-4 for the same
# reason)
SH_MOE_LR = 1e-4
SH_LOSS_REL = {"float32": 1e-5, "bfloat16": 5e-3}
SH_DIR = ROOT / "build" / "chip_smoke_sharded"
# the launch accounting's full-size cells, counted on meta on a (1, 1) mesh
ACCOUNT_CELLS = (("qwen2-vl-72b", "prefill_32k"),
                 ("qwen2-vl-72b", "decode_32k"), (ARCH, "train_4k"))
MESH_CLI = ["--arch", ARCH, "--compress", "drank", "--ratio", "0.2",
            "--device-compress", "--calib-mesh-shards", str(MESH_WORLD),
            "--calib-samples", "8",
            "--batch", "4", "--max-len", "64", "--requests", "4",
            "--prompt-len", "16", "--n-new", "8"]
QWEN_PROMPTS, QWEN_NEW, QWEN_NEW_F32 = (200, 64), 16, 8
# the recurrent families (random weights, seed 0; at REC_DEPTH): hymba-1.5b
# (attention and Mamba-2 heads in parallel) and xlstm-350m (mLSTM and
# sLSTM) through the main path's steps and the batcher's exact-length
# admission, eager and with graphs; hymba also one prompt past its window.
# Cut in depth only for the CPU and the host oracle: the float32 card
# against CPU at REC_PARITY_LAYERS of the D-Rank model; streaming against
# eager and host against device at REC_ORACLE_CUT (hymba's one global
# layer: its host fp64 oracle took 43.9 s at 2 layers; xLSTM's 2 layers
# with an sLSTM period of 2, so that they hold one); a train step at
# REC_TRAIN_CUT (hymba's 4 layers g, h, g, g: its schedule puts a global
# layer first, in the middle and last, so fewer than 4 hold no windowed
# layer)
HYMBA, XLSTM = "hymba-1.5b", "xlstm-350m"
REC_SEED, REC_RATIO, REC_PARITY_STEPS = 0, 0.2, 8
# the depths, cut to make room for the later paths in the run's time:
# hymba's from 32 (its schedule keeps a global layer first, in the middle
# (4) and last), xLSTM's from 24 (its sLSTM layer 7 stays)
REC_DEPTH = {HYMBA: dict(n_layers=8), XLSTM: dict(n_layers=8)}
REC_LONG, REC_LONG_NEW = 1200, 16
REC_PARITY_LAYERS = {HYMBA: 4, XLSTM: 8}
REC_ORACLE_CUT = {HYMBA: dict(n_layers=1),
                  XLSTM: dict(n_layers=2, mlstm_every_slstm=2)}
REC_TRAIN_CUT = {HYMBA: dict(n_layers=4), XLSTM: REC_ORACLE_CUT[XLSTM]}
REC_ARTIFACT_DIR = ROOT / "build" / "chip_smoke_recurrent_artifact"
# encoder-decoder: seamless-m4t-medium at full size (random weights, seed
# 0; its encoder fed seeded frames, the audio stub): calibration frames a
# sample, generate frames a prompt; float32 card vs CPU at ENC_PARITY_CUT,
# oracles and a train step at ENC_ORACLE_CUT (126 D-Rank groups at full
# size, every type at 1 + 1 layers)
SEAMLESS, ENC_SEED, ENC_RATIO = "seamless-m4t-medium", 0, 0.2
ENC_CALIB_FRAMES, ENC_GEN_FRAMES, ENC_GROUPS = 300, 200, 126
ENC_TYPES = {"q", "k", "v", "o", "cq", "ck", "cv", "co", "up", "down",
             "eq", "ek", "ev", "eo", "eup", "edown"}
ENC_PARITY_CUT = dict(n_layers=2, n_encoder_layers=2)
ENC_ORACLE_CUT = dict(n_layers=1, n_encoder_layers=1)
ENC_PARITY_STEPS = 8
ENC_ARTIFACT_DIR = ROOT / "build" / "chip_smoke_encdec_artifact"
ENC_KERNELS = ("lowrank_gemv", "lowrank_matmul_2d", "flash_attention",
               "decode_attention", "gram_blocked")
# M-RoPE: qwen2-vl-72b at full width, depth 80 -> VL_LAYERS, seeded random
# factors at uniform 20%, qkv biases seeded; a vision-stub row of VL_TEXT[0]
# text tokens, a VL_GRID of patches at one t, then VL_TEXT[1] text tokens
QWEN_VL, VL_LAYERS, VL_SEED, VL_RATIO = "qwen2-vl-72b", 2, 7, 0.2
VL_TEXT, VL_GRID, VL_NEW, VL_NEW_F32, VL_PROMPT = (8, 64), (16, 16), 16, 8, 200
# its dense size at VL_LAYERS layers and uniform_allocate's 20% ranks:
# floor(0.8·8192·8192/16384) for wq/wo, with K 8192 and N 1024 for wk/wv,
# with 8192 and 29568 for the MLP
VL_PARAMS = 4_246_794_240
VL_RANKS = {"q": {3276}, "o": {3276}, "k": {728}, "v": {728},
            "gate": {5131}, "up": {5131}, "down": {5131}}
VL_KERNELS = ("lowrank_gemv", "lowrank_matmul_2d", "flash_attention",
              "decode_attention", "decode_attention_paged")
# the kernels each family's path must launch (xLSTM has no attention)
REC_KERNELS = {HYMBA: ("lowrank_gemv", "lowrank_matmul_2d",
                       "flash_attention", "decode_attention",
                       "gram_blocked"),
               XLSTM: ("lowrank_gemv", "lowrank_matmul_2d", "gram_blocked")}
# the host calls that put work on the device: kernel launches, and a CUDA
# graph's launch (one a replay)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def log(msg: str = "") -> None:
    print(msg, flush=True)


class Phase:
    """Prints a phase's name and, when it ends without error, its
    seconds. Exceptions pass through: a failed phase fails the run."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            log(f"-- {self.name}: {time.perf_counter() - self.t0:.1f} s")
        return False


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Helpers over the port
# ---------------------------------------------------------------------------
class Port:
    """The port's modules, imported once ``src`` is on the path."""

    def __init__(self):
        import torch

        from repro_torch.configs import get_config
        from repro_torch.core import capture, compress
        from repro_torch.data import synthetic
        from repro_torch.dist import faultinject
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import gram as gm
        from repro_torch.kernels import lowrank_matmul as lm
        from repro_torch.ckpt import store
        from repro_torch import pytree
        from repro_torch.launch import dryrun, op_analysis
        from repro_torch.launch import serve as launch
        from repro_torch.models import mlp, ssm, transformer
        from repro_torch.optim import adamw
        from repro_torch.serve import admission, aot, api, engine
        from repro_torch.train import lora, loop
        from repro_torch.train import step as TS
        self.torch = torch
        self.pytree, self.adamw, self.TS, self.loop, self.lora = (
            pytree, adamw, TS, loop, lora)
        self.store, self.launch, self.aot, self.api = store, launch, aot, api
        self.dryrun, self.OA = dryrun, op_analysis
        self.card = dryrun.H100_SXM
        self.get_config = get_config
        self.capture, self.compress = capture, compress
        self.synthetic = synthetic
        self.build, self.ops, self.ref = _build, ops, ref
        self.T, self.engine, self.mlp, self.ssm = (transformer, engine,
                                                   mlp, ssm)
        self.faultinject, self.admission = faultinject, admission
        self.lm, self.gm, self.fa, self.da = lm, gm, fa, da
        self.wrappers = {"lowrank_gemv": lm.lowrank_gemv,
                         "lowrank_matmul_2d": lm.lowrank_matmul_2d,
                         "flash_attention": fa.flash_attention_bshd,
                         "decode_attention": da.decode_attention_bkgh,
                         "gram_blocked": gm.gram_blocked,
                         "decode_attention_paged":
                             da.decode_attention_paged_bkgh}

    def reset_counts(self) -> None:
        for w in self.wrappers.values():
            w.launches = 0
            for v in getattr(w, "launches_by_variant", {}):
                w.launches_by_variant[v] = 0

    def counts(self):
        return {n: w.launches for n, w in self.wrappers.items()}

    def variant_counts(self):
        """{kernel: {variant: launches}} for the kernels with variants."""
        return {n: dict(w.launches_by_variant)
                for n, w in self.wrappers.items()
                if hasattr(w, "launches_by_variant")}


def linears(params):
    """Every factorized linear {B, C} of a list-form params tree, in model
    order: the decoder's, then an encoder-decoder model's encoder's."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            if "B" in node and "C" in node:
                out.append(node)
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(params["decoder"])
    walk(params.get("encoder", {}))
    return out


def assert_gemv(counts: dict, dname: str, where: str) -> None:
    """Every gemv launch in ``counts`` ({variant: launches}) took the
    two-launch kernel of ``dname``, and at least one did."""
    want = GEMV_VARIANT[dname]
    other = {v: n for v, n in counts.items() if v != want and n}
    assert counts[want] > 0 and not other, \
        f"a {dname} gemv on {where} left the {want} kernel: {counts}"


def rel_err(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


def abs_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def device_ms(torch, fn, reps: int = 3) -> float:
    """Device time of ``fn`` in ms, median of ``reps`` runs. A sleep kernel
    holds the stream while the host enqueues ``fn``'s launches, so the
    events time the device's work and not the host's launch rate."""
    fn()                                               # warm up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)                 # ~0.1 s of cycles
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


@contextlib.contextmanager
def timed(torch, owner, name: str, sink: list):
    """Within the block, each call of ``owner.name`` appends its seconds,
    its device work included, to ``sink``."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(owner, name, wrapper)
    try:
        yield sink
    finally:
        setattr(owner, name, fn)


def bound_ms(nbytes: float, ops: float, dtype: str):
    """The card's least time for ``nbytes`` moved and ``ops`` done, by the
    data-sheet rates of ``launch/dryrun.py`` (``H100_SXM``)."""
    from repro_torch.launch.dryrun import H100_SXM
    t_bytes = nbytes / H100_SXM.hbm_bytes_per_s * 1e3
    t_ops = ops / H100_SXM.peak_ops_per_s[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def kernel_name(mangled: str) -> str:
    """A kernel's name and its template arguments' mangled text, from its
    mangled symbol (each name is preceded by its length; the last such name
    ending in ``_kernel``, after any namespace built from the source's
    path)."""
    found = mangled
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):     # a hash's digits may precede it
            name = mangled[m.end():m.end() + int(m.group()[k:])]
            if name.endswith("_kernel"):
                args = re.match(r"I(\w*?)EE", mangled[m.end() + len(name):])
                found = name + (f"<{args.group(1)}>" if args else "")
                break
    return found


def build_kernels(port) -> None:
    t0 = time.perf_counter()
    secs = port.build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{n} {s:.1f} s' for n, s in secs.items())})")
    for name in port.build.SOURCES:
        text = port.build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"  {name}: {len(regs)} entry points, max {max(regs or [0])} "
            f"registers, {sum(spills)} bytes of spill stores")
        serialized = re.findall(r"C75\d\d[^\n]*", text)
        if serialized:
            log(f"    ptxas: {len(serialized)} wgmma serialization warnings, "
                f"first: {serialized[0][:160]}")
        for entry in text.split("Compiling entry function '")[1:]:
            fn = kernel_name(entry.split("'", 1)[0])
            if not re.search(r"(wgmma|partial|gemv_stream)_kernel", fn):
                continue
            reg = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            log(f"    {fn}: {reg.group(1) if reg else '?'} registers, "
                f"{spill.group(1) if spill else '?'} bytes of spill stores")
    # the wrappers' pure mirrors of the shared-memory bounds against the
    # compiled formulas, and the clusters the card holds at once
    lm = port.lm
    c_simt = lm._fn("drt_lowrank_2d_max_rank")()
    c_wg = lm._fn("drt_lowrank_2d_wgmma_max_rank")()
    log(f"  lowrank_matmul_2d rank bounds: simt {c_simt}, wgmma {c_wg} "
        f"(Python mirrors {lm.simt_max_rank()}, {lm.wgmma_max_rank()})")
    assert (c_simt, c_wg) == (lm.simt_max_rank(), lm.wgmma_max_rank()), \
        "the Python mirror of a rank bound disagrees with the CUDA source"
    for R in (704, c_wg):
        occ = {cl: lm._fn("drt_lowrank_2d_wgmma_clusters")(R, cl)
               for cl in (8, 16)}
        log(f"  lowrank_matmul_2d wgmma at rank {R}: clusters the card holds "
            f"at once {occ} (cluster size: count; the kernel's is 8)")
    # the gemv's launch geometry: the Python mirror against the compiled
    # plan, at the main path's, the gemma3 path's and ragged shapes, for
    # this card's SMs and shared memory (asked of the driver)
    import ctypes
    card = lm.card(port.torch.device("cuda"))
    props = port.torch.cuda.get_device_properties(0)
    assert card[0] == props.multi_processor_count, (card, props)
    got = (ctypes.c_int * 11)()
    shapes = [(M, K, R, N) for M in (1, 8, 17, 33, 64) for K, R, N in (
        (960, 698, 2560), (2560, 600, 960), (960, 120, 320), (100, 13, 77),
        (3840, 2457, 15360), (15360, 2457, 3840), (3840, 1585, 4096))]
    for (M, K, R, N), dt in ((s, d) for s in shapes
                             for d in ("bfloat16", "float32")):
        p = lm.gemv_plan(M, K, R, N, getattr(port.torch, dt), card)
        lm._fn("drt_lowrank_gemv_plan")(
            M, K, R, N, *(lt["blocks"] for lt in p["launches"]),
            int(dt == "bfloat16"), ctypes.cast(got, ctypes.c_void_p))
        want = [p["rows_tile"], p["stages"], p["t_stride"]] + [
            lt[k] for lt in p["launches"]
            for k in ("strips", "cluster", "chunks_per_block", "smem")]
        assert list(got) == want, \
            f"gemv_plan disagrees with the CUDA source at {(M, K, R, N)} " \
            f"{dt}: {list(got)} against {want}"
    p = lm.gemv_plan(GEN_BATCH, 960, 698, 2560, port.torch.bfloat16, card)
    log(f"  lowrank_gemv plan: {len(shapes) * 2} shapes agree with the "
        f"compiled one on a card of {card[0]} SMs, {card[1]} bytes of "
        f"shared memory an SM; at (8, 960, 698, 2560) bf16 (blocks aimed "
        f"at, strips, cluster, chunks a block, smem) " + ", ".join(
            f"{lt['blocks']}, {lt['strips']}, {lt['cluster']}, "
            f"{lt['chunks_per_block']}, {lt['smem']}" for lt in p["launches"]))
    chunk = port.build.lib("decode_attention").drt_decode_chunk()
    log(f"  decode attention: {chunk} rows a block (Python mirror "
        f"{port.da.CHUNK})")
    assert chunk == port.da.CHUNK, \
        "the Python mirror of the decode chunk disagrees with the CUDA source"


def stub_embeds(shape, seed: int) -> np.ndarray:
    """Seeded 0.02·N(0, 1) float32 frontend embeddings: the audio stub's
    encoder frames, the vision stub's patches (``tests/conftest.py``)."""
    return (0.02 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def calib_batches(port, cfg, dev, enc_frames: int = 0):
    """The synthetic calibration batches; with ``enc_frames``, each also
    carries seeded ``enc_embeds`` of that many frames a sample."""
    dcfg = port.synthetic.DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=CALIB_SEQ,
                                     global_batch=CALIB_BATCH)
    out = [{"tokens": port.torch.as_tensor(b["tokens"], device=dev)}
           for b in port.synthetic.calibration_batches(
               dcfg, CALIB_SAMPLES, CALIB_BATCH)]
    for i, b in enumerate(out if enc_frames else ()):
        b["enc_embeds"] = port.torch.as_tensor(stub_embeds(
            (CALIB_BATCH, enc_frames, cfg.d_model), 100 + i), device=dev)
    return out


def main_path(port, dev):
    """Calibrate (streaming), compress on the card, save, boot from the
    artifact and serve SmolLM-360M. Returns (cfg, dense params, compressed
    params, plan, launch counts, streaming collector, calibration
    batches)."""
    torch, T, CC, E = port.torch, port.T, port.compress, port.engine
    Cap = port.capture
    cfg = port.get_config(ARCH)
    secs, ingest, dec = {}, [], []
    port.reset_counts()
    t0 = time.perf_counter()
    params, _ = T.init_model(cfg, seed=0, device=dev)
    log(f"init_model: {T.param_count(params) / 1e6:.1f} M params, "
        f"{time.perf_counter() - t0:.1f} s")

    calib = calib_batches(port, cfg, dev)
    t0 = time.perf_counter()
    with timed(torch, Cap.StreamingCalibrator, "ingest", ingest):
        col = CC.calibrate(Cap.to_list_params(params, cfg), cfg, calib,
                           flush_every=FLUSH_EVERY)
    torch.cuda.synchronize()
    secs["calibration"] = time.perf_counter() - t0
    log(f"streaming calibration: {len(col.gram)} Grams from {len(calib)} "
        f"batches of {CALIB_BATCH} x {CALIB_SEQ} tokens, fp64 host fold "
        f"every {FLUSH_EVERY} batches, {secs['calibration']:.2f} s (ingest "
        f"per batch " + ", ".join(f"{t:.3f}" for t in ingest) + " s)")

    t0 = time.perf_counter()
    with timed(torch, CC, "_decompose_groups_device", dec):
        comp, plan = CC.build_plan_and_params(
            params, cfg, CC.CompressionConfig(method="drank", ratio=0.2),
            calib, collector=col, device=True)
    torch.cuda.synchronize()
    secs["build_plan_and_params"] = time.perf_counter() - t0
    ks = [g.k for g in plan.groups]
    log(f"D-Rank: achieved ratio {plan.summary['achieved_ratio']:.4f} over "
        f"{len(ks)} groups, ranks {min(ks)}..{max(ks)}, "
        f"{secs['build_plan_and_params']:.2f} s: device decomposition "
        f"{sum(dec):.2f} s, rank allocation and factor assembly "
        f"{secs['build_plan_and_params'] - sum(dec):.2f} s")

    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = CC.save_plan(str(ARTIFACT_DIR), comp, plan, cfg)
    secs["save"] = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    scfg = E.ServeConfig(batch=GEN_BATCH, max_len=GEN_PROMPT + GEN_NEW + 1)
    t0 = time.perf_counter()
    booted = E.Engine.from_compressed(str(ARTIFACT_DIR), cfg, scfg,
                                      verify=True)
    torch.cuda.synchronize()
    secs["boot"] = time.perf_counter() - t0
    assert booted.plan.to_json() == plan.to_json(), "plan changed on disk"
    log(f"save_plan: {nbytes / 1e6:.1f} MB, {secs['save']:.2f} s; "
        f"from_compressed(verify=True): {secs['boot']:.2f} s")

    t0 = time.perf_counter()
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)
    toks = booted.generate(prompts, GEN_NEW)
    torch.cuda.synchronize()
    secs["generate"] = time.perf_counter() - t0
    toks_mem = E.Engine(comp, cfg, scfg, device=dev).generate(prompts,
                                                              GEN_NEW)
    torch.cuda.synchronize()
    counts = port.counts()
    variants = port.variant_counts()
    log(f"generate from the artifact: {GEN_BATCH} x {GEN_PROMPT} prompt "
        f"tokens, {GEN_NEW} new each, {secs['generate']:.2f} s")
    log(f"launches on the main path: {counts}; by variant {variants}")
    for name in TC_KERNELS:     # bf16 calibration and prefills, all
        assert variants[name]["wgmma"] > 0 and variants[name]["simt"] == 0, \
            f"{name} left its tensor-core variant on the bf16 main path: " \
            f"{variants[name]}"
    assert_gemv(variants["lowrank_gemv"], "bfloat16", "the main path")
    log("compression seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    missing = [n for n, c in counts.items()
               if c <= 0 and n != "decode_attention_paged"]
    assert not missing, f"kernels not launched on the main path: {missing}"
    assert toks.shape == (GEN_BATCH, GEN_NEW), toks.shape
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of range"
    assert (toks == toks_mem).all(), \
        "the artifact's engine and the in-memory engine disagree"
    logits, _ = T.prefill(booted.params, cfg, {"tokens": torch.as_tensor(
        prompts, device=dev)}, max_len=GEN_PROMPT + 1)
    assert torch.isfinite(logits).all(), "non-finite logits"
    log(f"first tokens of row 0: {toks[0, :8].tolist()}")
    return cfg, params, comp, plan, (counts, variants), col, calib


def cb_requests(vocab: int):
    """The batcher path's workload, from seed 4: (rid, prompt) pairs of
    17-160 tokens; the even rids start with one shared 64-token prefix."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, vocab, CB_PREFIX, dtype=np.int32)
    reqs = []
    for rid in range(CB_REQUESTS):
        if rid % 2 == 0:
            tail = rng.integers(0, vocab, int(rng.integers(1, 97)),
                                dtype=np.int32)
            reqs.append((rid, np.concatenate([prefix, tail])))
        else:
            reqs.append((rid, rng.integers(0, vocab,
                                           int(rng.integers(17, 161)),
                                           dtype=np.int32)))
    return reqs


def drive_batcher(port, cb, reqs, snapshot=None):
    """Submit ``reqs`` CB_STAGGER at a time with a ``step()`` between, then
    ``run_until_drained``. Returns (result, seconds, steps of this drive);
    the host clock runs from a synchronize before the first submit to one
    after the drain. ``snapshot`` (a dict) receives each slot's live length
    (pos + 1) and the block table right after the staggered steps."""
    torch, E = port.torch, port.engine
    steps0 = cb._step_idx
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (rid, toks) in enumerate(reqs):
        cb.submit(E.Request(rid=rid, tokens=toks.copy(), n_new=CB_NEW))
        if i % CB_STAGGER == CB_STAGGER - 1:
            cb.step()
    if snapshot is not None:
        snapshot["lengths"] = (cb.cache["pos"] + 1).clamp_min(0).to(
            torch.int32).clone()
        snapshot["table"] = torch.as_tensor(cb.table.copy(),
                                            device=cb.device)
    res = cb.run_until_drained(watchdog_s=120.0)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, cb._step_idx - steps0


def batcher_path(port, dev, cfg, comp):
    """The continuous batcher's path at full width on the main path's
    artifact, driven with every launch count set to 0 just before and read
    just after. Returns (launch counts, the paged decode step snapshot,
    {run: tokens/s, ms/step})."""
    torch, E, FI = port.torch, port.engine, port.faultinject
    cfg32 = cfg.replace(dtype="float32")
    reqs = cb_requests(cfg.vocab_size)
    contig = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN)
    paged = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN,
                          kv_block=CB_BLOCK)
    shared = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN,
                           kv_block=CB_BLOCK, prefix_cache=True)
    bound = int(np.ceil(np.log2(CB_MAX_LEN)))
    elastic_cfg = port.admission.AdmissionConfig(
        elastic=True, elastic_levels=2, degrade_above=4, restore_below=1)
    snap, rates, outs, bf16_variants = {}, {}, {}, None
    port.reset_counts()
    t0 = time.perf_counter()
    first = E.ContinuousBatcher.from_compressed(str(ARTIFACT_DIR), cfg,
                                                contig, verify=True)
    torch.cuda.synchronize()
    log(f"  ContinuousBatcher.from_compressed(verify=True): "
        f"{time.perf_counter() - t0:.2f} s")
    runs = [("bf16 contiguous", cfg, contig, None),
            ("bf16 paged", cfg, paged, None),
            ("bf16 paged, NaN one row", cfg, paged, CB_CHAOS[0]),
            ("bf16 paged, NaN all rows", cfg, paged, CB_CHAOS[1]),
            ("bf16 contiguous again", cfg, contig, None),
            ("bf16 paged, elastic", cfg, paged, None),
            ("fp32 contiguous", cfg32, contig, None),
            ("fp32 paged", cfg32, paged, None),
            ("fp32 paged + prefix", cfg32, shared, None)]
    for name, c, scfg, plan in runs:
        # the elastic run drops rank under the stagger's queue pressure,
        # so its tokens are not the full-rank ones
        elastic = name.endswith("elastic")
        if c.dtype == "float32" and bf16_variants is None:
            bf16_variants = port.variant_counts()   # the bf16 runs' launches
        cb = first if first is not None else E.ContinuousBatcher(
            comp, c, scfg, device=dev,
            faults=FI.FaultPlan(**plan) if plan else None,
            admission=elastic_cfg if elastic else None)
        first = None
        res, secs, steps = drive_batcher(
            port, cb, reqs,
            snap if name == "bf16 paged" and not snap else None)
        outs[name] = {r.rid: list(r.out) for r in res}
        ntok = sum(len(o) for o in outs[name].values())
        rates[name] = {"tokens_per_s": ntok / secs,
                       "ms_per_step": secs / steps * 1e3}
        sigs = {}
        for role, *_ in cb.exec.signatures:
            sigs[role] = sigs.get(role, 0) + 1
        m = cb.metrics()
        extra = ""
        if cb.paged:
            extra = (f", blocks peak {cb.pool.peak_in_use} of "
                     f"{cb.n_blocks - 1}, in use after {cb.pool.in_use}")
        prefix = getattr(cb, "prefix", None)
        if prefix is not None:
            extra += (f", prefix hits {m['prefix_hits']}, misses "
                      f"{m['prefix_misses']}, forks {m['cow_forks']}")
        if elastic:
            extra += f", steps per rank level {m['rank_residency']}"
        log(f"  {name}: {res.status}, {len(res)} done, {ntok} tokens in "
            f"{steps} steps, {secs:.2f} s: {rates[name]['tokens_per_s']:.1f}"
            f" tokens/s, {rates[name]['ms_per_step']:.2f} ms/step; "
            f"signatures {sigs}; poison events {m['poison_events']}, "
            f"probes {m.get('poison_probes', 0)}{extra}")
        assert res.status == "drained" and len(res) == CB_REQUESTS, name
        assert not res.failed and not res.shed and not res.rejected, name
        assert all(len(o) == CB_NEW for o in outs[name].values()), name
        rungs = len(m["rank_residency"])
        assert cb.stats["decode_retraces"] == rungs, (name, cb.stats)
        assert cb.stats["prefill_retraces"] <= bound * rungs, \
            (name, cb.stats)
        assert sigs.get("prefill_ext", 0) <= bound, (name, sigs)
        if elastic:
            assert rungs > 1, "the elastic run never left rank level 0"
        if cb.paged:
            if prefix is None:
                assert cb.pool.in_use == 0, (name, cb.pool.in_use)
            else:
                assert cb.pool.in_use == len(prefix), name
                assert m["prefix_hits"] > 0, "the prefix cache never hit"
            assert (cb.table == 0).all() and not cb._req_blocks, name
        if plan is not None:
            assert cb.faults.fired and m["poison_events"] == 1, name
        del cb
    counts = port.counts()
    variants = port.variant_counts()
    log(f"  launches on the batcher's path: {counts}; by variant {variants}")
    missing = [n for n in CB_KERNELS if counts[n] <= 0]
    assert not missing, f"kernels not launched on the batcher path: {missing}"
    for name in ("lowrank_matmul_2d", "flash_attention"):
        fp32 = {v: n - bf16_variants[name][v]
                for v, n in variants[name].items()}
        log(f"  {name} by variant: bf16 runs {bf16_variants[name]}, float32 "
            f"runs {fp32}")
        assert (bf16_variants[name]["wgmma"] > 0
                and bf16_variants[name]["simt"] == 0), \
            f"the batcher's bf16 prefills left the tensor-core {name} kernel"
        assert fp32["wgmma"] == 0, \
            f"a float32 prefill ran the tensor-core {name} kernel"
    fp32 = {v: n - bf16_variants["lowrank_gemv"][v]
            for v, n in variants["lowrank_gemv"].items()}
    log(f"  lowrank_gemv by variant: bf16 runs "
        f"{bf16_variants['lowrank_gemv']}, float32 runs {fp32}")
    assert_gemv(bf16_variants["lowrank_gemv"], "bfloat16",
                "the batcher's bf16 runs")
    assert_gemv(fp32, "float32", "the batcher's float32 runs")

    def same(a, b):
        bad = [r for r in outs[a] if outs[a][r] != outs[b][r]]
        if bad:
            r = bad[0]
            i = next(j for j, (x, y) in enumerate(zip(outs[a][r],
                                                      outs[b][r])) if x != y)
            log(f"  {a} and {b} differ on rids {bad}; rid {r} first at "
                f"token {i}: {outs[a][r][i]} against {outs[b][r][i]}")
        return not bad
    for a, b in (("bf16 contiguous", "bf16 paged"),
                 ("bf16 contiguous", "bf16 contiguous again"),
                 ("bf16 paged", "bf16 paged, NaN one row"),
                 ("bf16 paged", "bf16 paged, NaN all rows"),
                 ("fp32 contiguous", "fp32 paged"),
                 ("fp32 contiguous", "fp32 paged + prefix")):
        assert same(a, b), f"{a} and {b} give different tokens"
    log(f"  tokens identical: bf16 contiguous = paged = paged under both "
        f"fault plans; fp32 contiguous = paged = paged + prefix")
    return counts, snap, rates, outs


# ---------------------------------------------------------------------------
# The graph path: the batcher through AotRegistry, and the serve CLI
# ---------------------------------------------------------------------------
def prefill_buckets(max_len: int) -> list:
    """The pow2 prompt buckets of a pool of ``max_len`` (2, 4, ..., and
    max_len itself), as the JAX registry enumerates them."""
    out, b = [], 2
    while b < max_len:
        out.append(b)
        b *= 2
    return sorted(set(out + [max_len]))


def warm_set_size(rungs: int, paged: bool, max_len: int) -> int:
    """Entries of the JAX AotRegistry's warm set: decode per rank rung and
    prefill per bucket at rung 0, then scatter and purge; paged: prefill
    per bucket, decode_paged per rung, prefill_ext per bucket,
    scatter_paged per source width (max_len and every bucket), purge_paged
    and copy_blocks."""
    n = len(prefill_buckets(max_len))
    if not paged:
        return rungs + n + 2
    return n + rungs + n + len(set(prefill_buckets(max_len))
                               | {max_len}) + 2


def drive_graphs(port, cb, reqs):
    """Warm ``cb``'s AotRegistry on its empty pool, then ``drive_batcher``.
    Returns (result, seconds, steps, info): the warm seconds, the stats
    after warm, and the decode dispatches and replays of the drive."""
    torch, reg = port.torch, cb.exec
    dec = "decode_paged" if cb.paged else "decode"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb.warm_executables()
    torch.cuda.synchronize()
    info = {"warm_s": time.perf_counter() - t0, "warm": dict(cb.stats)}
    calls0, rep0 = dict(reg.calls), dict(reg.replays)
    res, secs, steps = drive_batcher(port, cb, reqs)
    info["decode_calls"] = reg.calls.get(dec, 0) - calls0.get(dec, 0)
    info["decode_replays"] = reg.replays.get(dec, 0) - rep0.get(dec, 0)
    info["prefill_replays"] = sum(
        reg.replays.get(r, 0) - rep0.get(r, 0)
        for r in ("prefill", "prefill_ext"))
    return res, secs, steps, info


def graph_path(port, dev, cfg, comp, eager_outs, eager_rates):
    """The batcher's path through ``AotRegistry`` (one CUDA graph per decode
    and prefill signature) on the main path's artifact, every launch count
    set to 0 just before and read just after: bf16 contiguous, paged,
    paged + prefix and paged elastic, float32 contiguous and paged, on 2b's
    24 requests. Tokens must be the eager runs' (2b's; the bf16 prefix
    pool's eager run is made here), the warm set JAX's, no entry made
    after warm but the elastic run's late low-rung prefills, and every
    decode step a replay. Returns (launch counts, {run: rates}, the bf16
    contiguous and paged batchers, drained, for the profile and Fig. 4
    phases)."""
    torch, E, aot = port.torch, port.engine, port.aot
    fp = port.store.artifact_fingerprint(str(ARTIFACT_DIR),
                                         name=port.compress.ARTIFACT_NAME)
    cfg32 = cfg.replace(dtype="float32")
    reqs = cb_requests(cfg.vocab_size)
    contig = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN)
    paged = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN,
                          kv_block=CB_BLOCK)
    shared = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN,
                           kv_block=CB_BLOCK, prefix_cache=True)
    elastic_cfg = port.admission.AdmissionConfig(
        elastic=True, elastic_levels=2, degrade_above=4, restore_below=1)
    runs = [("bf16 contiguous", cfg, contig, "bf16 contiguous"),
            ("bf16 paged", cfg, paged, "bf16 paged"),
            ("bf16 paged + prefix", cfg, shared, None),
            ("bf16 paged, elastic", cfg, paged, "bf16 paged, elastic"),
            ("fp32 contiguous", cfg32, contig, "fp32 contiguous"),
            ("fp32 paged", cfg32, paged, "fp32 paged")]
    port.reset_counts()
    rates, kept, first = {}, {}, True
    for name, c, scfg, eager_name in runs:
        elastic = name.endswith("elastic")
        acfg = elastic_cfg if elastic else None
        if eager_name is None:     # bf16 prefix reuse: no eager run in 2b
            cbe = E.ContinuousBatcher(comp, c, scfg, device=dev,
                                      admission=acfg)
            res, secs, steps = drive_batcher(port, cbe, reqs)
            eager_name = name + " (eager)"
            eager_outs[eager_name] = {r.rid: list(r.out) for r in res}
            ntok = sum(len(o) for o in eager_outs[eager_name].values())
            eager_rates[eager_name] = {"tokens_per_s": ntok / secs,
                                       "ms_per_step": secs / steps * 1e3}
            del cbe
        reg = aot.AotRegistry(c, scfg, fp)
        if first:                  # booted from the artifact, as 2b
            cb = E.ContinuousBatcher.from_compressed(
                str(ARTIFACT_DIR), c, scfg, verify=True, device=dev,
                executables=reg)
            first = False
        else:
            cb = E.ContinuousBatcher(comp, c, scfg, device=dev,
                                     admission=acfg, executables=reg)
        res, secs, steps, info = drive_graphs(port, cb, reqs)
        out = {r.rid: list(r.out) for r in res}
        ntok = sum(len(o) for o in out.values())
        rates[name] = {"tokens_per_s": ntok / secs,
                       "ms_per_step": secs / steps * 1e3,
                       "warm_s": info["warm_s"]}
        er = eager_rates[eager_name]
        want = warm_set_size(len(cb.ladder), cb.paged, CB_MAX_LEN)
        warm_n = info["warm"]["aot_compiles"]
        late = reg.entries()[warm_n:]
        mb = sum(reg.graph_bytes().values()) / 2 ** 20
        log(f"  {name}: {res.status}, {len(res)} done, {ntok} tokens in "
            f"{steps} steps, {secs:.2f} s: {rates[name]['tokens_per_s']:.1f}"
            f" tokens/s, {rates[name]['ms_per_step']:.2f} ms/step (eager "
            f"{er['tokens_per_s']:.1f} tokens/s, {er['ms_per_step']:.2f} "
            f"ms/step); warm {info['warm_s']:.2f} s: {warm_n} entries "
            f"(JAX's warm set: {want}), {len(reg.graph_bytes())} graphs, "
            f"{mb:.0f} MB; after the drain {cb.stats['aot_compiles']} "
            f"entries, {len(late)} late {late}; decode dispatches "
            f"{info['decode_calls']}, replays {info['decode_replays']}; "
            f"prefill replays {info['prefill_replays']}")
        assert res.status == "drained" and len(res) == CB_REQUESTS, name
        assert not res.failed and not res.shed and not res.rejected, name
        assert out == eager_outs[eager_name], \
            f"{name}: the graph run's tokens differ from the eager run's"
        assert warm_n == want, (name, warm_n, want)
        if elastic:
            assert len(cb.metrics()["rank_residency"]) > 1, \
                "the elastic run never left rank level 0"
            assert all(role == "prefill" and variant[0] >= 1
                       for role, variant in late), late
        else:
            assert not late, f"{name}: entries made after warm: {late}"
        assert cb.stats["aot_fallbacks"] == 0, cb.stats
        assert info["decode_calls"] > 0 and \
            info["decode_replays"] == info["decode_calls"], \
            f"{name}: a decode step did not replay its graph: {info}"
        if name in ("bf16 contiguous", "bf16 paged"):
            kept[name.split()[-1]] = cb
        else:
            del cb, reg
            torch.cuda.empty_cache()
    counts = port.counts()
    log(f"  launches on the graph path (the entries' first calls; a replay "
        f"goes through no wrapper): {counts}")
    missing = [n for n in CB_KERNELS if counts[n] <= 0]
    assert not missing, f"kernels not launched on the graph path: {missing}"
    log("  tokens identical to the eager runs: bf16 contiguous, paged, "
        "paged + prefix, elastic; fp32 contiguous, paged")
    return counts, rates, kept


def graph_profile(port, kept, steps: int = 4):
    """One graph step under ``torch.profiler`` on each kept batcher (bf16,
    batch 8): the batch-path workload's first 8 requests are admitted, two
    steps warm up, then ``profile_window``; the rest of the requests then
    drain, so the pool is empty again. Returns {pool: window}."""
    E = port.engine
    out = {}
    for name, cb in kept.items():
        cb.done.clear()            # the drained list of the earlier drive
        for rid, toks in cb_requests(cb.cfg.vocab_size)[:CB_BATCH]:
            cb.submit(E.Request(rid=rid, tokens=toks.copy(), n_new=CB_NEW))
        cb.step()
        cb.step()
        w = profile_window(port, cb, steps)
        log_window(f"{name}, graphs", w, steps)
        log(f"    the port's kernels a replay runs: " + ", ".join(
            f"{k} {v:.0f}" for k, v in sorted(w["ours"].items())))
        assert w["graph_launches"] >= 1, "no graph launch in a graph step"
        out[name] = w
        res = cb.run_until_drained(watchdog_s=120.0)
        assert res.status == "drained"
        cb.done.clear()
    return out


def fig4_graphs(port, dev, cfg, params, comp, kept):
    """Dense against D-Rank decode with graphs at batch 8 on the batcher
    path's 24 requests (the paper's Fig. 4 question), bf16, contiguous
    pool, in turns (dense, D-Rank, D-Rank, dense) on one warmed batcher
    each. Returns {name: [ms/step, ...]}."""
    torch, E, aot = port.torch, port.engine, port.aot
    scfg = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN)
    dense = E.ContinuousBatcher(
        params, cfg, scfg, device=dev,
        executables=aot.AotRegistry(cfg, scfg,
                                    aot.live_fingerprint(params, cfg)))
    dense.warm_executables()
    engines = {"dense": dense, "drank-20%": kept["contiguous"]}
    reqs = cb_requests(cfg.vocab_size)
    res_ms, toks = {}, {}
    for name in ("dense", "drank-20%", "drank-20%", "dense"):
        cb = engines[name]
        cb.done.clear()
        res, secs, steps = drive_batcher(port, cb, reqs)
        assert res.status == "drained" and len(res) == CB_REQUESTS, name
        out = {r.rid: list(r.out) for r in res}
        assert toks.setdefault(name, out) == out, \
            f"{name}: two graph drains of one batcher disagree"
        res_ms.setdefault(name, []).append(secs / steps * 1e3)
        log(f"  {name:9s} graphs, batch {CB_BATCH}: {secs / steps * 1e3:.3f}"
            f" ms/step, {sum(len(o) for o in out.values()) / secs:.1f} "
            f"tokens/s")
    del dense
    torch.cuda.empty_cache()
    return res_ms


def fig4_decode(port, dev, cfg, params, kept, steps: int = 16):
    """Dense against D-Rank decode with graphs at batch 8, bf16,
    contiguous pool, in turns (dense, D-Rank, D-Rank, dense) on one warmed
    batcher each: the batcher path's first 8 requests admitted (two
    steps, each admission an exact-length prefill graph), then ``steps``
    decode steps on the host clock between syncs, then the rest drained;
    so the decode step alone is timed, not a new prompt length's capture.
    Returns {name: [ms/step, ...]}."""
    torch, E, aot = port.torch, port.engine, port.aot
    scfg = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN)
    dense = E.ContinuousBatcher(
        params, cfg, scfg, device=dev,
        executables=aot.AotRegistry(cfg, scfg,
                                    aot.live_fingerprint(params, cfg)))
    dense.warm_executables()
    engines = {"dense": dense, "drank-20%": kept["contiguous"]}
    reqs = cb_requests(cfg.vocab_size)[:CB_BATCH]
    res_ms, toks = {}, {}
    for name in ("dense", "drank-20%", "drank-20%", "dense"):
        cb = engines[name]
        cb.done.clear()
        for rid, t in reqs:
            cb.submit(E.Request(rid=rid, tokens=t.copy(), n_new=CB_NEW))
        cb.step()
        cb.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            cb.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        res = cb.run_until_drained(watchdog_s=120.0)
        assert res.status == "drained" and len(res) == CB_BATCH, name
        out = {r.rid: list(r.out) for r in res}
        assert toks.setdefault(name, out) == out, \
            f"{name}: two graph runs of one batcher disagree"
        res_ms.setdefault(name, []).append(ms)
        log(f"  {name:9s} graphs, batch {CB_BATCH}, {steps} decode steps: "
            f"{ms:.3f} ms/step")
    cb.done.clear()
    del dense
    torch.cuda.empty_cache()
    return res_ms


CLI_ARGS = ["--arch", ARCH, "--verify", "--batch", str(CB_BATCH),
            "--max-len", str(CB_MAX_LEN), "--requests", "16",
            "--prompt-len", "64", "--n-new", "32"]
CLI_RUNS = {"contiguous": [], "paged + prefix": ["--kv-block",
                                                 str(CB_BLOCK),
                                                 "--prefix-cache"],
            "stream": ["--stream"]}


def cli_path(port, cfg):
    """``python -m repro_torch.launch.serve --aot`` on the artifact as
    three subprocesses (contiguous, paged + prefix, ``--stream``), started
    together; meanwhile ``serve()`` of the same options without ``--aot``
    in this process. Each CLI run must exit 0, drained, with the eager
    run's tokens (the reports' ``tokens_digest``). Then, alone, the boot
    to first token of ``load_engine`` with and without ``--aot`` and each
    graph's memory."""
    import os
    torch, api, launch = port.torch, port.api, port.launch
    base = CLI_ARGS + ["--compressed-ckpt", str(ARTIFACT_DIR)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = {}
    try:
        for name, extra in CLI_RUNS.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve", *base,
                 "--aot", *extra], cwd=str(ROOT), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        eager = {}
        for name, extra in CLI_RUNS.items():
            res = api.serve(launch.parse_serve_options(base + extra))
            assert res.status == "drained", name
            eager[name] = res.report
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, \
                f"the CLI ({name}) exited {proc.returncode}: {err[-3000:]}"
            report = json.loads(out[out.rindex("\n{\n") + 1:])
            warm = re.search(r"AOT warm in ([0-9.]+)s: (\d+) entries, "
                             r"(\d+) CUDA graphs", out)
            stats = report["engine_stats"]
            stats = stats[0] if isinstance(stats, list) else stats
            log(f"  CLI --aot {name}: exit 0, {report['drain_status']}, "
                f"{report['generated_tokens']} tokens, "
                f"{report['tokens_per_s']} tokens/s (three runs at once), "
                f"warm {warm.group(1) if warm else '?'} s, "
                f"{warm.group(2) if warm else '?'} entries, "
                f"{warm.group(3) if warm else '?'} graphs; eager serve() "
                f"{eager[name]['tokens_per_s']} tokens/s; tokens "
                f"{'equal' if report['tokens_digest'] == eager[name]['tokens_digest'] else 'DIFFER'}")
            assert report["drain_status"] == "drained", (name, report)
            assert report["generated_tokens"] == 16 * 32, report
            assert warm and stats["aot_compiles"] == int(warm.group(2)), \
                (name, stats)
            assert report["tokens_digest"] == eager[name]["tokens_digest"], \
                f"the CLI ({name}) gave other tokens than the eager serve()"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 64, dtype=np.int32)
    for aot_on in (False, True):
        opts = launch.parse_serve_options(base + (["--aot"] if aot_on
                                                  else []))
        lines = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb = api.load_engine(opts, echo=lines.append)
        torch.cuda.synchronize()
        boot = time.perf_counter() - t0
        req = port.engine.Request(rid=0, tokens=prompt.copy(), n_new=32)
        cb.submit(req)
        while not req.out:
            cb.step()
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        log(f"  load_engine {'with' if aot_on else 'without'} --aot: boot "
            f"{boot:.2f} s, boot to first token {ttft:.2f} s"
            + (f"; {lines[-1]}" if aot_on else ""))
        if aot_on:
            log("    graph memory, MB: " + ", ".join(
                f"{role}{list(variant)} {b / 2 ** 20:.0f}" for
                (role, variant), b in cb.exec.graph_bytes().items()))
        del cb
        torch.cuda.empty_cache()


def _rel64(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def eager_collector(port, cfg, params, calib):
    """The eager fp64 Collector (the oracle) on ``calib``."""
    return port.compress.calibrate(port.capture.to_list_params(params, cfg),
                                   cfg, calib, streaming=False)


def streaming_vs_eager(port, cfg, params, col, calib, eager=None):
    """The main path's streaming Grams against the eager fp64 Collector on
    the same batches (``eager``, made here if not given), every tag."""
    if eager is None:
        eager = eager_collector(port, cfg, params, calib)
    assert sorted(col.gram) == sorted(eager.gram), "tag sets differ"
    worst_g = worst_a = 0.0
    for tag, g in eager.gram.items():
        worst_g = max(worst_g, _rel64(col.gram[tag], g))
        worst_a = max(worst_a, _rel64(col.mean_abs(tag), eager.mean_abs(tag)))
        assert col.count[tag] == eager.count[tag], tag
    log(f"  {len(eager.gram)} tags: Gram max-relative {worst_g:.3e}, mean "
        f"|x| {worst_a:.3e} (tolerance {CALIB_RTOL:.0e}); counts equal")
    assert worst_g < CALIB_RTOL and worst_a < CALIB_RTOL, \
        "streaming statistics disagree with the eager fp64 oracle"


def device_vs_host(port, dev, calib, cfg=None, params=None, types=None):
    """Host fp64 decomposition (the oracle) against the device one at full
    width, model in float32: SmolLM at ORACLE_LAYERS layers, or ``cfg``
    and its ``params``; ``types``: the group types the plan must hold.
    Returns {path: seconds}."""
    torch, T, CC = port.torch, port.T, port.compress
    if cfg is None:
        cfg = port.get_config(ARCH).replace(n_layers=ORACLE_LAYERS,
                                            dtype="float32")
        params, _ = T.init_model(cfg, seed=0, device=dev)
    col = CC.calibrate(port.capture.to_list_params(params, cfg), cfg, calib)
    ccfg = CC.CompressionConfig(method="drank", ratio=0.2)
    out, secs = {}, {}
    for device in (False, True):
        t0 = time.perf_counter()
        out[device] = CC.build_plan_and_params(params, cfg, ccfg, calib,
                                               collector=col, device=device)
        torch.cuda.synchronize()
        secs["device" if device else "host"] = time.perf_counter() - t0
    (lp_h, plan_h), (lp_d, plan_d) = out[False], out[True]
    if types is not None:
        assert {g.mtype for g in plan_h.groups} == types, \
            {g.mtype for g in plan_h.groups}
    ks_h = {g.gid: g.k for g in plan_h.groups}
    ks_d = {g.gid: g.k for g in plan_d.groups}
    flips = {g: (ks_h[g], ks_d[g]) for g in ks_h if ks_h[g] != ks_d.get(g)}
    sig = max(_rel64(np.asarray(d.sigma_head), np.asarray(h.sigma_head))
              for d, h in zip(plan_d.groups, plan_h.groups))
    reff = max(abs(d.reff - h.reff) / h.reff
               for d, h in zip(plan_d.groups, plan_h.groups))
    fac = 0.0
    for ld, lh in zip(linears(lp_d), linears(lp_h)):
        pd = ld["B"].double() @ ld["C"].double()
        ph = lh["B"].double() @ lh["C"].double()
        fac = max(fac, float((pd - ph).abs().max() / ph.abs().max()))
    log(f"  {len(ks_h)} groups at {cfg.n_layers} layers: host fp64 "
        f"{secs['host']:.2f} s ({CC.LINALG}), device "
        f"{secs['device']:.2f} s; rank flips {len(flips)}; σ head "
        f"max-relative {sig:.3e} (tolerance {SIG_TOL:.0e}); reff "
        f"{reff:.3e}; B·C max-relative {fac:.3e} (tolerance "
        f"{FACTOR_TOL:.0e})")
    assert not flips, f"device ranks differ from the host's: {flips}"
    assert sig < SIG_TOL, "device σ disagrees with the host oracle"
    assert fac < FACTOR_TOL, "device factors disagree with the host oracle"
    return secs


def check_kernels(port, dev, comp):
    """Each kernel against its plain version on the card. Returns {name:
    max abs error}."""
    torch, ref = port.torch, port.ref
    w = port.wrappers
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    # the plan's (K, R, N) at the first layer, the largest rank, ragged
    # ranks at SmolLM's widths (13 and 697: B's rows on 2-byte boundaries;
    # 698: on 4-byte ones; 696 and 800: on 16-byte ones, B by TMA), and a
    # shape with nothing a multiple of anything (the CUDA-core 2-D kernel
    # only); then B at an offset of one element. Every variant that takes a
    # shape is held to the plain version (errors by variant in ``worst``;
    # ``errs`` has the largest).
    lins = linears(comp)
    shapes = {(int(p["B"].shape[0]), int(p["B"].shape[1]),
               int(p["C"].shape[1])) for p in lins[:7]}
    big = max(lins, key=lambda p: p["B"].shape[1])
    shapes.add((int(big["B"].shape[0]), int(big["B"].shape[1]),
                int(big["C"].shape[1])))
    shapes |= {(100, 13, 77), (960, 13, 320), (960, 697, 960),
               (960, 696, 960), (960, 698, 960), (2560, 800, 960)}
    errs = {n: 0.0 for n in w}
    for dtype, dname in ((torch.bfloat16, "bfloat16"),
                         (torch.float32, "float32")):
        worst = {}

        def hold(name, got, want, variant=None):
            key = f"{name}[{variant}]" if variant else name
            worst[key] = max(worst.get(key, 0.0), rel_err(got, want))
            errs[name] = max(errs[name], abs_err(got, want))

        rows = (1, 8, 64, 65, 100, GEN_BATCH * GEN_PROMPT, 2048)
        for K, R, N in sorted(shapes) + list(LARGE_RANKS):
            B = rnd((K, R), dtype, K ** -0.5)
            C = rnd((R, N), dtype, R ** -0.5)
            for M in (rows if (K, R, N) in shapes else (65, 512, 2048)):
                x = rnd((M, K), dtype)
                yr = ref.lowrank_matmul(x, B, C)
                if M <= port.ops.GEMV_MAX_ROWS:
                    for v in port.lm._allowed_gemv(dtype, M, K, R):
                        y = w["lowrank_gemv"](x, B, C, variant=v)
                        y2 = w["lowrank_gemv"](x, B, C, variant=v)
                        torch.cuda.synchronize()
                        assert torch.equal(y, y2), \
                            f"lowrank_gemv ({v}) gave other bits on a " \
                            f"second call at {(M, K, R, N)} {dname}"
                        hold("lowrank_gemv", y, yr, v)
                    continue
                for v in port.lm._allowed_2d(dtype, M, K, R, N):
                    y = w["lowrank_matmul_2d"](x, B, C, variant=v)
                    torch.cuda.synchronize()
                    hold("lowrank_matmul_2d", y, yr, v)
        K, R, N = max(shapes, key=lambda s: s[1])
        x = rnd((GEN_BATCH * GEN_PROMPT, K), dtype)
        C = rnd((R, N), dtype, R ** -0.5)
        B = rnd((K * R + 1,), dtype, K ** -0.5)[1:].view(K, R)
        yr = ref.lowrank_matmul(x, B, C)
        for v in port.lm._allowed_2d(dtype, x.shape[0], K, R, N):
            y = w["lowrank_matmul_2d"](x, B, C, variant=v)
            torch.cuda.synchronize()
            hold("lowrank_matmul_2d", y, yr, v)
        # the gemv with B and C, then x too, at an odd element offset: B and
        # C take the shifted raw words, x's rows the earlier design
        for M in (1, GEN_BATCH, GEMV_ROWS_WIDE):
            Bo = rnd((K * R + 1,), dtype, K ** -0.5)[1:].view(K, R)
            Co = rnd((R * N + 1,), dtype, R ** -0.5)[1:].view(R, N)
            xo = rnd((M * K + 1,), dtype)[1:].view(M, K)
            xa = xo.clone()
            yr = ref.lowrank_matmul(xa, Bo, Co)
            for v in port.lm._allowed_gemv(dtype, M, K, R):
                hold("lowrank_gemv", w["lowrank_gemv"](xa, Bo, Co, variant=v),
                     yr, f"{v}, B and C offset")
            assert port.lm._variant_gemv(dtype, M, K, R,
                                         port.lm._aligned(xo)) == "splitk"
            hold("lowrank_gemv", w["lowrank_gemv"](xo, Bo, Co), yr,
                 "splitk, x offset")
        gemv_graph(port, x[:GEN_BATCH].contiguous(), B.clone(), C, dname)
        # flash, every variant that takes the shape: G = 3 at SmolLM's heads
        # (hd 64), G = 2 at gemma3's (hd 256); causal, window, softcap,
        # ragged S; gemma3's prefill past its 1024-token window; and each
        # other head dim the kernels take (hd 128: qwen3-4b's and
        # mistral-nemo-12b's 32 heads over 8)
        others = [case for hd in (16, 32, 128) for case in (
            (2, 77, 6, 2, hd, True, 24, 0.0),
            (1, 130, 6, 3, hd, False, 0, 0.0),
            (2, 64, 6, 2, hd, True, 0, 30.0))]
        others.append((1, 300, 32, 8, 128, True, 0, 0.0))
        # non-causal (an encoder's) at seamless's frame counts, ragged
        # against every tile: every key tile of every query tile is read
        others += [(2, 200, 16, 16, 64, False, 0, 0.0),
                   (1, 300, 16, 16, 64, False, 0, 0.0),
                   (1, 200, 8, 2, 128, False, 0, 0.0),
                   (2, 300, 8, 8, 128, False, 0, 0.0)]
        for Bb, S, H, KVh, hd, causal, window, cap in others + [
                (2, 64, 15, 5, 64, True, 0, 0.0),
                (2, 128, 15, 5, 64, True, 48, 0.0),
                (2, 64, 15, 5, 64, True, 0, 30.0),
                (3, 50, 15, 5, 64, False, 0, 0.0),
                (1, 77, 15, 5, 64, True, 16, 20.0),
                (2, 128, 4, 2, 256, True, 0, 0.0),
                (1, 200, 4, 2, 256, True, 64, 0.0),
                (2, 64, 4, 2, 256, True, 0, 30.0),
                (2, 77, 4, 2, 256, False, 0, 0.0),
                (1, 1100, 2, 1, 256, True, 1024, 0.0)]:
            q = rnd((Bb, S, H, hd), dtype)
            k = rnd((Bb, S, KVh, hd), dtype)
            v = rnd((Bb, S, KVh, hd), dtype)
            orf = ref.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=cap)
            for var in port.fa._allowed(dtype, hd):
                o = w["flash_attention"](q, k, v, causal=causal,
                                         window=window, softcap=cap,
                                         variant=var)
                torch.cuda.synchronize()
                hold("flash_attention", o, orf, f"{var}, hd {hd}")
        # decode: full layout with a dead slot and mixed lengths, shorter
        # than one chunk (32 rows) and across several; ring; both at
        # SmolLM's heads and gemma3's (hd 256, G 2; its 1024-row ring)
        for L, window, KVh, G, hd, lens in (
                (97, 0, 5, 3, 64, [0, 1, 17, 64, 80, 96, 97, 33]),
                (32, 32, 5, 3, 64, [0, 5, 31, 32, 33, 77, 96, 1]),
                (1217, 0, 2, 2, 256, [0, 1, 31, 32, 33, 100, 1100, 1217]),
                (1024, 1024, 2, 2, 256, [0, 5, 1023, 1024, 1025, 2000, 77,
                                         1])):
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = rnd((8, KVh, G, hd), dtype)
            k = rnd((8, L, KVh, hd), dtype)
            v = rnd((8, L, KVh, hd), dtype)
            o = w["decode_attention"](q, k, v, lengths, window=window)
            orf = ref.decode_attention(q.reshape(8, KVh * G, hd), k, v,
                                       lengths, window=window
                                       ).reshape(o.shape)
            torch.cuda.synchronize()
            assert (o[0] == 0).all(), "dead slot must give exact zeros"
            hold("decode_attention", o, orf, f"hd {hd}")
        # paged decode: a shuffled, non-monotonic table in which slots 0
        # and 1 share their first block; a dead slot; lengths that are no
        # multiple of bk; at bk 6, length 7's last 4-row group (rows 4-6)
        # straddles the block boundary at 6. SmolLM's shapes, G 8 at hd
        # 128, and gemma3's hd 256 with lengths over many 32-row chunks.
        # Bit for bit against the contiguous kernel on the gathered layout,
        # then against the plain version.
        for KVh, G, hd, bk, lens in (
                (5, 3, 64, 16, [40, 23, 0, 1, 16, 17, 255, 100]),
                (5, 3, 64, 6, [7, 13, 0, 6, 5, 12, 61, 30]),
                (2, 8, 128, 16, [33, 70, 0, 15, 64, 2, 128, 49]),
                (2, 2, 256, 16, [33, 700, 0, 15, 64, 2, 1100, 49])):
            nb = -(-max(lens) // bk)
            P = 8 * nb + 2
            perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
            table = torch.zeros((8, nb), dtype=torch.int32, device=dev)
            used = 0
            for b, ln in enumerate(lens):
                n = -(-ln // bk)
                table[b, :n] = perm[used:used + n].to(torch.int32)
                used += n
            table[1, 0] = table[0, 0]                  # a shared block
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = rnd((8, KVh, G, hd), dtype)
            ka = rnd((P, bk, KVh, hd), dtype)
            va = rnd((P, bk, KVh, hd), dtype)
            ka[0] = 0
            va[0] = 0
            o = w["decode_attention_paged"](q, ka, va, lengths, table)
            idx = table.long()
            kc = ka[idx].reshape(8, nb * bk, KVh, hd).contiguous()
            vc = va[idx].reshape(8, nb * bk, KVh, hd).contiguous()
            oc = w["decode_attention"](q, kc, vc, lengths)
            orf = ref.decode_attention_paged(
                q.reshape(8, KVh * G, hd), ka, va, lengths,
                table).reshape(8, KVh, G, hd)
            torch.cuda.synchronize()
            assert torch.equal(o, oc), \
                "the paged kernel differs from the contiguous one"
            assert (o[2] == 0).all(), "dead slot must give exact zeros"
            hold("decode_attention_paged", o, orf, f"hd {hd}")
        # gram: one calibration batch's two widths at N and at a ragged N
        # (aligned widths: vector loads, and the tensor-core variant in
        # bf16), a ragged N and D (scalar loads); overwrite and accumulate
        # into an accumulator, every variant that takes the shape
        N = CALIB_BATCH * CALIB_SEQ
        for n_rows, d in ((N, 960), (N, 2560), (N - 24, 960),
                          (N - 24, 2560), (N - 24, 97)):
            x = rnd((n_rows, d), dtype)
            acc = rnd((d, d), torch.float32, n_rows ** 0.5)
            gr = ref.gram(x)
            for v in port.gm._allowed(dtype, n_rows, d):
                g = w["gram_blocked"](x, variant=v)
                ga = w["gram_blocked"](x, out=acc.clone(), variant=v)
                torch.cuda.synchronize()
                hold("gram_blocked", g, gr, v)
                hold("gram_blocked", ga, acc + gr, v)
        # under autograd at the training path's shapes, through ``ops``:
        # flash at (8, 256, 15, 64) causal and the 2-D product at a D-Rank
        # MLP linear's shape over 8 x 256 rows, from non-contiguous views
        # that require grad (q, k, v slices of one qkv tensor; x a column
        # slice); the outputs and the input grads against autograd through
        # the plain versions. The 2-D product also with B and C frozen (a
        # LoRA step's case: dx alone).
        Bb, S, H, KVh, hd = TRAIN_BATCH, TRAIN_SEQ, 15, 5, 64
        qkv = rnd((Bb, S, H + 2 * KVh, hd), dtype)
        go = rnd((Bb, S, H, hd), dtype)
        got = {}
        for name, fn in (("kernel", port.ops.flash_attention),
                         ("plain", ref.flash_attention)):
            t = qkv.clone().requires_grad_()
            o = fn(t[:, :, :H], t[:, :, H:H + KVh], t[:, :, H + KVh:],
                   causal=True)
            got[name] = (o, torch.autograd.grad(o, t, go)[0])
        torch.cuda.synchronize()
        hold("flash_attention", got["kernel"][0], got["plain"][0],
             "autograd, output")
        hold("flash_attention", got["kernel"][1], got["plain"][1],
             "autograd, dq dk dv")
        K, R, N = 960, 558, 2560
        xw = rnd((Bb * S, K + 64), dtype)
        B = rnd((K, R), dtype, K ** -0.5)
        C = rnd((R, N), dtype, R ** -0.5)
        gy = rnd((Bb * S, N), dtype)
        for frozen in (False, True):
            got = {}
            for name, fn in (("kernel", port.ops.lowrank_matmul),
                             ("plain", ref.lowrank_matmul)):
                ins = [xw.clone().requires_grad_(),
                       B.clone().requires_grad_(not frozen),
                       C.clone().requires_grad_(not frozen)]
                y = fn(ins[0][:, :K], ins[1], ins[2])
                want = [t for t in ins if t.requires_grad]
                got[name] = (y, torch.autograd.grad(y, want, gy))
            torch.cuda.synchronize()
            tag = "B, C frozen" if frozen else "x, B, C"
            hold("lowrank_matmul_2d", got["kernel"][0], got["plain"][0],
                 f"autograd ({tag}), output")
            for i, g in enumerate(got["kernel"][1]):
                hold("lowrank_matmul_2d", g, got["plain"][1][i],
                     f"autograd ({tag}), grad {'xBC'[i]}")
        for n, e in worst.items():
            tol = GRAM_TOL if n.startswith("gram_blocked") else TOL[dname]
            log(f"  {n} {dname}: max-relative error {e:.2e} "
                f"(tolerance {tol:.0e})")
            assert e <= tol, f"{n} disagrees with its plain version"
    return errs


def gemv_graph(port, x, B, C, dname: str) -> None:
    """One gemv call (its two launches, the second a programmatic
    dependent launch) captured in a CUDA graph and replayed twice: both
    replays give the bits of an eager call."""
    torch, gemv = port.torch, port.wrappers["lowrank_gemv"]
    eager = gemv(x, B, C)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        gemv(x, B, C)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = gemv(x, B, C)
    graph.replay()
    torch.cuda.synchronize()
    first = y.clone()
    graph.replay()
    torch.cuda.synchronize()
    variant = port.lm._variant_gemv(x.dtype, *x.shape, B.shape[1])
    log(f"  lowrank_gemv {dname} ({variant}) at {tuple(x.shape)} @ "
        f"{tuple(B.shape)} @ {tuple(C.shape)} captured in a CUDA graph: "
        f"two replays identical {torch.equal(first, y)}, equal to an "
        f"eager call {torch.equal(first, eager)}")
    assert torch.equal(first, y) and torch.equal(first, eager), \
        "the gemv's graph replays differ"


def time_kernels(port, dev, cfg, comp, snap):
    """Per kernel: the device time of the work it does in one prefill or
    one decode step of the main path (the paged kernel: one decode step
    of the batcher's path, ``snap``), its plain version's, one library
    call's, and the bound."""
    torch, ref = port.torch, port.ref
    F = torch.nn.functional
    w = port.wrappers
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lins = [(p["B"].to(bf), p["C"].to(bf)) for p in linears(comp)]
    H, KV, hd, nl = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    # the gemv at the decode step's 8 rows and at the larger throughput
    # batch's 64 ("lowrank_gemv@64", main() files it under the gemv)
    rows = {"lowrank_gemv": GEN_BATCH, "lowrank_gemv@64": GEMV_ROWS_WIDE,
            "lowrank_matmul_2d": GEN_BATCH * GEN_PROMPT}
    out = {}
    for key, M in rows.items():
        name = key.split("@")[0]
        xs = [torch.randn((M, B.shape[0]), generator=gen, device=dev
                          ).to(bf) for B, _ in lins]
        nbytes = sum(2 * (M * B.shape[0] + B.numel() + C.numel()
                          + M * C.shape[1]) for B, C in lins)
        ops = sum(2 * M * B.shape[1] * (B.shape[0] + C.shape[1])
                  for B, C in lins)
        out[key] = dict(
            work=f"{len(lins)} compressed linears at {M} rows (one "
                 f"{'prefill' if name.endswith('2d') else 'decode step'})",
            ms=device_ms(torch, lambda: [w[name](x, B, C) for x, (B, C)
                                         in zip(xs, lins)]),
            plain_ms=device_ms(torch, lambda: [ref.lowrank_matmul(x, B, C)
                                               for x, (B, C)
                                               in zip(xs, lins)]),
            library_ms=device_ms(torch, lambda: [
                torch.linalg.multi_dot([x, B, C])
                for x, (B, C) in zip(xs, lins)]),
            bound=bound_ms(nbytes, ops, "bfloat16"))
        if name == "lowrank_gemv":        # the earlier three-launch design
            out[key]["variant"] = sorted({
                port.lm._variant_gemv(bf, M, B.shape[0], B.shape[1])
                for B, _ in lins})
            out[key]["splitk_ms"] = device_ms(torch, lambda: [
                w[name](x, B, C, variant="splitk")
                for x, (B, C) in zip(xs, lins)])
        if name == "lowrank_matmul_2d":   # the earlier CUDA-core design
            out[name]["variant"] = sorted({
                port.lm._variant_2d(bf, M, B.shape[0], B.shape[1],
                                    C.shape[1]) for B, C in lins})
            out[name]["simt_ms"] = device_ms(torch, lambda: [
                w[name](x, B, C, variant="simt")
                for x, (B, C) in zip(xs, lins)])
            # the two-launch variant on the same prefill: whether it could
            # replace the fused tensor-core kernel
            out[name]["split_ms"] = device_ms(torch, lambda: [
                w[name](x, B, C, variant="split")
                for x, (B, C) in zip(xs, lins)])

    # flash: one prefill's attention, nl layers of (8, 64, 15, 64)
    Bb, S = GEN_BATCH, GEN_PROMPT
    qs = [torch.randn((Bb, S, H, hd), generator=gen, device=dev).to(bf)
          for _ in range(nl)]
    kvs = [(torch.randn((Bb, S, KV, hd), generator=gen, device=dev).to(bf),
            torch.randn((Bb, S, KV, hd), generator=gen, device=dev).to(bf))
           for _ in range(nl)]
    qt = [q.transpose(1, 2).contiguous() for q in qs]
    kvt = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
           for k, v in kvs]
    pairs = S * (S + 1) // 2                      # causal (query, key) pairs
    out["flash_attention"] = dict(
        work=f"{nl} layers of causal attention at B={Bb} S={S} H={H} "
             f"KV={KV} hd={hd} (one prefill)",
        ms=device_ms(torch, lambda: [w["flash_attention"](q, k, v)
                                     for q, (k, v) in zip(qs, kvs)]),
        plain_ms=device_ms(torch, lambda: [ref.flash_attention(q, k, v)
                                           for q, (k, v) in zip(qs, kvs)]),
        library_ms=device_ms(torch, lambda: [
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
            for q, (k, v) in zip(qt, kvt)]),
        bound=bound_ms(nl * 2 * Bb * (2 * S * H * hd + 2 * S * KV * hd),
                       nl * 4 * Bb * H * hd * pairs, "bfloat16"),
        variant=sorted({port.fa._variant(bf, hd)}),
        simt_ms=device_ms(torch, lambda: [
            w["flash_attention"](q, k, v, variant="simt")
            for q, (k, v) in zip(qs, kvs)]))

    # decode: one decode step's attention, nl layers, every slot mid-way
    L = GEN_PROMPT + GEN_NEW + 1
    ln = GEN_PROMPT + GEN_NEW // 2
    lengths = torch.full((Bb,), ln, dtype=torch.int32, device=dev)
    qd = [torch.randn((Bb, KV, H // KV, hd), generator=gen, device=dev
                      ).to(bf) for _ in range(nl)]
    cache = [(torch.randn((Bb, L, KV, hd), generator=gen, device=dev).to(bf),
              torch.randn((Bb, L, KV, hd), generator=gen, device=dev).to(bf))
             for _ in range(nl)]
    qdt = [q.reshape(Bb, H, 1, hd) for q in qd]
    cdt = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
           for k, v in cache]
    mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None]
            )[:, None, None, :]

    def decode():
        return [w["decode_attention"](q, k, v, lengths)
                for q, (k, v) in zip(qd, cache)]
    out["decode_attention"] = dict(
        work=f"{nl} layers of decode attention at B={Bb} H={H} KV={KV} "
             f"hd={hd}, {ln} live cache rows per slot (one decode step)",
        ms=device_ms(torch, decode),
        plain_ms=device_ms(torch, lambda: [
            ref.decode_attention(q.reshape(Bb, H, hd), k, v, lengths)
            for q, (k, v) in zip(qd, cache)]),
        library_ms=device_ms(torch, lambda: [
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           enable_gqa=True)
            for q, (k, v) in zip(qdt, cdt)]),
        bound=bound_ms(nl * 2 * (2 * Bb * H * hd + 2 * Bb * ln * KV * hd),
                       nl * 4 * Bb * H * hd * ln, "bfloat16"))
    # paged decode: one decode step of the batcher's path (its live
    # lengths and block table right after the staggered admissions) over
    # nl layers of an arena of the batcher's size. The library call is
    # masked SDPA on a contiguous copy gathered beforehand; the gather is
    # not timed.
    lp, tp = snap["lengths"], snap["table"]
    P = CB_BATCH * (CB_MAX_LEN // CB_BLOCK) + 1
    arenas = [(torch.randn((P, CB_BLOCK, KV, hd), generator=gen,
                           device=dev).to(bf),
               torch.randn((P, CB_BLOCK, KV, hd), generator=gen,
                           device=dev).to(bf)) for _ in range(nl)]
    Lc = tp.shape[1] * CB_BLOCK
    gathered = [(k[tp.long()].reshape(Bb, Lc, KV, hd).transpose(1, 2)
                 .contiguous(),
                 v[tp.long()].reshape(Bb, Lc, KV, hd).transpose(1, 2)
                 .contiguous()) for k, v in arenas]
    pmask = (torch.arange(Lc, device=dev)[None, :] < lp[:, None]
             )[:, None, None, :]
    live = int(lp.sum())

    def paged():
        return [w["decode_attention_paged"](q, k, v, lp, tp)
                for q, (k, v) in zip(qd, arenas)]
    out["decode_attention_paged"] = dict(
        work=f"{nl} layers of paged decode attention at B={Bb} H={H} "
             f"KV={KV} hd={hd}, block {CB_BLOCK}, live lengths "
             f"{lp.tolist()} (one decode step of the batcher's path)",
        ms=device_ms(torch, paged),
        plain_ms=device_ms(torch, lambda: [
            ref.decode_attention_paged(q.reshape(Bb, H, hd), k, v, lp, tp)
            for q, (k, v) in zip(qd, arenas)]),
        library_ms=device_ms(torch, lambda: [
            F.scaled_dot_product_attention(q, k, v, attn_mask=pmask,
                                           enable_gqa=True)
            for q, (k, v) in zip(qdt, gathered)]),
        bound=bound_ms(nl * (2 * 2 * Bb * H * hd + 2 * 2 * live * KV * hd
                             + 4 * tp.numel()),
                       nl * 4 * H * hd * live, "bfloat16"))
    # gram: one calibration batch of the main path, 7 tags a layer (the
    # tape keeps one Gram per tag, so wq/wk/wv's shared input is reduced
    # three times), bf16 activations added into float32 accumulators. A
    # bf16 product is exact in float32, so the same function runs at the
    # bf16 tensor-core rate: the bound takes that rate for the D(D+1)/2
    # distinct entries of a symmetric G, and the bytes of the activations
    # read once and the accumulators read and written once. The library
    # call is cuBLAS's bf16 GEMM with float32 output, added to the
    # accumulator; a float32 GEMM on a widened copy is logged beside it.
    N = CALIB_BATCH * CALIB_SEQ
    widths = [cfg.d_model] * 6 + [cfg.d_ff]
    xg = [torch.randn((N, d), generator=gen, device=dev).to(bf)
          for _ in range(nl) for d in widths]
    accs = [torch.zeros((x.shape[1], x.shape[1]), device=dev) for x in xg]
    out["gram_blocked"] = dict(
        work=f"{len(xg)} Grams of one calibration batch ({N} rows; "
             f"{nl * 6} at D={cfg.d_model}, {nl} at D={cfg.d_ff}; bf16 "
             f"into float32 accumulators)",
        ms=device_ms(torch, lambda: [w["gram_blocked"](x, out=a)
                                     for x, a in zip(xg, accs)]),
        plain_ms=device_ms(torch, lambda: [ref.gram(x) for x in xg]),
        library_ms=device_ms(torch, lambda: [
            torch.addmm(a, x.T, x, out_dtype=torch.float32)
            for x, a in zip(xg, accs)]),
        bound=bound_ms(sum(2 * x.numel() + 8 * x.shape[1] ** 2 for x in xg),
                       sum(N * x.shape[1] * (x.shape[1] + 1) for x in xg),
                       "bfloat16"),
        variant=sorted({port.gm._variant(bf, *x.shape) for x in xg}),
        simt_ms=device_ms(torch, lambda: [
            w["gram_blocked"](x, out=a, variant="simt")
            for x, a in zip(xg, accs)]))
    xf = [x.float() for x in xg]
    log(f"  gram_blocked: cuBLAS float32 x.T @ x on a widened copy, TF32 "
        f"off: {device_ms(torch, lambda: [x.T @ x for x in xf]):.4f} ms")
    del xf
    for name, r in out.items():
        earlier = (f" ({', '.join(r['variant'])}; the CUDA-core design "
                   f"{r['simt_ms']:.4f} ms)" if "simt_ms" in r else "")
        if "split_ms" in r:
            earlier += f" (split {r['split_ms']:.4f} ms)"
        if "splitk_ms" in r:
            earlier = (f" ({', '.join(r['variant'])}; the earlier design, "
                       f"splitk, {r['splitk_ms']:.4f} ms)")
        log(f"  {name}: {r['ms']:.4f} ms{earlier}, plain {r['plain_ms']:.4f}"
            f" ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) -- {r['work']}")
    return out


def time_large_shapes(port, dev):
    """gemma3-12b's and the other dense configs' shapes, bf16: flash at hd
    256 for one gemma3 prefill (6 layers of B 2, S 1200, 16 heads over 8),
    and every variant of the 2-D product that takes each of LARGE_RANKS and
    two of SmolLM's linears (rank <= 896, where "split" is timed against
    the fused tensor-core kernel), at 512 and 2048 rows, per linear, beside
    ``multi_dot``. Returns {"flash_hd256": {...}, "lowrank_2d": [...]}."""
    torch, ref, w = port.torch, port.ref, port.wrappers
    F = torch.nn.functional
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(bf)

    nl, Bb, S, H, KV, hd = GEMMA_LAYERS, 2, GEMMA_PROMPTS[0], 16, 8, 256
    qs = [rnd((Bb, S, H, hd)) for _ in range(nl)]
    kvs = [(rnd((Bb, S, KV, hd)), rnd((Bb, S, KV, hd))) for _ in range(nl)]
    qt = [q.transpose(1, 2).contiguous() for q in qs]
    kvt = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
           for k, v in kvs]
    pairs = S * (S + 1) // 2
    bound = bound_ms(nl * 2 * Bb * (2 * S * H * hd + 2 * S * KV * hd),
                     nl * 4 * Bb * H * hd * pairs, "bfloat16")
    flash = dict(
        work=f"{nl} layers of causal attention at B={Bb} S={S} H={H} "
             f"KV={KV} hd={hd} (one gemma3-12b prefill, no window)",
        ms=device_ms(torch, lambda: [w["flash_attention"](q, k, v)
                                     for q, (k, v) in zip(qs, kvs)]),
        simt_ms=device_ms(torch, lambda: [
            w["flash_attention"](q, k, v, variant="simt")
            for q, (k, v) in zip(qs, kvs)], reps=3),
        plain_ms=device_ms(torch, lambda: [ref.flash_attention(q, k, v)
                                           for q, (k, v) in zip(qs, kvs)],
                           reps=3),
        library_ms=device_ms(torch, lambda: [
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
            for q, (k, v) in zip(qt, kvt)]),
        bound_ms=bound[0], bound_by=bound[1])
    log(f"  flash_attention at hd 256: wgmma {flash['ms']:.4f} ms, simt "
        f"{flash['simt_ms']:.4f}, plain {flash['plain_ms']:.4f}, library "
        f"{flash['library_ms']:.4f}, bound {bound[0]:.4f} ({bound[1]}) -- "
        f"{flash['work']}")

    rows = []
    for K, R, N in ((960, 698, 2560), (2560, 600, 960)) + LARGE_RANKS:
        B, C = rnd((K, R), K ** -0.5), rnd((R, N), R ** -0.5)
        for M in (512, 2048):
            x = rnd((M, K))
            r = {"K": K, "R": R, "N": N, "M": M}
            for v in port.lm._allowed_2d(bf, M, K, R, N):
                r[f"{v}_ms"] = device_ms(torch, lambda: [
                    w["lowrank_matmul_2d"](x, B, C, variant=v)
                    for _ in range(10)]) / 10
            r["library_ms"] = device_ms(torch, lambda: [
                torch.linalg.multi_dot([x, B, C]) for _ in range(10)]) / 10
            r["bound_ms"] = bound_ms(
                2 * (M * K + K * R + R * N + M * N),
                2 * M * R * (K + N), "bfloat16")[0]
            rows.append(r)
            log(f"  lowrank_matmul_2d ({K}, {R}, {N}) at {M} rows, per "
                f"linear: " + ", ".join(
                    f"{k[:-3]} {v:.4f} ms" for k, v in r.items()
                    if k.endswith("_ms")))
    return {"flash_hd256": flash, "lowrank_2d": rows}


def time_float32_2d(port, dev, comp, gemma_shapes):
    """The two float32 2-D variants, the fused CUDA-core kernel ("simt")
    against the two-launch one ("split"): per prefill of the main path's
    plan (every compressed linear) at the parity run's 128 rows and at 256,
    512 and 2048 of the batcher's bucketed rows, and per linear at the gemma3
    path's prefill (2400 rows) for its ranks the fused kernel takes.
    Returns a list of rows {work, M, simt_ms, split_ms}."""
    torch, w = port.torch, port.wrappers
    f32 = torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    lins = [(p["B"].to(f32), p["C"].to(f32)) for p in linears(comp)]
    out = []

    def row(work, M, calls):
        r = {"work": work, "M": M}
        for v in ("simt", "split"):
            r[f"{v}_ms"] = device_ms(torch, lambda: [
                w["lowrank_matmul_2d"](x, B, C, variant=v)
                for x, B, C in calls])
        out.append(r)
        log(f"  lowrank_matmul_2d float32, {work} at {M} rows: simt "
            f"{r['simt_ms']:.4f} ms, split {r['split_ms']:.4f} ms")
    for M in (PARITY_BATCH * PARITY_PROMPT, 256, 512, 2048):
        xs = {K: torch.randn((M, K), generator=gen, device=dev)
              for K in {B.shape[0] for B, _ in lins}}
        row(f"one prefill of the plan's {len(lins)} linears", M,
            [(xs[B.shape[0]], B, C) for B, C in lins])
    M = GEMMA_PROMPTS[0] * 2
    for K, R, N in gemma_shapes:
        if "simt" not in port.lm._allowed_2d(f32, M, K, R, N):
            continue
        B = torch.randn((K, R), generator=gen, device=dev) * K ** -0.5
        C = torch.randn((R, N), generator=gen, device=dev) * R ** -0.5
        x = torch.randn((M, K), generator=gen, device=dev)
        row(f"gemma3's ({K}, {R}, {N})", M, [(x, B, C)])
    return out


def random_factors(port, params, cfg, ratio: float, seed: int):
    """``params`` with every linear replaced by factors B (d_in, k), C (k,
    d_out) drawn from a generator seeded with ``seed``, at the ranks of
    ``uniform_allocate`` at ``ratio`` (method svd's rule; GQA models group
    one matrix each), scaled so that B·C has the dense weight's variance;
    an MoE layer's routed experts each get their own factors, restacked
    into {"B": (E, d_in, k), "C": (E, k, d_out)} with zero rank padding.
    No calibration, no SVD. Returns (list-form params, {gid: rank})."""
    torch = port.torch
    from repro_torch.core import allocate as alloc
    from repro_torch.core import groups as grp
    lp = port.capture.to_list_params(params, cfg)
    groups = grp.build_groups(grp.enumerate_matrices(lp, cfg), cfg, 1)
    ks = alloc.uniform_allocate([alloc.GroupSpec(
        gid=g.gid, mtype=g.mtype, reff=1.0, omega=g.omega, kmax=g.cost_cap,
        kmin=1, dense_params=g.dense_params) for g in groups], ratio)
    gen = torch.Generator(device=params["embed"].device)
    gen.manual_seed(seed)
    experts = {}
    for g in groups:
        for m in g.members:
            parent = lp
            for key in m.path[:-1]:
                parent = parent[key]
            node = parent[m.path[-1]]
            wd = node["w"] if m.expert is None else node[m.expert]
            k = ks[g.gid]
            B = torch.randn((m.d_in, k), generator=gen, device=wd.device,
                            dtype=wd.dtype) * k ** -0.5
            C = torch.randn((k, m.d_out), generator=gen, device=wd.device,
                            dtype=wd.dtype) * wd.float().std()
            if m.expert is None:      # a bias (qwen2-vl's q/k/v) stays
                parent[m.path[-1]] = dict({"B": B, "C": C}, **{
                    k: v for k, v in node.items() if k == "b"})
            else:
                experts.setdefault(m.path, (parent, {}))[1][m.expert] = (B, C)
    for path, (parent, fs) in experts.items():
        E, d_in, d_out = parent[path[-1]].shape
        r = max(B.shape[1] for B, _ in fs.values())
        Bs = parent[path[-1]].new_zeros((E, d_in, r))
        Cs = parent[path[-1]].new_zeros((E, r, d_out))
        for e, (B, C) in fs.items():
            Bs[e, :, :B.shape[1]] = B
            Cs[e, :C.shape[0]] = C
        parent[path[-1]] = {"B": Bs, "C": Cs}
    return lp, ks


def greedy(port, params, cfg, prompts, steps: int, device, lengths=None,
           extra=None):
    """Prefill ``prompts`` (right-padded to a common length when
    ``lengths`` is given; with ``extra``'s arrays in the batch too: an
    encoder input, or ``embeds`` and ``positions`` in place of the tokens)
    and ``steps`` greedy decode steps on ``device`` in ``cfg``'s dtype.
    Returns the logits of every step on the CPU."""
    torch, T = port.torch, port.T
    p = port.engine.place_params(params, T.dtype_of(cfg.dtype), device)
    batch = {"tokens": torch.as_tensor(prompts, device=device)}
    if lengths is not None:
        batch["lengths"] = torch.as_tensor(lengths, device=device)
    for k, v in (extra or {}).items():
        batch[k] = torch.as_tensor(v, device=device)
    if "embeds" in batch:
        del batch["tokens"]
    with torch.inference_mode():
        logits, cache = T.prefill(p, cfg, batch,
                                  max_len=prompts.shape[1] + steps + 1)
        out = [logits.float().cpu()]
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            logits, cache = T.decode_step(p, cfg, cache, tok)
            out.append(logits.float().cpu())
    return out


def compare_greedy(torch, gpu, cpu) -> None:
    """Card against CPU logits of ``greedy``: prefill logits within atol
    2e-3 and identical greedy tokens at every step."""
    diffs = [abs_err(a, b) for a, b in zip(gpu, cpu)]
    toks_g = [s[:, -1].argmax(-1) for s in gpu]
    toks_c = [s[:, -1].argmax(-1) for s in cpu]
    same = all(torch.equal(a, b) for a, b in zip(toks_g, toks_c))
    log(f"  prefill logits max |card - cpu| = {diffs[0]:.3e} (atol "
        f"{LOGITS_ATOL:.0e}); over all {len(diffs)} steps "
        f"{max(diffs):.3e}; tokens identical: {same}")
    if not same:
        for i, (a, b) in enumerate(zip(toks_g, toks_c)):
            for r in torch.nonzero(a != b).flatten().tolist():
                top = torch.topk(cpu[i][r, -1], 2).values
                log(f"  step {i} row {r}: card {int(a[r])} cpu {int(b[r])}, "
                    f"cpu argmax margin {float(top[0] - top[1]):.3e}")
    assert diffs[0] < LOGITS_ATOL, "prefill logits differ from the CPU's"
    assert same, "greedy tokens differ between the card and the CPU"


# the kernel wrappers the model reaches through ``ops``, by name there
PATH_WRAPPERS = {"lowrank_gemv": "lowrank_gemv",
                 "lowrank_matmul_2d": "lowrank_matmul_2d",
                 "flash_attention": "flash_attention_bshd",
                 "decode_attention": "decode_attention_bkgh",
                 "gram_blocked": "gram_blocked",
                 "decode_attention_paged": "decode_attention_paged_bkgh"}


@contextlib.contextmanager
def recording(port):
    """Within the block each kernel wrapper the model calls through ``ops``
    keeps a copy of its operands (the low-rank products' weights by
    reference) at the first call of each signature (the operands' shapes
    and dtypes and the keyword arguments), in the list it yields as
    (kernel, args, kwargs)."""
    torch = port.torch
    calls, seen, saved = [], set(), {}

    def spy(name, fn):
        def wrapper(*args, **kwargs):
            key = (name, tuple(None if a is None else (tuple(a.shape),
                                                       a.dtype)
                               for a in args),
                   tuple(sorted(kwargs.items())))
            if key not in seen:
                seen.add(key)
                # a low-rank product's B and C are weights, never written
                # after load: kept by reference (a clone of each per row
                # count held ~50 GB on hymba's exact-length prefills)
                keep = (1, 2) if name in ("lowrank_gemv",
                                          "lowrank_matmul_2d") else ()
                calls.append((name, [None if a is None else
                                     a if i in keep else a.clone()
                                     for i, a in enumerate(args)],
                              dict(kwargs)))
            return fn(*args, **kwargs)
        return wrapper
    for name, attr in PATH_WRAPPERS.items():
        saved[attr] = getattr(port.ops, attr)
        setattr(port.ops, attr, spy(name, saved[attr]))
    try:
        yield calls
    finally:
        for attr, fn in saved.items():
            setattr(port.ops, attr, fn)


def hold_recorded(port, calls, dname: str,
                  where: str = "the gemma3 path") -> None:
    """Every recorded call again through every variant that takes its
    operands, held to the plain version on the same operands within
    ``TOL[dname]`` (the Gram: GRAM_TOL). A recorded Gram runs without
    its accumulator (``out``), against the plain Gram."""
    torch, ref, w = port.torch, port.ref, port.wrappers
    worst = {}
    for name, args, kw in calls:
        with torch.inference_mode():
            if name in ("lowrank_gemv", "lowrank_matmul_2d"):
                x, B, C = args
                want = ref.lowrank_matmul(x, B, C)
                sig = (f"{tuple(x.shape)} @ {tuple(B.shape)} @ "
                       f"{tuple(C.shape)}")
                variants = (port.lm._allowed_gemv(
                    x.dtype, *x.shape, B.shape[1], port.lm._aligned(x))
                    if name == "lowrank_gemv" else port.lm._allowed_2d(
                        x.dtype, *x.shape, *C.shape, port.lm._aligned(x, C)))
            elif name == "flash_attention":
                q, k, v = args
                want = ref.flash_attention(q, k, v, **kw)
                sig = f"q {tuple(q.shape)} k {tuple(k.shape)} {kw}"
                variants = port.fa._allowed(q.dtype, q.shape[-1], all(
                    t.data_ptr() % 16 == 0 for t in args))
            elif name == "gram_blocked":
                x = args[0]
                args, kw = [x], {}
                want = ref.gram(x)
                sig = f"x {tuple(x.shape)}"
                variants = port.gm._allowed(x.dtype, *x.shape,
                                            x.data_ptr() % 16 == 0)
            elif name == "decode_attention_paged":
                q, k, v, lengths, table = args
                Bq, KVh, G, hd = q.shape
                want = ref.decode_attention_paged(
                    q.reshape(Bq, KVh * G, hd), k, v, lengths, table,
                    **kw).reshape(q.shape)
                sig = (f"q {tuple(q.shape)} arena {tuple(k.shape)} table "
                       f"{tuple(table.shape)} lengths {lengths.tolist()}")
                variants = (None,)
            else:
                q, k, v, lengths = args
                Bq, KVh, G, hd = q.shape
                want = ref.decode_attention(q.reshape(Bq, KVh * G, hd), k, v,
                                            lengths, **kw).reshape(q.shape)
                sig = (f"q {tuple(q.shape)} cache {tuple(k.shape)} lengths "
                       f"{lengths.tolist()} {kw}")
                variants = (None,)
            for var in variants:
                extra = {} if var is None else {"variant": var}
                got = w[name](*args, **kw, **extra)
                torch.cuda.synchronize()
                e = rel_err(got, want)
                key = f"{name}[{var}]" if var else name
                worst[key] = max(worst.get(key, 0.0), e)
                log(f"  {key} {dname} at {sig}: max-relative error {e:.2e} "
                    f"(max |plain| {float(want.float().abs().max()):.3e}, "
                    f"{int((got != want).sum())} of {want.numel()} "
                    f"elements differ)")
    for key, e in worst.items():
        tol = GRAM_TOL if key.startswith("gram_blocked") else TOL[dname]
        assert e <= tol, \
            f"{key} disagrees with its plain version at {where}'s " \
            f"operands ({e:.2e} > {tol:.0e})"


def gemma_path(port, dev):
    """gemma3-12b at full width, 6 layers, seeded random factors at the
    uniform 20% ranks: ``Engine.generate`` in bf16 on one prompt past the
    sliding window and one short one, with every launch count set to 0 just
    before and read just after; then float32 on the card against the CPU."""
    torch, T, E = port.torch, port.T, port.engine
    cfg = port.get_config(GEMMA).replace(n_layers=GEMMA_LAYERS)
    t0 = time.perf_counter()
    params, _ = T.init_model(cfg, seed=GEMMA_SEED, device=dev)
    comp, ks = random_factors(port, params, cfg, GEMMA_RATIO, GEMMA_SEED)
    del params
    torch.cuda.synchronize()
    ranks = {}
    for gid, k in ks.items():
        ranks.setdefault(gid.split(":")[0], set()).add(k)
    log(f"  {T.param_count(comp) / 1e9:.3f} B params ({GEMMA_LAYERS} layers "
        f"of {cfg.layer_kinds()}), ranks {ranks}, "
        f"{time.perf_counter() - t0:.1f} s")
    long, short = GEMMA_PROMPTS
    rng = np.random.default_rng(GEMMA_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (2, long), dtype=np.int32)
    prompts[1, short:] = 0
    lengths = np.asarray([long, short], dtype=np.int32)
    eng = E.Engine(comp, cfg, E.ServeConfig(batch=2), device=dev)
    windows = []
    decode = port.ops.decode_attention_bkgh

    def spy(*args, **kwargs):        # the cache layouts decode reads
        windows.append(kwargs.get("window", 0))
        return decode(*args, **kwargs)
    port.ops.decode_attention_bkgh = spy
    try:
        with recording(port) as calls:
            port.reset_counts()
            t0 = time.perf_counter()
            toks = eng.generate(prompts, GEMMA_NEW, lengths=lengths)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts, variants = port.counts(), port.variant_counts()
    finally:
        port.ops.decode_attention_bkgh = decode
    log(f"  bf16 generate, prompts of {long} and {short} tokens, {GEMMA_NEW} "
        f"new each: {secs:.2f} s; first tokens {toks[:, :6].tolist()}")
    log(f"  launches: {counts}; by variant {variants}; decode layouts "
        f"(window: launches) { {x: windows.count(x) for x in set(windows)} }")
    assert toks.shape == (2, GEMMA_NEW)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of range"
    for name in ("lowrank_gemv", "lowrank_matmul_2d", "flash_attention",
                 "decode_attention"):
        assert counts[name] > 0, f"{name} never launched on the gemma3 path"
    assert variants["lowrank_matmul_2d"]["split"] > 0, variants
    assert variants["flash_attention"]["wgmma"] > 0, variants
    assert_gemv(variants["lowrank_gemv"], "bfloat16", "the gemma3 path")
    for name in ("lowrank_matmul_2d", "flash_attention"):
        assert variants[name]["simt"] == 0, \
            f"a bf16 {name} launch took simt on the gemma3 path"
    assert {0, cfg.sliding_window} <= set(windows), \
        "decode attention missed the full or the ring layout"
    with torch.inference_mode():
        logits, _ = T.prefill(eng.params, cfg, {
            "tokens": torch.as_tensor(prompts, device=dev),
            "lengths": torch.as_tensor(lengths, device=dev)},
            max_len=long + 1)
    assert torch.isfinite(logits).all(), "non-finite gemma3 logits"
    del eng, logits
    # every kernel call of the run, through every variant that takes it,
    # against the plain version on the same operands
    shapes = sorted({(a[0].shape[1], a[1].shape[1], a[2].shape[1])
                     for n, a, _ in calls if n == "lowrank_matmul_2d"})
    log(f"  the bf16 run's {len(calls)} kernel signatures against the plain "
        f"versions:")
    hold_recorded(port, calls, "bfloat16")
    del calls
    # float32, card kernels against the CPU's plain versions, and against
    # the plain versions on the card on the run's own operands
    cfg32 = cfg.replace(dtype="float32")
    t0 = time.perf_counter()
    port.reset_counts()
    with recording(port) as calls:
        gpu = greedy(port, comp, cfg32, prompts, GEMMA_NEW_F32, dev,
                     lengths)
    card_s = time.perf_counter() - t0
    assert_gemv(port.variant_counts()["lowrank_gemv"], "float32",
                "the gemma3 path's float32 run")
    log(f"  the float32 run's {len(calls)} kernel signatures against the "
        f"plain versions:")
    hold_recorded(port, calls, "float32")
    del calls
    t0 = time.perf_counter()
    cpu = greedy(port, comp, cfg32, prompts, GEMMA_NEW_F32,
                 torch.device("cpu"), lengths)
    log(f"  float32, {GEMMA_NEW_F32} new tokens: card {card_s:.1f} s, cpu "
        f"{time.perf_counter() - t0:.1f} s")
    compare_greedy(torch, gpu, cpu)
    return shapes


def throughput(port, dev, cfg, params, comp):
    """Decode tokens/s of the dense and the D-Rank model, one after the
    other at each batch (one run each: the timing repeats no check)."""
    E = port.engine
    res = {}
    engines = {"dense": E.Engine(params, cfg, E.ServeConfig(), device=dev),
               "drank-20%": E.Engine(comp, cfg, E.ServeConfig(), device=dev)}
    for batch in (8, 64):
        for name in ("dense", "drank-20%"):
            m = engines[name].measure_decode_throughput(
                batch=batch, prompt_len=128, n_new=64)
            res.setdefault((name, batch), []).append(m)
            log(f"  {name:9s} batch {batch:2d}: {m['tokens_per_s']:9.1f} "
                f"tokens/s, {m['ms_per_step']:.3f} ms/step")
    return res


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def on_device(events):
    """The events a profiler's ``key_averages()`` holds for work on the
    device itself (kernels, copies, sets), not for the host calls that
    launched it."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA]


def device_summary(events, steps: int):
    """(device-busy ms, the port's kernels' ms, kernel launches, device
    ms summed over every event) per step from a profiler's
    ``key_averages()`` over ``steps`` steps. Device-busy sums the device
    events alone; the last sum also counts each kernel's time again on the
    host call that launched it (how ``device_summary`` summed until the
    graph path was added), kept to compare with earlier records."""
    dev = on_device(events)
    busy = sum(dev_us(e) for e in dev) / steps / 1e3
    ours = sum(dev_us(e) for e in dev if "drt::" in e.key) / steps / 1e3
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS) / steps
    every = sum(dev_us(e) for e in events) / steps / 1e3
    return busy, ours, launches, every


def profile_window(port, cb, steps: int):
    """One batcher ``cb`` with live slots: ``steps`` steps timed on the host
    clock, ``steps`` more under ``torch.profiler`` and ``steps`` more timed
    again. Returns a dict: host ms/step before and after the profiled
    window, device-busy ms/step, the port's kernels' ms/step, kernel
    launches, graph launches, synchronizations and device kernels per step,
    the port's kernels by name per step, and the profiler's events."""
    torch = port.torch
    from torch.profiler import ProfilerActivity, profile

    def timed_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            cb.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3
    host_ms = timed_ms()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            cb.step()
        torch.cuda.synchronize()
    again_ms = timed_ms()
    assert all(r is not None for r in cb.slots), "a slot retired"
    events = prof.key_averages()
    busy, ours, launches, every = device_summary(events, steps)
    kernels = [e for e in on_device(events)
               if not e.key.startswith(("Memcpy", "Memset"))]
    return {
        "host_ms": host_ms, "again_ms": again_ms, "busy_ms": busy,
        "ours_ms": ours, "launches": launches, "every_ms": every,
        "graph_launches": sum(e.count for e in events
                              if e.key in GRAPH_LAUNCH_CALLS) / steps,
        "syncs": sum(e.count for e in events if e.key in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize")) / steps,
        "kernels": sum(e.count for e in kernels) / steps,
        "ours": {kernel_name(e.key): e.count / steps for e in kernels
                 if "drt::" in e.key},
        "events": events,
    }


def log_window(name: str, w: dict, steps: int) -> None:
    log(f"  {name}: {w['host_ms']:.3f} ms/step on the host clock before the "
        f"profiled window, {w['again_ms']:.3f} after; device busy "
        f"{w['busy_ms']:.3f} ms/step (idle "
        f"{1 - w['busy_ms'] / w['again_ms']:.1%}); {w['launches']:.0f} "
        f"kernel launches/step, {w['graph_launches']:.0f} graph "
        f"launches/step, {w['syncs']:.0f} synchronizations/step, "
        f"{w['kernels']:.0f} kernels/step on the device; the port's "
        f"kernels {w['ours_ms']:.3f} ms/step; device ms summed over every "
        f"event, host calls included {w['every_ms']:.3f}")
    for e in sorted(w["events"], key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:5]:
        log(f"    host {e.self_cpu_time_total / steps / 1e3:7.3f} "
            f"ms/step  {e.count // steps:5d}/step  {e.key[:60]}")


def profile_batcher(port, dev, cfg, comp, steps: int = 4, graph=None):
    """Where a batcher decode step's time goes at batch 8, bf16, on the
    contiguous and the paged pool: the batch-path workload's first 8
    requests are admitted, two steps warm up, then ``profile_window``
    (no admission or retirement falls in any window). ``graph`` ({pool:
    window}) holds the graph path's windows of the same step, printed
    beside."""
    E = port.engine
    reqs = cb_requests(cfg.vocab_size)[:CB_BATCH]
    pools = {"contiguous": E.ServeConfig(batch=CB_BATCH,
                                         max_len=CB_MAX_LEN),
             "paged": E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN,
                                    kv_block=CB_BLOCK)}
    for name, scfg in pools.items():
        cb = E.ContinuousBatcher(comp, cfg, scfg, device=dev)
        for rid, toks in reqs:
            cb.submit(E.Request(rid=rid, tokens=toks.copy(), n_new=CB_NEW))
        cb.step()
        cb.step()
        w = profile_window(port, cb, steps)
        log_window(name, w, steps)
        if graph is not None and name in graph:
            g = graph[name]
            log(f"    beside the graph step: host {g['again_ms']:.3f} "
                f"against {w['again_ms']:.3f} ms/step, device busy "
                f"{g['busy_ms']:.3f} against {w['busy_ms']:.3f}, idle "
                f"{1 - g['busy_ms'] / g['again_ms']:.1%} against "
                f"{1 - w['busy_ms'] / w['again_ms']:.1%}, host launches "
                f"{g['launches'] + g['graph_launches']:.0f} against "
                f"{w['launches']:.0f} a step, device kernels "
                f"{g['kernels']:.0f} against {w['kernels']:.0f}")
        del cb


def profile_decode(port, dev, cfg, comp, steps: int = 4):
    """Where a D-Rank decode step's time goes at batch 8: host ms/step
    (timed without the profiler), device-busy ms/step and launches per
    step (``torch.profiler`` over ``steps`` more steps), and the device
    time of the port's kernels against all of it."""
    torch, T = port.torch, port.T
    from torch.profiler import ProfilerActivity, profile
    eng = port.engine.Engine(comp, cfg, port.engine.ServeConfig(),
                             device=dev)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (GEN_BATCH, 128), dtype=np.int32), device=dev)

    def step(cache, tok):
        logits, cache = T.decode_step(eng.params, cfg, cache, tok)
        return cache, torch.argmax(logits[:, -1:], -1).to(torch.int32)

    with torch.inference_mode():
        logits, cache = T.prefill(eng.params, cfg, {"tokens": prompts},
                                  max_len=128 + 3 * steps + 1)
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        cache, tok = step(cache, tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            cache, tok = step(cache, tok)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                cache, tok = step(cache, tok)
            torch.cuda.synchronize()
    events = prof.key_averages()
    busy, ours, launches, every = device_summary(events, steps)
    log(f"  {host_ms:.3f} ms/step on the host clock; device busy "
        f"{busy:.3f} ms/step (idle {1 - busy / host_ms:.1%}); "
        f"{launches:.0f} kernel launches/step; the port's kernels "
        f"{ours:.3f} ms/step of device time; device ms summed over every "
        f"event, host calls included {every:.3f}")
    if busy == 0:
        log("  device time: not measured (the profiler saw no device "
            "activity)")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"    {dev_us(e) / steps / 1e3:8.3f} ms/step  "
            f"{e.count // steps:5d}/step  {e.key[:70]}")


def parity(port, dev, cfg, comp):
    """The compressed model in float32 on the card (kernels) and on the
    CPU (plain versions): identical greedy tokens, prefill logits within
    atol 2e-3."""
    cfg32 = cfg.replace(dtype="float32")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT), dtype=np.int32)
    gpu = greedy(port, comp, cfg32, prompts, PARITY_STEPS, dev)
    cpu = greedy(port, comp, cfg32, prompts, PARITY_STEPS,
                 port.torch.device("cpu"))
    compare_greedy(port.torch, gpu, cpu)


def replica_graphs(port):
    """``serve(ServeOptions(replicas=2, aot=True, elastic=True))`` on the
    artifact: two batchers on the card, each behind its own ``FrontDoor``
    thread, each warmed on its empty pool; under the queue's pressure the
    elastic ladder's low-rung prefills are captured late, in one replica's
    thread while the other replica may be decoding. Every request must
    finish, and late captures must have happened."""
    api = port.api
    opts = api.ServeOptions(
        arch=ARCH, compressed_ckpt=str(ARTIFACT_DIR), replicas=2, aot=True,
        elastic=True, batch=CB_BATCH, max_len=CB_MAX_LEN, requests=48,
        prompt_len=64, n_new=32, watchdog_s=120.0)
    t0 = time.perf_counter()
    res = api.serve(opts)
    secs = time.perf_counter() - t0
    stats = res.report["engine_stats"]
    warm = warm_set_size(1 + opts.elastic_levels, False, CB_MAX_LEN)
    late = [s["aot_compiles"] - warm for s in stats]
    log(f"  two replicas, --aot, elastic: {res.report['drain_status']}, "
        f"{res.report['requests']} done, {res.report['generated_tokens']} "
        f"tokens in {secs:.2f} s (boot and warm included); entries after "
        f"warm, by replica, {late}; failed {len(res.failed)}")
    assert res.report["drain_status"] == "drained", res.report
    assert res.report["requests"] == opts.requests and not res.failed
    assert sum(late) > 0, "no replica captured a graph after warm"


# ---------------------------------------------------------------------------
# The launch accounting (launch/dryrun.py, launch/op_analysis.py)
# ---------------------------------------------------------------------------
def allocator_peak_blocks(torch, fn, top: int = 8):
    """The caching allocator's view of one run of ``fn``: its memory
    history replayed to the moment the most bytes were allocated, and the
    block sizes live then (size: count), largest first. For a predicted
    peak that missed."""
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        out = fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del out
    live, cur, best, best_live = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev["size"]
            cur += ev["size"]
            if cur > best:
                best, best_live = cur, dict(live)
        elif ev["action"] in ("free_requested", "free_completed"):
            cur -= live.pop(ev["addr"], 0)
    sizes = {}
    for n in best_live.values():
        sizes[n] = sizes.get(n, 0) + 1
    return best, sorted(sizes.items(), key=lambda kv: -kv[0] * kv[1])[:top]


def account_step(port, name: str, fn, args, ms: float,
                 model_flops: float) -> dict:
    """The op counter (``launch/op_analysis.py``) on one step that an
    earlier phase runs: the step counted once on the card and once on
    ``meta``, which must give identical FLOPs and bytes (both byte models,
    every op and kernel) and argument bytes; the step's own bytes at its
    peak, predicted by the meta count, against ``max_memory_allocated``
    less ``memory_allocated`` over an uncounted run of the same step, taken
    after ``reset_peak_memory_stats``, held to 10% (the allocator's blocks
    at its peak printed before it fails), and the whole peak (the arguments
    as the card counts them plus those bytes) against the prediction;
    model and counted FLOPs over
    ``ms`` (the step's time, measured by the phase) as shares of the
    card's bf16 peak; the roofline's dominant term against ``ms``."""
    torch, OA, card = port.torch, port.OA, port.card
    t0 = time.perf_counter()
    on_card = OA.count(fn, *args)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    del on_card["out"]
    meta = OA.count(fn, *OA.to_meta(args))
    del meta["out"]
    keys = ("flops", "bytes", "per_op", "kernels")
    if any(on_card[k] != meta[k] for k in keys):
        diff = {op: (on_card["per_op"].get(op), meta["per_op"].get(op))
                for op in set(on_card["per_op"]) | set(meta["per_op"])
                if on_card["per_op"].get(op) != meta["per_op"].get(op)}
        raise AssertionError(f"{name}: the card's count differs from "
                             f"meta's: {diff}; kernels {on_card['kernels']}"
                             f" against {meta['kernels']}")
    mem, card_mem = meta["memory"], on_card["memory"]
    if card_mem["argument_bytes"] != mem["argument_bytes"]:
        raise AssertionError(f"{name}: argument bytes on the card "
                             f"{card_mem['argument_bytes']}, on meta "
                             f"{mem['argument_bytes']}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn(*args)
    torch.cuda.synchronize()
    top = torch.cuda.max_memory_allocated()
    del res
    own = top - before
    own_pred = mem["peak_bytes"] - mem["argument_bytes"]
    own_miss = abs(own_pred - own) / own
    measured = card_mem["argument_bytes"] + own
    miss = abs(mem["peak_bytes"] - measured) / measured
    rf = port.dryrun.roofline(meta["flops"], meta["bytes"], 0.0,
                              model_flops, 1)
    resident = sum(k["resident"] for k in meta["kernels"].values())
    plain = sum(k["plain"] for k in meta["kernels"].values())
    out = {"flops": meta["flops"], "bytes": meta["bytes"],
           "bytes_resident": meta["bytes"] - plain + resident,
           "per_op": meta["per_op"], "kernels": meta["kernels"],
           "memory": mem, "measured_peak": measured,
           "max_memory_allocated": top, "allocated_before": before,
           "own_predicted": own_pred, "own_measured": own,
           "own_miss": own_miss, "peak_miss": miss, "ms": ms,
           "model_share": model_flops / (ms * 1e-3) / card.peak_flops,
           "counted_share": meta["flops"] / (ms * 1e-3) / card.peak_flops,
           "roofline": rf, "count_s": meta["count_s"], "card_count_s": card_s}
    needed = sum(k["flops_needed"] for k in meta["kernels"].values())
    log(f"  accounting, {name}: counted on the card ({card_s:.2f} s) and "
        f"on meta ({meta['count_s']:.2f} s), identical: "
        f"{meta['flops'] / 1e12:.4f} TFLOP, {meta['bytes'] / 1e9:.3f} GB "
        f"(kernels' intermediates resident: "
        f"{out['bytes_resident'] / 1e9:.3f} GB); kernels "
        + ", ".join(f"{k} x{v['calls']}" for k, v in meta["kernels"].items())
        + f" (their FLOPs the plain products'; what the masks keep "
        f"{needed / 1e12:.4f} T of {sum(k['flops'] for k in meta['kernels'].values()) / 1e12:.4f})")
    log(f"    the step's own bytes at its peak: predicted {own_pred} "
        f"against measured {own} (max_memory_allocated {top} less "
        f"{before} allocated before): "
        f"{'within' if own_miss <= 0.1 else 'MISSED'} 10% "
        f"({own_miss:.2%}); the whole peak: predicted "
        f"{mem['peak_bytes'] / 2 ** 30:.4f} GiB (arguments "
        f"{mem['argument_bytes'] / 2 ** 30:.4f}, the card's the same) "
        f"against {measured / 2 ** 30:.4f} GiB ({miss:.2%}); {card_line()}")
    log(f"    FLOPs over the measured {ms:.3f} ms: model "
        f"{model_flops / 1e12:.4f} T = {out['model_share']:.2%}, counted "
        f"{out['counted_share']:.2%} of 989 TFLOP/s bf16; roofline "
        f"compute {rf['compute_s'] * 1e3:.3f} ms, memory "
        f"{rf['memory_s'] * 1e3:.3f} ms (resident "
        f"{out['bytes_resident'] / card.hbm_bytes_per_s * 1e3:.3f}): "
        f"dominant {rf['dominant']} "
        f"{max(rf['compute_s'], rf['memory_s']) * 1e3:.3f} ms against "
        f"{ms:.3f} ms measured")
    if own_miss > 0.1:
        best, sizes = allocator_peak_blocks(torch, lambda: fn(*args))
        log(f"    the allocator's history at its peak ({best} bytes of the "
            f"step's blocks): " + ", ".join(f"{n} B x{c}" for n, c in sizes))
        raise AssertionError(f"{name}: the step's own peak bytes predicted "
                             f"{own_pred}, measured {own} ({own_miss:.2%} "
                             f"off, the tier 10%)")
    return out


def accounting_phase(port, dev, cfg, comp) -> dict:
    """The op counter on a D-Rank decode step of the batcher's shape
    (batch 8, max_len 256, contiguous pool, live lengths 73-80) and on one
    prefill of 512 rows (8 x 64), each on the card and on meta; then three
    full-size cells counted on meta alone on a (1, 1) mesh
    (``launch/dryrun.account_cell``)."""
    torch, T, D = port.torch, port.T, port.dryrun
    params = port.engine.place_params(comp, T.dtype_of(cfg.dtype), dev)
    out = {}
    rng = np.random.default_rng(11)
    cache = T.init_cache(cfg, CB_BATCH, CB_MAX_LEN, device=dev)
    cache["pos"].copy_(torch.arange(72, 72 + CB_BATCH, device=dev))
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (CB_BATCH, 1),
                                       dtype=np.int32), device=dev)

    def decode(p, c, t):
        with torch.no_grad():
            return T.decode_step(p, cfg, c, t)[0]

    ms = host_ms(torch, lambda: decode(params, cache, tok))
    mf = D.model_flops(cfg, D.ShapeConfig("chip_decode", CB_MAX_LEN,
                                          CB_BATCH, "decode"), params)
    out["decode"] = account_step(
        port, f"D-Rank decode step (batch {CB_BATCH}, max_len "
        f"{CB_MAX_LEN})", decode, (params, cache, tok), ms, mf)
    del cache
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int32),
        device=dev)

    def prefill(p, b):
        with torch.no_grad():
            return T.prefill(p, cfg, b, max_len=GEN_PROMPT + GEN_NEW + 1)

    batch = {"tokens": prompts}
    ms = host_ms(torch, lambda: prefill(params, batch))
    mf = D.model_flops(cfg, D.ShapeConfig("chip_prefill", GEN_PROMPT,
                                          GEN_BATCH, "prefill"), params)
    out["prefill"] = account_step(
        port, f"D-Rank prefill ({GEN_BATCH} x {GEN_PROMPT} = "
        f"{GEN_BATCH * GEN_PROMPT} rows)", prefill, (params, batch), ms, mf)
    del params
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1, 1), ("data", "model"), rank=0, build_groups=False)
    out["cells"] = {}
    for arch, shape in ACCOUNT_CELLS:
        res = D.account_cell(arch, shape, mesh)
        m, rf = res["memory"], res["roofline"]
        out["cells"][f"{arch}/{shape}"] = {
            "fits": res["fits"], "count_s": res["count_s"],
            "peak_bytes": m["peak_bytes"], "dominant": rf["dominant"]}
        log(f"  {arch} x {shape} on a (1, 1) mesh, counted on meta in "
            f"{res['count_s']:.2f} s: peak {m['peak_bytes'] / 1e9:.1f} GB "
            f"(arguments {m['argument_bytes'] / 1e9:.1f}), fits "
            f"{res['fits']}; {res['cost']['counted_flops'] / 1e15:.2f} "
            f"PFLOP counted, model {res['model_flops'] / 1e15:.2f}; "
            f"dominant {rf['dominant']} "
            f"({max(rf['compute_s'], rf['memory_s']):.3f} s)")
    return out


def host_ms(torch, fn, reps: int = 3) -> float:
    """Host ms of ``fn`` between syncs, mean of ``reps`` runs after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# ---------------------------------------------------------------------------
# The training path: Trainer, resume, card against CPU, compress the
# trained model, LoRA, and the train / serve --ckpt CLIs
# ---------------------------------------------------------------------------
def cut_layers(port, params, n: int):
    """The first ``n`` layers of a one-run stacked params tree."""
    run = port.pytree.tree_map(lambda t: t[:n], params["decoder"]["run0"])
    return dict(params, decoder={"run0": run})


def profile_train_step(port, step_fn, state, batch):
    """One train step under ``torch.profiler``: (host ms, device-busy ms,
    the port's kernels' ms, kernel launches, device kernels, the five
    device kernels that took longest, with their ms and counts)."""
    torch = port.torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    del out
    events = prof.key_averages()
    busy, ours, launches, _ = device_summary(events, 1)
    kernels = [e for e in on_device(events)
               if not e.key.startswith(("Memcpy", "Memset"))]
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return (host, busy, ours, launches, sum(e.count for e in kernels),
            [(e.key[:70], dev_us(e) / 1e3, e.count) for e in top])


def train_path(port, dev):
    """SmolLM-360M at full size, float32 params, bf16 compute, remat
    "block", seed 0, with every launch count set to 0 just before and read
    just after. Returns ({kernel: launches}, {metric: value})."""
    import os
    torch, TS, CC, loop = port.torch, port.TS, port.compress, port.loop
    cfg = port.get_config(ARCH)
    assert cfg.remat == "block" and cfg.param_dtype == "float32"
    dcfg = port.synthetic.DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH)
    tcfg = TS.TrainConfig(microbatches=TRAIN_MICRO,
                          optimizer=port.adamw.OptimizerConfig(
                              lr=TRAIN_LR, warmup_steps=2,
                              total_steps=TRAIN_STEPS))
    out = {}
    port.reset_counts()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # (a) train: an async checkpoint at step 3, the final save at 6
    lcfg = loop.LoopConfig(total_steps=TRAIN_STEPS, ckpt_dir=str(TRAIN_DIR),
                           ckpt_every=TRAIN_STEPS // 2, log_every=1)
    submits, saves = [], []
    torch.cuda.reset_peak_memory_stats()
    with timed(torch, port.store.AsyncCheckpointer, "submit", submits), \
            timed(torch, port.store, "save", saves):
        t0 = time.perf_counter()
        tr = loop.Trainer(cfg, tcfg, dcfg, lcfg, seed=0)
        res = tr.run()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [h["loss"] for h in res["history"]]
    n_params = port.T.param_count(tr.state.params)
    log(f"  Trainer: {n_params / 1e6:.1f} M params, {TRAIN_STEPS} steps "
        f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
        f"microbatches, {time.perf_counter() - t0:.2f} s with init and "
        f"checkpoints, peak memory {peak:.2f} GiB; losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    log(f"  AsyncCheckpointer.submit (a host copy of "
        f"{n_params * 3 * 4 / 1e9:.2f} GB) ms " + ", ".join(
            f"{x * 1e3:.1f}" for x in submits) + "; store.save seconds "
        + ", ".join(f"{x:.2f}" for x in saves)
        + f" (the async writes at steps {TRAIN_STEPS // 2} and "
        f"{TRAIN_STEPS}, ckpt_every dividing the run as in the JAX loop, "
        f"then the final synchronous one)")
    out["submit_ms"] = [x * 1e3 for x in submits]
    out["save_s"] = saves
    assert res["final_step"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
    assert all(np.isfinite(losses)), f"non-finite loss: {losses}"
    assert sorted(os.listdir(TRAIN_DIR)) == [
        "LATEST", f"step_{TRAIN_STEPS // 2:09d}", f"step_{TRAIN_STEPS:09d}"]

    # (b) resume from the middle step, as after a preemption just past its
    # checkpoint: the last step's directory gone, LATEST back at it
    shutil.rmtree(TRAIN_DIR / f"step_{TRAIN_STEPS:09d}")
    (TRAIN_DIR / "LATEST").write_text(f"step_{TRAIN_STEPS // 2:09d}")
    t0 = time.perf_counter()
    tr2 = loop.Trainer(cfg, tcfg, dcfg, lcfg, seed=0)
    restore_s = time.perf_counter() - t0
    assert tr2.start_step == TRAIN_STEPS // 2, tr2.start_step
    res2 = tr2.run()
    torch.cuda.synchronize()
    l6, r6 = losses[-1], res2["history"][-1]["loss"]
    dmax = max(float((a - b).abs().max()) for a, b in zip(
        port.pytree.leaves(tr2.state.params),
        port.pytree.leaves(tr.state.params)))
    same = all(torch.equal(a, b) for a, b in zip(
        port.pytree.leaves(tr2.state), port.pytree.leaves(tr.state)))
    log(f"  resume from step {TRAIN_STEPS // 2} (Trainer boot with restore "
        f"{restore_s:.2f} s): step-{TRAIN_STEPS} loss {r6:.6f} against the "
        f"continuous run's {l6:.6f} (rel {abs(r6 - l6) / abs(l6):.2e}, "
        f"tolerance 1e-4); largest |Δparam| {dmax:.3e}; state "
        f"{'bit-identical' if same else 'not bit-identical (the embedding backward adds with atomics on CUDA, so bits may differ)'}")
    assert abs(r6 - l6) <= 1e-4 * abs(l6), (r6, l6)
    del tr2, res2
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # the step alone, from the trained state: host ms and tokens/s over 3
    # steps after a warm one, then one profiled step and its flash launches
    step_fn = TS.make_train_step(cfg, tcfg)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in tr.loader.batch(0).items()}
    state = tr.state
    ms = host_ms(torch, lambda: step_fn(state, batch))
    f0 = port.wrappers["flash_attention"].launches
    host, busy, ours, launches, kernels, top = profile_train_step(
        port, step_fn, state, batch)
    flash_step = port.wrappers["flash_attention"].launches - f0
    shape = port.dryrun.ShapeConfig("chip_train", TRAIN_SEQ, TRAIN_BATCH,
                                    "train")
    flops = port.dryrun.model_flops(cfg, shape, state.params)
    acct = account_step(port, f"train step ({TRAIN_BATCH} x {TRAIN_SEQ}, "
                        f"{TRAIN_MICRO} microbatches)", step_fn,
                        (state, batch), ms, flops)
    del state
    tokens = TRAIN_BATCH * TRAIN_SEQ
    share = flops / (ms * 1e-3) / port.card.peak_flops
    # QKᵀ and PV: the flash kernels' (forward and remat recompute) and the
    # flash backward's, traced (its recompute and its grads: the step's
    # only batched products)
    attention = (acct["kernels"]["flash_attention"]["flops"]
                 + acct["per_op"].get("bmm", {}).get("flops", 0.0))
    log(f"  train step: {ms:.2f} ms/step, {tokens / ms * 1e3:.0f} tokens/s "
        f"(host clock between syncs, 3 steps); model FLOPs "
        f"{flops / 1e12:.3f} T a step (6·N·D, launch/dryrun.model_flops), "
        f"{share:.2%} of 989 TFLOP/s bf16; counted "
        f"{acct['flops'] / 1e12:.3f} T ({acct['counted_share']:.2%}), of "
        f"them attention {attention / 1e12:.3f} T (QKᵀ and PV of the flash "
        f"forward, its remat recompute and its backward, counted apart "
        f"from the model FLOPs); flash launches a step "
        f"{flash_step:.0f} (expected {2 * cfg.n_layers * TRAIN_MICRO}: "
        f"forward and remat recompute, per layer and microbatch)")
    log(f"  profiled step: {host:.2f} ms on the host clock under the "
        f"profiler, device busy {busy:.2f} ms: idle {1 - busy / host:.1%} "
        f"of the profiled step (an estimate for the unprofiled steps, "
        f"this busy time over their {ms:.2f} ms: {1 - busy / ms:.1%}); "
        f"the port's kernels {ours:.3f} ms, {launches:.0f} kernel "
        f"launches, {kernels} device kernels; longest: " + "; ".join(
            f"{k} {t:.2f} ms x{n}" for k, t, n in top))
    assert flash_step == 2 * cfg.n_layers * TRAIN_MICRO, flash_step
    out.update(ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
               flop_share=share, idle=1 - busy / host,
               idle_estimate=1 - busy / ms, peak_gib=peak,
               flash_per_step=flash_step, busy_ms=busy,
               launches_per_step=launches, accounting=acct,
               attention_flops=attention)

    # (c) float32, card against CPU: one train step of a 2-layer SmolLM
    # from the same weights, TF32 off, at lr 1e-3 from its first step. The
    # step's two halves are held apart, each leaf relative to its largest
    # entry: the grads of lm_loss, and the params that the card's AdamW
    # makes from the CPU's grads. The limit must fail a leaf left
    # unchanged, stepped the wrong way, or given zero or negated grads: the
    # run reads those too. Adam's first update is lr·g/(|g|+eps), which
    # sends a grad entry near eps to ±lr whatever its last bits, so the
    # whole step's params (the card's grads through the card's AdamW) are
    # printed, not held.
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg4 = cfg.replace(n_layers=TRAIN_PARITY_LAYERS, dtype="float32")
    ocfg = port.adamw.OptimizerConfig(lr=1e-3, warmup_steps=1)
    state_cpu, _ = TS.init_train_state(cfg4, seed=1, device="cpu")
    state_gpu = port.pytree.tree_map(lambda t: t.to(dev), state_cpu)
    b4 = port.synthetic.ShardedLoader(port.synthetic.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=PARITY_TRAIN_SEQ,
        global_batch=PARITY_TRAIN_ROWS)).batch(0)
    leaves, update = port.pytree.leaves, port.adamw.adamw_update
    t0 = time.perf_counter()
    l_cpu, _, g_cpu = TS.value_and_grad(
        state_cpu.params, cfg4, {k: torch.as_tensor(v) for k, v in b4.items()})
    p_cpu, _, _ = update(ocfg, g_cpu, state_cpu.opt, state_cpu.params)
    cpu_s = time.perf_counter() - t0
    l_gpu, _, g_gpu = TS.value_and_grad(
        state_gpu.params, cfg4,
        {k: torch.as_tensor(v, device=dev) for k, v in b4.items()})
    p_gpu, _, _ = update(ocfg, g_gpu, state_gpu.opt, state_gpu.params)
    p_opt, _, _ = update(ocfg, port.pytree.tree_map(lambda t: t.to(dev),
                                                    g_cpu),
                         state_gpu.opt, state_gpu.params)
    lc, lg = float(l_cpu), float(l_gpu)

    def per_leaf(got, want):
        return [rel_err(x.cpu(), y) for x, y in zip(leaves(got),
                                                     leaves(want))]

    g_err = max(per_leaf(g_gpu, g_cpu))
    p_err = max(per_leaf(p_opt, p_cpu))
    p_neg, _, _ = update(ocfg, port.pytree.tree_map(torch.neg, g_cpu),
                         state_cpu.opt, state_cpu.params)
    # the least that a single leaf reads when it alone is wrong
    ctrl = {"zero grads": min(per_leaf(port.pytree.tree_map(
                torch.zeros_like, g_cpu), g_cpu)),
            "negated grads": min(per_leaf(port.pytree.tree_map(
                torch.neg, g_cpu), g_cpu)),
            "params unchanged": min(per_leaf(state_cpu.params, p_cpu)),
            "params stepped the wrong way": min(per_leaf(p_neg, p_cpu))}
    step_p = max(per_leaf(p_gpu, p_cpu))
    # the grad at the entry where the whole step's params differ most
    g_at = max(((x.cpu() - y).abs().max(), g.flatten()[
        (x.cpu() - y).abs().argmax()].abs()) for x, y, g in zip(
            leaves(p_gpu), leaves(p_cpu), leaves(g_cpu)))[1]
    log(f"  float32 step, {TRAIN_PARITY_LAYERS} layers, {PARITY_TRAIN_ROWS} x "
        f"{PARITY_TRAIN_SEQ} tokens, lr 1e-3: loss card {lg:.7f}, CPU "
        f"{lc:.7f} (rel {abs(lg - lc) / abs(lc):.2e}, tolerance 1e-5); "
        f"each leaf relative to its largest entry: grads {g_err:.2e}, "
        f"params from the card's AdamW on the CPU's grads {p_err:.2e} "
        f"(tolerance 1e-4); one leaf alone wrong reads at least "
        + ", ".join(f"{k} {v:.2e}" for k, v in ctrl.items())
        + f"; the card's whole step's params {step_p:.2e}, most where the "
        f"CPU's grad is {float(g_at):.2e} (not held: Adam's first step "
        f"scales a grad entry near eps={ocfg.eps:g} to ±lr); CPU step "
        f"{cpu_s:.2f} s")
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    assert g_err <= 1e-4, g_err
    assert p_err <= 1e-4, p_err
    assert min(ctrl.values()) > 1e-4, ctrl
    out["train_parity"] = dict(loss=abs(lg - lc) / abs(lc), grads=g_err,
                               params=p_err, step_params=step_p,
                               controls=ctrl)
    del state_cpu, state_gpu, g_cpu, g_gpu, p_cpu, p_gpu, p_opt, p_neg

    # (d) compress the trained model: D-Rank and fwsvd 20% on the card,
    # fwsvd's ranks against the host oracle at TRAIN_PARITY_LAYERS layers
    trained = tr.state.params
    calib = calib_batches(port, cfg, dev)
    held = [{k: torch.as_tensor(v, device=dev) for k, v in
             tr.loader.batch(PPL_STEP0 + i).items()} for i in range(4)]
    t0 = time.perf_counter()
    col = CC.calibrate(port.capture.to_list_params(trained, cfg), cfg, calib,
                       flush_every=FLUSH_EVERY)
    comps, secs = {}, {"calibration": time.perf_counter() - t0}
    for method in ("drank", "fwsvd"):
        t0 = time.perf_counter()
        comps[method] = CC.build_plan_and_params(
            trained, cfg, CC.CompressionConfig(method=method, ratio=0.2),
            calib, collector=col, device=True)
        torch.cuda.synchronize()
        secs[method] = time.perf_counter() - t0
    del col
    cfg_o = cfg.replace(n_layers=TRAIN_PARITY_LAYERS, dtype="float32")
    p_o = cut_layers(port, trained, TRAIN_PARITY_LAYERS)
    t0 = time.perf_counter()
    plans = {d: CC.build_plan_and_params(
        p_o, cfg_o, CC.CompressionConfig(method="fwsvd", ratio=0.2), calib,
        device=d) for d in (False, True)}
    secs["oracle"] = time.perf_counter() - t0
    (lp_h, plan_h), (lp_d, plan_d) = plans[False], plans[True]
    ks_h = [(g.gid, g.k) for g in plan_h.groups]
    ks_d = [(g.gid, g.k) for g in plan_d.groups]
    fac = max(float((d["B"].double() @ d["C"].double()
                     - h["B"].double() @ h["C"].double()).abs().max()
                    / (h["B"].double() @ h["C"].double()).abs().max())
              for d, h in zip(linears(lp_d), linears(lp_h)))
    log(f"  compress the trained model: calibration {secs['calibration']:.2f}"
        f" s; D-Rank 20% {secs['drank']:.2f} s (ratio "
        f"{comps['drank'][1].summary['achieved_ratio']:.4f}); fwsvd 20% "
        f"{secs['fwsvd']:.2f} s (ratio "
        f"{comps['fwsvd'][1].summary['achieved_ratio']:.4f}); fwsvd at "
        f"{TRAIN_PARITY_LAYERS} layers, float32 ({secs['oracle']:.2f} s, host and "
        f"device): {len(ks_h)} groups, ranks "
        f"{'equal' if ks_h == ks_d else 'DIFFER'} host and device, B·C "
        f"max-relative {fac:.3e} (tolerance {FACTOR_TOL:.0e})")
    assert ks_h == ks_d, "fwsvd's device ranks differ from the host's"
    assert fac < FACTOR_TOL, "fwsvd's device factors disagree with the host"
    del plans, lp_h, lp_d, p_o

    # (e) LoRA on the D-Rank model: 4 steps, rank 8, alpha 32, lr 1e-4
    lora_batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                     tr.loader.batch(LORA_STEP0 + i).items()}
                    for i in range(LORA_STEPS)]
    v0 = port.variant_counts()["lowrank_matmul_2d"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lora_p, lora_hist = port.lora.lora_finetune(
        comps["drank"][0], cfg, lora_batches, steps=LORA_STEPS, rank=8,
        alpha=32.0, lr=1e-4)
    torch.cuda.synchronize()
    lora_ms = (time.perf_counter() - t0) / LORA_STEPS * 1e3
    v1 = port.variant_counts()["lowrank_matmul_2d"]
    lora_v = {k: v1[k] - v0[k] for k in v1}
    log(f"  LoRA on D-Rank 20%: {LORA_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, {lora_ms:.1f} ms/step (the first step's warm-up "
        f"included); losses " + ", ".join(
            f"{h['loss']:.4f}" for h in lora_hist)
        + f"; 2-D product launches by variant {lora_v}")
    assert all(np.isfinite([h["loss"] for h in lora_hist]))
    assert lora_v["wgmma"] > 0 and sum(lora_v.values()) == lora_v["wgmma"], \
        f"a bf16 2-D launch of the LoRA steps left wgmma: {lora_v}"
    out["lora_ms"] = lora_ms
    ppl = {name: TS.evaluate_ppl(p, cfg, held) for name, p in (
        ("dense (trained)", trained), ("D-Rank 20%", comps["drank"][0]),
        ("fwsvd 20%", comps["fwsvd"][0]), ("D-Rank 20% + LoRA", lora_p))}
    log(f"  perplexity on 4 held-out batches of synthetic data (random init "
        f"+ {TRAIN_STEPS} steps, not a language model): " + ", ".join(
            f"{k} {v['ppl']:.2f}" for k, v in ppl.items()))
    assert all(np.isfinite(v["ppl"]) for v in ppl.values())
    out["ppl"] = {k: v["ppl"] for k, v in ppl.items()}
    del comps, lora_p, tr

    # (f) the CLIs: train 2 steps, then serve that checkpoint in a
    # subprocess and in this process
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    try:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             ARCH, "--steps", "2", "--global-batch", "4", "--seq-len", "64",
             "--warmup", "1", "--log-every", "1", "--ckpt-dir",
             str(CLI_TRAIN_DIR)], cwd=str(ROOT), env=env,
            capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, f"launch.train exited {r.returncode}: " \
            f"{r.stderr[-3000:]}"
        rows = [json.loads(ln) for ln in r.stdout.splitlines()
                if ln.startswith("{")]
        log(f"  launch.train: exit 0 in {time.perf_counter() - t0:.1f} s, "
            f"losses {[round(x['loss'], 4) for x in rows]}; "
            f"{r.stderr.strip().splitlines()[-1]}")
        assert [x["step"] for x in rows] == [1, 2]
        args = ["--arch", ARCH, "--ckpt", str(CLI_TRAIN_DIR), "--requests",
                "4", "--batch", "4", "--max-len", "128", "--prompt-len",
                "32", "--n-new", "8"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *args],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        mine = port.api.serve(port.launch.parse_serve_options(args))
        sout, serr = proc.communicate(timeout=600)
        assert proc.returncode == 0, \
            f"launch.serve --ckpt exited {proc.returncode}: {serr[-3000:]}"
        report = json.loads(sout[sout.rindex("\n{\n") + 1:])
        log(f"  launch.serve --ckpt: exit 0 in {time.perf_counter() - t0:.1f}"
            f" s, {report['drain_status']}, "
            f"{report['generated_tokens']} tokens; tokens "
            f"{'equal' if report['tokens_digest'] == mine.report['tokens_digest'] else 'DIFFER'}"
            f" to serve(ServeOptions(ckpt=...)) in this process")
        assert report["drain_status"] == "drained"
        assert report["tokens_digest"] == mine.report["tokens_digest"], \
            "launch.serve --ckpt gave other tokens than serve(ckpt=...)"
    finally:
        shutil.rmtree(CLI_TRAIN_DIR, ignore_errors=True)
    counts = port.counts()
    log(f"  launches on the training path: {counts}; by variant "
        f"{port.variant_counts()}")
    for name in TRAIN_KERNELS:
        assert counts[name] > 0, f"{name} never launched on the training path"
    return counts, out


# ---------------------------------------------------------------------------
# The MoE path: granite-moe-1b-a400m at full width (MOE_LAYERS),
# qwen2-moe-a2.7b at full width
# ---------------------------------------------------------------------------
class DropCounter:
    """Within the block, counts the top-k assignments the MoE layers'
    capacity dropped, by wrapping the port's
    ``models.mlp._dispatch_to_buffers``: the layer calls it three times
    (the T·k repeated rows to the one shard, their meta rows, then the
    received rows to the experts), and an assignment is dropped where the
    second-level dispatch did not keep one of its first T·k rows, which
    are the repeated rows in order (the first level keeps every row at
    expert parallelism 1: its capacity is at least T·k, asserted). The
    count adds up on the device; ``dropped`` reads it."""

    def __init__(self, port):
        self.mlp, self.torch = port.mlp, port.torch
        self.total = None
        self.assigned = 0
        self.calls = 0

    def __enter__(self):
        inner = self.inner = self.mlp._dispatch_to_buffers

        def spy(x, dest, n_dest, capacity):
            buf, slot, kept = inner(x, dest, n_dest, capacity)
            if self.calls % 3 == 0:
                assert n_dest == 1 and capacity >= x.shape[0], \
                    (n_dest, capacity, x.shape)
                self.rows = x.shape[0]
                self.assigned += self.rows
            elif self.calls % 3 == 2:
                lost = (~kept[:self.rows]).sum()
                self.total = lost if self.total is None else self.total + lost
            self.calls += 1
            return buf, slot, kept
        self.mlp._dispatch_to_buffers = spy
        return self

    def __exit__(self, *exc):
        self.mlp._dispatch_to_buffers = self.inner
        return False

    @property
    def dropped(self) -> int:
        return 0 if self.total is None else int(self.total)


@contextlib.contextmanager
def route_recorder(port):
    """Within the block, every call of the port's router
    (``models.mlp.route``) keeps its float32 probabilities and top-k expert
    ids, in call order, in the list it yields."""
    mlp, calls = port.mlp, []
    inner = mlp.route

    def spy(router_w, m, x):
        probs, gates, ids = inner(router_w, m, x)
        calls.append((probs.detach(), ids.detach()))
        return probs, gates, ids
    mlp.route = spy
    try:
        yield calls
    finally:
        mlp.route = inner


def route_flips(torch, card, cpu, k: int, passes: list):
    """The card's routing against the CPU's, call by call, ``passes`` the
    number of router calls of each forward pass in order. Within a pass a
    flip at token t (flattened order, which is the dispatch's row order)
    can change the expert slots of later tokens only, so the comparison
    stops at the first flip's token: a top-k set may differ only where the
    CPU's k-th and (k+1)-th probabilities are within ROUTE_GAP (any other
    difference fails). After a pass with a flip nothing more is compared.
    Returns (flips [(pass, call, token, gap)], the first flipped pass or
    None, the token cut of each compared pass)."""
    flips, cuts, c = [], [], 0
    for p, n in enumerate(passes):
        cut = None
        for _ in range(n):
            (_, ids_g), (probs_c, ids_c) = card[c], cpu[c]
            lim = ids_c.shape[0] if cut is None else cut
            g = torch.sort(ids_g[:lim].cpu(), dim=-1).values
            h = torch.sort(ids_c[:lim], dim=-1).values
            for t in torch.nonzero((g != h).any(-1)).flatten().tolist():
                top = torch.topk(probs_c[t], k + 1).values
                gap = float(top[k - 1] - top[k])
                log(f"    routing flip: pass {p}, router call {c}, token "
                    f"{t}: card {g[t].tolist()} cpu {h[t].tolist()}, cpu "
                    f"gap between the k-th and (k+1)-th probability "
                    f"{gap:.3e} (allowed up to {ROUTE_GAP:.0e})")
                assert gap <= ROUTE_GAP, \
                    "the card routed a token the CPU's margin does not allow"
                flips.append((p, c, t, gap))
                cut = t if cut is None else min(cut, t)
                break
            c += 1
        cuts.append(cut)
        if cut is not None:
            return flips, p, cuts
    return flips, None, cuts


def moe_parity(port, dev, cfg, params, prompts, lengths, steps: int,
               name: str) -> dict:
    """``params`` in float32 on the card (kernels) and on the CPU (plain
    versions): teacher-forced logits of ``prompts`` within LOGITS_ATOL and
    greedy tokens (``steps`` new) identical, each held up to the first
    routing flip ``route_flips`` allows. Returns the padding experts'
    assignments (ids >= num_experts) counted over both runs."""
    torch, T, E = port.torch, port.T, port.engine
    cfg32 = cfg.replace(dtype="float32")
    cpu = torch.device("cpu")
    k, B, S = cfg.moe.top_k, *prompts.shape
    n_layers = cfg.n_layers
    logits, routes, secs = {}, {}, {}
    where = {"card": dev, "cpu": cpu}
    for w, d in where.items():
        p = E.place_params(params, torch.float32, d)
        t0 = time.perf_counter()
        with torch.inference_mode(), route_recorder(port) as calls:
            logits[w] = T.forward(p, cfg32, {
                "tokens": torch.as_tensor(prompts, device=d)})[0].cpu()
        routes[w] = calls
        secs[w] = time.perf_counter() - t0
        del p
    flips, first, cuts = route_flips(torch, routes["card"], routes["cpu"], k,
                                     [n_layers])
    cut = B * S if cuts[0] is None else cuts[0]
    lg = logits["card"].reshape(B * S, -1)[:cut]
    lc = logits["cpu"].reshape(B * S, -1)[:cut]
    tf = abs_err(lg, lc)
    pad = sum(int((ids >= cfg.moe.num_experts).sum())
              for r in routes.values() for _, ids in r)
    log(f"  {name}: teacher-forced logits of {B} x {S} tokens, max |card - "
        f"cpu| {tf:.3e} over the first {cut} tokens (atol "
        f"{LOGITS_ATOL:.0e}); {len(flips)} routing flips; card "
        f"{secs['card']:.1f} s, cpu {secs['cpu']:.1f} s")
    assert tf < LOGITS_ATOL, f"{name}: teacher-forced logits differ"
    del logits, routes
    outs, routes = {}, {}
    for w, d in where.items():
        with route_recorder(port) as calls:
            outs[w] = greedy(port, params, cfg32, prompts, steps, d, lengths)
        routes[w] = calls
    flips, first, _ = route_flips(torch, routes["card"], routes["cpu"], k,
                                  [n_layers] * (steps + 1))
    held = steps + 1 if first is None else first
    gpu, cpu_out = outs["card"][:held], outs["cpu"][:held]
    pad += sum(int((ids >= cfg.moe.num_experts).sum())
               for r in routes.values() for _, ids in r)
    if held:
        diffs = [abs_err(a, b) for a, b in zip(gpu, cpu_out)]
        toks_g = [s[:, -1].argmax(-1) for s in gpu]
        toks_c = [s[:, -1].argmax(-1) for s in cpu_out]
        same = all(torch.equal(a, b) for a, b in zip(toks_g, toks_c))
        log(f"  {name}: greedy, {steps} new tokens: held over {held} of "
            f"{steps + 1} passes ({len(flips)} routing flips); prefill "
            f"logits max |card - cpu| {diffs[0]:.3e}, over the held steps "
            f"{max(diffs):.3e}; tokens identical: {same}")
        assert diffs[0] < LOGITS_ATOL, f"{name}: prefill logits differ"
        assert same, f"{name}: greedy tokens differ between card and CPU"
    else:
        log(f"  {name}: greedy: a routing flip in the prefill, nothing held")
    return {"flips": len(flips), "padding_assignments": pad,
            "teacher_forced": tf}


def moe_path(port, dev):
    """granite-moe-1b-a400m at full width, MOE_LAYERS of its 24 layers (32
    experts top-8, random weights from seed 0): streaming calibration with every expert
    tag's Gram through the kernel, D-Rank 20% on the card, save, boot,
    generate. Every kernel call is recorded (``recording``). Returns (cfg,
    params, compressed params, plan, calibration batches, recorded calls,
    seconds)."""
    torch, T, CC, E = port.torch, port.T, port.compress, port.engine
    Cap = port.capture
    cfg = port.get_config(MOE).replace(n_layers=MOE_LAYERS)
    n_exp = cfg.moe.padded_experts
    secs, ingest, chunks, integ = {}, [], [], []
    t0 = time.perf_counter()
    params, _ = T.init_model(cfg, seed=MOE_SEED, device=dev)
    torch.cuda.synchronize()
    log(f"  init_model: {T.param_count(params) / 1e9:.3f} B params, "
        f"{time.perf_counter() - t0:.1f} s")
    calib = calib_batches(port, cfg, dev)
    with recording(port) as calls:
        t0 = time.perf_counter()
        with timed(torch, Cap.StreamingCalibrator, "ingest", ingest):
            col = CC.calibrate(Cap.to_list_params(params, cfg), cfg, calib,
                               flush_every=FLUSH_EVERY)
        torch.cuda.synchronize()
        secs["calibration"] = time.perf_counter() - t0
        grams = port.wrappers["gram_blocked"].launches
        experts = [t for t in col.gram if "/expert" in t]
        log(f"  streaming calibration: {len(col.gram)} Grams a batch "
            f"({len(experts)} of them experts', capacity "
            f"{col.count[experts[0]] // len(calib)} rows a batch), "
            f"{grams} gram_blocked launches over {len(calib)} batches of "
            f"{CALIB_BATCH} x {CALIB_SEQ} tokens, {secs['calibration']:.2f} "
            f"s (ingest per batch " + ", ".join(f"{t:.3f}" for t in ingest)
            + " s)")
        assert len(experts) == cfg.n_layers * 2 * n_exp, len(experts)
        assert grams == len(col.gram) * len(calib), grams

        t0 = time.perf_counter()
        with timed(torch, CC, "_decompose_chunk", chunks), \
                timed(torch, CC.alloc, "integerize", integ):
            comp, plan = CC.build_plan_and_params(
                params, cfg, CC.CompressionConfig(method="drank",
                                                  ratio=MOE_RATIO),
                calib, collector=col, device=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        secs["decomposition"] = sum(chunks)
        secs["integerize"] = sum(integ)
        secs["allocation and assembly"] = total - sum(chunks)
        del col
        n_x = sum(g.mtype.startswith("x") for g in plan.groups)
        ks = {}
        for g in plan.groups:
            ks.setdefault(g.mtype, []).append(g.k)
        log(f"  D-Rank {MOE_RATIO:.0%}: achieved ratio "
            f"{plan.summary['achieved_ratio']:.4f} (requested {MOE_RATIO}) "
            f"over {len(plan.groups)} groups ({n_x} expert, "
            f"{len(plan.groups) - n_x} attention); ranks by type " + ", ".join(
                f"{t} {min(v)}..{max(v)}" for t, v in sorted(ks.items()))
            + f"; {total:.2f} s: device decomposition "
            f"{secs['decomposition']:.2f} s in {len(chunks)} chunks, "
            f"allocation and assembly "
            f"{secs['allocation and assembly']:.2f} s (integerize "
            f"{secs['integerize']:.2f} s)")
        assert n_x == cfg.n_layers * 3 * n_exp, n_x
        assert len(plan.groups) - n_x == cfg.n_layers * 4

        shutil.rmtree(MOE_ARTIFACT_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        path = CC.save_plan(str(MOE_ARTIFACT_DIR), comp, plan, cfg)
        secs["save"] = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        scfg = E.ServeConfig(batch=GEN_BATCH,
                             max_len=GEN_PROMPT + GEN_NEW + 1)
        t0 = time.perf_counter()
        booted = E.Engine.from_compressed(str(MOE_ARTIFACT_DIR), cfg, scfg,
                                          verify=True, device=dev)
        torch.cuda.synchronize()
        secs["boot"] = time.perf_counter() - t0
        assert booted.plan.to_json() == plan.to_json(), "plan changed on disk"
        log(f"  save_plan: {nbytes / 1e6:.1f} MB, {secs['save']:.2f} s; "
            f"from_compressed(verify=True): {secs['boot']:.2f} s")
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)
        t0 = time.perf_counter()
        toks = booted.generate(prompts, GEN_NEW)
        torch.cuda.synchronize()
        secs["generate"] = time.perf_counter() - t0
        toks_mem = E.Engine(comp, cfg, scfg, device=dev).generate(prompts,
                                                                  GEN_NEW)
        torch.cuda.synchronize()
    counts, variants = port.counts(), port.variant_counts()
    log(f"  generate from the artifact: {GEN_BATCH} x {GEN_PROMPT} prompt "
        f"tokens, {GEN_NEW} new each, {secs['generate']:.2f} s; first "
        f"tokens of row 0 {toks[0, :8].tolist()}")
    log(f"  launches: {counts}; by variant {variants}")
    log("  MoE compression seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    for name in TC_KERNELS:
        assert variants[name]["wgmma"] > 0 and variants[name]["simt"] == 0, \
            f"{name} left its tensor-core variant on the bf16 MoE path"
    assert_gemv(variants["lowrank_gemv"], "bfloat16", "the MoE path")
    missing = [n for n, c in counts.items()
               if c <= 0 and n != "decode_attention_paged"]
    assert not missing, f"kernels not launched on the MoE path: {missing}"
    assert toks.shape == (GEN_BATCH, GEN_NEW)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of range"
    assert (toks == toks_mem).all(), \
        "the MoE artifact's engine and the in-memory engine disagree"
    secs["artifact_mb"] = nbytes / 1e6
    secs["achieved_ratio"] = plan.summary["achieved_ratio"]
    return cfg, params, comp, plan, calib, calls, secs


def moe_batcher_path(port, dev, cfg, params, comp):
    """The continuous batcher on the MoE artifact, bf16, batch 8, max_len
    256, the batcher path's 24 requests: eager on the contiguous, paged
    and paged + prefix pools (the first booted from the artifact), the
    dropped assignments of each run counted (``DropCounter``); then the
    contiguous and paged pools through ``AotRegistry``, every decode a
    replay, tokens equal to the eager runs'; a profiled graph step; dense
    against D-Rank with graphs. Returns ({run: rates}, recorded calls,
    {run: dropped}, the graph step's window, {name: [ms/step]})."""
    torch, E, aot = port.torch, port.engine, port.aot
    reqs = cb_requests(cfg.vocab_size)
    pools = {"contiguous": E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN),
             "paged": E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN,
                                    kv_block=CB_BLOCK),
             "paged + prefix": E.ServeConfig(batch=CB_BATCH,
                                             max_len=CB_MAX_LEN,
                                             kv_block=CB_BLOCK,
                                             prefix_cache=True)}
    outs, rates, drops = {}, {}, {}
    with recording(port) as calls:
        for i, (name, scfg) in enumerate(pools.items()):
            cb = (E.ContinuousBatcher.from_compressed(
                str(MOE_ARTIFACT_DIR), cfg, scfg, verify=True, device=dev)
                if i == 0 else E.ContinuousBatcher(comp, cfg, scfg,
                                                   device=dev))
            with DropCounter(port) as dc:
                res, secs, steps = drive_batcher(port, cb, reqs)
            assert res.status == "drained" and len(res) == CB_REQUESTS, name
            outs[name] = {r.rid: list(r.out) for r in res}
            drops[name] = dc.dropped
            ntok = sum(len(o) for o in outs[name].values())
            rates[name] = {"tokens_per_s": ntok / secs,
                           "ms_per_step": secs / steps * 1e3}
            log(f"  eager {name}: {ntok} tokens in {steps} steps, "
                f"{rates[name]['tokens_per_s']:.1f} tokens/s, "
                f"{rates[name]['ms_per_step']:.2f} ms/step; dropped "
                f"assignments {drops[name]} of {dc.assigned}")
            del cb
    assert outs["contiguous"] == outs["paged"], \
        "MoE: the contiguous and paged pools' tokens differ"
    same = outs["paged + prefix"] == outs["contiguous"]
    log(f"  contiguous == paged: True; paged + prefix == contiguous: {same} "
        f"(dropped {drops['paged + prefix']} and {drops['contiguous']})")
    if drops["paged + prefix"] == 0 and drops["contiguous"] == 0:
        assert same, "MoE: prefix reuse changed tokens with no drop"
    fp = port.store.artifact_fingerprint(str(MOE_ARTIFACT_DIR),
                                         name=port.compress.ARTIFACT_NAME)
    kept = {}
    for name in ("contiguous", "paged"):
        scfg = pools[name]
        reg = aot.AotRegistry(cfg, scfg, fp)
        cb = E.ContinuousBatcher(comp, cfg, scfg, device=dev,
                                 executables=reg)
        res, secs, steps, info = drive_graphs(port, cb, reqs)
        out = {r.rid: list(r.out) for r in res}
        ntok = sum(len(o) for o in out.values())
        rates[name + ", graphs"] = {"tokens_per_s": ntok / secs,
                                    "ms_per_step": secs / steps * 1e3,
                                    "warm_s": info["warm_s"]}
        log(f"  graphs {name}: {ntok} tokens in {steps} steps, "
            f"{ntok / secs:.1f} tokens/s, {secs / steps * 1e3:.2f} ms/step "
            f"(eager {rates[name]['ms_per_step']:.2f}); warm "
            f"{info['warm_s']:.2f} s, {info['warm']['aot_compiles']} entries,"
            f" {sum(reg.graph_bytes().values()) / 2 ** 20:.0f} MB of graphs; "
            f"decode dispatches {info['decode_calls']}, replays "
            f"{info['decode_replays']}")
        assert res.status == "drained" and len(res) == CB_REQUESTS, name
        assert out == outs[name], \
            f"MoE {name}: the graph run's tokens differ from the eager run's"
        assert info["decode_calls"] > 0 and \
            info["decode_replays"] == info["decode_calls"], \
            f"MoE {name}: a decode step did not replay its graph: {info}"
        assert cb.stats["aot_fallbacks"] == 0, cb.stats
        if name == "contiguous":
            kept[name] = cb
        else:
            del cb, reg
            torch.cuda.empty_cache()
    steps = 4
    window = graph_profile(port, kept, steps)["contiguous"]
    log("    the graph step's longest device kernels (ms/step, launches/step):")
    for e in sorted(on_device(window["events"]), key=dev_us,
                    reverse=True)[:8]:
        log(f"      {dev_us(e) / steps / 1e3:7.3f} ms "
            f"{e.count / steps:6.0f}  {e.key[:90]}")
    fig4 = fig4_graphs(port, dev, cfg, params, comp, kept)
    del kept
    torch.cuda.empty_cache()
    return rates, calls, drops, window, fig4


def moe_oracles(port, dev, cfg, params, calib):
    """At MOE_ORACLE_LAYERS layers of the MoE model: the streaming Grams
    (bf16 model) against the eager fp64 Collector, every tag, expert tags
    included; the host fp64 decomposition against the device one (model
    in float32), expert groups included."""
    CC = port.compress
    cfg2 = cfg.replace(n_layers=MOE_ORACLE_LAYERS)
    p2 = cut_layers(port, params, MOE_ORACLE_LAYERS)
    col = CC.calibrate(port.capture.to_list_params(p2, cfg2), cfg2, calib,
                       flush_every=FLUSH_EVERY)
    n_exp = sum("/expert" in t for t in col.gram)
    log(f"  streaming against eager at {MOE_ORACLE_LAYERS} layers, "
        f"{n_exp} expert tags:")
    streaming_vs_eager(port, cfg2, p2, col, calib)
    del col
    device_vs_host(port, dev, calib, cfg2.replace(dtype="float32"), p2)


def qwen_path(port, dev):
    """qwen2-moe-a2.7b at full width (d_model 2048, 60 experts padded to 64,
    top-4, d_expert 1408, 4 shared experts, MHA 16 of 128, vocab 151936),
    depth cut to QWEN_LAYERS, seeded random factors at uniform 20% (every
    linear and every expert): bf16 ``Engine.generate`` on a 200- and a
    64-token prompt with every kernel call recorded and held, then the
    float32 card-against-CPU check. No padding expert may be routed to."""
    torch, T, E = port.torch, port.T, port.engine
    cfg = port.get_config(QWEN_MOE).replace(n_layers=QWEN_LAYERS)
    t0 = time.perf_counter()
    params, _ = T.init_model(cfg, seed=QWEN_SEED, device=dev)
    comp, ks = random_factors(port, params, cfg, MOE_RATIO, QWEN_SEED)
    del params
    torch.cuda.synchronize()
    ranks = {}
    for gid, k in ks.items():
        ranks.setdefault(gid.split(":")[0], set()).add(k)
    log(f"  {T.param_count(comp) / 1e9:.3f} B params ({QWEN_LAYERS} of 24 "
        f"layers), ranks {ranks}, {time.perf_counter() - t0:.1f} s")
    long, short = QWEN_PROMPTS
    rng = np.random.default_rng(QWEN_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (2, long), dtype=np.int32)
    prompts[1, short:] = 0
    lengths = np.asarray([long, short], dtype=np.int32)
    eng = E.Engine(comp, cfg, E.ServeConfig(batch=2), device=dev)
    port.reset_counts()
    with recording(port) as calls, route_recorder(port) as routes:
        t0 = time.perf_counter()
        toks = eng.generate(prompts, QWEN_NEW, lengths=lengths)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = port.counts()
    pad = sum(int((ids >= cfg.moe.num_experts).sum()) for _, ids in routes)
    log(f"  bf16 generate, prompts of {long} and {short} tokens, {QWEN_NEW} "
        f"new each: {secs:.2f} s; first tokens {toks[:, :6].tolist()}; "
        f"launches {counts}; padding-expert assignments {pad} over "
        f"{len(routes)} router calls")
    assert toks.shape == (2, QWEN_NEW)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of range"
    for name in ("lowrank_gemv", "lowrank_matmul_2d", "flash_attention",
                 "decode_attention"):
        assert counts[name] > 0, f"{name} never launched on the qwen2 path"
    del eng, routes
    log(f"  the bf16 run's {len(calls)} kernel signatures against the plain "
        f"versions:")
    hold_recorded(port, calls, "bfloat16", "the qwen2-moe path")
    del calls
    res = moe_parity(port, dev, cfg, comp, prompts, lengths, QWEN_NEW_F32,
                     "qwen2-moe float32")
    pad += res["padding_assignments"]
    assert pad == 0, f"{pad} assignments went to a padding expert"
    return res


def moe_train_step(port, dev, cfg):
    """One float32 train step of the MoE model at MOE_TRAIN_LAYERS
    layers on the card against the CPU (``train_step_parity``)."""
    return train_step_parity(
        port, dev, cfg.replace(n_layers=MOE_TRAIN_LAYERS), MOE)


def moe_phases(port, dev) -> dict:
    """The MoE path, every launch count set to 0 just before granite's
    calibration and read after its batcher and graph runs; then the
    checks at cut depth and qwen2-moe. Returns what ``log_moe`` prints and
    the kernels line's ``moe_launches``."""
    torch = port.torch
    out = {}
    port.reset_counts()
    try:
        with Phase(f"MoE path: {MOE} at {MOE_LAYERS} layers, streaming "
                   f"calibration "
                   f"with expert Grams, D-Rank 20% on the card, save, boot, "
                   f"generate"):
            cfg, params, comp, plan, calib, calls, out["secs"] = \
                moe_path(port, dev)
        with Phase("MoE batcher path: eager contiguous, paged and prefix "
                   "pools with drops counted, graphs on contiguous and "
                   "paged, dense against D-Rank with graphs"):
            (out["rates"], cb_calls, out["drops"], out["window"],
             out["fig4"]) = moe_batcher_path(port, dev, cfg, params, comp)
    finally:
        shutil.rmtree(MOE_ARTIFACT_DIR, ignore_errors=True)
    out["launches"] = port.counts()
    out["variants"] = port.variant_counts()
    log(f"  launches on the MoE path: {out['launches']}; by variant "
        f"{out['variants']}")
    missing = [n for n, c in out["launches"].items() if c <= 0]
    assert not missing, f"kernels not launched on the MoE path: {missing}"
    with Phase("MoE path's kernel calls against the plain versions, every "
               "variant, the first call of each operand signature"):
        log(f"  {len(calls) + len(cb_calls)} signatures (compression and "
            f"generate; the batcher's eager runs)")
        hold_recorded(port, calls + cb_calls, "bfloat16", "the MoE path")
        done = {n for n, _, _ in calls + cb_calls}
        assert done == set(port.wrappers), done
    del calls, cb_calls, comp
    torch.cuda.empty_cache()
    with Phase(f"MoE float32, card against CPU, {MOE_PARITY_LAYERS} "
               f"layers"):
        rng = np.random.default_rng(2)
        prompts = rng.integers(0, cfg.vocab_size,
                               (PARITY_BATCH, PARITY_PROMPT), dtype=np.int32)
        out["parity"] = moe_parity(
            port, dev, cfg.replace(n_layers=MOE_PARITY_LAYERS),
            cut_layers(port, params, MOE_PARITY_LAYERS), prompts, None,
            PARITY_STEPS, f"{MOE} float32")
    with Phase(f"MoE streaming against eager and host against device, "
               f"{MOE_ORACLE_LAYERS} layers, expert tags and groups"):
        moe_oracles(port, dev, cfg, params, calib)
    with Phase(f"MoE float32 train step, card against CPU, "
               f"{MOE_TRAIN_LAYERS} layers"):
        out["train"] = moe_train_step(port, dev, cfg)
    del params, calib
    torch.cuda.empty_cache()
    with Phase(f"qwen2-moe path: {QWEN_MOE} at full width, {QWEN_LAYERS} "
               f"layers, random factors at uniform 20%, bf16 generate, "
               f"float32 card against CPU"):
        out["qwen"] = qwen_path(port, dev)
    return out


def log_moe(moe: dict) -> None:
    """The MoE path's summary lines."""
    s = moe["secs"]
    log(f"MoE {MOE}: compression seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in s.items()
        if k not in ("artifact_mb", "achieved_ratio"))
        + f"; artifact {s['artifact_mb']:.1f} MB; achieved ratio "
        f"{s['achieved_ratio']:.4f} (requested {MOE_RATIO})")
    for name, r in moe["rates"].items():
        log(f"MoE batcher {name}, batch {CB_BATCH}: "
            f"{r['tokens_per_s']:.1f} tokens/s, {r['ms_per_step']:.2f} "
            f"ms/step" + (f" (dropped {moe['drops'][name]})"
                          if name in moe["drops"] else ""))
    w = moe["window"]
    log(f"MoE graph step (contiguous, batch {CB_BATCH}): device busy "
        f"{w['busy_ms']:.3f} ms of {w['again_ms']:.3f}, idle "
        f"{1 - w['busy_ms'] / w['again_ms']:.1%}")
    log("MoE with graphs, bf16, batch 8, ms/step: " + ", ".join(
        f"{k} {' / '.join(f'{v:.3f}' for v in vs)}"
        for k, vs in moe["fig4"].items()))
    log(f"MoE float32 card against CPU: {moe['parity']}; qwen2-moe "
        f"{moe['qwen']}; train step {moe['train']}")


# ---------------------------------------------------------------------------
# The recurrent families: hymba-1.5b (full width, REC_DEPTH) and xlstm-350m
# ---------------------------------------------------------------------------
def cut_depth(port, params, cfg, **cut):
    """``cfg`` cut by ``cut`` (its depth, an encoder-decoder model's
    encoder depth and, for xLSTM, the sLSTM period) and list-form params
    for it: each layer of the cut config takes the next unused layer of
    its kind from ``params`` (either run form), in model order, in the
    decoder and the encoder. Returns (cut cfg, list-form params)."""
    cfg2 = cfg.replace(**cut)
    lp = dict(port.capture.to_list_params(params, cfg))
    stacks = [("decoder", cfg, cfg2)]
    if cfg.is_encoder_decoder:
        stacks.append(("encoder", port.T.encoder_config(cfg),
                       port.T.encoder_config(cfg2)))
    for name, c, c2 in stacks:
        layers = {}
        for r, (kind, _) in enumerate(c.layer_runs()):
            layers.setdefault(kind, []).extend(lp[name][f"run{r}"])
        keep = {k: v for k, v in lp[name].items()
                if not k.startswith("run")}       # the encoder's enc_norm
        lp[name] = dict(keep, **{
            f"run{r}": [layers[kind].pop(0) for _ in range(n)]
            for r, (kind, n) in enumerate(c2.layer_runs())})
    return cfg2, lp


def _widths(name, args, kw) -> tuple:
    """The operand widths a launch of ``name`` is counted by: (K, N) of a
    low-rank product, (heads, KV heads, head_dim, window, causal) of flash,
    the Gram's width."""
    if name in ("lowrank_gemv", "lowrank_matmul_2d"):
        return (args[0].shape[1], args[2].shape[1])
    if name == "flash_attention":
        q, k = args[0], args[1]
        return (q.shape[2], k.shape[2], q.shape[3], kw.get("window", 0),
                kw.get("causal", True))
    return (args[0].shape[1],)


@contextlib.contextmanager
def census(port):
    """Within the block every launch of a kernel with variants that the
    model reaches through ``ops`` is counted by (kernel, operand widths,
    variant), the variant read from the kernel wrapper's own per-variant
    launch count across the call, in the dict the block yields
    (``"counts"``); ``"unaligned"`` lists each launch with a tensor
    operand off 16-byte alignment."""
    out = {"counts": {}, "unaligned": []}
    saved = {}

    def spy(name, fn):
        counts = port.wrappers[name].launches_by_variant

        def wrapper(*args, **kwargs):
            before = dict(counts)
            res = fn(*args, **kwargs)
            for var, n in counts.items():
                if n > before[var]:
                    key = (name, _widths(name, args, kwargs), var)
                    out["counts"][key] = (out["counts"].get(key, 0)
                                          + n - before[var])
                    if any(a.data_ptr() % 16 for a in args
                           if isinstance(a, port.torch.Tensor)):
                        out["unaligned"].append(key)
            return res
        return wrapper
    for name in ("lowrank_gemv", "lowrank_matmul_2d", "flash_attention",
                 "gram_blocked"):
        attr = PATH_WRAPPERS[name]
        saved[attr] = getattr(port.ops, attr)
        setattr(port.ops, attr, spy(name, saved[attr]))
    try:
        yield out
    finally:
        for attr, fn in saved.items():
            setattr(port.ops, attr, fn)


def log_census(cens: dict, where: str) -> None:
    """Prints the launches of each (kernel, variant) in ``cens`` by operand
    widths (per path and per shape: xLSTM's 1365-wide FFN, a bf16 shape
    the tensor-core or two-launch design cannot take, shows which of
    ``splitk``, ``simt`` or ``split`` it took), and holds every launch's
    operands to 16-byte alignment."""
    by = {}
    for (name, shape, var), n in sorted(cens["counts"].items(),
                                        key=lambda kv: str(kv[0])):
        by.setdefault(name, {}).setdefault(var, {})[shape] = n
    for name, vs in by.items():
        log(f"  {where}: {name} launches by variant and operand widths: "
            + "; ".join(f"{v} " + ", ".join(f"{s} {n}" for s, n in
                                            sorted(sh.items()))
                        for v, sh in vs.items()))
    assert not cens["unaligned"], \
        f"{where}: launches with an operand off 16-byte alignment: " \
        f"{cens['unaligned'][:8]}"


def recurrent_compress(port, dev, arch):
    """``arch`` at full width and REC_DEPTH, random weights from REC_SEED:
    streaming calibration with its Grams through ``gram_blocked`` (one
    fp64 host fold, at the end: at 32 layers hymba's 385 Grams a batch
    were ~21 GB of float64 a fold, 10-14 s each on the card's host), D-Rank
    REC_RATIO on the card, ``save_plan``, ``from_compressed(verify=True)``
    and ``generate`` on GEN_BATCH prompts of GEN_PROMPT tokens, equal to an
    in-memory ``Engine``'s tokens; hymba also one REC_LONG-token prompt,
    past its 1024-token window. Returns (cfg, dense params, compressed
    params, plan, calibration batches, seconds and sizes)."""
    torch, T, CC, E = port.torch, port.T, port.compress, port.engine
    Cap = port.capture
    cfg = port.get_config(arch).replace(**REC_DEPTH[arch])
    secs, ingest, dec = {}, [], []
    t0 = time.perf_counter()
    params, _ = T.init_model(cfg, seed=REC_SEED, device=dev)
    torch.cuda.synchronize()
    log(f"  init_model: {T.param_count(params) / 1e9:.3f} B params, runs "
        f"{cfg.layer_runs()}, {time.perf_counter() - t0:.1f} s")
    calib = calib_batches(port, cfg, dev)
    t0 = time.perf_counter()
    with timed(torch, Cap.StreamingCalibrator, "ingest", ingest):
        col = CC.calibrate(Cap.to_list_params(params, cfg), cfg, calib,
                           flush_every=len(calib))
    torch.cuda.synchronize()
    secs["calibration"] = time.perf_counter() - t0
    widths = sorted({g.shape[0] for g in col.gram.values()})
    log(f"  streaming calibration: {len(col.gram)} Grams a batch (widths "
        f"{widths}), one fp64 host fold at the end (the main path folds "
        f"mid-stream), {secs['calibration']:.2f} s (ingest per batch "
        + ", ".join(f"{t:.3f}" for t in ingest) + " s)")
    t0 = time.perf_counter()
    with timed(torch, CC, "_decompose_groups_device", dec):
        comp, plan = CC.build_plan_and_params(
            params, cfg, CC.CompressionConfig(method="drank",
                                              ratio=REC_RATIO),
            calib, collector=col, device=True)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    secs["decomposition"] = sum(dec)
    secs["allocation and assembly"] = total - sum(dec)
    del col
    ks = {}
    for g in plan.groups:
        ks.setdefault(g.mtype, []).append(g.k)
    log(f"  D-Rank {REC_RATIO:.0%}: achieved ratio "
        f"{plan.summary['achieved_ratio']:.4f} over {len(plan.groups)} "
        f"groups; ranks by type " + ", ".join(
            f"{t} {min(v)}..{max(v)} ({len(v)})" for t, v in
            sorted(ks.items())) + f"; {total:.2f} s: device decomposition "
        f"{secs['decomposition']:.2f} s, allocation and assembly "
        f"{secs['allocation and assembly']:.2f} s")
    if arch == HYMBA:       # GQA: group size 1, 11 groups a layer
        assert len(plan.groups) == 11 * cfg.n_layers, len(plan.groups)
        assert set(ks) == {"q", "k", "v", "o", "gate", "up", "down",
                           "ssm_in", "ssm_z", "ssm_bc", "ssm_out"}, set(ks)
    else:
        assert set(ks) == {"mup", "mgate", "mq", "mk", "mdown", "lin",
                           "lfgate", "lfup", "lfdown"}, set(ks)
    shutil.rmtree(REC_ARTIFACT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = CC.save_plan(str(REC_ARTIFACT_DIR), comp, plan, cfg)
    secs["save"] = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    scfg = E.ServeConfig(batch=GEN_BATCH, max_len=GEN_PROMPT + GEN_NEW + 1)
    t0 = time.perf_counter()
    booted = E.Engine.from_compressed(str(REC_ARTIFACT_DIR), cfg, scfg,
                                      verify=True, device=dev)
    torch.cuda.synchronize()
    secs["boot"] = time.perf_counter() - t0
    assert booted.plan.to_json() == plan.to_json(), "plan changed on disk"
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)
    t0 = time.perf_counter()
    toks = booted.generate(prompts, GEN_NEW)
    torch.cuda.synchronize()
    secs["generate"] = time.perf_counter() - t0
    toks_mem = E.Engine(comp, cfg, scfg, device=dev).generate(prompts,
                                                              GEN_NEW)
    log(f"  save_plan: {nbytes / 1e6:.1f} MB, {secs['save']:.2f} s; "
        f"from_compressed(verify=True): {secs['boot']:.2f} s; generate "
        f"{GEN_BATCH} x {GEN_PROMPT} + {GEN_NEW}: {secs['generate']:.2f} s;"
        f" first tokens of row 0 {toks[0, :8].tolist()}")
    assert toks.shape == (GEN_BATCH, GEN_NEW)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of range"
    assert (toks == toks_mem).all(), \
        f"{arch}: the artifact's engine and the in-memory engine disagree"
    if arch == HYMBA:
        long = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (1, REC_LONG), dtype=np.int32)
        t0 = time.perf_counter()
        ltoks = booted.generate(long, REC_LONG_NEW)
        torch.cuda.synchronize()
        secs["generate, long prompt"] = time.perf_counter() - t0
        with torch.inference_mode():
            logits, cache = T.prefill(booted.params, cfg, {
                "tokens": torch.as_tensor(long, device=dev)},
                max_len=REC_LONG + 1)
        rings = sum(n for k, n in cfg.layer_runs() if k == "hymba")
        log(f"  one {REC_LONG}-token prompt, {REC_LONG_NEW} new (past the "
            f"{cfg.sliding_window}-token window: {rings} layers' rings "
            f"wrap): {secs['generate, long prompt']:.2f} s, tokens "
            f"{ltoks[0, :8].tolist()}")
        assert torch.isfinite(logits).all(), "non-finite long-prompt logits"
        assert ((ltoks >= 0) & (ltoks < cfg.vocab_size)).all()
        del cache
    del booted
    secs["artifact_mb"] = nbytes / 1e6
    secs["achieved_ratio"] = plan.summary["achieved_ratio"]
    return cfg, params, comp, plan, calib, secs


def recurrent_batcher(port, dev, cfg, params, comp):
    """The continuous batcher on the artifact through exact-length
    admission (one single-row prefill per request at its prompt's
    length), bf16, batch 8, max_len 256, the batcher path's 24 requests:
    eager, booted from the artifact; then through ``AotRegistry``: tokens
    equal, every decode a replay, the warm set JAX's (decode and purge),
    one prefill graph per distinct prompt length and one decode entry;
    then one NaN fault plan on row 1 on that graph batcher: the
    quarantined slot's every state leaf reads zero right after its purge
    and every request gets the clean run's tokens; a profiled graph step;
    dense against D-Rank decode steps with graphs (``fig4_decode``).
    Returns a summary dict."""
    torch, E, aot, FI = port.torch, port.engine, port.aot, port.faultinject
    reqs = cb_requests(cfg.vocab_size)
    n_lens = len({len(t) for _, t in reqs})
    scfg = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN)
    out = {}
    # the artifact was verified by the Engine's boot; no second rehash
    cb = E.ContinuousBatcher.from_compressed(str(REC_ARTIFACT_DIR), cfg,
                                             scfg, device=dev)
    assert not cb.bucketed
    res, secs, steps = drive_batcher(port, cb, reqs)
    assert res.status == "drained" and len(res) == CB_REQUESTS
    eager = {r.rid: list(r.out) for r in res}
    ntok = sum(len(o) for o in eager.values())
    out["eager"] = {"tokens_per_s": ntok / secs,
                    "ms_per_step": secs / steps * 1e3}
    log(f"  eager: {ntok} tokens in {steps} steps, {ntok / secs:.1f} "
        f"tokens/s, {secs / steps * 1e3:.2f} ms/step; stats {cb.stats}")
    assert cb.stats["prefill_retraces"] == n_lens, (cb.stats, n_lens)
    assert cb.stats["decode_retraces"] == 1, cb.stats
    del cb
    fp = port.store.artifact_fingerprint(str(REC_ARTIFACT_DIR),
                                         name=port.compress.ARTIFACT_NAME)
    reg = aot.AotRegistry(cfg, scfg, fp)
    cb = E.ContinuousBatcher(comp, cfg, scfg, device=dev, executables=reg)
    with timed(torch, reg, "_capture", []) as caps:
        res, secs, steps, info = drive_graphs(port, cb, reqs)
    graphs = {r.rid: list(r.out) for r in res}
    ntok = sum(len(o) for o in graphs.values())
    roles = [role for role, _ in reg.entries()]
    pbytes = sum(b for (role, _), b in reg.graph_bytes().items()
                 if role == "prefill")
    out["graphs"] = {"tokens_per_s": ntok / secs,
                     "ms_per_step": secs / steps * 1e3,
                     "warm_s": info["warm_s"],
                     "prefill_graphs": roles.count("prefill"),
                     "prefill_graph_mb": pbytes / 2 ** 20,
                     "capture_s": sum(caps)}
    log(f"  graphs: {ntok} tokens in {steps} steps, {ntok / secs:.1f} "
        f"tokens/s, {secs / steps * 1e3:.2f} ms/step (eager "
        f"{out['eager']['ms_per_step']:.2f}, captures of the exact "
        f"prefills included); warm {info['warm_s']:.2f} s, "
        f"{info['warm']['aot_compiles']} entries; after the drain "
        f"{len(roles)} entries: {roles.count('prefill')} exact prefills "
        f"({n_lens} distinct prompt lengths), {roles.count('decode')} "
        f"decode; the exact prefills' graphs {pbytes / 2 ** 20:.0f} MB, all "
        f"graphs {sum(reg.graph_bytes().values()) / 2 ** 20:.0f} MB; "
        f"{len(caps)} captures (each with its first, eager call) "
        f"{sum(caps):.2f} s, median {np.median(caps):.3f} s; decode "
        f"dispatches {info['decode_calls']}, replays "
        f"{info['decode_replays']}")
    assert res.status == "drained" and len(res) == CB_REQUESTS
    assert graphs == eager, "the graph run's tokens differ from the eager's"
    assert reg.entries()[:info["warm"]["aot_compiles"]] == \
        [("decode", (0,)), ("purge", ())], reg.entries()
    assert roles.count("prefill") == n_lens and roles.count("decode") == 1
    assert info["decode_calls"] > 0 and \
        info["decode_replays"] == info["decode_calls"], info
    assert cb.stats["aot_fallbacks"] == 0, cb.stats

    purged, inner = [], aot.purge_rows

    def spy(pool, rows):
        res = inner(pool, rows)
        for r in np.asarray(rows):
            if r < pool["pos"].shape[0]:
                purged.append((int(r), max(
                    float(t[:, r].abs().max())
                    for t in port.pytree.tensors(pool["runs"])),
                    int(pool["pos"][r])))
        return res
    cb.done.clear()
    cb.faults = FI.FaultPlan(nan_decode_step=cb._step_idx + 3, nan_rows=(1,))
    aot.purge_rows = spy
    try:
        res, secs, steps = drive_batcher(port, cb, reqs)
    finally:
        aot.purge_rows = inner
    chaos = {r.rid: list(r.out) for r in res}
    log(f"  NaN fault plan on row 1 (graphs): {res.status}, fired "
        f"{cb.faults.fired}, purged (row, max |state|, pos) {purged}, "
        f"{len(res.failed)} failed; tokens equal to the clean run's: "
        f"{chaos == eager}")
    assert res.status == "drained" and cb.faults.fired and purged
    assert all(m == 0.0 and pos == -1 for _, m, pos in purged), purged
    assert chaos == eager, "a fault-plan run's tokens differ from the clean"
    cb.faults = None
    cb.done.clear()
    kept = {"contiguous": cb}
    steps = 4
    out["window"] = graph_profile(port, kept, steps)["contiguous"]
    log("    the graph step's longest device kernels (ms/step, "
        "launches/step):")
    for e in sorted(on_device(out["window"]["events"]), key=dev_us,
                    reverse=True)[:8]:
        log(f"      {dev_us(e) / steps / 1e3:7.3f} ms "
            f"{e.count / steps:6.0f}  {e.key[:90]}")
    out["fig4"] = fig4_decode(port, dev, cfg, params, kept)
    del kept, cb, reg
    torch.cuda.empty_cache()
    return out


def slstm_share(port, dev, cfg, comp):
    """The sLSTM loop's share of one eager bf16 prefill of the longest
    batcher prompt (one row): the host clock after a sync around the
    prefill and around each ``apply_slstm`` call inside it."""
    torch, T, E = port.torch, port.T, port.engine
    p = E.place_params(comp, T.dtype_of(cfg.dtype), dev)
    n = max(len(t) for _, t in cb_requests(cfg.vocab_size))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, n), dtype=np.int32), device=dev)
    inner, total = [], []
    with torch.inference_mode():
        T.prefill(p, cfg, {"tokens": toks}, max_len=CB_MAX_LEN)   # warm
        with timed(torch, port.ssm, "apply_slstm", inner), \
                timed(torch, T, "prefill", total):
            T.prefill(p, cfg, {"tokens": toks}, max_len=CB_MAX_LEN)
    share = sum(inner) / total[0]
    log(f"  one eager bf16 prefill of {n} tokens: {total[0] * 1e3:.2f} ms, "
        f"the {len(inner)} sLSTM layers' loops {sum(inner) * 1e3:.2f} ms "
        f"({share:.1%})")
    del p
    return {"prefill_ms": total[0] * 1e3, "slstm_ms": sum(inner) * 1e3,
            "share": share}


def train_step_parity(port, dev, cfg2, name: str) -> dict:
    """One float32 train step's loss and grads of ``cfg2`` (seeded
    weights) on the card against the CPU: loss 1e-5 relative, grads 1e-4
    of each leaf's largest; an MoE model's ``moe_aux`` finite and equal
    within 1e-5."""
    torch, TS = port.torch, port.TS
    cfg2 = cfg2.replace(dtype="float32")
    state, _ = TS.init_train_state(cfg2, seed=1, device="cpu")
    b = port.synthetic.ShardedLoader(port.synthetic.DataConfig(
        vocab_size=cfg2.vocab_size, seq_len=PARITY_TRAIN_SEQ,
        global_batch=PARITY_TRAIN_ROWS)).batch(0)
    if cfg2.is_encoder_decoder:     # the audio stub feeds the encoder
        b["enc_embeds"] = stub_embeds((PARITY_TRAIN_ROWS, PARITY_TRAIN_SEQ,
                                       cfg2.d_model), 1)
    out = {}
    for w, d in (("cpu", torch.device("cpu")), ("card", dev)):
        p = port.pytree.tree_map(lambda t: t.to(d), state.params)
        t0 = time.perf_counter()
        loss, m, g = TS.value_and_grad(
            p, cfg2, {k: torch.as_tensor(v, device=d) for k, v in b.items()})
        out[w] = (float(loss), float(m.get("moe_aux", 0.0)), g,
                  time.perf_counter() - t0)
    (lc, ac, gc, sc), (lg, ag, gg, sg) = out["cpu"], out["card"]
    errs = [rel_err(x.cpu(), y) for x, y in zip(port.pytree.leaves(gg),
                                                 port.pytree.leaves(gc))]
    log(f"  {name} float32 train step, {cfg2.n_layers} layers "
        f"{cfg2.layer_runs()}, {PARITY_TRAIN_ROWS} x {PARITY_TRAIN_SEQ} "
        f"tokens: loss card {lg:.7f}, cpu {lc:.7f} (rel "
        f"{abs(lg - lc) / abs(lc):.2e}, tolerance 1e-5); grads, each leaf "
        f"relative to its largest entry, at most {max(errs):.2e} (tolerance "
        f"1e-4) over {len(errs)} leaves; card {sg:.2f} s, cpu {sc:.2f} s"
        + (f"; moe_aux card {ag:.7f}, cpu {ac:.7f}" if cfg2.moe.num_experts
           else ""))
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    assert max(errs) <= 1e-4, max(errs)
    res = {"loss": abs(lg - lc) / abs(lc), "grads": max(errs)}
    if cfg2.moe.num_experts:
        assert np.isfinite(ag) and abs(ag - ac) <= 1e-5, (ag, ac)
        res["moe_aux"] = abs(ag - ac)
    return res


def recurrent_phases(port, dev, arch) -> dict:
    """One recurrent family's path, every launch count set to 0 just
    before its calibration and read after its batcher and graph runs;
    then every recorded kernel call held against its plain version, the
    float32 card against the CPU at REC_PARITY_LAYERS, streaming against
    eager Grams and host against device decomposition at the
    REC_ORACLE_CUT and a float32 train step at the REC_TRAIN_CUT.
    Returns the summary and the kernels line's launches."""
    torch = port.torch
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== {arch}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated on the card before the path")
    port.reset_counts()
    try:
        with recording(port) as calls, census(port) as cens:
            depth = REC_DEPTH[arch].get("n_layers",
                                        port.get_config(arch).n_layers)
            with Phase(f"{arch} at {depth} layers: streaming calibration, "
                       f"D-Rank 20% on the card, save, boot, generate"):
                cfg, params, comp, plan, calib, out["secs"] = \
                    recurrent_compress(port, dev, arch)
            with Phase(f"{arch} batcher: exact-length admission, eager and "
                       f"with graphs, a NaN fault plan, dense against "
                       f"D-Rank with graphs"):
                out.update(recurrent_batcher(port, dev, cfg, params, comp))
    finally:
        shutil.rmtree(REC_ARTIFACT_DIR, ignore_errors=True)
    out["launches"] = port.counts()
    out["variants"] = port.variant_counts()
    log(f"  launches on the {arch} path: {out['launches']}; by variant "
        f"{out['variants']}")
    log_census(cens, f"the {arch} path")
    missing = [n for n in REC_KERNELS[arch] if out["launches"][n] <= 0]
    assert not missing, f"kernels not launched on the {arch} path: {missing}"
    if arch == XLSTM:
        with Phase(f"{arch}: the sLSTM loop's share of a prefill"):
            out["slstm"] = slstm_share(port, dev, cfg, comp)
    with Phase(f"{arch}: the path's kernel calls against the plain "
               f"versions, every variant, the first call of each operand "
               f"signature"):
        log(f"  {len(calls)} signatures")
        hold_recorded(port, calls, "bfloat16", f"the {arch} path")
    del calls
    torch.cuda.empty_cache()
    n = REC_PARITY_LAYERS[arch]
    with Phase(f"{arch} float32, card against CPU, {n} layers of the D-Rank "
               f"model"), recording(port) as calls32:
        cfg_p, lp = cut_depth(port, comp, cfg, n_layers=n)
        cfg_p = cfg_p.replace(dtype="float32")
        prompts = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT), dtype=np.int32)
        log(f"  runs {cfg_p.layer_runs()}")
        gpu = greedy(port, lp, cfg_p, prompts, REC_PARITY_STEPS, dev)
        cpu = greedy(port, lp, cfg_p, prompts, REC_PARITY_STEPS,
                     torch.device("cpu"))
        compare_greedy(torch, gpu, cpu)
        out["parity"] = max(abs_err(a, b) for a, b in zip(gpu, cpu))
        log(f"  the float32 card run's {len(calls32)} kernel signatures "
            f"against the plain versions:")
        hold_recorded(port, calls32, "float32", f"the {arch} float32 path")
    del comp, calls32, lp
    torch.cuda.empty_cache()
    cut = REC_ORACLE_CUT[arch]
    with Phase(f"{arch} streaming against eager and host against device, "
               f"{cut}"):
        cfg2, p2 = cut_depth(port, params, cfg, **cut)
        col = port.compress.calibrate(p2, cfg2, calib,
                                      flush_every=FLUSH_EVERY)
        log(f"  runs {cfg2.layer_runs()}")
        streaming_vs_eager(port, cfg2, p2, col, calib)
        del col
        out["oracle_s"] = device_vs_host(port, dev, calib,
                                         cfg2.replace(dtype="float32"), p2)
    del params, calib, p2
    torch.cuda.empty_cache()
    cut = REC_TRAIN_CUT[arch]
    with Phase(f"{arch} float32 train step, card against CPU, {cut}"):
        out["train"] = train_step_parity(port, dev, cfg.replace(**cut), arch)
    return out


def log_recurrent(arch: str, r: dict) -> None:
    """A recurrent family's summary lines."""
    s = r["secs"]
    log(f"{arch}: compression seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in s.items()
        if k not in ("artifact_mb", "achieved_ratio"))
        + f"; artifact {s['artifact_mb']:.1f} MB; achieved ratio "
        f"{s['achieved_ratio']:.4f} (requested {REC_RATIO})")
    g = r["graphs"]
    log(f"{arch} batcher, batch {CB_BATCH}, exact-length admission: eager "
        f"{r['eager']['ms_per_step']:.2f} ms/step, "
        f"{r['eager']['tokens_per_s']:.1f} tokens/s; graphs "
        f"{g['ms_per_step']:.2f} ms/step, {g['tokens_per_s']:.1f} tokens/s "
        f"(warm {g['warm_s']:.2f} s; {g['prefill_graphs']} exact-prefill "
        f"graphs, {g['prefill_graph_mb']:.0f} MB; captures "
        f"{g['capture_s']:.2f} s, inside the first drain)")
    w = r["window"]
    log(f"{arch} graph step (contiguous, batch {CB_BATCH}): device busy "
        f"{w['busy_ms']:.3f} ms of {w['again_ms']:.3f}, idle "
        f"{1 - w['busy_ms'] / w['again_ms']:.1%}")
    log(f"{arch} with graphs, bf16, batch 8, ms/step: " + ", ".join(
        f"{k} {' / '.join(f'{v:.3f}' for v in vs)}"
        for k, vs in r["fig4"].items()))
    log(f"{arch}: launches by variant {r['variants']}; float32 card against "
        f"CPU max |logits| {r['parity']:.3e}; train step {r['train']}"
        + (f"; sLSTM loop {r['slstm']['share']:.1%} of a prefill"
           if "slstm" in r else ""))


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless-m4t-medium) and M-RoPE (qwen2-vl-72b)
# ---------------------------------------------------------------------------
def seamless_compress(port, dev):
    """seamless-m4t-medium at full size, random weights from ENC_SEED:
    streaming calibration (each sample ENC_CALIB_FRAMES seeded encoder
    frames; every encoder, decoder and cross Gram through ``gram_blocked``,
    folded into fp64 every FLUSH_EVERY batches as on the main path), D-Rank
    ENC_RATIO on the card, ``save_plan``, ``from_compressed(verify=True)``
    and ``generate`` on GEN_BATCH prompts of GEN_PROMPT tokens with
    ENC_GEN_FRAMES frames each, equal to an in-memory ``Engine``'s tokens.
    Returns (cfg, dense params, compressed params, calibration batches,
    seconds and sizes)."""
    torch, T, CC, E = port.torch, port.T, port.compress, port.engine
    Cap = port.capture
    cfg = port.get_config(SEAMLESS)
    secs, ingest, dec = {}, [], []
    t0 = time.perf_counter()
    params, _ = T.init_model(cfg, seed=ENC_SEED, device=dev)
    torch.cuda.synchronize()
    log(f"  init_model: {T.param_count(params):,} params, "
        f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, "
        f"{time.perf_counter() - t0:.1f} s")
    calib = calib_batches(port, cfg, dev, ENC_CALIB_FRAMES)
    t0 = time.perf_counter()
    with timed(torch, Cap.StreamingCalibrator, "ingest", ingest):
        col = CC.calibrate(Cap.to_list_params(params, cfg), cfg, calib,
                           flush_every=FLUSH_EVERY)
    torch.cuda.synchronize()
    secs["calibration"] = time.perf_counter() - t0
    rows = {t: col.count[t] for t in ("encoder/run0/0/attn/wq",
                                      "decoder/run0/0/attn/wq",
                                      "decoder/run0/0/cross/wk")}
    log(f"  streaming calibration: {len(col.gram)} Grams a batch, rows "
        f"{rows}, fp64 host fold every {FLUSH_EVERY} batches, "
        f"{secs['calibration']:.2f} s (ingest per batch "
        + ", ".join(f"{t:.3f}" for t in ingest) + " s)")
    assert col.count["decoder/run0/0/cross/wk"] == \
        len(calib) * CALIB_BATCH * ENC_CALIB_FRAMES, col.count
    assert any(t.startswith("encoder/") for t in col.gram)
    t0 = time.perf_counter()
    with timed(torch, CC, "_decompose_groups_device", dec):
        comp, plan = CC.build_plan_and_params(
            params, cfg, CC.CompressionConfig(method="drank",
                                              ratio=ENC_RATIO),
            calib, collector=col, device=True)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    secs["decomposition"] = sum(dec)
    secs["allocation and assembly"] = total - sum(dec)
    del col
    ks = {}
    for g in plan.groups:
        ks.setdefault(g.mtype, []).append(g.k)
    log(f"  D-Rank {ENC_RATIO:.0%}: achieved ratio "
        f"{plan.summary['achieved_ratio']:.4f} over {len(plan.groups)} "
        f"groups; ranks by type " + ", ".join(
            f"{t} {min(v)}..{max(v)} ({len(v)})" for t, v in
            sorted(ks.items())) + f"; {total:.2f} s: device decomposition "
        f"{secs['decomposition']:.2f} s")
    assert len(plan.groups) == ENC_GROUPS and set(ks) == ENC_TYPES, ks
    shutil.rmtree(ENC_ARTIFACT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = CC.save_plan(str(ENC_ARTIFACT_DIR), comp, plan, cfg)
    secs["save"] = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    scfg = E.ServeConfig(batch=GEN_BATCH, max_len=GEN_PROMPT + GEN_NEW + 1)
    t0 = time.perf_counter()
    booted = E.Engine.from_compressed(str(ENC_ARTIFACT_DIR), cfg, scfg,
                                      verify=True, device=dev)
    torch.cuda.synchronize()
    secs["boot"] = time.perf_counter() - t0
    assert booted.plan.to_json() == plan.to_json(), "plan changed on disk"
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)
    enc = stub_embeds((GEN_BATCH, ENC_GEN_FRAMES, cfg.d_model), 2)
    t0 = time.perf_counter()
    toks = booted.generate(prompts, GEN_NEW, enc_embeds=enc)
    torch.cuda.synchronize()
    secs["generate"] = time.perf_counter() - t0
    toks_mem = E.Engine(comp, cfg, scfg, device=dev).generate(
        prompts, GEN_NEW, enc_embeds=enc)
    log(f"  save_plan: {nbytes / 1e6:.1f} MB, {secs['save']:.2f} s; "
        f"from_compressed(verify=True): {secs['boot']:.2f} s; generate "
        f"{GEN_BATCH} x {GEN_PROMPT} + {GEN_NEW}, {ENC_GEN_FRAMES} encoder "
        f"frames each: {secs['generate']:.2f} s; first tokens of row 0 "
        f"{toks[0, :8].tolist()}")
    assert toks.shape == (GEN_BATCH, GEN_NEW)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of range"
    assert (toks == toks_mem).all(), \
        "seamless: the artifact's engine and the in-memory engine disagree"
    del booted
    secs["artifact_mb"] = nbytes / 1e6
    secs["achieved_ratio"] = plan.summary["achieved_ratio"]
    return cfg, params, comp, calib, secs


def seamless_serve(port, dev, cfg, params, comp):
    """Decode throughput, dense against D-Rank (``Engine.
    measure_decode_throughput`` at batch 8, prompt 128, 64 new tokens; the
    encoder reads zero frames, as in JAX); and the batcher's refusal of an
    encoder-decoder model. Returns {name: rates}."""
    E = port.engine
    res = {}
    for name, p in (("dense", params), ("drank-20%", comp)):
        eng = E.Engine(p, cfg, E.ServeConfig(), device=dev)
        res[name] = eng.measure_decode_throughput(batch=8, prompt_len=128,
                                                  n_new=64)
        log(f"  {name:9s} batch 8: {res[name]['tokens_per_s']:9.1f} "
            f"tokens/s, {res[name]['ms_per_step']:.3f} ms/step")
        del eng
    try:
        E.ContinuousBatcher(comp, cfg, E.ServeConfig(
            batch=CB_BATCH, max_len=CB_MAX_LEN), device=dev)
    except ValueError as e:
        log(f"  the batcher refuses it: {e}")
    else:
        raise AssertionError("the batcher took an encoder-decoder model")
    return res


def seamless_phases(port, dev) -> dict:
    """The encoder-decoder path: every launch count set to 0 just before
    seamless's calibration and read after its decode throughput; every
    recorded kernel call held against its plain version; float32 card
    against CPU at ENC_PARITY_CUT; streaming against eager Grams, host
    against device decomposition and a float32 train step at
    ENC_ORACLE_CUT. Returns the summary and the kernels line's
    launches."""
    torch = port.torch
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== {SEAMLESS}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated on the card before the path")
    port.reset_counts()
    try:
        with recording(port) as calls, census(port) as cens:
            with Phase(f"{SEAMLESS} at full size: streaming calibration "
                       f"with encoder frames, D-Rank 20% on the card (encoder,"
                       f" decoder and cross-attention), save, boot, "
                       f"generate"):
                cfg, params, comp, calib, out["secs"] = \
                    seamless_compress(port, dev)
            with Phase(f"{SEAMLESS}: decode throughput, dense against "
                       f"D-Rank; the batcher refuses it"):
                out["tput"] = seamless_serve(port, dev, cfg, params, comp)
    finally:
        shutil.rmtree(ENC_ARTIFACT_DIR, ignore_errors=True)
    out["launches"] = port.counts()
    out["variants"] = port.variant_counts()
    out["noncausal"] = sum(n for (name, w, _), n in cens["counts"].items()
                           if name == "flash_attention" and not w[-1])
    log(f"  launches on the {SEAMLESS} path: {out['launches']}, of them "
        f"non-causal flash (the encoder's) {out['noncausal']}; by variant "
        f"{out['variants']}")
    log_census(cens, f"the {SEAMLESS} path")
    missing = [n for n in ENC_KERNELS if out["launches"][n] <= 0]
    assert not missing, f"kernels not launched on the seamless path: {missing}"
    assert out["noncausal"] > 0, "no non-causal flash launch"
    assert out["launches"]["decode_attention_paged"] == 0
    assert_gemv(out["variants"]["lowrank_gemv"], "bfloat16",
                "the seamless path")
    for name in TC_KERNELS:
        assert out["variants"][name]["simt"] == 0, \
            f"a bf16 {name} launch took simt on the seamless path"
    with Phase(f"{SEAMLESS}: the path's kernel calls against the plain "
               f"versions, every variant, the first call of each operand "
               f"signature"):
        nc_calls = sum(1 for n, _, kw in calls
                       if n == "flash_attention" and not kw.get("causal"))
        log(f"  {len(calls)} signatures, {nc_calls} of them non-causal flash")
        assert nc_calls > 0
        hold_recorded(port, calls, "bfloat16", f"the {SEAMLESS} path")
    del calls
    torch.cuda.empty_cache()
    with Phase(f"{SEAMLESS} float32, card against CPU, {ENC_PARITY_CUT} of "
               f"the D-Rank model"), recording(port) as calls32:
        out["parity"] = encdec_parity(port, dev, cfg, comp)
        log(f"  the float32 card run's {len(calls32)} kernel signatures "
            f"against the plain versions:")
        hold_recorded(port, calls32, "float32", f"the {SEAMLESS} float32 "
                      f"path")
    del comp, calls32
    torch.cuda.empty_cache()
    with Phase(f"{SEAMLESS} streaming against eager and host against "
               f"device, {ENC_ORACLE_CUT}"):
        cfg2, p2 = cut_depth(port, params, cfg, **ENC_ORACLE_CUT)
        col = port.compress.calibrate(p2, cfg2, calib,
                                      flush_every=FLUSH_EVERY)
        streaming_vs_eager(port, cfg2, p2, col, calib)
        del col
        out["oracle_s"] = device_vs_host(port, dev, calib,
                                         cfg2.replace(dtype="float32"), p2,
                                         ENC_TYPES)
    del params, calib, p2
    torch.cuda.empty_cache()
    with Phase(f"{SEAMLESS} float32 train step, card against CPU, "
               f"{ENC_ORACLE_CUT}"):
        out["train"] = train_step_parity(
            port, dev, cfg.replace(**ENC_ORACLE_CUT), SEAMLESS)
    return out


def encdec_parity(port, dev, cfg, comp) -> float:
    """The D-Rank seamless model cut to ENC_PARITY_CUT in float32 on the
    card and on the CPU, on PARITY_BATCH prompts with ENC_GEN_FRAMES
    frames each: teacher-forced logits within LOGITS_ATOL and greedy
    tokens (ENC_PARITY_STEPS new) identical. Returns the largest logits
    difference."""
    torch, T, E = port.torch, port.T, port.engine
    cfg_p, lp = cut_depth(port, comp, cfg, **ENC_PARITY_CUT)
    cfg_p = cfg_p.replace(dtype="float32")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT), dtype=np.int32)
    enc = stub_embeds((PARITY_BATCH, ENC_GEN_FRAMES, cfg.d_model), 3)
    tf = {}
    for w, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = E.place_params(lp, torch.float32, d)
        with torch.inference_mode():
            tf[w] = T.forward(p, cfg_p, {
                "tokens": torch.as_tensor(prompts, device=d),
                "enc_embeds": torch.as_tensor(enc, device=d)})[0].cpu()
        del p
    err = abs_err(tf["card"], tf["cpu"])
    log(f"  teacher-forced logits of {PARITY_BATCH} x {PARITY_PROMPT} "
        f"tokens, max |card - cpu| {err:.3e} (atol {LOGITS_ATOL:.0e})")
    assert err < LOGITS_ATOL, "seamless: teacher-forced logits differ"
    gpu = greedy(port, lp, cfg_p, prompts, ENC_PARITY_STEPS, dev,
                 extra={"enc_embeds": enc})
    cpu = greedy(port, lp, cfg_p, prompts, ENC_PARITY_STEPS,
                 torch.device("cpu"), extra={"enc_embeds": enc})
    compare_greedy(torch, gpu, cpu)
    return max([err] + [abs_err(a, b) for a, b in zip(gpu, cpu)])


def vision_row(port, cfg, embed):
    """The vision-stub row: VL_TEXT[0] text tokens at t = h = w = 0..,
    a VL_GRID of seeded patch embeddings at t = VL_TEXT[0] with h and w
    along the grid, then VL_TEXT[1] text tokens from the next free
    position on (t = h = w). ``embed``: the embedding table whose rows
    the text tokens take. Returns (embeds (1, S, D) in ``embed``'s dtype,
    positions (3, 1, S) int32) on ``embed``'s device."""
    torch = port.torch
    n0, n1 = VL_TEXT
    gh, gw = VL_GRID
    toks = np.random.default_rng(VL_SEED).integers(
        0, cfg.vocab_size, n0 + n1, dtype=np.int32)
    rows = embed[torch.as_tensor(toks, device=embed.device).long()]
    patches = torch.as_tensor(stub_embeds((gh * gw, cfg.d_model), VL_SEED),
                              device=embed.device).to(embed.dtype)
    embeds = torch.cat([rows[:n0], patches, rows[n0:]])[None]
    t = list(range(n0)) + [n0] * (gh * gw)
    h = list(range(n0)) + [n0 + i for i in range(gh) for _ in range(gw)]
    w = list(range(n0)) + [n0 + j for _ in range(gh) for j in range(gw)]
    start = n0 + max(gh, gw)
    tail = list(range(start, start + n1))
    pos = np.asarray([t + tail, h + tail, w + tail], dtype=np.int32)
    return embeds, torch.as_tensor(pos[:, None], device=embed.device)


def vision_greedy(port, params, cfg, steps: int, device):
    """The vision-stub row's prefill (explicit (3, 1, S) positions) and
    ``steps`` greedy decode steps (positions: the cache index, as in JAX)
    on ``device`` in ``cfg``'s dtype. Returns every step's logits on the
    CPU."""
    torch, T = port.torch, port.T
    p = port.engine.place_params(params, T.dtype_of(cfg.dtype), device)
    embeds, pos = vision_row(port, cfg, p["embed"])
    out = []
    with torch.inference_mode():
        logits, cache = T.prefill(p, cfg, {"embeds": embeds,
                                           "positions": pos},
                                  max_len=embeds.shape[1] + steps + 1)
        out.append(logits.float().cpu())
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            logits, cache = T.decode_step(p, cfg, cache, tok)
            out.append(logits.float().cpu())
    return out


def qwen2vl_batcher(port, dev, cfg, comp) -> dict:
    """The batcher on the batcher path's 24 requests, bf16, batch 8,
    max_len 256: eager on the contiguous and the paged pool (identical
    tokens), then the contiguous pool through ``AotRegistry`` (tokens
    equal, the warm set JAX's, every decode a replay); prefix reuse
    refused under M-RoPE. Returns {run: rates}."""
    torch, E, aot = port.torch, port.engine, port.aot
    reqs = cb_requests(cfg.vocab_size)
    contig = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN)
    paged = E.ServeConfig(batch=CB_BATCH, max_len=CB_MAX_LEN,
                          kv_block=CB_BLOCK)
    rates, outs = {}, {}
    for name, scfg in (("eager contiguous", contig),
                       ("eager paged", paged)):
        cb = E.ContinuousBatcher(comp, cfg, scfg, device=dev)
        res, secs, steps = drive_batcher(port, cb, reqs)
        assert res.status == "drained" and len(res) == CB_REQUESTS, name
        outs[name] = {r.rid: list(r.out) for r in res}
        ntok = sum(len(o) for o in outs[name].values())
        rates[name] = {"tokens_per_s": ntok / secs,
                       "ms_per_step": secs / steps * 1e3}
        log(f"  {name}: {ntok} tokens in {steps} steps, "
            f"{ntok / secs:.1f} tokens/s, {secs / steps * 1e3:.2f} ms/step; "
            f"stats {cb.stats}")
        del cb
        torch.cuda.empty_cache()
    assert outs["eager paged"] == outs["eager contiguous"], \
        "qwen2-vl: the paged pool's tokens differ from the contiguous"
    reg = aot.AotRegistry(cfg, contig, aot.live_fingerprint(comp, cfg))
    cb = E.ContinuousBatcher(comp, cfg, contig, device=dev, executables=reg)
    res, secs, steps, info = drive_graphs(port, cb, reqs)
    out = {r.rid: list(r.out) for r in res}
    ntok = sum(len(o) for o in out.values())
    rates["graphs contiguous"] = {"tokens_per_s": ntok / secs,
                                  "ms_per_step": secs / steps * 1e3,
                                  "warm_s": info["warm_s"]}
    warm_n, want = info["warm"]["aot_compiles"], warm_set_size(
        len(cb.ladder), False, CB_MAX_LEN)
    late = reg.entries()[warm_n:]
    log(f"  graphs contiguous: {ntok} tokens in {steps} steps, "
        f"{ntok / secs:.1f} tokens/s, {secs / steps * 1e3:.2f} ms/step; warm "
        f"{info['warm_s']:.2f} s, {warm_n} entries (JAX's warm set: "
        f"{want}), {sum(reg.graph_bytes().values()) / 2 ** 20:.0f} MB; "
        f"late {late}; decode dispatches {info['decode_calls']}, replays "
        f"{info['decode_replays']}")
    assert res.status == "drained" and len(res) == CB_REQUESTS
    assert out == outs["eager contiguous"], \
        "qwen2-vl: the graph run's tokens differ from the eager run's"
    assert warm_n == want and not late, (warm_n, want, late)
    assert cb.stats["aot_fallbacks"] == 0, cb.stats
    assert info["decode_calls"] > 0 and \
        info["decode_replays"] == info["decode_calls"], info
    del cb, reg
    torch.cuda.empty_cache()
    try:
        E.ContinuousBatcher(comp, cfg, E.ServeConfig(
            batch=CB_BATCH, max_len=CB_MAX_LEN, kv_block=CB_BLOCK,
            prefix_cache=True), device=dev)
    except ValueError as e:
        log(f"  prefix reuse refused: {e}")
    else:
        raise AssertionError("qwen2-vl: prefix reuse was taken")
    return rates


def qwen2vl_phases(port, dev) -> dict:
    """qwen2-vl-72b at full width, depth cut to VL_LAYERS, random weights
    from VL_SEED, the qkv biases seeded, every linear replaced by seeded
    random factors at uniform VL_RATIO (the biases kept), with every launch
    count set to 0 just before its bf16 runs and read just after: the
    vision-stub prefill and VL_NEW decode steps, ``Engine.generate`` on a
    VL_PROMPT-token text prompt, the batcher eager and with graphs; every
    kernel call held against its plain version; then the vision-stub row
    in float32 on the card against the CPU. Returns the summary and the
    kernels line's launches."""
    torch, T, E = port.torch, port.T, port.engine
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== {QWEN_VL}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated on the card before the path")
    with Phase(f"{QWEN_VL} at full width, {VL_LAYERS} of 80 layers: seeded "
               f"qkv biases, random factors at uniform 20%"):
        cfg = port.get_config(QWEN_VL).replace(n_layers=VL_LAYERS)
        t0 = time.perf_counter()
        params, _ = T.init_model(cfg, seed=VL_SEED, device=dev)
        n_params = T.param_count(params)
        gen = torch.Generator(device=dev)
        gen.manual_seed(VL_SEED)
        attn = params["decoder"]["run0"]["attn"]
        for name in ("wq", "wk", "wv"):
            b = attn[name]["b"]
            b.copy_(0.02 * torch.randn(b.shape, generator=gen, device=dev))
        comp, ks = random_factors(port, params, cfg, VL_RATIO, VL_SEED)
        del params, attn
        torch.cuda.synchronize()
        ranks = {}
        for gid, k in ks.items():
            ranks.setdefault(gid.split(":")[0], set()).add(k)
        biased = [p for p in linears(comp) if "b" in p]
        log(f"  {n_params:,} dense params; {T.param_count(comp) / 1e9:.3f} B "
            f"factorized ({VL_LAYERS} layers), ranks {ranks}; "
            f"{len(biased)} factorized linears keep their bias; "
            f"{time.perf_counter() - t0:.1f} s")
        assert n_params == VL_PARAMS, n_params
        assert ranks == VL_RANKS, ranks
        assert len(biased) == 3 * VL_LAYERS and all(
            float(p["b"].abs().max()) > 0 for p in biased)
    port.reset_counts()
    with recording(port) as calls:
        with Phase(f"{QWEN_VL}: bf16 vision-stub prefill and decode, "
                   f"generate, the batcher eager and with graphs"):
            eng = E.Engine(comp, cfg, E.ServeConfig(batch=1), device=dev)
            t0 = time.perf_counter()
            steps = vision_greedy(port, eng.params, cfg, VL_NEW, dev)
            torch.cuda.synchronize()
            vtoks = [int(s[0, -1].argmax()) for s in steps]
            log(f"  vision-stub row ({VL_TEXT[0]} text, {VL_GRID[0]} x "
                f"{VL_GRID[1]} patches, {VL_TEXT[1]} text: "
                f"{sum(VL_TEXT) + VL_GRID[0] * VL_GRID[1]} positions), "
                f"{VL_NEW} decode steps: {time.perf_counter() - t0:.2f} s, "
                f"tokens {vtoks[:8]}")
            assert all(torch.isfinite(s).all() for s in steps)
            prompt = np.random.default_rng(VL_SEED).integers(
                0, cfg.vocab_size, (1, VL_PROMPT), dtype=np.int32)
            t0 = time.perf_counter()
            toks = eng.generate(prompt, VL_NEW)
            torch.cuda.synchronize()
            log(f"  generate, a {VL_PROMPT}-token prompt, {VL_NEW} new: "
                f"{time.perf_counter() - t0:.2f} s, tokens "
                f"{toks[0, :8].tolist()}")
            assert toks.shape == (1, VL_NEW)
            assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
            del eng, steps
            out["rates"] = qwen2vl_batcher(port, dev, cfg, comp)
    out["launches"] = port.counts()
    out["variants"] = variants = port.variant_counts()
    log(f"  launches on the {QWEN_VL} path: {out['launches']}; by variant "
        f"{variants}")
    missing = [n for n in VL_KERNELS if out["launches"][n] <= 0]
    assert not missing, f"kernels not launched on the qwen2-vl path: {missing}"
    assert variants["lowrank_matmul_2d"]["split"] > 0, variants
    for name in TC_KERNELS:
        assert variants[name]["simt"] == 0, \
            f"a bf16 {name} launch took simt on the qwen2-vl path"
    assert_gemv(variants["lowrank_gemv"], "bfloat16", "the qwen2-vl path")
    with Phase(f"{QWEN_VL}: the path's kernel calls against the plain "
               f"versions, every variant, the first call of each operand "
               f"signature"):
        log(f"  {len(calls)} signatures")
        hold_recorded(port, calls, "bfloat16", f"the {QWEN_VL} path")
    del calls
    torch.cuda.empty_cache()
    with Phase(f"{QWEN_VL} float32, card against CPU, the vision-stub row"):
        cfg32 = cfg.replace(dtype="float32")
        port.reset_counts()
        with recording(port) as calls32:
            t0 = time.perf_counter()
            gpu = vision_greedy(port, comp, cfg32, VL_NEW_F32, dev)
            card_s = time.perf_counter() - t0
        assert_gemv(port.variant_counts()["lowrank_gemv"], "float32",
                    "the qwen2-vl float32 run")
        t0 = time.perf_counter()
        cpu = vision_greedy(port, comp, cfg32, VL_NEW_F32,
                            torch.device("cpu"))
        log(f"  {VL_NEW_F32} new tokens: card {card_s:.1f} s, cpu "
            f"{time.perf_counter() - t0:.1f} s")
        compare_greedy(torch, gpu, cpu)
        out["parity"] = max(abs_err(a, b) for a, b in zip(gpu, cpu))
        log(f"  the float32 run's {len(calls32)} kernel signatures against "
            f"the plain versions:")
        hold_recorded(port, calls32, "float32", f"the {QWEN_VL} float32 path")
    del comp, calls32, gpu, cpu
    torch.cuda.empty_cache()
    return out


def log_encdec_vl(enc: dict, vl: dict) -> None:
    """The seamless and qwen2-vl summary lines."""
    s = enc["secs"]
    log(f"{SEAMLESS}: compression seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in s.items()
        if k not in ("artifact_mb", "achieved_ratio"))
        + f"; artifact {s['artifact_mb']:.1f} MB; achieved ratio "
        f"{s['achieved_ratio']:.4f} (requested {ENC_RATIO}); decode at "
        f"batch 8: " + ", ".join(
            f"{k} {v['ms_per_step']:.3f} ms/step" for k, v in
            enc["tput"].items())
        + f"; non-causal flash launches {enc['noncausal']}; float32 card "
        f"against CPU max |logits| {enc['parity']:.3e}; train step "
        f"{enc['train']}")
    log(f"{QWEN_VL} ({VL_LAYERS} layers): batcher, batch {CB_BATCH}: "
        + ", ".join(f"{k} {v['ms_per_step']:.2f} ms/step, "
                    f"{v['tokens_per_s']:.1f} tokens/s"
                    for k, v in vl["rates"].items())
        + f"; by variant {vl['variants']}; float32 card against CPU max "
        f"|logits| {vl['parity']:.3e}")


# ---------------------------------------------------------------------------
# The mesh (ROADMAP Queue 1, item 11): world 2 on the one card over gloo
# through pinned host memory, the serve CLI under torchrun, NCCL at world 1
# ---------------------------------------------------------------------------
def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def wq_tags(cfg) -> list:
    return [f"decoder/run{r}/{i}/attn/wq"
            for r, (_, n) in enumerate(cfg.layer_runs()) for i in range(n)]


class QRChain:
    """Capture target: the single-shard QR chain ``R' = qr_r([R; X])`` of
    ``tags``, batch by batch, as ``StreamingCalibrator``'s whiten route
    computes it on one device (float32, from a zero factor)."""

    def __init__(self, torch, tags):
        self.torch, self.tags, self.R = torch, set(tags), {}

    def add(self, tag, x) -> None:
        if tag not in self.tags:
            return
        torch = self.torch
        x2 = x.detach().reshape(-1, x.shape[-1]).float()
        R = self.R.get(tag)
        if R is None:
            R = torch.zeros((x2.shape[1],) * 2, dtype=torch.float32,
                            device=x2.device)
        self.R[tag] = torch.linalg.qr(torch.cat([R, x2]), mode="r")[1]

    def add_expert_batch(self, tag, xs) -> None:
        pass


def single_chain(port, params, cfg, calib, tags) -> dict:
    """The single-shard whitening factors of ``tags`` over ``calib``: one
    forward pass a batch, nothing else captured."""
    from repro_torch.models.params import set_capture
    torch, Cap = port.torch, port.capture
    tagged = Cap.tag_linears(Cap.to_list_params(params, cfg))
    chain = QRChain(torch, tags)
    set_capture(chain)
    try:
        with torch.no_grad():
            for b in calib:
                port.T.forward(tagged, cfg, b)
    finally:
        set_capture(None)
    return {t: R.double().cpu().numpy() for t, R in chain.R.items()}


def sign_fixed(R: np.ndarray) -> np.ndarray:
    s = np.sign(np.diag(R)).copy()
    s[s == 0] = 1.0
    return s[:, None] * R


def _npz_key(tag: str) -> str:
    return tag.replace("/", ".")


class EPDrops:
    """Within the block, the MoE layers' dropped rows under expert
    parallelism, by wrapping ``models.mlp._dispatch_to_buffers``: a layer
    calls it three times (the T·k repeated rows to the ep shards, their
    meta rows, the received rows to the local experts). The first level
    drops an assignment where it keeps no slot; the second where it keeps
    none for a row that holds data (a received buffer's empty rows are
    exact zeros and take expert 0's spare capacity, as in JAX)."""

    def __init__(self, port):
        self.mlp = port.mlp
        self.first = self.second = None
        self.assigned = 0
        self.calls = 0

    def __enter__(self):
        inner = self.inner = self.mlp._dispatch_to_buffers

        def spy(x, dest, n_dest, capacity):
            buf, slot, kept = inner(x, dest, n_dest, capacity)
            level = self.calls % 3
            if level == 0:
                self.assigned += x.shape[0]
                lost = (~kept).sum()
                self.first = lost if self.first is None else self.first + lost
            elif level == 2:
                lost = (~kept & (x.abs().sum(-1) > 0)).sum()
                self.second = (lost if self.second is None
                               else self.second + lost)
            self.calls += 1
            return buf, slot, kept
        self.mlp._dispatch_to_buffers = spy
        return self

    def __exit__(self, *exc):
        self.mlp._dispatch_to_buffers = self.inner
        return False

    def counts(self) -> dict:
        return {"assigned": self.assigned,
                "dropped_first_level": int(self.first or 0),
                "dropped_second_level": int(self.second or 0)}


def ep_local(port, params, mesh):
    """This rank's E/ep experts of every MoE layer (``local_block`` of the
    stacked (layers, E, ...) expert arrays along ``model``); everything
    else whole, as JAX's EP body holds it."""
    from repro_torch.dist import sharding as SH
    spec = SH.P(None, "model")
    out = port.pytree.tree_map(lambda x: x, params)     # new containers
    for run in out["decoder"].values():
        moe = run.get("moe") if isinstance(run, dict) else None
        for k in ("w_gate", "w_up", "w_down") if moe else ():
            moe[k] = SH.local_block(moe[k], spec, mesh).contiguous()
    return out


def _digest(arrays) -> list:
    """Float sums of each array, in order: equal on two ranks only if their
    values are (here: identical all-reduced and gathered results)."""
    return [float(np.asarray(a, dtype=np.float64).sum()) for a in arrays]


def mesh_calibration(port, dev, rank: int, comm) -> dict:
    """World 2 over the one card: SmolLM-360M's mesh calibration on the main
    path's batches (``w_down``'s 2560-wide input sharded, the wq tags
    whitened per shard), the device decomposition spread over the ranks,
    and the same decomposition on one process from the same Collector;
    then ``generate`` on the mesh-compressed model. Rank 0 writes its
    Grams and factors for the parent's comparison with the main path."""
    from repro_torch.launch.mesh import make_host_mesh
    torch, T, CC, Cap, E = (port.torch, port.T, port.compress, port.capture,
                            port.engine)
    out = {}
    mesh = make_host_mesh(data=MESH_WORLD, model=1)
    cfg = port.get_config(ARCH)
    params, _ = T.init_model(cfg, seed=0, device=dev)
    calib = calib_batches(port, cfg, dev)
    port.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cal = Cap.StreamingCalibrator(
        Cap.to_list_params(params, cfg), cfg, mesh=mesh,
        flush_every=FLUSH_EVERY, whiten_tags=wq_tags(cfg),
        shard_grams_above=MESH_SHARD_ABOVE)
    for b in calib:
        cal.ingest(b)
    routes = out["route_of"] = dict(cal.routes)
    shapes = {t: list(a["gram"].shape) for t, a in cal.accumulators.items()
              if routes[t] == "sharded"}
    col = cal.finalize()
    torch.cuda.synchronize()
    out["calibration_s"] = time.perf_counter() - t0
    out["launches_calibration"] = port.counts()
    out["routes"] = {r: sum(v == r for v in routes.values())
                     for r in ("replicated", "sharded", "whiten")}
    for t, s in shapes.items():
        d = col.gram[t].shape[0]
        assert t.endswith("/mlp/w_down") and s == [d // MESH_WORLD, d], \
            (t, s)
    assert out["routes"]["sharded"] == cfg.n_layers, out["routes"]
    assert out["launches_calibration"]["gram_blocked"] > 0
    out["sharded_block"] = next(iter(shapes.values()))
    out["gram_digest"] = _digest(col.gram[t] for t in sorted(col.gram))
    out["chol_digest"] = _digest(col.chol[t] for t in sorted(col.chol))
    if rank == 0:
        np.savez(MESH_DIR / "grams.npz", **{
            _npz_key(t): g.astype(np.float32) for t, g in col.gram.items()})
        np.savez(MESH_DIR / "chol.npz", **{
            _npz_key(t): R for t, R in col.chol.items()})

    ccfg = CC.CompressionConfig(method="drank", ratio=0.2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp, plan = CC.build_plan_and_params(params, cfg, ccfg, calib,
                                          collector=col, device=True,
                                          mesh=mesh)
    torch.cuda.synchronize()
    out["spread_s"] = time.perf_counter() - t0
    out["ranks"] = {g.gid: g.k for g in plan.groups}
    lin = linears(comp)
    out["factor_digest"] = [float(sum(x[k].double().sum().item()
                                      for x in lin)) for k in ("B", "C")]
    if rank == 0:
        t0 = time.perf_counter()
        comp1, plan1 = CC.build_plan_and_params(params, cfg, ccfg, calib,
                                                collector=col, device=True)
        torch.cuda.synchronize()
        out["single_s"] = time.perf_counter() - t0
        assert {g.gid: g.k for g in plan1.groups} == out["ranks"], \
            "the spread decomposition's ranks differ from one process's"
        out["sigma_rel"] = max(
            _rel64(np.asarray(a.sigma_head), np.asarray(b.sigma_head))
            for a, b in zip(plan.groups, plan1.groups))
        fac = 0.0
        for a, b in zip(lin, linears(comp1)):
            pa = a["B"].double() @ a["C"].double()
            pb = b["B"].double() @ b["C"].double()
            fac = max(fac, float((pa - pb).abs().max() / pb.abs().max()))
        out["bc_rel"] = fac
        assert out["sigma_rel"] < SIG_TOL and fac < FACTOR_TOL, \
            (out["sigma_rel"], fac)
        del comp1
        # the mesh-compressed model serves
        port.reset_counts()
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)
        t0 = time.perf_counter()
        toks = E.Engine(comp, cfg, E.ServeConfig(
            batch=GEN_BATCH, max_len=GEN_PROMPT + GEN_NEW + 1),
            device=dev).generate(prompts, GEN_NEW)
        torch.cuda.synchronize()
        out["generate_s"] = time.perf_counter() - t0
        out["launches_generate"] = port.counts()
        assert toks.shape == (GEN_BATCH, GEN_NEW) and (
            (toks >= 0) & (toks < cfg.vocab_size)).all()
    comm.barrier()
    del params, comp, col, cal
    torch.cuda.empty_cache()
    return out


def mesh_train(port, dev, rank: int, comm) -> dict:
    """Data-parallel training at world 2 on the training path's float32 cut
    (SmolLM-360M at TRAIN_PARITY_LAYERS layers), DP_STEPS steps of DP_ROWS x
    DP_SEQ tokens, and on rank 0 the single-process Trainer on the same
    global batches."""
    torch = port.torch
    cfg = port.get_config(ARCH).replace(n_layers=TRAIN_PARITY_LAYERS,
                                        dtype="float32")
    dcfg = port.synthetic.DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=DP_SEQ, global_batch=DP_ROWS)
    tcfg = port.TS.TrainConfig(optimizer=port.adamw.OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=DP_STEPS + 1))

    def run(shard: int, n: int) -> dict:
        port.reset_counts()
        tr = port.loop.Trainer(cfg, tcfg, dcfg, port.loop.LoopConfig(
            total_steps=DP_STEPS, log_every=1, shard_id=shard,
            num_shards=n), seed=0, device=dev)
        c = comm.current()
        ar = c.seconds.get("all_reduce", 0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.run()["history"]
        torch.cuda.synchronize()
        return {"losses": [h["loss"] for h in hist],
                "ms_per_step": (time.perf_counter() - t0) / DP_STEPS * 1e3,
                "all_reduce_ms": (c.seconds.get("all_reduce", 0.0) - ar)
                / DP_STEPS * 1e3, "launches": port.counts()}
    out = {"world2": run(rank, MESH_WORLD), "dp_bytes": dp_step_bytes(
        port, dev, comm, cfg, tcfg)}
    if rank == 0:
        out["world1"] = run(0, 1)
    comm.barrier()
    torch.cuda.empty_cache()
    return out


def dp_step_bytes(port, dev, comm, cfg, tcfg) -> dict:
    """One data-parallel step at world 2: the result bytes per collective
    family that ``Comm.report()`` shows for it, and the op counter's count
    of the same step on meta (``dist.comm.counting``)."""
    import torch.distributed as dist
    torch, TS, OA = port.torch, port.TS, port.OA
    state, _ = TS.init_train_state(cfg, seed=0, device=dev)
    batch = {"tokens": torch.zeros((DP_ROWS // MESH_WORLD, DP_SEQ),
                                   dtype=torch.int32, device=dev)}
    step = TS.make_train_step(cfg, tcfg, group=dist.group.WORLD)
    before = dict(comm.current().report()["bytes"])
    new, _ = step(state, batch)
    torch.cuda.synchronize()
    after = comm.current().report()["bytes"]
    counted = OA.count(step, *OA.to_meta((state, batch)), world=MESH_WORLD)
    del new, state, counted["out"]
    return {"real": {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)},
            "counted": counted["collectives"]["per_op"],
            "calls": counted["collectives"]["calls"]}


def mesh_moe(port, dev, rank: int, comm) -> dict:
    """Expert parallelism on (data 1, model 2): granite-moe-1b-a400m at full
    width, EP_LAYERS layers, random weights from MOE_SEED, each rank
    holding half of every layer's experts: bf16 ``generate`` with the
    drops counted, then the float32 forward and greedy decode on the card
    against the same ranks on the CPU (``moe_parity``)."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    torch, T, E = port.torch, port.T, port.engine
    mesh = make_host_mesh(data=1, model=MESH_WORLD)
    cfg = port.get_config(MOE).replace(n_layers=EP_LAYERS)
    params, _ = T.init_model(cfg, seed=MOE_SEED, device=dev)
    local = ep_local(port, params, mesh)
    del params
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (EP_BATCH, EP_PROMPT), dtype=np.int32)
    out = {}
    with SH.use_rules(mesh=mesh):
        port.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with EPDrops(port) as drops:
            toks = E.Engine(local, cfg, E.ServeConfig(
                batch=EP_BATCH, max_len=EP_PROMPT + EP_NEW + 1),
                device=dev).generate(prompts, EP_NEW)
        torch.cuda.synchronize()
        out["generate_s"] = time.perf_counter() - t0
        out["launches"] = port.counts()
        out["drops"] = drops.counts()
        out["tokens"] = np.asarray(toks).tolist()
        t0 = time.perf_counter()
        out["parity"] = moe_parity(port, dev, cfg, local, prompts, None,
                                   EP_PARITY_STEPS, f"EP rank {rank}")
        out["parity_s"] = time.perf_counter() - t0
    comm.barrier()
    return out


def mesh_rank(rank: int, init_method: str) -> None:
    """One rank of the world-2 job on the card, spawned by ``mesh_phase``:
    joins the process group (gloo through pinned host memory: the ranks
    share the one card), runs the calibration, training and MoE parts and
    writes its results to MESH_DIR/rank{r}.json. Any failure raises, and
    the parent's spawn fails with it."""
    global log
    sys.path.insert(0, str(SRC))
    quiet = log

    def log(msg: str = "") -> None:          # noqa: F811
        quiet(f"  [rank {rank}] {msg}")

    port = Port()
    from repro_torch.dist import comm
    c = comm.init(MESH_WORLD, rank, "cuda", init_method=init_method)
    try:
        assert (c.backend, c.transport) == ("gloo", "pinned-host"), c
        out = {"rank": rank}
        out["calibration"] = mesh_calibration(port, c.device, rank, comm)
        out["training"] = mesh_train(port, c.device, rank, comm)
        out["moe"] = mesh_moe(port, c.device, rank, comm)
        out["comm"] = c.report()
    finally:
        comm.shutdown()
    (MESH_DIR / f"rank{rank}.json").write_text(json.dumps(out))


def nccl_world1(port) -> None:
    """NCCL at world 1 on the card, the only NCCL a one-card host can run:
    every ``comm`` wrapper once on CUDA tensors, each equal to its
    definition at world 1."""
    torch = port.torch
    from repro_torch.dist import comm
    c = comm.init(1, 0, "cuda", init_method=f"tcp://localhost:{_free_port()}")
    try:
        assert (c.backend, c.transport) == ("nccl", "nccl"), c
        x = torch.randn(6, 5, generator=torch.Generator(device=c.device)
                        .manual_seed(3), device=c.device)
        got = {"all_reduce_sum": (comm.all_reduce_sum(x), x),
               "all_reduce_mean": (comm.all_reduce_mean(x), x),
               "all_gather_rows": (comm.all_gather_rows(x), x),
               "all_to_all": (comm.all_to_all(x[None]), x[None]),
               "broadcast": (comm.broadcast(x, src=0), x),
               "gather_rows_to_host": (comm.gather_rows_to_host(x)[0],
                                       x.cpu())}
        for name, (a, b) in got.items():
            assert a.device == b.device and torch.equal(a, b), name
        assert comm.all_reduce_ints([3, 4]) == [3, 4]
        comm.barrier()
        log(f"  NCCL at world 1 on {c.device} (the only NCCL one card can "
            f"run; ranks that share the card use gloo): "
            f"{', '.join(got)}, all_reduce_ints and barrier each equal to "
            f"its definition; calls {c.calls}")
    finally:
        comm.shutdown()


def mesh_phase(port, dev, cfg, plan, col, eager, calib, params) -> dict:
    """The mesh on the one H100 (ROADMAP Queue 1, item 11), with the main
    path's batches, its streaming and eager fp64 Collectors and its plan as
    references: the world-2 job
    (``mesh_rank``, two processes on cuda:0 over gloo), and beside it the
    serve CLI under ``torchrun --standalone --nproc-per-node 2`` with
    ``--calib-mesh-shards 2``; then NCCL at world 1. Every spawned process
    must exit 0."""
    import os
    import torch.multiprocessing as mp
    torch = port.torch
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    out = {}
    t0 = time.perf_counter()
    chain = single_chain(port, params, cfg, calib, wq_tags(cfg))
    torch.cuda.synchronize()
    log(f"  single-shard QR chain of the {len(chain)} wq tags on the main "
        f"path's batches: {time.perf_counter() - t0:.2f} s")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(MESH_WORLD), "-m",
         "repro_torch.launch.serve", *MESH_CLI], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t_cli = time.perf_counter()
    try:
        t0 = time.perf_counter()
        mp.spawn(mesh_rank, args=(f"tcp://localhost:{_free_port()}",),
                 nprocs=MESH_WORLD, join=True)
        out["job_s"] = time.perf_counter() - t0
        ranks = [json.loads((MESH_DIR / f"rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        out["ranks"] = ranks
        check_mesh_ranks(ranks, plan, col, eager, chain, out)
        cli_out, cli_err = cli.communicate(timeout=900)
        out["cli_s"] = time.perf_counter() - t_cli
        assert cli.returncode == 0, \
            f"the torchrun CLI exited {cli.returncode}: {cli_err[-3000:]}"
        report = json.loads(cli_out[cli_out.rindex("\n{\n") + 1:])
        log(f"  torchrun --nproc-per-node {MESH_WORLD} serve "
            f"--calib-mesh-shards {MESH_WORLD}: exit 0, "
            f"{report['drain_status']}, world {report['world']}, backend "
            f"{report['comm']['backend']} ({report['comm']['transport']}, "
            f"{report['comm']['staged_bytes'] / 2 ** 20:.0f} MiB staged on "
            f"rank 0), {report['generated_tokens']} tokens, "
            f"{out['cli_s']:.1f} s beside the world-2 job")
        assert report["drain_status"] == "drained", report
        assert report["world"] == MESH_WORLD, report
        assert report["comm"]["backend"] == "gloo", report
        out["cli_report"] = {k: report[k] for k in ("world", "comm")}
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    nccl_world1(port)
    log(f"  NCCL world 1: {time.perf_counter() - t0:.2f} s")
    return out


def check_mesh_ranks(ranks, plan, col, eager, chain, out) -> None:
    """The world-2 job's results against the main path's streaming and
    eager fp64 Collectors, its plan and the single-shard chain; both ranks
    equal."""
    r0, r1 = ranks
    c0, c1 = r0["calibration"], r1["calibration"]
    assert c0["gram_digest"] == c1["gram_digest"], "ranks' Grams differ"
    assert c0["chol_digest"] == c1["chol_digest"], "ranks' factors differ"
    assert c0["factor_digest"] == c1["factor_digest"], \
        "the ranks hold different factors"
    assert c0["ranks"] == c1["ranks"]
    worst_r = 0.0
    # by route, the worst tag against the streaming Grams and against the
    # fp64 oracle, with the streaming Grams' own distance from the oracle
    worst = {}
    with np.load(MESH_DIR / "grams.npz") as z:
        tags = {k.replace(".", "/") for k in z.files}
        assert tags == set(col.gram) - set(chain), "tag sets differ"
        for t in sorted(tags):
            g = z[_npz_key(t)].astype(np.float64)
            w = worst.setdefault(c0["route_of"][t], {
                "streaming": (0.0, ""), "fp64": (0.0, ""),
                "streaming_fp64": 0.0})
            w["streaming"] = max(w["streaming"], (_rel64(g, col.gram[t]), t))
            w["fp64"] = max(w["fp64"], (_rel64(g, eager.gram[t]), t))
            w["streaming_fp64"] = max(w["streaming_fp64"],
                                      _rel64(col.gram[t], eager.gram[t]))
    worst_g = max(w["streaming"][0] for w in worst.values())
    worst_e = max(w["fp64"][0] for w in worst.values())
    with np.load(MESH_DIR / "chol.npz") as z:
        assert {k.replace(".", "/") for k in z.files} == set(chain)
        for t, R in chain.items():
            worst_r = max(worst_r, _rel64(sign_fixed(z[_npz_key(t)]),
                                          sign_fixed(R)))
    main_ranks = {g.gid: g.k for g in plan.groups}
    flips = {g: (k, c0["ranks"].get(g)) for g, k in main_ranks.items()
             if c0["ranks"].get(g) != k}
    log(f"  mesh calibration, world {MESH_WORLD} on one card (gloo, pinned "
        f"host): {c0['calibration_s']:.2f} s; routes {c0['routes']}, each "
        f"sharded w_down a {c0['sharded_block']} block a rank; "
        f"{len(tags)} Grams max-relative {worst_g:.3e} against the main "
        f"path's single-process streaming Grams (tolerance "
        f"{MESH_GRAM_REL:.0e}), {worst_e:.3e} against the eager fp64 "
        f"Collector (tolerance {CALIB_RTOL:.0e}, phase 3's); "
        f"{len(chain)} tree-reduced wq factors {worst_r:.3e} against the "
        f"single-shard chain after the sign fix (tolerance "
        f"{MESH_FACTOR_REL:.0e}); gram_blocked launches "
        f"{c0['launches_calibration']['gram_blocked']} / "
        f"{c1['launches_calibration']['gram_blocked']} by rank")
    log(f"  device decomposition spread over {MESH_WORLD} ranks: "
        f"{c0['spread_s']:.2f} s (one process on the same Collector "
        f"{c0['single_s']:.2f} s): {len(main_ranks)} groups, rank flips "
        f"against the main path's plan {len(flips)}; against one process "
        f"on the same Grams σ {c0['sigma_rel']:.3e} (tolerance "
        f"{SIG_TOL:.0e}), B·C {c0['bc_rel']:.3e} (tolerance "
        f"{FACTOR_TOL:.0e}); factors identical on both ranks; generate on "
        f"the mesh-compressed model {c0['generate_s']:.2f} s, launches "
        f"{c0['launches_generate']}")
    for route, w in sorted(worst.items()):
        log(f"    {route} route: worst against the streaming Grams "
            f"{w['streaming'][0]:.3e} ({w['streaming'][1]}), against the "
            f"fp64 oracle {w['fp64'][0]:.3e} ({w['fp64'][1]}); the streaming"
            f" Grams of this route against the oracle at worst "
            f"{w['streaming_fp64']:.3e}")
    out["gram_worst"] = worst
    assert worst_g < MESH_GRAM_REL, "mesh Grams disagree with the main path"
    assert worst_e < CALIB_RTOL, "mesh Grams disagree with the fp64 oracle"
    assert worst_r < MESH_FACTOR_REL, \
        "tree-reduced factors disagree with the single-shard chain"
    assert not flips, f"mesh plan's ranks differ from the main path's: {flips}"
    d0, d1 = r0["training"], r1["training"]
    w1 = d0["world1"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(d0["world2"]["losses"], w1["losses"]))
    log(f"  data-parallel training, world {MESH_WORLD}, {TRAIN_PARITY_LAYERS} "
        f"layers float32, {DP_STEPS} steps of {DP_ROWS} x {DP_SEQ} tokens: "
        f"losses {[round(x, 6) for x in d0['world2']['losses']]}, "
        f"max-relative {loss_rel:.3e} against one process (tolerance 1e-5); "
        f"{d0['world2']['ms_per_step']:.1f} / {d1['world2']['ms_per_step']:.1f}"
        f" ms/step by rank, of them all-reduce "
        f"{d0['world2']['all_reduce_ms']:.1f} / "
        f"{d1['world2']['all_reduce_ms']:.1f} ms (one flat bucket, "
        f"staged through pinned host memory); world 1 "
        f"{w1['ms_per_step']:.1f} ms/step; {card_line()}")
    for r, d in enumerate((d0, d1)):
        log(f"  accounting, one DP step at world {MESH_WORLD} on rank {r}: "
            f"counted on meta {d['dp_bytes']['counted']} "
            f"({d['dp_bytes']['calls']}), Comm.report() "
            f"{d['dp_bytes']['real']} (result bytes per family)")
        assert d["dp_bytes"]["counted"] == d["dp_bytes"]["real"], \
            "counted collective bytes differ from the real step's"
        assert d["dp_bytes"]["real"].get("all_reduce", 0) > 0
    assert d0["world2"]["losses"] == d1["world2"]["losses"]
    assert loss_rel < 1e-5, "data-parallel losses differ from one process"
    assert d0["world2"]["launches"]["flash_attention"] > 0
    m0, m1 = r0["moe"], r1["moe"]
    log(f"  expert parallelism (data 1, model {MESH_WORLD}), {MOE} at "
        f"{EP_LAYERS} layers: bf16 generate {EP_BATCH} x {EP_PROMPT} + "
        f"{EP_NEW} in {m0['generate_s']:.2f} s, tokens identical on both "
        f"ranks: {m0['tokens'] == m1['tokens']}; drops by rank "
        f"{m0['drops']} / {m1['drops']}; float32 card against CPU "
        f"{m0['parity']} ({m0['parity_s']:.1f} s); launches "
        f"{m0['launches']}")
    assert m0["tokens"] == m1["tokens"], "EP ranks generated other tokens"
    assert m0["parity"]["padding_assignments"] == 0
    out["launches"] = {
        "calibration": [r["calibration"]["launches_calibration"]
                        for r in ranks],
        "generate (rank 0)": c0["launches_generate"],
        "training": [r["training"]["world2"]["launches"] for r in ranks],
        "ep generate": [r["moe"]["launches"] for r in ranks]}
    log(f"  comm: rank 0 {r0['comm']}")


# ---------------------------------------------------------------------------
# Sharded training: FSDP, tensor, vocab and expert parallelism at world 4
# ---------------------------------------------------------------------------
def sharded_cases(port) -> dict:
    """The phase's cases: (config, global batches, train config, count
    drops). Batches are seeded; each rank takes its data shard."""
    import dataclasses
    tcfg = port.TS.TrainConfig(optimizer=port.adamw.OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=DP_STEPS + 1))
    smol = port.get_config(ARCH).replace(n_layers=TRAIN_PARITY_LAYERS)
    gr = port.get_config(MOE)
    gr = gr.replace(n_layers=SH_MOE_LAYERS, dtype="float32",
                    moe=dataclasses.replace(gr.moe,
                                            capacity_factor=SH_MOE_CAPACITY))

    def batches(cfg, n, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, cfg.vocab_size, (DP_ROWS, DP_SEQ),
                             dtype=np.int32) for _ in range(n)]
    gr_tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, lr=SH_MOE_LR))
    return {"smollm float32": (smol.replace(dtype="float32"),
                               batches(smol, DP_STEPS, 21), tcfg, False),
            "smollm bfloat16": (smol, batches(smol, DP_STEPS, 21), tcfg,
                                False),
            "granite float32": (gr, batches(gr, SH_MOE_STEPS, 22), gr_tcfg,
                                True)}


def sharded_run(port, dev, cfg, batches, tcfg, mesh=None, drops=False):
    """``len(batches)`` train steps from seed 0: on ``mesh`` each rank
    holds its blocks (``TS.shard_state``) and takes its data shard of each
    global batch; without, one process on the whole state. Returns the
    losses, ms/step, collective seconds, the state's bytes as held, the
    allocator's peak, the launches and the (q, kv) heads of every flash
    call. On ``mesh`` every kernel call of the steps, the first of each
    operand signature, is then held again through every variant against
    the plain version on the same operands (``hold_recorded``)."""
    from repro_torch.dist import comm
    torch, TS = port.torch, port.TS
    state, specs = TS.init_train_state(cfg, seed=0, device=dev)
    if mesh is not None:
        state, _ = TS.shard_state(state, specs, mesh)
        torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size()
               for t in port.pytree.tensors(state))
    step = TS.make_train_step(cfg, tcfg, mesh=mesh)
    n = mesh.shape["data"] if mesh is not None else 1
    d = mesh.coord("data") if mesh is not None else 0
    rows = DP_ROWS // n
    heads, inner = set(), port.ops.flash_attention

    def spy(q, k, v, *a, **kw):
        heads.add((int(q.shape[2]), int(k.shape[2])))    # (q, kv) heads
        return inner(q, k, v, *a, **kw)
    c = comm.current() if mesh is not None else None
    sec0 = dict(c.seconds) if c else {}
    port.ops.flash_attention = spy
    port.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"state_bytes": held, "base": torch.cuda.memory_allocated()}
    try:
        with (EPDrops(port) if drops else contextlib.nullcontext()) as dr, \
                (recording(port) if mesh is not None
                 else contextlib.nullcontext([])) as calls:
            losses, norms = [], []
            t0 = time.perf_counter()
            for b in batches:
                tok = torch.as_tensor(b[d * rows:(d + 1) * rows], device=dev)
                state, m = step(state, {"tokens": tok})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        port.ops.flash_attention = inner
    out.update(losses=losses, grad_norms=norms,
               ms_per_step=dt / len(batches) * 1e3,
               peak=torch.cuda.max_memory_allocated(),
               launches=port.counts(),
               flash_heads=[list(h) for h in sorted(heads)])
    if c:
        out["seconds"] = {k: v - sec0.get(k, 0.0)
                          for k, v in c.seconds.items()
                          if v != sec0.get(k, 0.0)}
    if drops:
        out["drops"] = dr.counts()
    del state, step
    if calls:
        dname = "float32" if cfg.dtype == "float32" else "bfloat16"
        log(f"  {cfg.name} {dname}: the steps' {len(calls)} kernel "
            f"signatures against the plain versions:")
        hold_recorded(port, calls, dname, f"the sharded {cfg.name} path")
        out["held"] = len(calls)
    del calls
    torch.cuda.empty_cache()
    return out


def sharded_rank(rank: int, init_method: str) -> None:
    """One rank of the world-4 sharded-training job on the card, spawned
    by ``sharded_phase``: joins the process group (gloo through pinned
    host memory), runs every case of ``sharded_cases`` on the (data 2,
    model 2) mesh and writes its results to SH_DIR/rank{r}.json. Any
    failure raises, and the parent's join fails with it."""
    global log
    sys.path.insert(0, str(SRC))
    quiet = log

    def log(msg: str = "") -> None:          # noqa: F811
        quiet(f"  [rank {rank}] {msg}")

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port = Port()
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import make_host_mesh
    world = SH_MESH[0] * SH_MESH[1]
    c = comm.init(world, rank, "cuda", init_method=init_method)
    try:
        assert (c.backend, c.transport) == ("gloo", "pinned-host"), c
        mesh = make_host_mesh(*SH_MESH)
        out = {"rank": rank, "coords": [mesh.coord("data"),
                                        mesh.coord("model")]}
        for name, (cfg, batches, tcfg, drops) in sharded_cases(port).items():
            out[name] = sharded_run(port, c.device, cfg, batches, tcfg,
                                    mesh, drops)
        out["comm"] = c.report()
    finally:
        comm.shutdown()
    (SH_DIR / f"rank{rank}.json").write_text(json.dumps(out))


def sharded_accounting(port) -> dict:
    """``account_cell`` of each case's train step on a shapes-only (data 2,
    model 2) mesh, on meta: the rules' state bytes a rank and the
    predicted peak."""
    from repro_torch import config as C
    from repro_torch.launch.mesh import Mesh
    name = "chip_sharded"
    C.SHAPES[name] = C.ShapeConfig(name, DP_SEQ, DP_ROWS, "train")
    mesh = Mesh(SH_MESH, ("data", "model"), rank=0, build_groups=False)
    out = {}
    try:
        for case, (cfg, _, _, _) in sharded_cases(port).items():
            arch = MOE if case.startswith("granite") else ARCH
            over = {k: getattr(cfg, k) for k in ("n_layers", "dtype", "moe")}
            out[case] = port.dryrun.account_cell(arch, name, mesh,
                                                 overrides=over)
    finally:
        del C.SHAPES[name]
    return out


def sharded_phase(port, dev) -> dict:
    """World 4 = (data 2, model 2) on the one card (``sharded_rank``), and
    meanwhile in this process the one-process steps on the same global
    batches (granite's with one microbatch a data shard, so that its MoE
    aux statistic is each shard's, as under JAX's EP body) and the
    accounting's cells on meta. Each rank's losses against
    one process, its state's bytes against ``rule_state_bytes`` exactly,
    the flash launches on its local heads."""
    import dataclasses

    import torch.multiprocessing as mp
    shutil.rmtree(SH_DIR, ignore_errors=True)
    SH_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    # a file rendezvous: no port to pick, so none that another process
    # can take between its choice and its bind
    ctx = mp.spawn(sharded_rank, args=(f"file://{SH_DIR / 'pg'}",),
                   nprocs=SH_MESH[0] * SH_MESH[1], join=False)
    try:
        # granite's one process takes one microbatch a data shard: its aux
        # statistic is then each data shard's, as under the EP body
        one = {name: sharded_run(port, dev, cfg, batches, dataclasses.replace(
                   tcfg, microbatches=SH_MESH[0] if drops else 1))
               for name, (cfg, batches, tcfg, drops) in
               sharded_cases(port).items()}
        acct = sharded_accounting(port)
        while not ctx.join():
            pass
        job_s = time.perf_counter() - t0
        ranks = [json.loads((SH_DIR / f"rank{r}.json").read_text())
                 for r in range(len(ctx.processes))]
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        shutil.rmtree(SH_DIR, ignore_errors=True)
    out = {"job_s": job_s, "launches": {}}
    card = card_line()
    for name, ref in one.items():
        dname = "bfloat16" if "bfloat16" in name else "float32"
        mem = acct[name]["memory"]
        for r in ranks:
            got = r[name]
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(got["losses"], ref["losses"]))
            gn = (abs(got["grad_norms"][0] - ref["grad_norms"][0])
                  / ref["grad_norms"][0])
            secs = ", ".join(f"{k} {v:.3f}" for k, v in
                             sorted(got["seconds"].items()))
            log(f"  {name}, rank {r['rank']} (data, model) {r['coords']}: "
                f"losses {[round(x, 6) for x in got['losses']]} against one "
                f"process's {[round(x, 6) for x in ref['losses']]}, "
                f"max-relative {rel:.3e} (tolerance {SH_LOSS_REL[dname]}); "
                f"the first step's grad norm {got['grad_norms'][0]:.7f} "
                f"against {ref['grad_norms'][0]:.7f} ({gn:.2e}); "
                f"state {got['state_bytes']} bytes held, rule_state_bytes "
                f"{mem['rule_state_bytes']} (whole {ref['state_bytes']}); "
                f"{got['ms_per_step']:.1f} ms/step (one process "
                f"{ref['ms_per_step']:.1f}), collective seconds {secs}; "
                f"max_memory_allocated {got['peak']} (of it before the "
                f"steps {got['base']}) against the accounting's peak "
                f"{mem['peak_bytes']}; flash (q, kv) heads "
                f"{got['flash_heads']} in {got['launches']['flash_attention']}"
                f" launches, {got['held']} kernel signatures held to the "
                f"plain version" + (f"; drops {got['drops']} (capacity factor "
                                f"{SH_MOE_CAPACITY}: none may drop)"
                                if "drops" in got else "") + f"; {card}")
            assert rel <= SH_LOSS_REL[dname], \
                f"{name}: rank {r['rank']}'s losses differ from one process"
            assert gn <= SH_LOSS_REL[dname], \
                f"{name}: rank {r['rank']}'s grads differ from one process"
            assert got["state_bytes"] == mem["rule_state_bytes"], \
                f"{name}: rank {r['rank']} holds other bytes than the rules"
            assert got["launches"]["flash_attention"] > 0
            assert got["held"] > 0, f"{name}: rank {r['rank']} held no call"
            if name.startswith("granite"):
                cfg = sharded_cases(port)[name][0]
                assert got["flash_heads"] == [
                    [cfg.n_heads // SH_MESH[1], cfg.n_kv_heads // SH_MESH[1]]]
                assert got["drops"]["dropped_first_level"] == 0
                assert got["drops"]["dropped_second_level"] == 0
            else:
                assert got["flash_heads"] == [[15, 5]]   # heads replicated
        out["launches"][name] = [r[name]["launches"] for r in ranks]
    log(f"  world {len(ranks)} job {job_s:.1f} s (spawn, init, every case; "
        f"the one-process steps and the accounting beside it); comm rank "
        f"0: {ranks[0]['comm']}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke runs the "
              "port on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not at {SRC}/repro_torch; "
              f"run this script from the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    with Phase("environment"):
        card = card_line()
        log(card)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        port = Port()
        build_kernels(port)
    try:
        with Phase("main path: SmolLM-360M, streaming calibration, D-Rank "
                   "20% on the card, save, boot, generate"):
            cfg, params, comp, plan, (counts, variants), col, calib = \
                main_path(port, dev)
        with Phase("mesh: world 2 on the one card over gloo (mesh "
                   "calibration, the spread decomposition, data-parallel "
                   "training, expert parallelism), the serve CLI under "
                   "torchrun, NCCL at world 1"):
            eager = eager_collector(port, cfg, params, calib)
            mesh = mesh_phase(port, dev, cfg, plan, col, eager, calib,
                              params)
        with Phase("sharded training: world 4 = (data 2, model 2) on the "
                   "one card over gloo, FSDP and tensor, vocab and expert "
                   "parallelism of the params and AdamW state (SmolLM-360M "
                   "float32 and bf16, granite float32)"):
            sharded = sharded_phase(port, dev)
        with Phase("batcher path: ContinuousBatcher from the artifact, "
                   "contiguous, paged and prefix pools, fault plans"):
            cb_counts, snap, rates, cb_outs = batcher_path(port, dev, cfg,
                                                           comp)
        with Phase("graph path: the batcher through AotRegistry, one CUDA "
                   "graph per decode and prefill signature"):
            _, graph_rates, kept = graph_path(port, dev, cfg, comp, cb_outs,
                                              rates)
        with Phase("graph step profile, bf16, batch 8"):
            graph_windows = graph_profile(port, kept)
        with Phase("dense against D-Rank with graphs, bf16, batch 8"):
            fig4 = fig4_graphs(port, dev, cfg, params, comp, kept)
        del kept
        torch.cuda.empty_cache()
        with Phase("the serve CLI: python -m repro_torch.launch.serve --aot "
                   "on the artifact"):
            cli_path(port, cfg)
        with Phase("two replicas on the card with graphs: late elastic "
                   "captures while the other replica serves"):
            replica_graphs(port)
    finally:
        shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    with Phase(f"gemma3 path: {GEMMA} at full width, {GEMMA_LAYERS} layers, "
               f"random factors at uniform 20%, bf16 generate, float32 card "
               f"against CPU"):
        gemma_shapes = gemma_path(port, dev)
    with Phase("batcher step profile, bf16, batch 8"):
        profile_batcher(port, dev, cfg, comp, graph=graph_windows)
    with Phase("streaming Grams against the eager fp64 oracle, every tag"):
        streaming_vs_eager(port, cfg, params, col, calib, eager)
    del col, eager
    with Phase(f"device decomposition against the host fp64 oracle, "
               f"{ORACLE_LAYERS} layers"):
        device_vs_host(port, dev, calib)
    with Phase("kernels against their plain versions on the card"):
        errs = check_kernels(port, dev, comp)
    with Phase("kernel times (bfloat16, main-path shapes)"):
        times = time_kernels(port, dev, cfg, comp, snap)
    with Phase("kernel times (bfloat16, the dense configs' shapes)"):
        large = time_large_shapes(port, dev)
    with Phase("kernel times (float32 2-D product, simt against split)"):
        f32_2d = time_float32_2d(port, dev, comp, gemma_shapes)
    with Phase("decode throughput, prompt 128, 64 new tokens"):
        tput = throughput(port, dev, cfg, params, comp)
    step_ms = np.median([m["ms_per_step"] for m in tput[("drank-20%", 8)]])
    kern_ms = times["lowrank_gemv"]["ms"] + times["decode_attention"]["ms"]
    log(f"D-Rank decode step at batch 8: {step_ms:.3f} ms/step against "
        f"{kern_ms:.3f} ms of gemv + decode-attention kernel time "
        f"(kernel share {kern_ms / step_ms:.1%})")
    with Phase("decode step profile, D-Rank 20%, batch 8"):
        profile_decode(port, dev, cfg, comp)
    with Phase("parity: float32, card kernels against CPU plain versions"):
        parity(port, dev, cfg, comp)
    with Phase("accounting: the op counter on a decode step and a prefill, "
               "on the card and on meta; full-size cells on meta"):
        acct = accounting_phase(port, dev, cfg, comp)
    del params, comp
    torch.cuda.empty_cache()
    try:
        with Phase("training path: SmolLM-360M Trainer, resume, float32 "
                   "card against CPU, compress the trained model, LoRA, "
                   "the train and serve --ckpt CLIs"):
            train_counts, train = train_path(port, dev)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        shutil.rmtree(CLI_TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    moe = moe_phases(port, dev)
    torch.cuda.empty_cache()
    rec = {}
    for arch in (HYMBA, XLSTM):
        rec[arch] = recurrent_phases(port, dev, arch)
        torch.cuda.empty_cache()
    enc = seamless_phases(port, dev)
    torch.cuda.empty_cache()
    vl = qwen2vl_phases(port, dev)
    torch.cuda.empty_cache()

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    for name in ("bf16 contiguous", "bf16 paged", "bf16 contiguous again"):
        r = rates[name]
        log(f"batcher {name}, batch {CB_BATCH}: {r['tokens_per_s']:.1f} "
            f"tokens/s, {r['ms_per_step']:.2f} ms/step (host clock between "
            f"syncs, admissions included)")
    for name, r in graph_rates.items():
        log(f"batcher {name} with graphs, batch {CB_BATCH}: "
            f"{r['tokens_per_s']:.1f} tokens/s, {r['ms_per_step']:.2f} "
            f"ms/step (warm {r['warm_s']:.2f} s)")
    log("with graphs, bf16, batch 8, ms/step: " + ", ".join(
        f"{k} {' / '.join(f'{v:.3f}' for v in vs)}" for k, vs in
        fig4.items()))
    log(f"train step (SmolLM-360M, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"{TRAIN_MICRO} microbatches, remat block): "
        f"{train['ms_per_step']:.2f} ms/step, {train['tokens_per_s']:.0f} "
        f"tokens/s, model FLOPs {train['flop_share']:.2%} of 989 TFLOP/s, "
        f"device idle {train['idle']:.1%} of a profiled step (estimated "
        f"{train['idle_estimate']:.1%} of an unprofiled one), peak "
        f"{train['peak_gib']:.2f} GiB, {train['flash_per_step']:.0f} flash "
        f"launches a step; submit " + ", ".join(
            f"{x:.1f}" for x in train["submit_ms"]) + " ms, saves "
        + ", ".join(f"{x:.2f}" for x in train["save_s"]) + " s; LoRA "
        f"{train['lora_ms']:.1f} ms/step; perplexity (synthetic data) "
        + ", ".join(f"{k} {v:.2f}" for k, v in train["ppl"].items()))
    for name, a in (("D-Rank decode step", acct["decode"]),
                    ("D-Rank prefill", acct["prefill"]),
                    ("train step", train["accounting"])):
        rf = a["roofline"]
        log(f"accounting, {name}: card count = meta count; the step's own "
            f"peak bytes predicted {a['own_predicted']}, measured "
            f"{a['own_measured']} ({a['own_miss']:.2%}); whole peak "
            f"predicted {a['memory']['peak_bytes'] / 2 ** 30:.4f} GiB, "
            f"measured {a['measured_peak'] / 2 ** 30:.4f} GiB "
            f"({a['peak_miss']:.2%}); "
            f"model FLOPs {a['model_share']:.2%}, counted "
            f"{a['counted_share']:.2%} of 989 TFLOP/s; roofline "
            f"{rf['dominant']} {max(rf['compute_s'], rf['memory_s']) * 1e3:.3f}"
            f" ms against {a['ms']:.3f} ms")
    log("accounting, full-size cells on meta: " + "; ".join(
        f"{k} fits {v['fits']} (peak {v['peak_bytes'] / 1e9:.1f} GB, "
        f"{v['count_s']:.2f} s)" for k, v in acct["cells"].items()))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        # the paged kernel's launches are its path's: the batcher's
        launches = (cb_counts if name == "decode_attention_paged"
                    else counts)[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "work": t["work"], "train_launches": train_counts[name],
            "moe_launches": moe["launches"][name],
            "hymba_launches": rec[HYMBA]["launches"][name],
            "xlstm_launches": rec[XLSTM]["launches"][name],
            "seamless_launches": enc["launches"][name],
            "qwen2vl_launches": vl["launches"][name],
            "mesh_launches": {
                part: ([c[name] for c in v] if isinstance(v, list)
                       else v[name])
                for part, v in mesh["launches"].items()},
            "sharded_launches": {
                part: [c[name] for c in v]
                for part, v in sharded["launches"].items()}})
        if "simt_ms" in t:     # the variant the main path ran, the earlier
            kernels[-1].update(variant="+".join(t["variant"]),
                               launches_by_variant=variants[name],
                               simt_ms=t["simt_ms"])
        if "split_ms" in t:
            kernels[-1]["split_ms"] = t["split_ms"]
        if "splitk_ms" in t:   # the gemv: the earlier three-launch design
            kernels[-1].update(variant="+".join(t["variant"]),
                               launches_by_variant=variants[name],
                               splitk_ms=t["splitk_ms"])
    log_moe(moe)
    for arch, r in rec.items():
        log_recurrent(arch, r)
    log_encdec_vl(enc, vl)
    by_name = {k["name"]: k for k in kernels}
    wide = times["lowrank_gemv@64"]
    by_name["lowrank_gemv"]["rows_64"] = dict(
        work=wide["work"], ms=wide["ms"], splitk_ms=wide["splitk_ms"],
        plain_ms=wide["plain_ms"], library_ms=wide["library_ms"],
        bound_ms=wide["bound"][0], bound_by=wide["bound"][1])
    by_name["flash_attention"]["gemma3_hd256"] = large["flash_hd256"]
    by_name["lowrank_matmul_2d"]["by_shape"] = large["lowrank_2d"]
    by_name["lowrank_matmul_2d"]["float32"] = f32_2d
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
