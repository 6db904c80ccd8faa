"""The port's decode-shaped low-rank product ``lowrank_gemv`` on the CPU:
the Python mirror of the two-launch kernel's geometry (``gemv_plan``)
against the constants of ``csrc/lowrank_matmul.cu``, that its blocks cover
every weight element exactly once within one block's shared memory, the
variant rule, and a plain-PyTorch walk of its summation order against the
JAX ``lowrank_gemv``. The kernel itself runs only on the card
(``chip_smoke.py`` holds it against its plain version there)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import lowrank_matmul as lm
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

CSRC = Path(lm.__file__).resolve().parents[1] / "csrc"
SMEM_MAX = 232448            # a block's shared memory on sm_90
H100 = (132, 233472)         # an H100 SXM's SMs and shared memory an SM

# SmolLM-360M's compressed linears at D-Rank 20% (ragged ranks, 698 the
# largest), gemma3-12b's MLP (both ways) and attention at uniform 20%, its
# widest reduction with its widest output (K 15360, R 2457, N 15360), and a
# rank whose rows start on no 4-byte boundary
SHAPES = [(960, 300, 960), (960, 120, 320), (960, 121, 320),
          (960, 298, 960), (960, 698, 2560), (960, 697, 2560),
          (2560, 600, 960), (3840, 2457, 15360), (15360, 2457, 3840),
          (3840, 1585, 4096), (15360, 2457, 15360), (100, 13, 77)]


def _c_constant(path: Path, name: str) -> int:
    m = re.search(rf"\b{name}\s*=\s*(\d+)\s*;", path.read_text())
    assert m, f"{name} not found in {path.name}"
    return int(m.group(1))


def test_gemv_plan_mirrors_the_cuda_source():
    src = CSRC / "lowrank_matmul.cu"
    for name, value in (("GV2_WS", lm.GEMV_STRIP), ("GV2_KC", lm.GEMV_CHUNK),
                        ("GV2_STAGES", lm.GEMV_STAGES),
                        ("GV2_MAX_CLUSTER", lm.GEMV_MAX_CLUSTER),
                        ("GV2_MAX_ROWS", lm.GEMV_MAX_ROWS)):
        assert _c_constant(src, name) == value, name
    assert _c_constant(src, "MM_SMEM_MAX") == SMEM_MAX
    tile = _c_constant(CSRC / "hopper_mma.cuh", "TILE")
    raw, swizzled = tile * (tile // 8 + 1) * 16, tile * tile * 2
    stages, kc, ws = lm.GEMV_STAGES, lm.GEMV_CHUNK, lm.GEMV_STRIP
    for M, mt in ((1, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64)):
        p16 = lm.gemv_plan(M, 960, 697, 2560, torch.bfloat16, H100)
        p32 = lm.gemv_plan(M, 960, 697, 2560, torch.float32, H100)
        assert p16["rows_tile"] == p32["rows_tile"] == mt
        assert p16["stages"] == stages
        assert p16["t_stride"] == 704 and p32["t_stride"] == 700
        # the peers' partial sums: rows of 64 + 4 float32
        recv = (mt + lm.GEMV_MAX_CLUSTER) * (ws + 4) * 4
        for lt in p16["launches"]:
            assert lt["smem"] == (128 + stages * (raw + mt * kc * 2)
                                  + swizzled + recv)
        for lt in p32["launches"]:
            assert lt["smem"] == (128 + stages * (kc * ws * 4 + mt * kc * 4)
                                  + recv)


@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("K,R,N", SHAPES)
def test_every_weight_element_falls_in_one_block(M, K, R, N):
    """Launch 1 tiles B (K x R), launch 2 C (R x N): each block owns a
    strip of columns and its cluster rank's rows; together they cover each
    element exactly once, no block is empty, and the grid is the product
    of strips and cluster ranks."""
    plan = lm.gemv_plan(M, K, R, N, torch.bfloat16, H100)
    for lt, (rows, cols) in zip(plan["launches"], ((K, R), (R, N))):
        ws, cs = lt["strip_width"], lt["cluster"]
        assert lt["grid"] == (lt["strips"], cs, 1)
        assert 1 <= cs <= lm.GEMV_MAX_CLUSTER
        assert lt["strips"] * ws >= cols > (lt["strips"] - 1) * ws
        splits = lt["k_splits"]
        assert len(splits) == cs and splits[0][0] == 0
        assert splits[-1][1] == rows
        for (a0, a1), (b0, b1) in zip(splits, splits[1:]):
            assert a1 == b0
        assert all(k0 < k1 and k0 % lm.GEMV_CHUNK == 0 for k0, k1 in splits)
        assert all(k1 - k0 <= lt["chunks_per_block"] * lm.GEMV_CHUNK
                   for k0, k1 in splits)
        if rows * cols <= 4_000_000:
            seen = np.zeros((rows, cols), np.int8)
            for s in range(lt["strips"]):
                for k0, k1 in splits:
                    seen[k0:k1, s * ws:(s + 1) * ws] += 1
            assert (seen == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shared_memory_fits_one_block(dtype):
    for M in range(1, lm.GEMV_MAX_ROWS + 1):
        for lt in lm.gemv_plan(M, 15360, 2457, 15360, dtype,
                               H100)["launches"]:
            assert lt["smem"] <= SMEM_MAX
    # two bf16 blocks of 64 rows fit one SM (228 KB, 1 KB reserved each)
    if dtype == torch.bfloat16:
        smem = lm.gemv_plan(64, 960, 697, 2560, dtype,
                            H100)["launches"][0]["smem"]
        assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("M", [2, 8, 64])
@pytest.mark.parametrize("card", [H100, (114, 233472)])
def test_block_target_halves_below_the_big_weight_bound(M, card):
    """A launch aims at the blocks the card holds at once at its shared
    memory, halved for a weight under GEMV_BIG_BYTES: SmolLM-360M's w_up
    (B 1.3 MB) takes the half, gemma3-12b's (B 19 MB) the whole; a card
    with fewer SMs (an H100 PCIe's 114) aims at fewer."""
    mt = lm.gemv_plan(M, 1, 1, 1, torch.bfloat16, card)["rows_tile"]
    smem = lm._gemv_smem(2, mt)
    held = card[0] * (card[1] // (smem + 1024))
    assert lm._gemv_target_blocks(2, mt, 960 * 698 * 2, card) == held // 2
    assert lm._gemv_target_blocks(2, mt, 3840 * 2457 * 2, card) == held
    small = lm.gemv_plan(M, 960, 698, 2560, torch.bfloat16,
                         card)["launches"][0]
    big = lm.gemv_plan(M, 3840, 2457, 15360, torch.bfloat16,
                       card)["launches"][0]
    assert small["blocks"] == held // 2 and big["blocks"] == held
    assert small["cluster"] == min(8, (held // 2) // small["strips"])
    assert big["cluster"] == min(8, held // big["strips"])
    assert lm._gemv_blocks(M, 3840, 2457, 15360, 2, card) == \
        (held, held)


@pytest.mark.parametrize("M", [1, 8, 64])
def test_variant_rule(M):
    bf, f32 = torch.bfloat16, torch.float32
    assert lm._variant_gemv(bf, M, 960, 697) == "mma"
    assert lm._variant_gemv(f32, M, 960, 697) == "fma"
    assert lm._allowed_gemv(bf, M, 960, 697) == ("mma", "splitk")
    assert lm._allowed_gemv(f32, M, 2560, 13) == ("fma", "splitk")
    # x not on a 16-byte boundary, or its rows not: the earlier design
    assert lm._variant_gemv(bf, M, 960, 697, aligned=False) == "splitk"
    assert lm._variant_gemv(f32, M, 960, 697, aligned=False) == "splitk"
    assert lm._variant_gemv(bf, M, 100, 13) == "splitk"
    assert lm._variant_gemv(f32, M, 962, 13) == "splitk"
    assert lm._variant_gemv(bf, M, 960, 697, variant="splitk") == "splitk"
    with pytest.raises(ValueError):
        lm._variant_gemv(bf, M, 960, 697, variant="fma")
    with pytest.raises(ValueError):
        lm._variant_gemv(f32, M, 960, 697, variant="mma")
    with pytest.raises(ValueError):
        lm._variant_gemv(bf, M, 960, 697, aligned=False, variant="mma")


def test_rows_past_the_decode_bound_take_splitk():
    assert lm._allowed_gemv(torch.bfloat16, 65, 960, 697) == ("splitk",)
    assert lm._allowed_gemv(torch.bfloat16, 8, 960, 0) == ("splitk",)


@pytest.mark.parametrize("variant", [None, "mma", "fma", "splitk"])
def test_gemv_refuses_cpu_tensors_and_counts_nothing(variant):
    before = (lm.lowrank_gemv.launches,
              dict(lm.lowrank_gemv.launches_by_variant))
    with pytest.raises(ValueError, match="CUDA"):
        lm.lowrank_gemv(torch.zeros(8, 64, dtype=torch.bfloat16),
                        torch.zeros(64, 8, dtype=torch.bfloat16),
                        torch.zeros(8, 64, dtype=torch.bfloat16),
                        variant=variant)
    assert before == (lm.lowrank_gemv.launches,
                      lm.lowrank_gemv.launches_by_variant)
    assert set(lm.lowrank_gemv.launches_by_variant) == {"mma", "fma",
                                                        "splitk"}


def plan_walk(x: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor) -> torch.Tensor:
    """The two-launch kernel's sums in plain PyTorch: in each launch one
    float32 partial per cluster rank (its rows of the reduction, the plan's
    ``k_splits``), summed in rank order and rounded once to the operands'
    dtype; t between."""
    M, K = x.shape
    R, N = C.shape
    plan = lm.gemv_plan(M, K, R, N, x.dtype, H100)

    def launch(a, w, lt):
        parts = [a[:, k0:k1].float() @ w[k0:k1].float()
                 for k0, k1 in lt["k_splits"]]
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return s.to(w.dtype)
    t = launch(x, B, plan["launches"][0])
    return launch(t, C, plan["launches"][1])


def chunk_sum(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """round(a @ w) as float32 products of consecutive 64-row chunks of the
    reduction, added first to last, written out without the plan."""
    s = a[:, :64].float() @ w[:64].float()
    for k0 in range(64, a.shape[1], 64):
        s = s + a[:, k0:k0 + 64].float() @ w[k0:k0 + 64].float()
    return s.to(w.dtype)


@pytest.mark.parametrize("M,K,R,N", [(7, 200, 130, 90), (3, 320, 13, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_walk_matches_jax_gemv(M, K, R, N, dtype):
    """At ragged ranks whose reductions split over one cluster rank a
    64-row chunk: the walk of the plan gives the bits of the chunks summed
    in order (a plan that split or ordered the reduction otherwise would
    not), and agrees with the JAX op (its Pallas gemv in interpret mode, as
    tests/test_decode_fast_path.py runs it): 2e-5 in float32, 2e-2 in
    bfloat16, t rounded once in both."""
    plan = lm.gemv_plan(M, K, R, N, dtype, H100)
    assert [lt["cluster"] for lt in plan["launches"]] == \
        [-(-K // 64), -(-R // 64)]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((M, K)).astype(np.float32)
    B = (0.1 * rng.standard_normal((K, R))).astype(np.float32)
    C = (0.1 * rng.standard_normal((R, N))).astype(np.float32)
    xt, Bt, Ct = (torch.tensor(a).to(dtype) for a in (x, B, C))
    y = plan_walk(xt, Bt, Ct)
    assert torch.equal(y, chunk_sum(chunk_sum(xt, Bt), Ct))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    yj = np.asarray(jops.lowrank_matmul(
        *(jnp.asarray(a, dtype=jdt) for a in (x, B, C))).astype(jnp.float32))
    y = y.float().numpy()
    err = np.max(np.abs(y - yj)) / (np.max(np.abs(yj)) + 1e-6)
    assert err < (2e-5 if dtype == torch.float32 else 2e-2), err
