"""The shape envelope of the port's kernels on the larger dense configs:
ranks above 1600 in ``lowrank_matmul_2d`` and head_dim 256 in the three
attention wrappers, as the JAX kernels take them. Routing and the decode
kernels' chunk arithmetic are pure Python and run here; the kernels run on
the card, where ``chip_smoke.py`` holds them against their plain versions
at these shapes."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lowrank_matmul as lm
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

CSRC = Path(lm.__file__).resolve().parents[1] / "csrc"

# (K, R, N) at uniform 20%, rank 0.8 K N / (K + N): qwen3-4b's MLP,
# gemma3-12b's MLP, mistral-nemo-12b's w_up, gemma3-12b's wq
LARGE_RANKS = [(2560, 1621, 9728), (3840, 2457, 15360), (5120, 3018, 14336),
               (3840, 1585, 4096)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,R,N", LARGE_RANKS)
def test_large_ranks_are_taken(K, R, N, dtype):
    for M in (65, 512, 2048):
        allowed = lm._allowed_2d(dtype, M, K, R, N)
        assert "split" in allowed
        v = lm._variant_2d(dtype, M, K, R, N)
        assert v == allowed[0]
        if dtype == torch.bfloat16:     # on the tensor cores, never simt
            assert v == "split" and lm._split_on_tensor_cores(dtype, K, N)


def test_uniform_ranks_of_the_dense_configs():
    """The ranks above are what uniform 20% gives the configs' linears."""
    def rank(K, N):
        return int(0.8 * K * N / (K + N))
    g = get_config("gemma3-12b")
    assert rank(g.d_model, g.d_ff) == 2457
    assert rank(g.d_model, g.n_heads * g.head_dim) == 1585
    assert rank(2560, 9728) == 1621 and rank(5120, 14336) == 3018


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, ("wgmma", "simt")),
                                        (torch.float32, ("simt",))])
def test_flash_takes_head_dim_256_in_both_variants(dtype, want):
    assert 256 in fa.HEAD_DIMS
    assert fa._allowed(dtype, 256) == want
    assert fa._variant(dtype, 256) == want[0]
    assert fa._allowed(torch.bfloat16, 256, aligned=False) == ("simt",)
    for v in want:
        assert fa._variant(dtype, 256, variant=v) == v
    with pytest.raises(ValueError):
        fa._variant(dtype, 96)


def test_decode_takes_head_dim_256():
    assert 256 in da.HEAD_DIMS and da.MAX_GROUP >= 2


def _cases(text: str, pattern: str) -> set:
    return {int(h) for h in re.findall(pattern, text)}


def test_every_head_dim_has_a_case_in_the_cuda_dispatch():
    flash = (CSRC / "flash_attention.cu").read_text()
    assert set(fa.HEAD_DIMS) == _cases(
        flash, r"case (\d+): return launch_flash<T, \1>")
    assert set(fa.HEAD_DIMS) == _cases(
        flash, r"case (\d+): return launch_flash_wgmma<\1>")
    decode = (CSRC / "decode_attention.cu").read_text()
    assert set(da.HEAD_DIMS) == _cases(decode, r"DA_CASE\((\d+)\)\n")


@pytest.mark.parametrize("module,source", [(fa, "flash_attention.cu"),
                                           (da, "decode_attention.cu")])
def test_every_attention_entry_point_a_wrapper_calls_is_defined(module,
                                                                source):
    """The C functions the attention wrappers reach through ctypes (each
    variant's, and the chunk size chip_smoke.py checks) are defined in the
    CUDA source."""
    text = Path(module.__file__).read_text()
    if module is da:
        text += (CSRC.parents[2] / "chip_smoke.py").read_text()
    called = set(re.findall(r"\b(drt_(?:flash|decode)_\w+)", text))
    cu = (CSRC / source).read_text()
    defined = set(re.findall(r"^int (drt_\w+)\(", cu, re.M))
    assert called and called <= defined, called - defined


def _constant(text: str, pattern: str) -> int:
    m = re.search(pattern, text)
    assert m, pattern
    return int(m.group(1))


def test_decode_chunk_mirrors_the_cuda_source():
    """The decode plan's constants in ``kernels/decode_attention.py`` are
    the CUDA source's (chip_smoke.py holds them to the compiled ones)."""
    text = (CSRC / "decode_attention.cu").read_text()
    assert _constant(text, r"#define DRT_DA_CL (\d+)") == da.CLUSTER
    assert _constant(text, r"constexpr int DA_TILE = (\d+);") == da.TILE
    assert _constant(text, r"constexpr int DA_WARPS = (\d+);") == da.WARPS
    assert _constant(text, r"constexpr int DA_STAGES = (\d+);") == \
        da.STAGES
    vecs = _constant(text, r"constexpr int DA_VECS = (\d+);")
    assert da.RING_BYTES == da.WARPS * da.STAGES * 32 * vecs * 2 * 16
    assert _constant(text, r"constexpr int DA_SMEM_MAX = (\d+);") == \
        da.SMEM_MAX
    assert _constant(text, r"constexpr int DA_GMAX = (\d+);") == \
        da.MAX_GROUP
    assert "return (DA_TILE - 1) / bk + 2;" in text
    assert [da.tile_entries(bk) for bk in (1, 6, 16, 64)] == [65, 12, 5, 2]
    # no grid dimension is taken from the pool: only int32 rows bound it
    assert da.MAX_ROWS == 2 ** 31 - 1


def _visited(plan) -> list:
    return [r for tiles in plan for a, b in tiles for r in range(a, b)]


@pytest.mark.parametrize("length", [0, 1, 17, 31, 32, 33, 64, 80, 155, 257,
                                    63, 65, 511, 512, 513, 1217, 4097,
                                    32768])
def test_decode_chunks_depend_on_the_length_alone(length):
    """The rows each cluster rank of a slot visits, in order, are the same
    in every pool that holds the slot's rows (the contiguous pool at any L,
    the paged pool at any NB * bk), so both layouts and every pool merge
    the same states in the same order; every live row is visited once."""
    pools = [length + extra for extra in (0, 1, 15, 64, 1000)] + [40960]
    seen = {str(da.rank_rows(length, rows)) for rows in pools
            if rows >= length}
    assert len(seen) == 1
    plan = da.rank_rows(length, max(length, 1))
    assert len(plan) == da.CLUSTER
    assert sorted(_visited(plan)) == list(range(length))
    for r, tiles in enumerate(plan):
        # rank r takes tiles r, r + CLUSTER, ... in order, TILE rows each
        # but the slot's last
        assert [a for a, _ in tiles] == list(
            range(r * da.TILE, length, da.CLUSTER * da.TILE))
        assert all(b - a == da.TILE or b == length for a, b in tiles)
    # a rank's tiles span at most tile_entries(bk) table blocks each, and
    # no rank takes more tiles than rank 0 (whose entries the paged
    # kernel's shared memory is sized for)
    for bk in (1, 6, 16):
        for a, b in (t for tiles in plan for t in tiles):
            assert (b - 1) // bk - a // bk + 1 <= da.tile_entries(bk)
    assert all(len(t) <= len(plan[0]) for t in plan)


def test_ring_chunks_cover_the_ring():
    """The ring's live rows are a prefix: [0, min(length, window)); the
    plan visits each once and never a dead ring row or the padding past
    the window."""
    def live(length, window, rows):
        return [s for s in range(min(rows, window)) if length > 0 and
                (length - 1 - s) % window < min(length, window)]
    for window, rows in ((32, 32), (1024, 1024), (16, 24), (100, 128)):
        for length in (0, 1, 5, window - 1, window, window + 1,
                       2 * window + 7, 5000):
            plan = da.rank_rows(length, rows, window=window)
            assert sorted(_visited(plan)) == live(length, window, rows)
    assert da.rank_rows(5, 32, window=32)[0] == [(0, 5)]
    assert da.rank_rows(77, 1024, window=1024)[:2] == [[(0, 64)],
                                                       [(64, 77)]]
    assert da.rank_rows(2000, 1024, window=1024)[7] == [(448, 512),
                                                        (960, 1024)]
    assert da.rank_rows(0, 32, window=32) == [[]] * da.CLUSTER


@pytest.mark.parametrize("window", [1, 2, 5, 32, 100, 1024])
def test_ring_live_rows_are_the_age_rule(window):
    """``live_rows`` of the ring equals the TPU kernel's liveness rule,
    row s < window live iff (len - 1 - s) mod window < min(len, window),
    at every length up to three windows."""
    for length in range(0, 3 * window + 2):
        want = [s for s in range(window) if length > 0 and
                (length - 1 - s) % window < min(length, window)]
        assert list(range(da.live_rows(length, window, window))) == want


@pytest.mark.parametrize("G,hd,paged,rows,bk", [
    (3, 64, False, 97, 1),        # SmolLM-360M's main path
    (3, 64, True, 256, 16),       # its batcher's paged pool
    (2, 256, False, 1217, 1),     # gemma3-12b
    (4, 128, False, 32768, 1),    # mistral-nemo-12b's long cache
    (8, 128, True, 32768, 16),    # qwen2-vl-72b's group, paged, long
    (8, 256, True, 4096, 1)])     # the largest state, one-row blocks
def test_decode_smem_fits_three_blocks_an_sm(G, hd, paged, rows, bk):
    """A block's shared memory fits the card, and three blocks (each with
    the 1 KB the card reserves) fit one SM's 228 KB, so that the main
    path's 320 blocks (B 8 x 5 kv heads x CLUSTER) are resident at once on
    132 SMs."""
    s = da.smem_bytes(G, hd, paged, rows, bk)
    assert s <= da.SMEM_MAX
    assert 3 * (s + 1024) <= 228 * 1024
    assert 3 * 132 >= 8 * 5 * da.CLUSTER
