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


def test_decode_chunk_mirrors_the_cuda_source():
    text = (CSRC / "decode_attention.cu").read_text()
    m = re.search(r"constexpr int DA_CHUNK = (\d+);", text)
    assert m and int(m.group(1)) == da.CHUNK
    assert da.MAX_ROWS == 65535 * da.CHUNK


@pytest.mark.parametrize("length", [0, 1, 17, 31, 32, 33, 64, 80, 155, 257])
def test_decode_chunks_depend_on_the_length_alone(length):
    """A slot's chunks are the same in every pool that holds its rows (the
    contiguous pool at any L, the paged pool at any NB * bk), so the two
    layouts merge the same partials in the same order."""
    pools = [length + extra for extra in (0, 1, 15, 64, 1000)] + [4096]
    seen = {tuple(da.live_chunks(length, rows)) for rows in pools}
    assert len(seen) == 1
    chunks = da.live_chunks(length, pools[0])
    # whole, in order, non-overlapping, CHUNK rows each but the last
    assert [c for c, _ in chunks] == list(range(0, length, da.CHUNK))
    assert all(b - a == da.CHUNK for a, b in chunks[:-1])
    assert (chunks[-1][1] if chunks else 0) == length
    for rows in pools:
        assert len(chunks) <= da.chunks(rows)


def test_ring_chunks_cover_the_ring():
    # the ring's rows may all be live: its chunks follow the window
    assert da.live_chunks(5, 32, window=32) == [(0, 32)]
    assert da.live_chunks(77, 1024, window=1024) == [
        (c, c + da.CHUNK) for c in range(0, 1024, da.CHUNK)]
    assert da.live_chunks(0, 32, window=32) == []
