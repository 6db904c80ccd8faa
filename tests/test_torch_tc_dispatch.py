"""How the tensor-core (``"wgmma"``), CUDA-core (``"simt"``) and two-launch
(``"split"``) variants of ``lowrank_matmul_2d`` and the variants of
``gram_blocked`` are chosen: by dtype and shape alone, through pure
functions that run here. The kernels themselves run only on the card
(``chip_smoke.py`` holds each variant against its plain version there)."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gram as gm
from repro_torch.kernels import lowrank_matmul as lm
from repro_torch.kernels import tc_profile as tcp
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

CSRC = Path(lm.__file__).resolve().parents[1] / "csrc"

# SmolLM-360M's compressed linears (d_model 960, d_ff 2560, 5 KV heads of
# 64), each at a D-Rank rank such as the plan gives, 698 the largest
SMOLLM_LINEARS = [(960, 300, 960), (960, 120, 320), (960, 121, 320),
                  (960, 298, 960), (960, 698, 2560), (960, 697, 2560),
                  (2560, 600, 960)]


@pytest.mark.parametrize("M", [65, 512, 2048])
@pytest.mark.parametrize("K,R,N", SMOLLM_LINEARS)
def test_bf16_main_path_shapes_take_the_tensor_cores(M, K, R, N):
    assert lm._variant_2d(torch.bfloat16, M, K, R, N) == "wgmma"


@pytest.mark.parametrize("K,R,N", SMOLLM_LINEARS + [(100, 13, 77)])
def test_float32_stays_on_the_cuda_cores(K, R, N):
    """The fused CUDA-core kernel below ``SPLIT_ROWS_F32`` rows, the
    two-launch variant's CUDA-core products from there on."""
    assert lm.SPLIT_ROWS_F32 == 512
    assert not lm._split_on_tensor_cores(torch.float32, K, N)
    assert lm._variant_2d(torch.float32, 128, K, R, N) == "simt"
    assert lm._variant_2d(torch.float32, 511, K, R, N) == "simt"
    assert lm._variant_2d(torch.float32, 512, K, R, N) == "split"
    assert lm._allowed_2d(torch.float32, 2048, K, R, N) == ("split", "simt")
    assert gm._variant(torch.float32, 1024, K) == "simt"


@pytest.mark.parametrize("K,R,N,aligned,why", [
    (100, 13, 960, True, "K % 8"),
    (960, 13, 77, True, "N % 8"),
    (960, 300, 960, False, "x or C not 16-byte aligned"),
    (960, 1000, 960, True, "t of 64 rows does not fit shared memory"),
    (0, 16, 960, True, "empty reduction"),
])
def test_shapes_the_tensor_core_kernel_refuses_take_simt(K, R, N, aligned,
                                                         why):
    """Such shapes never take "wgmma". Where the two-launch variant has no
    tensor cores either, the fused CUDA-core kernel comes first; where it
    has them (only t is too large for the fused kernel), it comes first."""
    tc = lm._split_on_tensor_cores(torch.bfloat16, K, N, aligned)
    want = ("split", "simt") if tc else ("simt", "split")
    assert tc == (R == 1000), why
    assert lm._allowed_2d(torch.bfloat16, 512, K, R, N, aligned) == want, why
    assert lm._variant_2d(torch.bfloat16, 512, K, R, N, aligned) == want[0]


@pytest.mark.parametrize("N,D,aligned,want", [
    (1024, 960, True, "wgmma"), (1024, 2560, True, "wgmma"),
    (1000, 960, True, "wgmma"), (0, 64, True, "wgmma"),
    (1024, 97, True, "simt"), (1024, 964, True, "simt"),
    (1024, 960, False, "simt")])
def test_gram_variant(N, D, aligned, want):
    assert gm._variant(torch.bfloat16, N, D, aligned) == want


def _c_constant(path: Path, name: str) -> int:
    """The value of a constant, or of the macro it is set to by default
    (``WG_S2 = DRT_WG_S2`` with ``#define DRT_WG_S2 6``)."""
    text = path.read_text()
    m = re.search(rf"\b{name}\s*=\s*(\w+)", text)
    assert m, f"{name} not found in {path.name}"
    value = m.group(1)
    if not value.isdigit():
        d = re.search(rf"#define {value}\s+(\d+)", text)
        assert d, f"{value} has no default in {path.name}"
        value = d.group(1)
    return int(value)


def test_rank_limits_mirror_the_cuda_sources():
    """The Python mirrors of the kernels' shared-memory formulas use the
    constants the CUDA sources compile with."""
    src = CSRC / "lowrank_matmul.cu"
    assert _c_constant(src, "MM_SMEM_MAX") == lm.SMEM_MAX
    s1, s2 = _c_constant(src, "WG_S1"), _c_constant(src, "WG_S2")
    tile = 64 * 64 * 2
    raw = 64 * (64 // 8 + 1) * 16
    groups = _c_constant(src, "WG_GROUPS")
    ring = max(s1 * (tile + groups * raw) + 2 * groups * tile,
               s2 * groups * tile)
    n = 0
    while 1024 + (n + 1) * tile + ring <= lm.SMEM_MAX - 1024:
        n += 1
    assert lm.wgmma_max_rank() == 64 * n
    rp = 0       # drt_lowrank_2d_max_rank: float32 t of 32 rows
    while 4 * ((rp + 64) * 32 + 64 * 64 + 64 * 33) <= lm.SMEM_MAX:
        rp += 64
    assert lm.simt_max_rank() == rp == 1600


def test_t_that_does_not_fit_the_tensor_core_kernel_takes_split_first():
    """bf16 ranks above the fused tensor-core kernel's bound take the
    two-launch tensor-core variant ahead of the fused CUDA-core one (it was
    measured 13.8-19.8x faster at rank 1585); the CUDA-core kernel stays allowed up to
    its own bound, and takes such ranks where split has no tensor cores."""
    wg = lm.wgmma_max_rank()
    assert lm._allowed_2d(torch.bfloat16, 512, 960, 1000, 960) == \
        ("split", "simt")
    assert lm._allowed_2d(torch.bfloat16, 512, 960, wg + 1, 960) == \
        ("split", "simt")
    assert lm._allowed_2d(torch.bfloat16, 512, 100, 1000, 960) == \
        ("simt", "split")
    assert lm._allowed_2d(torch.float32, 256, 960, 1000, 960) == \
        ("simt", "split")
    assert lm._allowed_2d(torch.float32, 512, 960, 1000, 960) == \
        ("split", "simt")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_no_rank_that_worked_before_is_refused(dtype):
    """Every rank is taken in both dtypes: up to the tensor-core kernel's
    bound bf16 keeps "wgmma"; above it bf16 takes "split" on the tensor
    cores; float32 keeps "simt" up to 1600 (the CUDA-core kernel's bound)
    below ``SPLIT_ROWS_F32`` rows and takes "split" from there on; above
    1600, where ``_variant_2d`` used to raise, every operand takes
    "split"."""
    wg = lm.wgmma_max_rank()
    assert 698 <= wg < 1600 == lm.simt_max_rank()
    for R in range(1, 1601):
        v = lm._variant_2d(dtype, 512, 960, R, 960)
        if dtype == torch.bfloat16:
            assert v == ("wgmma" if R <= wg else "split")
        else:
            assert v == "split"
            assert lm._variant_2d(dtype, 128, 960, R, 960) == "simt"
    for R in (1601, 2457, 3018, 10000):
        assert lm._allowed_2d(dtype, 512, 960, R, 960) == ("split",)
        assert lm._variant_2d(dtype, 512, 960, R, 960) == "split"


@pytest.mark.parametrize("dtype,K,R,N,variant", [
    (torch.float32, 960, 698, 2560, "wgmma"),
    (torch.bfloat16, 960, 1000, 960, "wgmma"),
    (torch.bfloat16, 100, 13, 77, "wgmma"),
    (torch.bfloat16, 960, 1601, 960, "simt"),
    (torch.bfloat16, 960, 300, 960, "tensor-cores"),
])
def test_forcing_a_variant_the_shape_does_not_allow_raises(dtype, K, R, N,
                                                           variant):
    with pytest.raises(ValueError):
        lm._variant_2d(dtype, 512, K, R, N, variant=variant)


def test_forcing_an_allowed_variant_is_honoured():
    assert lm._variant_2d(torch.bfloat16, 512, 960, 698, 2560,
                          variant="simt") == "simt"
    assert gm._variant(torch.bfloat16, 1024, 960, variant="simt") == "simt"
    with pytest.raises(ValueError):
        gm._variant(torch.float32, 1024, 960, variant="wgmma")
    with pytest.raises(ValueError):
        gm._variant(torch.bfloat16, 1024, 97, variant="wgmma")


@pytest.mark.parametrize("variant", [None, "wgmma", "simt", "split"])
def test_wrappers_refuse_cpu_tensors_and_count_nothing(variant):
    before = (lm.lowrank_matmul_2d.launches,
              dict(lm.lowrank_matmul_2d.launches_by_variant),
              gm.gram_blocked.launches,
              dict(gm.gram_blocked.launches_by_variant))
    x = torch.zeros(128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        lm.lowrank_matmul_2d(x, torch.zeros(64, 8, dtype=torch.bfloat16),
                             torch.zeros(8, 64, dtype=torch.bfloat16),
                             variant=variant)
    with pytest.raises(ValueError, match="CUDA"):
        gm.gram_blocked(x, variant=variant)
    assert before == (lm.lowrank_matmul_2d.launches,
                      lm.lowrank_matmul_2d.launches_by_variant,
                      gm.gram_blocked.launches,
                      gm.gram_blocked.launches_by_variant)
    assert set(lm.lowrank_matmul_2d.launches_by_variant) == {
        "wgmma", "simt", "split"}
    assert set(gm.gram_blocked.launches_by_variant) == {"wgmma", "simt"}


@pytest.mark.parametrize("D", [97, 960, 2560])
def test_gram_tile_schedule_covers_the_upper_triangle_once(D):
    nt = -(-D // 64)
    tiles = gm.tiles(D)
    assert len(tiles) == nt * (nt + 1) // 2
    assert sorted(tiles) == [(i, j) for i in range(nt) for j in range(i, nt)]
    # each block's tile and its mirror write every output tile exactly once
    cover = {}
    for i, j in tiles:
        for t in {(i, j), (j, i)}:
            cover[t] = cover.get(t, 0) + 1
    assert len(cover) == nt * nt and set(cover.values()) == {1}


@pytest.mark.parametrize("module,source", [(lm, "lowrank_matmul.cu"),
                                           (gm, "gram.cu")])
def test_every_entry_point_a_wrapper_calls_is_defined(module, source):
    """The C functions the wrapper reaches through ctypes (each variant's,
    and the bounds chip_smoke.py checks) are defined in the CUDA source."""
    wrapper = Path(module.__file__).read_text()
    if module is lm:   # chip_smoke.py checks the bounds through lm._fn
        wrapper += (CSRC.parents[2] / "chip_smoke.py").read_text()
    called = set(re.findall(r'_fn\("(drt_\w+)"\)', wrapper))
    called |= {"drt_gram"} if module is gm else set()
    cu = (CSRC / source).read_text()
    defined = set(re.findall(r"^int (drt_\w+)\(", cu, re.M))
    assert called and called <= defined, called - defined


def test_the_wrappers_build_sets_no_debug_switch():
    """The libraries the wrappers load are built without ``-D``: the
    trapping mbarrier wait and the profiling stamps stay out of them."""
    assert not any(f.startswith("-D") for f in _build.flags())
    assert _build.target("gram") == _build.target("gram", _build.CSRC,
                                                  _build.BUILD_DIR, ())


@pytest.mark.parametrize("copy", sorted(tcp.COPIES))
def test_every_profiling_switch_is_read_by_the_sources(copy):
    """Each switch of a profiling copy names a macro the sources test, so
    no copy silently builds the default kernels; each copy builds into a
    library of its own, and ``default`` is the wrappers' library."""
    text = "".join(p.read_text() for p in CSRC.glob("*.cu*"))
    for d in tcp.COPIES[copy]:
        name = d.split("=")[0]
        assert re.search(rf"#if(n?def)? {name}\b", text), name
    jobs = tcp.jobs()
    outs = [v[1] for v in jobs.values()]
    assert len(set(outs)) == len(outs)
    for n in tcp.SOURCES:
        src, out, defines = jobs[copy, n]
        assert src == CSRC / f"{n}.cu" and defines == tcp.COPIES[copy]
        assert (out == _build.target(n)) == (copy == "default")


def test_profiling_against_another_checkout_builds_its_sources(tmp_path):
    """``--against DIR`` builds DIR's sources without switches, into a
    library named after DIR's text, not this checkout's."""
    for p in CSRC.glob("*.cu*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    (tmp_path / "gram.cu").write_text(
        (CSRC / "gram.cu").read_text() + "\n// another checkout\n")
    jobs = tcp.jobs(tmp_path)
    src, out, defines = jobs["against", "gram"]
    assert src == tmp_path / "gram.cu" and defines == ()
    assert out != _build.target("gram")
    # the same text at another path builds the same library name
    assert (jobs["against", "lowrank_matmul"][1].name
            == _build.target("lowrank_matmul").name)
