"""The RMSNorm kernel's geometry (``kernels/rmsnorm.py``), on the CPU.

``rmsnorm_geometry`` decides, from a row's width, dtype and the pointers'
16-byte alignment alone, which of ``csrc/rmsnorm.cu``'s two paths runs
and how the register path splits a row over threads.  The kernel itself
runs only on a card (``tests/test_torch_gpu.py``); here the table is
checked at every width a config uses and at every width the register
path takes, against the instances the CUDA source builds, and the
selector's shared-memory and cost figures are held to it.
"""
import inspect
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import variants as V
from repro_torch.kernels.hw_model import DEFAULT_HW
from repro_torch.kernels.rmsnorm import (CTA_THREADS, MAX_SMEM_BYTES,
                                         MAX_VECS, ROW_THREADS, VEC_BYTES,
                                         max_reg_width, rmsnorm_geometry,
                                         tensor_geometry)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

# every width a config normalizes: d_model, deepseek_v3's MLA latents and
# xlstm's mLSTM output norm at d_inner
WIDTHS = (512, 1536, 1600, 2048, 3072, 4096, 4608, 7168)
DTYPES = (torch.float32, torch.bfloat16)
ARCHS = ("llama2_1b", "gemma_2b", "gemma_7b", "granite_8b", "starcoder2_7b",
         "musicgen_medium", "internvl2_2b", "kimi_k2_1t_a32b",
         "deepseek_v3_671b", "hymba_1p5b", "xlstm_1p3b")


def test_the_widths_are_the_configs_widths():
    widths = set()
    for arch in ARCHS:
        cfg = get_config(arch)
        widths.add(cfg.d_model)
        if cfg.attn_kind == "mla":
            widths |= {cfg.r_kv, cfg.r_q}
        if cfg.block_kind == "xlstm":
            widths.add(cfg.xlstm_config().d_inner)
    assert widths == set(WIDTHS)


def test_the_geometry_takes_no_row_count():
    assert list(inspect.signature(rmsnorm_geometry).parameters) == [
        "d", "dtype", "aligned"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", WIDTHS)
def test_every_config_width_takes_the_register_path(d, dtype):
    geo = rmsnorm_geometry(d, dtype)
    vec = VEC_BYTES // dtype.itemsize
    assert geo.path == "reg" and geo.vec == vec and d % vec == 0
    # the threads' vectors cover the row with no vector to spare a thread,
    # and half the threads a row would need more than a thread holds
    assert geo.threads_per_row * geo.vecs_per_thread * vec >= d
    assert geo.threads_per_row * (geo.vecs_per_thread - 1) * vec < d
    assert 1 <= geo.vecs_per_thread <= MAX_VECS[dtype]
    assert geo.threads_per_row in ROW_THREADS
    if geo.threads_per_row > ROW_THREADS[0]:
        assert (geo.threads_per_row // 2) * MAX_VECS[dtype] * vec < d
    assert geo.rows_per_cta * geo.threads_per_row == geo.cta_threads \
        == CTA_THREADS


def test_the_widths_split_as_designed():
    """bf16: one warp a row to d 1536 (8 rows a CTA at d 512), two warps
    at 2048-3072, four at 4096-7168; f32 holds half the elements a vector
    and up to 8 of them."""
    got = {d: (rmsnorm_geometry(d, torch.bfloat16).threads_per_row,
               rmsnorm_geometry(d, torch.float32).threads_per_row)
           for d in WIDTHS}
    assert got == {512: (32, 32), 1536: (32, 64), 1600: (32, 64),
                   2048: (64, 64),
                   3072: (64, 128), 4096: (128, 128), 4608: (128, 256),
                   7168: (128, 256)}
    assert rmsnorm_geometry(512, torch.bfloat16).rows_per_cta == 8


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_past_the_preferred_vectors_a_row_takes_all_256_threads(dtype):
    """A row one vector past what 128 threads hold at their most vectors,
    and the widest row, take all 256 threads."""
    vec = VEC_BYTES // dtype.itemsize
    for nvec in (128 * MAX_VECS[dtype] + 1, 256 * MAX_VECS[dtype]):
        geo = rmsnorm_geometry(nvec * vec, dtype)
        assert (geo.path, geo.threads_per_row) == ("reg", 256)
        assert geo.vecs_per_thread == -(-nvec // 256) <= MAX_VECS[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_every_register_width_asks_for_a_built_instance(dtype):
    """At every whole number of vectors the register path takes, the
    threads cover the row, a half as many would not, and the vectors a
    thread holds are an instance the kernel has (1 to MAX_VECS)."""
    vec = VEC_BYTES // dtype.itemsize
    for nvec in range(1, max_reg_width(dtype) // vec + 1):
        geo = rmsnorm_geometry(nvec * vec, dtype)
        tpr, k = geo.threads_per_row, geo.vecs_per_thread
        assert geo.path == "reg" and 1 <= k <= MAX_VECS[dtype]
        assert tpr * k >= nvec and tpr * (k - 1) < nvec
        assert tpr == ROW_THREADS[0] or (tpr // 2) * MAX_VECS[dtype] < nvec


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_vector_cap_is_the_cuda_source_s(dtype):
    """``MAX_VECS`` is ``VecWidth<T>::K`` of csrc/rmsnorm.cu, the most
    vectors a thread of an instance holds, and its ``N`` the elements of
    a vector."""
    src = (CSRC / "rmsnorm.cu").read_text()
    ctype = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}[dtype]
    m = re.search(r"struct VecWidth<" + ctype +
                  r"> \{\s*static constexpr int N = (\d+), K = (\d+);", src)
    assert m is not None
    assert (int(m.group(1)), int(m.group(2))) == (
        VEC_BYTES // dtype.itemsize, MAX_VECS[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_what_the_register_path_does_not_take_goes_to_the_loop_path(dtype):
    vec = VEC_BYTES // dtype.itemsize
    cap = max_reg_width(dtype)
    assert cap == (14336 if dtype == torch.bfloat16 else 8192)
    assert rmsnorm_geometry(cap, dtype).path == "reg"
    for d, aligned in ((cap + vec, True), (16384, True), (16392, True),
                       (4096 + 1, True),
                       (300 if vec == 8 else 302, True), (4096, False)):
        geo = rmsnorm_geometry(d, dtype, aligned)
        assert geo.path == "loop", (d, aligned)
        assert (geo.threads_per_row, geo.vecs_per_thread,
                geo.rows_per_cta) == (CTA_THREADS, 0, 1)
        assert geo.smem_bytes == 32 * 4


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_a_call_s_geometry_follows_its_pointers(dtype):
    """A view one element off a 16-byte boundary takes the loop path; a
    row of an aligned tensor (d a whole number of vectors) keeps it."""
    flat = torch.zeros(3 * 4096 + 8, dtype=dtype)
    scale = torch.zeros(4096, dtype=dtype)
    x = flat[:3 * 4096].view(3, 4096)
    assert tensor_geometry(x, scale, torch.empty_like(x)).path == "reg"
    assert tensor_geometry(x[1:2], scale, torch.empty_like(x[1:2])) \
        == tensor_geometry(x, scale, torch.empty_like(x))
    off = flat[1:1 + 3 * 4096].view(3, 4096)
    assert tensor_geometry(off, scale, torch.empty_like(off)).path == "loop"
    assert tensor_geometry(x, torch.zeros(4097, dtype=dtype)[1:],
                           torch.empty_like(x)).path == "loop"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", WIDTHS + (16392, 300))
def test_the_selector_reads_the_geometry(d, dtype):
    geo = rmsnorm_geometry(d, dtype)
    hw = DEFAULT_HW
    assert V.variant_smem_bytes("rmsnorm", V.REG_ROWS, {"n": 8, "d": d},
                                dtype) == geo.smem_bytes
    assert V.REG_ROWS.threads == geo.cta_threads
    shape = {"n": 8192, "d": d}
    raw = V.rmsnorm_cost(V.REG_ROWS, shape, dtype, {}, hw, 1.0)
    hbm = (2 * 8192 * d + d) * dtype.itemsize
    roof = max(4.0 * 8192 * d / hw.fp32_flops, hbm / hw.hbm_bw)
    grid = -(-8192 // geo.rows_per_cta)
    fill = V._fill(grid, V.REG_ROWS, geo.smem_bytes, hw)
    assert raw.hbm_bytes == hbm
    assert raw.time_s == pytest.approx(roof / fill + hw.launch_s)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_register_path_s_shared_memory_holds_scale(dtype):
    """A reduction slot a warp, and scale's row, which the CTA reads once
    and every row it normalizes reuses."""
    for d in WIDTHS + (max_reg_width(dtype),):
        geo = rmsnorm_geometry(d, dtype)
        assert geo.smem_bytes == 8 * 4 + d * dtype.itemsize
        assert geo.smem_bytes <= MAX_SMEM_BYTES == 32 + 32 * 1024


def test_an_unknown_width_prices_the_most_shared_memory():
    assert V.variant_smem_bytes("rmsnorm", V.REG_ROWS, {"n": 8, "d": None},
                                torch.bfloat16) == MAX_SMEM_BYTES
    assert V.variant_smem_bytes("rmsnorm", V.REG_ROWS, {"n": 8, "d": 4096}) \
        == MAX_SMEM_BYTES
    assert V.variant_smem_bytes("rmsnorm", V.REF_UNFUSED, {"d": 4096},
                                torch.bfloat16) == 0


def test_a_row_group_of_several_rows_fills_the_card_sooner():
    """At d 512 a CTA holds 8 rows: 8192 rows are 1024 CTAs, about one
    wave of 132 SMs x 8 CTAs, where one CTA a row took 8."""
    hw = DEFAULT_HW
    geo = rmsnorm_geometry(512, torch.bfloat16)
    grid = 8192 // geo.rows_per_cta
    assert grid == 1024
    assert V._fill(grid, V.REG_ROWS, geo.smem_bytes, hw) > 0.95
    slots = hw.sm_count * (hw.max_threads_per_sm // CTA_THREADS)
    assert -(-8192 // slots) == 8
