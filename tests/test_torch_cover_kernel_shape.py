"""K3's host side: row lists, instantiations and admission (``csrc/cover.cu``).

The cover kernel is a template on ``(RW, CW, ST)``, the row words each
thread owns, the covered words and whether its constants are staged in
shared memory, with one run-time instantiation for every other shape; it
reads each row's columns from a compact list and keeps a count of every
primary column per lane, in the owner thread's registers for a compiled
shape, else in shared memory, or in device memory when it does not fit.  These tests read the CUDA source and
run on the CPU: that the lists equal the incidence rows, that instances map
to the instantiations the entry point dispatches to, and that
``launch_shape`` admits every instance that the JAX kernel and the first
port of K3 (state in shared memory, keys ``cnt * n_primary + col`` below
2**31) admit, in a layout that fits.  The kernel itself is held against its
plain version on a card (``tests/test_torch_port_rules.py``, ``-m cuda``).
"""

import itertools
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.models import cover as jcover
from distributed_sudoku_solver_tpu.models import nqueens as jnq
from distributed_sudoku_solver_tpu.models import pentomino as jpent
from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops import pallas_cover
from distributed_sudoku_solver_tpu_torch.models.cover import (
    _unpack_bits,
    build_cover,
    cover_from_numpy,
)
from distributed_sudoku_solver_tpu_torch.ops import cuda_build, cuda_cover

# Each shipped family's instances with the instantiation they take.
SHIPPED = {
    "nqueens4": ((lambda: jnq.nqueens_cover(4)), (1, 1, 1)),
    "nqueens8": ((lambda: jnq.nqueens_cover(8)), (1, 1, 1)),
    "nqueens14": ((lambda: jnq.nqueens_cover(14)), (1, 1, 1)),
    "nqueens20": ((lambda: jnq.nqueens_cover(20)), (1, 2, 1)),
    "pentomino3x20": ((lambda: jpent.pentomino_cover(3, 20)), (2, 3, 1)),
    "pentomino5x12": ((lambda: jpent.pentomino_cover(5, 12)), (2, 3, 1)),
    "pentomino6x10": ((lambda: jpent.pentomino_cover(6, 10)), (3, 3, 1)),
    "sudoku-cover4x4": ((lambda: jcover.sudoku_cover(JGeometry(2, 2))), (1, 2, 1)),
    "sudoku-cover6x6": ((lambda: jcover.sudoku_cover(JGeometry(2, 3))), (0, 0, -1)),
    "sudoku-cover9x9": ((lambda: jcover.sudoku_cover(JGeometry(3, 3))), (1, 11, 1)),
    "sudoku-cover16x16": ((lambda: jcover.sudoku_cover(JGeometry(4, 4))), (4, 32, 0)),
}

_CACHE = {}


def _pair(name):
    """(JAX instance, port instance) of a SHIPPED entry, built once."""
    if name not in _CACHE:
        jp = SHIPPED[name][0]()
        _CACHE[name] = (jp, cover_from_numpy(jp))
    return _CACHE[name]


def _wide():
    """60,000 primary columns: counts too large for shared memory."""
    segments, width = 60, 1000
    a = np.zeros((2 * segments, segments * width), dtype=bool)
    for s in range(segments):
        a[2 * s:2 * s + 2, s * width:(s + 1) * width] = True
    return build_cover("wide", a, segments * width)


def _parent_admits(p) -> bool:
    """The first port's admission: keys cnt * n_primary + col below 2**31
    and a lane's packed state within a block's shared memory."""
    return (p.n_rows * p.n_primary + p.n_primary < 2**31
            and 4 * (p.w_rows + p.w_cols) <= cuda_cover.SMEM_BYTES)


def _jax_admits(p) -> bool:
    """The JAX kernel's admission (``cover_consts``'s f32-exact key bound,
    ``cover_vmem_bytes`` under the scoped-VMEM ceiling) at its most
    permissive, one stack slot."""
    bw = pallas_cover.cover_block_words(p)
    r_pad = -(-p.w_rows // bw) * bw * 32
    keys = p.n_rows * p.n_primary + p.n_cols_full
    return (keys < pallas_cover._BIG and r_pad < pallas_cover._BIG
            and pallas_cover.cover_vmem_bytes(p, 1) <= pallas_cover._VMEM_CEILING_BYTES)


def _fake(n_rows, n_primary, n_secondary=0, per_row=4):
    """The fields ``launch_shape`` and the admission rules read."""
    return SimpleNamespace(name=f"r{n_rows}c{n_primary}", incidence=np.zeros(1), n_rows=n_rows,
                           n_primary=n_primary, n_cols_full=n_primary + n_secondary,
                           w_rows=-(-n_rows // 32), w_cols=-(-n_primary // 32),
                           row_list=lambda: np.zeros((n_rows, per_row), np.int32))


def _check_layout(p, shape):
    """An admitted shape fits the kernel's shared-memory layout: per lane W_r
    exchange words and, for the run-time shape, a private block (row words
    and 32 W_c counts) unless that is in device memory; per block the
    staged column masks (and a zero mask) at an odd pitch and the row lists
    of 32 * W_r rows as 16-bit pairs."""
    k = p.row_list().shape[1]
    staged = 4 * ((p.n_cols_full + 1) * (p.w_rows | 1) + 32 * p.w_rows * k // 2)
    private = p.w_rows + 32 * p.w_cols
    compiled = shape.instantiation != (0, 0, -1)
    lane_words = p.w_rows + (private if not compiled and shape.shared_private else 0)
    assert 1 <= shape.warps <= cuda_cover.MAX_WARPS
    assert shape.smem_bytes == 4 * shape.warps * lane_words + (staged if shape.stage else 0)
    assert shape.smem_bytes <= cuda_cover.SMEM_BYTES
    if compiled:
        assert shape.shared_private
        assert shape.instantiation == (-(-p.w_rows // 32), p.w_cols, int(shape.stage))
        assert shape.instantiation in cuda_build.compiled_cover_shapes()
    else:
        assert shape.shared_private == (4 * (p.w_rows + private) <= cuda_cover.SMEM_BYTES)
    if shape.stage:
        assert p.n_cols_full < 0xFFFF  # 16-bit row lists, 0xFFFF the padding
    # Keys (rank << cb) | col stay below the "no key" word.
    assert (p.n_rows + 1) << cuda_cover.column_bits(p.n_primary) < 2**32


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_row_list_equals_the_incidence_rows(name):
    _, p = _pair(name)
    rl = p.row_list()
    inc = _unpack_bits(p.incidence, p.n_cols_full)
    assert rl.dtype == np.int32 and rl.shape[0] == p.n_rows and rl.shape[1] % 2 == 0
    for r in range(p.n_rows):
        cols = rl[r][rl[r] >= 0]
        assert (rl[r][len(cols):] == -1).all()
        assert np.array_equal(cols, np.nonzero(inc[r])[0])  # ascending: primary first
    t = p._tensors(torch.device("cpu"))
    padded = t["row_list"].numpy()
    assert padded.shape == (32 * p.w_rows, rl.shape[1])
    assert np.array_equal(padded[:p.n_rows], rl) and (padded[p.n_rows:] == -1).all()
    masks = t["col_rows_full"]
    assert masks.shape == (p.n_cols_full + 1, p.w_rows) and not bool(masks[-1].any())


def test_row_list_pads_rows_of_unequal_length():
    a = np.zeros((3, 9), dtype=bool)
    a[0, [0, 3, 4, 5, 6, 7]] = True
    a[1, [1, 8]] = True
    a[2, [2]] = True
    rl = build_cover("ragged", a, 3).row_list()
    assert rl.tolist() == [[0, 3, 4, 5, 6, 7], [1, 8] + [-1] * 4, [2] + [-1] * 5]
    a[0, 8] = True  # seven columns: padded to eight
    assert build_cover("ragged", a, 3).row_list()[0].tolist() == [0, 3, 4, 5, 6, 7, 8, -1]


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_each_shipped_instance_takes_its_instantiation(name):
    _, p = _pair(name)
    want = SHIPPED[name][1]
    shape = cuda_cover.launch_shape(p)
    assert shape.instantiation == want
    assert cuda_build.cover_instantiation(p.w_rows, p.w_cols, shape.stage) == want
    if want != (0, 0, -1):
        assert want == (-(-p.w_rows // 32), p.w_cols, int(shape.stage))
        assert want in cuda_build.compiled_cover_shapes()


@pytest.mark.parametrize("shape", [(7, 5, True), (33, 11, True), (97, 3, True), (129, 32, True),
                                   (1, 33, True), (600, 90, False), (7, 1, False),
                                   (65, 3, False), (128, 32, True)], ids=str)
def test_other_shapes_take_the_runtime_instantiation(shape):
    assert cuda_build.cover_instantiation(*shape) == (0, 0, -1)


def test_compiled_shapes_are_those_the_entry_point_dispatches():
    text = (cuda_build.CSRC_DIR / "cover.cu").read_text()
    assert cuda_build.compiled_cover_shapes() == (
        (1, 1, 1), (1, 2, 1), (1, 11, 1), (2, 3, 1), (3, 3, 1), (4, 32, 0))
    entry = text[text.index('extern "C" int dsst_cover_rounds('):]
    body = entry[: entry.index("\n}\n")]
    # One launch per listed shape, with the counts in shared memory, then
    # the run-time instantiation.
    assert "DSST_FOR_EACH_COVER_SHAPE(DSST_LAUNCH)" in body
    assert re.search(r"if \(rw == RW && w_cols == CW && stage == ST && scratch == nullptr\)", body)
    assert re.search(r"return launch_cover<0, 0, -1>\(", body)
    assert re.search(r"template <int RW, int CW, int ST>\s*__global__ void __launch_bounds__",
                     text)


def test_ptxas_report_names_the_cover_instantiations():
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__b45aadb3_8_cover_cu_34a27e2e"
        "12cover_kernelILi1ELi11ELi1EEEvPKjPjPKiS5_S5_S3_S3_PiS2_S5_S3_iiiiiiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__b45aadb3_8_cover_cu_34a27e2e"
        "12cover_kernelILi0ELi0ELin1EEEvPKjPjPKiS5_S5_S3_S3_PiS2_S5_S3_iiiiiiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 60 registers, used 1 barriers",
    ])
    rows = cuda_build.ptxas_kernels(report)
    assert [(r["kernel"], r["geometry"], r["registers"]) for r in rows] == [
        ("cover_kernel", (1, 11, 1), 56), ("cover_kernel", (0, 0, -1), 60)]


def test_the_wide_instance_keeps_its_counts_in_device_memory():
    p = _wide()
    shape = cuda_cover.launch_shape(p)
    assert not shape.shared_private and shape.instantiation == (0, 0, -1)
    _check_layout(p, shape)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_launch_shape_admits_what_the_jax_kernel_and_the_parent_admit(name):
    jp, p = _pair(name)
    if _jax_admits(jp) or _parent_admits(p):
        _check_layout(p, cuda_cover.launch_shape(p))


ROWS = [1, 31, 33, 729, 4096, 32_767, 32_768, 100_000, 1_000_000, 1_859_584]
PRIMARY = [1, 2, 28, 324, 1024, 5_000, 56_000, 60_000, 1_000_000, 1_800_000]


@pytest.mark.parametrize("n_rows", ROWS)
def test_launch_shape_admits_every_shape_the_parent_or_jax_admits(n_rows):
    for n_primary, secondary in itertools.product(PRIMARY, (0, 54)):
        p = _fake(n_rows, n_primary, secondary)
        if not (_parent_admits(p) or _jax_admits(p)):
            continue
        _check_layout(p, cuda_cover.launch_shape(p))


def test_launch_shape_refuses_what_no_layout_holds():
    with pytest.raises(ValueError, match="keys"):
        cuda_cover.launch_shape(_fake(3_000_000, 4_000))
    with pytest.raises(ValueError, match="shared"):
        cuda_cover.launch_shape(_fake(2_000_000, 1))


def test_call_hands_the_kernel_its_lists_and_count_scratch():
    # The marshalling of dsst_cover_rounds, with a stand-in for the kernel.
    seen = []

    def fake(*args):
        seen.append(args)
        return 0

    for p, scratch in ((cover_from_numpy(jnq.nqueens_cover(6)), False), (_wide(), True)):
        d = p.w_rows + p.w_cols
        top = torch.from_numpy(p.initial_state()[None])
        stack = torch.zeros((1, 3, 1, d), dtype=torch.int32)
        lane = torch.zeros(1, dtype=torch.int32)
        out = cuda_cover._call(fake, None, top, stack, lane.bool(), lane, lane, p, 64, 8, 128,
                               True)
        args = seen[-1]
        assert len(args) == 25 and len(out) == 13
        shape = cuda_cover.launch_shape(p)
        assert (args[10] is not None) == scratch == (not shape.shared_private)
        assert args[8] == p._tensors(top.device)["col_rows_full"].data_ptr()
        assert args[9] == p._tensors(top.device)["row_list"].data_ptr()
        assert args[11:18] == (1, 3, p.w_rows, p.w_cols, p.n_primary, p.n_cols_full,
                               p.row_list().shape[1])
        assert args[18:24] == (64, 8, 1, shape.warps, int(shape.stage), shape.smem_bytes)
