"""K1's and K2's instantiations per board geometry (``csrc/fixpoint.cuh``).

The Sudoku kernels are templates on the box shape: every geometry the
package ships (``models/geometry._BY_SIZE``) must have its own compile-time
instantiation in both entry points, so that its index arithmetic folds
into constants; every other box shape with n <= 32 takes the one
instantiation with run-time dimensions.  These tests read the CUDA sources
and run on the CPU; the kernels themselves are held against their plain
versions on a card (``tests/test_torch_port_rules.py``, ``-m cuda``).
"""

import itertools
import re

import pytest

from distributed_sudoku_solver_tpu_torch.models.geometry import _BY_SIZE, Geometry
from distributed_sudoku_solver_tpu_torch.ops import cuda_build

SHIPPED = sorted(_BY_SIZE.values(), key=lambda g: g.n)
ENTRY_POINTS = {"propagate.cu": "dsst_propagate", "fused_step.cu": "dsst_fused_rounds"}


@pytest.mark.parametrize("geom", SHIPPED, ids=str)
def test_every_shipped_geometry_has_a_compiled_instantiation(geom):
    assert (geom.box_h, geom.box_w) in cuda_build.compiled_geometries()
    assert cuda_build.instantiation(geom.box_h, geom.box_w) == (geom.box_h, geom.box_w)


@pytest.mark.parametrize("source", sorted(ENTRY_POINTS))
def test_each_entry_point_dispatches_over_the_geometry_list(source):
    text = (cuda_build.CSRC_DIR / source).read_text()
    entry = text[text.index(f'extern "C" int {ENTRY_POINTS[source]}('):]
    body = entry[: entry.index("\n}\n")]
    # One launch per listed geometry, then the run-time instantiation.
    assert "DSST_FOR_EACH_GEOMETRY(DSST_LAUNCH)" in body
    assert re.search(r"if \(box_h == BH && box_w == BW\)", body)
    assert re.search(r"return launch_\w+<0, 0>\(", body)
    # The kernel is a template on the box shape, bounded per instantiation.
    assert re.search(r"template <int BH, int BW>\s*__global__ void __launch_bounds__", text)


@pytest.mark.parametrize("box", [(3, 4), (4, 8), (1, 32), (2, 5)], ids=str)
def test_other_box_shapes_take_the_runtime_instantiation(box):
    Geometry(*box)  # admitted by the package
    assert cuda_build.instantiation(*box) == (0, 0)


def test_every_admitted_geometry_fits_the_runtime_instantiation():
    # A lane keeps ceil(n*box_h / 32) row segments of box_w cells in
    # registers (cells_per_lane in fixpoint.cuh); the run-time
    # instantiation holds 32, which every box shape with n <= 32 fits.
    text = (cuda_build.CSRC_DIR / "fixpoint.cuh").read_text()
    assert "return (bh * bw * bh + 31) / 32 * bw;" in text
    assert re.search(r"struct Geo<0, 0> \{\s*static constexpr int MAXC = 32,", text)
    shapes = [(h, w) for h, w in itertools.product(range(1, 33), repeat=2) if h * w <= 32]
    assert max((h * w * h + 31) // 32 * w for h, w in shapes) == 32


def test_ptxas_report_parses_per_instantiation():
    report = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z12fused_kernelILi3ELi3EEvPKjPjPKiS4_S4_S1_S1_Piiiiiiiiiiii10HeadParams' for 'sm_90a'",
        "ptxas info    : Function properties for _Z12fused_kernelILi3ELi3EEvPKj",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers, 436 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z16propagate_kernelILi0ELi0EEvPKjPjPiiiiii' for 'sm_90a'",
        "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers",
    ])
    rows = cuda_build.ptxas_kernels(report)
    assert rows == [
        {"kernel": "fused_kernel", "geometry": (3, 3), "stack_frame": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 40},
        {"kernel": "propagate_kernel", "geometry": (0, 0), "stack_frame": 16,
         "spill_stores": 8, "spill_loads": 4, "registers": 255},
    ]
