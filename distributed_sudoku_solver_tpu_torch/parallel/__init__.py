"""Multi-device parallelism: device meshes, sharded frontier solves, collectives."""

from distributed_sudoku_solver_tpu_torch.parallel.mesh import (  # noqa: F401
    LANE_AXIS,
    Mesh,
    default_mesh,
    make_mesh,
    virtual_devices,
    visible_devices,
)
from distributed_sudoku_solver_tpu_torch.parallel.board_sharded import (  # noqa: F401
    BAND_AXIS,
    BandedSudoku,
    make_band_mesh,
    solve_batch_banded,
    validate_banded_config,
)
from distributed_sudoku_solver_tpu_torch.parallel.sharded import (  # noqa: F401
    solve_batch_sharded,
    solve_batch_sharded_wire,
    solve_csp_sharded,
)
from distributed_sudoku_solver_tpu_torch.parallel.fused_sharded import (  # noqa: F401
    solve_batch_fused_sharded,
    solve_csp_fused_sharded,
)
