"""Cluster control plane: typed TCP wire protocol + membership + fault tolerance."""

from distributed_sudoku_solver_tpu_torch.cluster.node import ClusterNode  # noqa: F401
from distributed_sudoku_solver_tpu_torch.cluster.wire import (  # noqa: F401
    Addr,
    WireError,
    recv_msg,
    request,
    send_msg,
)
