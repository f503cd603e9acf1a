"""Peaks of one NVIDIA H100 SXM at its full 700 W, and the card's own
power limit.  Copied from ``chip_smoke.py`` (``PEAK_BYTES_PER_S``,
``PEAK_INT32_OPS_PER_S``, ``bound_ms``).

HBM bandwidth is NVIDIA's data sheet's.  The kernels do 32-bit integer work,
which the data sheet does not rate: its 67 TFLOP/s float32 rate outside the
tensor cores counts an FMA as two operations on 128 FP32 lanes per SM;
compute capability 9.0 issues 64 32-bit integer operations (add, logic,
shift, compare, min) per SM per clock (CUDA C++ Programming Guide,
arithmetic instruction throughput), so 67e12 / 2 / 2 int32 operations/s.
"""

from __future__ import annotations

import subprocess

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    HBM peak and the operations over the int32 peak, in ms, and which."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card() -> dict:
    """The card's name and power limit from ``nvidia-smi`` (empty where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, _, limit = out[0].rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
