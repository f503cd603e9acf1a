"""Learn the front door's ``easy_score`` threshold from recorded outcomes.

``FrontDoorConfig.easy_score`` decides which probed-open boards race the
native DFS (easy tier) and which go straight to device flights (hard
tail).  The shipped default (64) is a hand-picked constant; this module
replaces it with a threshold **fit to this deployment's own traffic**:
the opt-in ordering trace (``obs/ordertrace.py``) journals every resolved
job's probe score, route, and wall time, and :func:`fit_easy_score`
replays those outcomes to pick the score cut that minimizes total
estimated wall.

The model is deliberately tiny — a 1-D threshold over an integer score,
chosen by exhaustive scan.  Per candidate threshold ``t``, each recorded
job is charged the *observed* mean wall of its would-be tier (native-tier
mean for ``score <= t``, device-tier mean for ``score > t``), estimated
from the jobs that actually took that route in the journal.  Scores only
ever observed on one route contribute their own wall either way; the scan
therefore reduces to choosing where the per-score mean-wall curves cross,
robust to a handful of outliers because means pool across the whole
journal.  No dependencies beyond the stdlib — this runs in the no-jax
fast lane (``benchmarks/train_ordering.py fit-threshold`` is the CLI).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

#: Routes whose wall time measures the native/easy path.
_NATIVE_ROUTES = ("native",)
#: Routes whose wall time measures the device/hard path.
_DEVICE_ROUTES = ("device", "direct")


def fit_easy_score(
    events: Iterable[dict],
    default: int = 64,
    min_samples: int = 8,
) -> Tuple[int, dict]:
    """Pick the easy/hard threshold minimizing estimated total wall.

    ``events`` are ordering-trace dicts (``kind == 'route'`` rows are
    read, others skipped).  Returns ``(threshold, report)``; with fewer
    than ``min_samples`` jobs on either route the journal cannot price
    one of the tiers and the ``default`` comes back unchanged (report
    says why) — a cold deployment keeps the shipped constant until it
    has seen real traffic.
    """
    native: list = []  # (score, wall_ms)
    device: list = []
    for ev in events:
        if ev.get("kind") != "route":
            continue
        score = int(ev.get("score", -1))
        if score < 0:  # cache hits / never-probed jobs carry no signal
            continue
        wall = float(ev.get("wall_ms", 0.0))
        route = ev.get("route")
        if route in _NATIVE_ROUTES:
            native.append((score, wall))
        elif route in _DEVICE_ROUTES:
            device.append((score, wall))
    report = {
        "native_samples": len(native),
        "device_samples": len(device),
        "default": int(default),
    }
    if len(native) < min_samples or len(device) < min_samples:
        report["fitted"] = False
        report["reason"] = (
            f"needs >= {min_samples} samples per route "
            f"(native={len(native)}, device={len(device)})"
        )
        return int(default), report

    def mean_wall_by_score(rows):
        acc: dict = {}
        for score, wall in rows:
            tot, cnt = acc.get(score, (0.0, 0))
            acc[score] = (tot + wall, cnt + 1)
        return {s: tot / cnt for s, (tot, cnt) in acc.items()}

    nat_mean = mean_wall_by_score(native)
    dev_mean = mean_wall_by_score(device)
    nat_global = sum(w for _, w in native) / len(native)
    dev_global = sum(w for _, w in device) / len(device)
    scores = sorted(set(nat_mean) | set(dev_mean))

    def cost(threshold: int) -> float:
        total = 0.0
        for s in scores:
            n_nat = sum(1 for sc, _ in native if sc == s)
            n_dev = sum(1 for sc, _ in device if sc == s)
            count = n_nat + n_dev
            if s <= threshold:
                # This score's jobs would race native: price them at the
                # observed native wall for the score, falling back to the
                # global native mean where that route was never sampled.
                total += count * nat_mean.get(s, nat_global)
            else:
                total += count * dev_mean.get(s, dev_global)
        return total

    candidates = sorted({default, *scores, max(scores) + 1})
    best = min(candidates, key=lambda t: (cost(t), abs(t - default)))
    report["fitted"] = True
    report["cost_default"] = round(cost(default), 3)
    report["cost_best"] = round(cost(best), 3)
    report["scores_seen"] = len(scores)
    return int(best), report


def learned_easy_score(
    path: str, default: int = 64, min_samples: int = 8
) -> Tuple[int, dict]:
    """Convenience: fit from an ordering-trace JSONL file on disk."""
    from distributed_sudoku_solver_tpu_torch.obs import ordertrace

    return fit_easy_score(
        ordertrace.read_events(path), default=default, min_samples=min_samples
    )
