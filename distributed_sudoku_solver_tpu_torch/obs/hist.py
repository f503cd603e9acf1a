"""Mergeable, lock-cheap log2-bucketed latency histograms.

``StatWindow`` (utils/profiling.py) answers "what is THIS node's p95?",
but its percentile snapshots cannot be combined: the p95 of two p95s is
not the p95 of the union, so a ring of N nodes has no honest answer to
"what is *cluster* p95?".  :class:`LatencyHistogram` is the mergeable
twin, threaded beside the StatWindows at the same phase seams:

* **Fixed log2 bucket edges** — bucket ``i`` counts samples with
  ``v_ms <= EDGE0_MS * 2**i`` (last bucket = +Inf overflow).  Every
  histogram in every process shares the one scheme, so histograms from
  different nodes merge by plain vector add (:func:`merge_hist`) — the
  property cluster-scope aggregation (``obs/agg.py``) is built on.
* **Lock-cheap recording** — one bucket-index computation (``frexp``,
  no log calls) and one locked integer increment per sample; no numpy,
  no percentile math on the hot path.  Quantiles are estimated at READ
  time from the cumulative counts (log-linear interpolation inside the
  bucket), the same trade Prometheus histograms make.
* **Optional exemplars** — a trace uuid per bucket (latest wins),
  linking a slow bucket straight to its PR-8 stitched trace
  (``GET /trace/<uuid>``).  Callers pass an exemplar ONLY when a
  recorder is installed, so the disabled path allocates nothing extra.

:class:`MinEstimator` is the companion floor tracker: fed from the
``chunk.sync`` seams, its minimum is a live estimate of the per-sync RPC
floor (``rpc_floor_ms`` on ``/metrics``) — the baseline number ROADMAP
item #2 (kill the interactive dispatch floor) needs to attack and then
prove it moved.

Prometheus rendering (cumulative ``le`` buckets, ``_sum``/``_count``)
lives in ``obs/prom.py``; the dict forms here (``to_dict`` /
:func:`merge_hist` / :func:`hist_quantile`) are the wire/merge format.

Import discipline: stdlib only (like the rest of ``obs/``).
"""

from __future__ import annotations

import math
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from typing import Optional

# The one process-independent bucket scheme: first edge 1 µs, doubling
# 31 times (last finite edge ~17.9 min), bucket 31 = +Inf.  Changing
# either constant is a wire-format change for METRICS_PULL replies —
# merge_hist refuses mixed schemes rather than silently mis-adding.
EDGE0_MS = 1e-3
N_BUCKETS = 32
HIST_TYPE = "log2_hist"
MIN_EST_TYPE = "min_est"


def bucket_index(v_ms: float) -> int:
    """Smallest ``i`` with ``v_ms <= EDGE0_MS * 2**i`` (clamped into the
    scheme; non-positive samples land in bucket 0)."""
    if v_ms <= EDGE0_MS:
        return 0
    m, e = math.frexp(v_ms / EDGE0_MS)
    i = e - 1 if m == 0.5 else e  # ceil(log2(ratio)) without log()
    return i if i < N_BUCKETS else N_BUCKETS - 1


def bucket_edge_ms(i: int) -> float:
    """Upper edge of bucket ``i`` in ms (``inf`` for the overflow bucket)."""
    return math.inf if i >= N_BUCKETS - 1 else EDGE0_MS * (2.0 ** i)


class LatencyHistogram:
    """Thread-safe log2-bucket histogram over latency samples in seconds
    (stored and exported in ms, matching every ``*_ms`` metric)."""

    def __init__(self):
        self._lock = lockdep.named_lock("obs.hist")  # lockck: name(obs.hist)
        self._counts = [0] * N_BUCKETS
        self._n = 0
        self._sum_ms = 0.0
        # bucket index (as str, the JSON dict-key form) -> trace uuid.
        # Bounded by construction: at most one exemplar per bucket.
        self._exemplars: dict = {}

    def __len__(self) -> int:
        return self._n

    def record(self, seconds: float, exemplar: Optional[str] = None) -> None:
        v_ms = seconds * 1e3
        i = bucket_index(v_ms)
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum_ms += v_ms
            if exemplar is not None:
                self._exemplars[str(i)] = exemplar

    def to_dict(self) -> dict:
        """The canonical JSON-safe form — the METRICS_PULL wire format and
        the merge/render input (``type`` tags it for obs/agg + obs/prom)."""
        with self._lock:
            d = {
                "type": HIST_TYPE,
                "edge0_ms": EDGE0_MS,
                "counts": list(self._counts),
                "sum_ms": round(self._sum_ms, 6),
            }
            if self._exemplars:
                d["exemplars"] = dict(self._exemplars)
            return d

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            counts = list(self._counts)
        return hist_quantile(
            {"type": HIST_TYPE, "edge0_ms": EDGE0_MS, "counts": counts}, q
        )


def is_hist(d) -> bool:
    return (
        isinstance(d, dict)
        and d.get("type") == HIST_TYPE
        and isinstance(d.get("counts"), list)
    )


def merge_hist(acc: Optional[dict], other: dict) -> dict:
    """Vector-add ``other`` into ``acc`` (None = start fresh); exemplars
    keep the donor's where present (latest wins — any exemplar is a valid
    representative of its bucket).  Raises ``ValueError`` on a scheme
    mismatch: silently mis-adding differently-bucketed histograms would
    corrupt every cluster quantile downstream."""
    if not is_hist(other):
        raise ValueError(f"not a {HIST_TYPE} dict: {other!r}")
    if acc is None:
        return {
            "type": HIST_TYPE,
            "edge0_ms": float(other.get("edge0_ms", EDGE0_MS)),
            "counts": [int(c) for c in other["counts"]],
            "sum_ms": float(other.get("sum_ms", 0.0)),
            **(
                {"exemplars": dict(other["exemplars"])}
                if other.get("exemplars")
                else {}
            ),
        }
    if float(other.get("edge0_ms", EDGE0_MS)) != float(
        acc.get("edge0_ms", EDGE0_MS)
    ) or len(other["counts"]) != len(acc["counts"]):
        raise ValueError(
            "histogram scheme mismatch: "
            f"edge0={other.get('edge0_ms')}/{acc.get('edge0_ms')} "
            f"n={len(other['counts'])}/{len(acc['counts'])}"
        )
    acc["counts"] = [
        int(a) + int(b) for a, b in zip(acc["counts"], other["counts"])
    ]
    acc["sum_ms"] = float(acc.get("sum_ms", 0.0)) + float(other.get("sum_ms", 0.0))
    if other.get("exemplars"):
        ex = acc.setdefault("exemplars", {})
        ex.update(other["exemplars"])
    return acc


def hist_count(d: dict) -> int:
    return sum(int(c) for c in d.get("counts", ()))


def hist_quantile(d: dict, q: float) -> Optional[float]:
    """Estimated ``q``-quantile in ms from a histogram dict: log-linear
    interpolation inside the bucket that crosses the target rank (the
    overflow bucket reports its lower edge — an honest lower bound)."""
    counts = [int(c) for c in d.get("counts", ())]
    total = sum(counts)
    if total == 0:
        return None
    edge0 = float(d.get("edge0_ms", EDGE0_MS))
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            upper = edge0 * (2.0 ** i)
            if i >= len(counts) - 1:
                return edge0 * (2.0 ** (i - 1))  # +Inf bucket: lower bound
            lower = 0.0 if i == 0 else edge0 * (2.0 ** (i - 1))
            frac = (target - cum) / c
            return lower + (upper - lower) * frac
        cum += c
    return edge0 * (2.0 ** (len(counts) - 2))


class MinEstimator:
    """Online floor estimate over a stream of wall samples (seconds in,
    ms out): the lifetime minimum plus a windowed "recent" minimum (last
    completed window of ``window`` samples), so a floor that MOVED — the
    success criterion of ROADMAP item #2 — is visible without restarting
    the process."""

    def __init__(self, window: int = 256):
        self._lock = lockdep.named_lock("obs.minest")  # lockck: name(obs.minest)
        self._window = max(1, window)
        self._min_ms: Optional[float] = None
        self._cur_min_ms: Optional[float] = None
        self._cur_n = 0
        self._recent_ms: Optional[float] = None
        self._n = 0

    def record(self, seconds: float) -> None:
        v_ms = seconds * 1e3
        with self._lock:
            self._n += 1
            if self._min_ms is None or v_ms < self._min_ms:
                self._min_ms = v_ms
            if self._cur_min_ms is None or v_ms < self._cur_min_ms:
                self._cur_min_ms = v_ms
            self._cur_n += 1
            if self._cur_n >= self._window:
                self._recent_ms = self._cur_min_ms
                self._cur_min_ms = None
                self._cur_n = 0

    def to_dict(self) -> Optional[dict]:
        with self._lock:
            if self._n == 0:
                return None
            recent = self._recent_ms
            if recent is None:
                recent = self._cur_min_ms  # window not yet full: best so far
            return {
                "type": MIN_EST_TYPE,
                "min": round(float(self._min_ms), 6),
                "recent": round(float(recent), 6),
                "samples": int(self._n),
            }


def is_min_est(d) -> bool:
    return isinstance(d, dict) and d.get("type") == MIN_EST_TYPE


def merge_min_est(acc: Optional[dict], other: dict) -> dict:
    """Cluster merge for floor estimates: the floor of a ring is the min
    of the members' floors; samples sum."""
    if not is_min_est(other):
        raise ValueError(f"not a {MIN_EST_TYPE} dict: {other!r}")
    if acc is None:
        return {
            "type": MIN_EST_TYPE,
            "min": float(other["min"]),
            "recent": float(other.get("recent", other["min"])),
            "samples": int(other.get("samples", 0)),
        }
    acc["min"] = min(float(acc["min"]), float(other["min"]))
    acc["recent"] = min(
        float(acc.get("recent", acc["min"])),
        float(other.get("recent", other["min"])),
    )
    acc["samples"] = int(acc.get("samples", 0)) + int(other.get("samples", 0))
    return acc
