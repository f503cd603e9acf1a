"""What the per-layer readers share: counters and histograms of the node's
``/metrics`` read before and after the window, and the profiler's busy
time."""

from __future__ import annotations

from typing import Optional

from portbench.yardstick import hist


def route_counts(before: dict, after: dict) -> dict:
    """The front door's ``routes`` counters over the window."""
    a = after.get("frontdoor", {}).get("routes", {})
    b = before.get("frontdoor", {}).get("routes", {})
    return {k: v - b.get(k, 0) for k, v in a.items()}


def route_share(r: dict, route: str) -> Optional[float]:
    """Percent of the window's routed requests that the front door sent to
    ``route`` (its ``routes`` counters, after minus before)."""
    if "metrics_after" not in r:
        return None
    d = route_counts(r["metrics_before"], r["metrics_after"])
    total = sum(d.values())
    return 100.0 * d.get(route, 0) / total if total > 0 else None


def hist_quantile(r: dict, name: str, q: float) -> Optional[float]:
    """The ``q``-quantile in ms of histogram ``name`` over the window."""
    if "metrics_after" not in r:
        return None
    after = r["metrics_after"].get("hist", {}).get(name)
    before = r["metrics_before"].get("hist", {}).get(name)
    return hist.quantile(hist.delta(before, after), q)


def idle_pct(r: dict) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    p = r.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
