"""Prometheus text exposition of the nested ``/metrics`` dict.

The JSON ``GET /metrics`` body grew organically over rounds 6-10 into a
nested dict (latency windows, per-geometry resident sections, per-method
fault counters); scraping it requires a JSON exporter sidecar.
:func:`render` flattens it into Prometheus exposition-format lines
(``name{labels} value``) for ``GET /metrics?format=prometheus``:

* nested dict keys join into the metric name
  (``job_latency_ms.p95`` -> ``dsst_job_latency_ms_p95``);
* per-geometry dicts (keys shaped ``9x9``) become a ``geometry`` label
  instead of polluting metric names with digits;
* known enumeration dicts (``duplicates_dropped`` per wire method, an
  injector's per-site counters) become labels too;
* string leaves become info-style gauges: the string is a label on a
  ``1``-valued metric (``dsst_faults_breaker_state{state="open"} 1``);
* numeric lists label by ``index`` (occupancy histogram buckets, the
  ``[term, epoch]`` view);
* ``obs/hist.py`` log2 histograms (dicts tagged ``type: log2_hist``)
  render as real Prometheus histograms: cumulative ``_bucket{le=...}``
  series (edges in ms, ``+Inf`` last) plus ``_sum``/``_count`` — so a
  Prometheus server can `histogram_quantile()` across a scraped ring
  exactly the way ``obs/agg.py`` merges them server-side.  Exemplars
  stay JSON-only (the classic text format has no exemplar syntax).
* ``rpc_floor_ms`` floor estimates (``type: min_est``) render their
  numeric fields as plain gauges.

Output is deterministic (keys sorted at every level) so the golden-file
test pins the format, and ``obs/promck.py`` lints the result (duplicate
series, label escaping, monotone ``le`` buckets).  Stdlib only.
"""

from __future__ import annotations

import re
from typing import List

_GEOM_KEY = re.compile(r"^\d+x\d+$")
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")
# Dicts whose keys enumerate a label, not a metric-name path: the parent
# key maps to the label name applied to each child.
_LABEL_DICTS = {
    "duplicates_dropped": "method",
    "dispatches": "site",
    "injected": "site_kind",
    # SLO objectives ("solve_p95_ms<=250") and cluster member addresses
    # ("10.0.0.1:7000") are identities, not name-path material.
    "objectives": "objective",
    "cluster_nodes": "node",
    # Compile-watch / cost-plane program tables (obs/compilewatch.py):
    # per-program series label by display name instead of minting one
    # metric family per compiled program.
    "programs": "program",
    # Front-door route counters (serving/frontdoor): one series per
    # routing tier (cache/propagation/native/device) under a `route`
    # label, mirroring the frontdoor_<route>_ms histograms in `hist`.
    "routes": "route",
    # Brownout per-tier shed counters (serving/brownout.py): one series
    # per shed tier (easy/hard) under a `tier` label.
    "shed": "tier",
}


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _name(parts) -> str:
    return _NAME_BAD.sub("_", "_".join(parts))


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".10g")


def _line(parts, labels, v) -> str:
    name = _name(parts)
    if labels:
        lab = ",".join(f'{k}="{_esc(str(val))}"' for k, val in labels)
        return f"{name}{{{lab}}} {_fmt(v)}"
    return f"{name} {_fmt(v)}"


def _hist_lines(parts: list, labels: list, val: dict, lines: List[str]) -> None:
    """An obs/hist.py log2 histogram as Prometheus histogram series:
    cumulative ``le`` buckets (ms edges), then ``_sum`` and ``_count``."""
    edge0 = float(val.get("edge0_ms", 0.001))
    counts = val.get("counts") or []
    cum = 0
    for i, c in enumerate(counts):
        cum += int(c)
        le = "+Inf" if i == len(counts) - 1 else _fmt(edge0 * (2.0 ** i))
        lines.append(_line(parts + ["bucket"], labels + [("le", le)], cum))
    lines.append(_line(parts + ["sum"], labels, float(val.get("sum_ms", 0.0))))
    lines.append(_line(parts + ["count"], labels, cum))


def _walk(parts: list, val, labels: list, lines: List[str]) -> None:
    if isinstance(val, bool) or isinstance(val, (int, float)):
        lines.append(_line(parts, labels, val))
    elif isinstance(val, str):
        # Info-style: the leaf key doubles as the label name.
        lines.append(_line(parts, labels + [(parts[-1], val)], 1))
    elif isinstance(val, dict):
        if not val:
            return
        if val.get("type") == "log2_hist":
            _hist_lines(parts, labels, val, lines)
            return
        if val.get("type") == "min_est":
            # Floor estimate: numeric fields as gauges, the tag skipped.
            for k in sorted(val, key=str):
                if k != "type":
                    _walk(parts + [str(k)], val[k], labels, lines)
            return
        keys = sorted(val, key=str)
        if all(isinstance(k, str) and _GEOM_KEY.match(k) for k in keys):
            for k in keys:
                _walk(parts, val[k], labels + [("geometry", k)], lines)
        elif parts and parts[-1] in _LABEL_DICTS:
            label = _LABEL_DICTS[parts[-1]]
            for k in keys:
                child = val[k]
                child_labels = labels + [(label, str(k))]
                if isinstance(child, dict):
                    # Exactly ONE labeled level: the child's own keys are
                    # ordinary name-path segments (an SLO objective's
                    # fields, a member's reachability gauges) — without
                    # this, a nested dict re-matches the rule and emits a
                    # duplicate label name, which breaks the scrape.
                    for ck in sorted(child, key=str):
                        _walk(parts + [str(ck)], child[ck], child_labels, lines)
                else:
                    _walk(parts, child, child_labels, lines)
        else:
            for k in keys:
                _walk(parts + [str(k)], val[k], labels, lines)
    elif isinstance(val, (list, tuple)):
        for i, item in enumerate(val):
            if isinstance(item, (bool, int, float)):
                _walk(parts, item, labels + [("index", str(i))], lines)
    # None and anything else: skipped (no honest numeric reading).


def render(metrics: dict, prefix: str = "dsst") -> str:
    """The full exposition body for one scrape (trailing newline included,
    as the exposition format requires)."""
    lines: List[str] = []
    _walk([prefix], metrics, [], lines)
    return "\n".join(lines) + ("\n" if lines else "")
