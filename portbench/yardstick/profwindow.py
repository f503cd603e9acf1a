"""The profiler over a measured window, and what is read from it.

:class:`Window` runs ``torch.profiler`` (host and device activity) over the
window.  Each window opens with ``PRIMERS`` one-word adds and a sync, as
``chip_smoke.device_ms`` does (copied from there): on the H100 the profiler
now and then loses the first kernel records of a window, and a throwaway
launch is lost in their place.  A kernel's device time is read only where
the window recorded exactly as many of its events as the program counted
launches (:func:`strict_durations`), as ``chip_smoke.window_ms`` requires.

Only device activity is profiled.  The host ranges that name the idle gaps
are the benchmark's own (:class:`Ranges`, around each call into a layer),
read on the epoch clock: kineto's device times are in ns on the same clock
(``time.time_ns``), so ranges taken in this process or another line up with
them.  Profiling host activity as well would record every torch operation
on every thread of the node, and reading that back would take longer than
the window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

PRIMERS = 16
TOP = 10


class Window:
    """``with Window() as w:`` profiles the body; afterwards :func:`read`."""

    def __init__(self):
        self.prof = None
        self.t0_ns = self.t1_ns = 0

    def __enter__(self) -> "Window":
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        primer = torch.zeros(1, device="cuda")
        for _ in range(PRIMERS):
            primer.add_(1)
        torch.cuda.synchronize()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(*exc)

    def events(self) -> list:
        """Device operations (kernels, copies, sets) as ``(name, start_ns,
        end_ns)``, clipped to the window, in order of start."""
        from torch.autograd import DeviceType

        device = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "activity_type") and e.activity_type() == "gpu_user_annotation":
                continue
            start = e.start_ns()
            end = start + e.duration_ns()
            if end > self.t0_ns and start < self.t1_ns:
                device.append((e.name(), max(start, self.t0_ns), min(end, self.t1_ns)))
        device.sort(key=lambda x: x[1])
        return device


class Ranges:
    """Host ranges ``(label, start_ns, end_ns)`` on the epoch clock, taken
    around calls into the program's layers from any thread."""

    def __init__(self):
        self.spans: list = []

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((label, t0, time.time_ns()))

    def wrap(self, fn, label: str):
        def inner(*a, **k):
            with self.span(label):
                return fn(*a, **k)
        return inner


def busy_intervals(device: list) -> list:
    """The union of the device's activity, as sorted ``(start, end)``."""
    merged: list = []
    for _, s, e in sorted(device, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(w: Window, host: list) -> dict:
    """``busy_s``, ``window_s``, the device operations that took most time
    and the longest idle gaps, each named by the three host ranges that
    overlap it most, with their range-seconds per second of the gap (above 1
    where ranges of one name run at once, as request handlers do).
    ``host`` holds ``(label, start_ns, end_ns)`` ranges, from this process
    or another (a client's)."""
    device = w.events()
    busy = busy_intervals(device)
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    edge = w.t0_ns
    for s, e in busy + [[w.t1_ns, w.t1_ns]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for gs, ge in gaps[:TOP]:
        overlap: dict = {}
        for label, hs, he in host:
            o = min(ge, he) - max(gs, hs)
            if o > 0:
                overlap[label] = overlap.get(label, 0) + o
        shares = sorted(((o / (ge - gs), label) for label, o in overlap.items()), reverse=True)
        label = ", ".join(f"{lab} {sh:.2f}" for sh, lab in shares[:3]) or "no benchmark range"
        idle.append([f"{label} at {(gs - w.t0_ns) / 1e9:.6f} s", (ge - gs) / 1e9])
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w.t1_ns - w.t0_ns) / 1e9,
        "device_ops": [[name, ns / 1e9] for name, ns in top],
        "idle_gaps": idle,
        "device": device,
    }


def strict_durations(device: list, match: str, launches: int) -> Optional[list]:
    """The device ns of each event whose name contains ``match``, in launch
    order, or None unless the window holds exactly ``launches`` of them."""
    found = [e - s for name, s, e in device if match in name]
    return found if len(found) == launches else None
