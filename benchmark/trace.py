"""The device trace of a window, reduced: busy time, per-kernel totals, the
longest idle gaps with what the host was doing, and the kernels' work
against their least time.

The trace is ``torch.profiler`` over the measured window (CPU and CUDA
activities).  Busy time is the union of the intervals in which a device
operation (kernel, copy or set) ran; an idle gap is a stretch of the
window in which none ran, named by the innermost host operation that
covers its middle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# A launch shorter than this share of its least time cannot have read its
# matrix: its done flag was set and it skipped every row.
SKIPPED_BELOW = 0.1
TOP = 10
NAME_CHARS = 160  # of a device operation's name in the breakdown


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list  # [(name, start_us, dur_us)] of every device operation, in start order
    by_name: dict = field(default_factory=dict)  # name -> (count, seconds)
    gaps: list = field(default_factory=list)  # [(host op, seconds)], longest first


def symbol(name: str) -> str:
    """A kernel's profiler name without its return type and arguments:
    'void ns::k<float, float>(float const*, ...)' -> 'ns::k<float, float>'."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def reduce(prof, window_s: float) -> Trace:
    """The window's Trace from a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    # The profiler's raw events (times in ns), read without building its
    # per-event Python objects.
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev.append((e.name(), start, dur))
        elif kind == DeviceType.CPU:
            host.append((e.name(), start, start + dur))
    dev.sort(key=lambda r: r[1])
    by_name: dict = {}
    for name, _, dur in dev:
        n, s = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, s + dur * 1e-6)

    busy_us = 0.0
    gaps = []
    if dev:
        starts = np.array([r[1] for r in dev])
        ends = starts + np.array([r[2] for r in dev])
        run_end = np.maximum.accumulate(ends)
        # A new busy stretch starts where an op begins after every earlier one ended.
        new = np.concatenate([[True], starts[1:] > run_end[:-1]])
        first = np.flatnonzero(new)
        last = np.concatenate([first[1:] - 1, [len(dev) - 1]])
        seg_start, seg_end = starts[first], run_end[last]
        busy_us = float((seg_end - seg_start).sum())
        gap_start, gap_len = seg_end[:-1], seg_start[1:] - seg_end[:-1]
        order = np.argsort(-gap_len)[:TOP]
        hs = np.array([r[1] for r in host]) if host else np.zeros(0)
        he = np.array([r[2] for r in host]) if host else np.zeros(0)
        gaps = [(_host_at(host, hs, he, gap_start[i] + gap_len[i] / 2),
                 float(gap_len[i]) * 1e-6) for i in order if gap_len[i] > 0]
    return Trace(window_s=window_s, busy_s=busy_us * 1e-6, ops=dev, by_name=by_name,
                 gaps=gaps)


def _host_at(host: list, starts: np.ndarray, ends: np.ndarray, t: float) -> str:
    """The innermost host operation running at time t (the latest to start
    of those that cover it)."""
    cover = np.flatnonzero((starts <= t) & (ends >= t))
    if len(cover) == 0:
        return "no host operation"
    return host[cover[np.argmax(starts[cover])]][0]


def least_seconds(entry: dict, E: int, G: int, peaks: dict, B: int = 1) -> float:
    """The least time of one live launch of kernel `entry` on an (E, G)
    matrix for B replicates: its bytes at the peak bandwidth or its
    operations at the peak rate of its type, whichever is longer.  An
    entry counts its bytes and operations by the cell, row, column,
    replicate and their products (`*_rep` terms: times B)."""
    def count(terms):
        return (terms.get("cell", 0) * E * G + terms.get("row", 0) * E
                + terms.get("col", 0) * G + terms.get("fixed", 0)
                + B * (terms.get("cell_rep", 0) * E * G + terms.get("row_rep", 0) * E
                       + terms.get("col_rep", 0) * G + terms.get("rep", 0)))

    t_bytes = count(entry["bytes"]) / peaks["bytes_per_s"]
    t_ops = count(entry["ops"]) / peaks["flops"][entry["compute"]]
    return max(t_bytes, t_ops)


def roofline_share(run, kernel: str):
    """Percent: the least time of kernel `kernel`'s live launches in the
    window over the device time of all of its launches (a launch skipped
    by its done flag counts only its time); None where the window has no
    launch of it or the device has no peaks on record."""
    if run.trace is None or run.peaks is None:
        return None
    E, G = run.config["n_ecs"], run.config["n_groups"]
    B = run.traffic.get("replicates", 1)
    least = spent = 0.0
    for name, _, dur_us in run.trace.ops:
        entry = run.kernels.get(symbol(name))
        if entry is None or entry["kernel"] != kernel:
            continue
        t = least_seconds(entry, E, G, run.peaks, B)
        dur = dur_us * 1e-6
        spent += dur
        if dur >= SKIPPED_BELOW * t:
            least += t
    return 100.0 * least / spent if spent > 0 else None


def breakdown(trace: Trace) -> dict:
    """The traced window's top device operations by time and its longest
    idle gaps, at most TOP of each."""
    top = sorted(trace.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"device_ops": [[symbol(name)[:NAME_CHARS], s] for name, (_, s) in top],
            "idle_gaps": [[name, s] for name, s in trace.gaps]}
