"""One ``torch.profiler`` capture of a few calls, reduced for the metrics.

The harness wraps each call in a range ``bench.call`` (and an entry may
wrap its own parts in ``bench.*`` ranges); the program's driver opens a
range for each stage of the pipeline while a profiler runs
(``rte_rrtmgp_torch.models.radiation.STAGES``).  On the card's timeline
each range also has a device-side span.  The arithmetic that gives a
stage the card's work inside its span is copied from the program's
``tools/profile_stages.py`` (``device_rows``, ``stage_times``): the
stream runs in order, so a span holds only its stage's work, and that
reaches the hand-written kernels too, which ``ctypes`` launches outside
any aten op.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

PREFIX = "bench."
# Kernel names in the breakdown are cut to this many characters.
NAME_CHARS = 160


def span(name: str):
    """A harness range ``bench.<name>`` while a profiler runs; nothing
    (one check) otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return contextlib.nullcontext()


@dataclasses.dataclass
class Trace:
    """What the metric readers read: times in microseconds on the
    profiler's clock."""

    calls: int                 # calls captured
    window: tuple              # (start, end) of the captured calls, host side
    ops: list                  # device operations: (name, start, end, stage)
    host_ranges: list          # host-side ranges: (name, start, end)

    def stage_us(self, names) -> float:
        """The card's time a call in the ranges ``names``."""
        return sum(e - s for _, s, e, st in self.ops if st in names) / self.calls

    def has_stage(self, names) -> bool:
        return any(st in names for _, _, _, st in self.ops)

    def busy_us(self) -> float:
        """Time inside the window in which some operation ran on the card."""
        w0, w1 = self.window
        busy, end = 0.0, w0
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, end), min(e, w1)
            if e > s:
                busy += e - s
                end = e
        return busy

    def gaps(self) -> list:
        """Idle stretches of the card inside the window: (start, end)."""
        w0, w1 = self.window
        out, end = [], w0
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                out.append((end, min(s, w1)))
            end = max(end, e)
        if w1 > end:
            out.append((end, w1))
        return [(a, b) for a, b in out if b > a]

    def host_range_at(self, t: float) -> str:
        """The innermost host-side range open at ``t`` (the harness's when
        no stage's is)."""
        best, width = "host outside any call", None
        for name, s, e in self.host_ranges:
            if s <= t < e and (width is None or e - s < width):
                best, width = name, e - s
        return best

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        stretches grouped by the host range open at their middle, each as
        [name, seconds over the captured calls]."""
        by_op = {}
        for name, s, e, _ in self.ops:
            name = name[:NAME_CHARS]
            by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
        by_gap = {}
        for a, b in self.gaps():
            key = self.host_range_at(0.5 * (a + b))
            by_gap[key] = by_gap.get(key, 0.0) + (b - a) * 1e-6
        srt = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda kv: -kv[1])][:top]
        return {"device_ops": srt(by_op), "idle_gaps": srt(by_gap)}


def capture(call, n: int, stages, cuda: bool):
    """Run ``call`` ``n`` times under ``torch.profiler`` (each call in a
    ``bench.call`` range) and reduce the profile.  Returns (the last
    call's outputs, :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(n):
            with span("call"):
                out = call()
    return out, reduce(prof.events(), n, set(stages), cuda)


def reduce(events, n: int, stages: set, cuda: bool) -> Trace:
    """:class:`Trace` from the profiler's events of ``n`` calls."""
    CPU = torch.autograd.DeviceType.CPU
    CUDA = torch.autograd.DeviceType.CUDA
    annot = lambda name: name in stages or name.startswith(PREFIX)
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == CPU and annot(e.name)]
    calls = [(s, e) for name, s, e in host if name == PREFIX + "call"]
    window = (min(s for s, _ in calls), max(e for _, e in calls))
    dev = [e for e in events if e.device_type == CUDA] if cuda else []
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in dev if e.name in stages)
    starts = [sp[0] for sp in spans]
    ops = []
    for e in dev:
        if annot(e.name):
            continue
        s, t = e.time_range.start, e.time_range.end
        i = bisect.bisect_right(starts, s) - 1
        stage = spans[i][2] if i >= 0 and s < spans[i][1] else None
        ops.append((e.name, s, t, stage))
    return Trace(calls=n, window=window, ops=ops, host_ranges=host)
