"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, read once it has closed.

``busy_s`` is the union of the intervals in which an operation ran on
the card (kernels, copies, sets), clipped to the window; ``window_s``
the window's length.  ``device_ops`` sums each operation's seconds by
name; ``idle_gaps`` are the longest stretches of the window with
nothing on the card, each named by what the benchmark's clients were
doing at its middle (the load's ``label``).  The profiler's clock is
tied to the host's monotonic clock by a mark the window opens with.
On a device other than a card (the CPU tests) the ``aten::`` operations
stand for the card's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

MARK = "kmabench_window_mark"
TOP = 10
NAME_CHARS = 120


class Window:
    """``start`` opens the trace at once, or with ``later`` in the
    profiler's warm-up (its device tracing primed, nothing kept) until
    ``record`` opens it: a trace opened cold in the middle of busy work
    records nothing for its first seconds."""

    def __init__(self, device, later: bool = False):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        self.torch = torch
        self.cuda = device.type == "cuda"
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self.later = later
        self.prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) if later \
            else profile(activities=acts)

    def start(self) -> None:
        self.prof.__enter__()
        if not self.later:
            self._mark()

    def record(self) -> None:
        self.prof.step()
        self._mark()

    def _mark(self) -> None:
        self.t_mark = time.perf_counter()
        with self.torch.profiler.record_function(MARK):
            pass

    def _intervals(self):
        """(mark start s, [(start s, end s, name)] of the device's ops),
        on the profiler's clock."""
        dev_type = self.torch.autograd.DeviceType
        mark, ops = None, []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns() / 1e9
            if name == MARK:
                mark = t0
                continue
            if self.cuda:
                if e.device_type() != dev_type.CUDA:
                    continue
            elif not name.startswith("aten::"):
                continue
            ops.append((t0, t0 + e.duration_ns() / 1e9, name))
        if mark is None:
            raise RuntimeError("the profiler lost the window's mark")
        return mark, ops

    def stop(self, t_start: float, t_end: float, label) -> Dict:
        """The window [t_start, t_end] (host clock) read from the trace;
        ``label(t)`` names what the clients did at host time t."""
        self.prof.__exit__(None, None, None)
        mark, ops = self._intervals()
        shift = mark - self.t_mark
        w0, w1 = t_start + shift, t_end + shift
        by_name: Dict[str, float] = {}
        spans: List[Tuple[float, float]] = []
        for a, b, name in ops:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            spans.append((a, b))
        spans.sort()
        busy, gaps = 0.0, []
        end = w0
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if w1 > end:
            gaps.append((end, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {
            "busy_s": busy, "window_s": w1 - w0, "op_s": by_name,
            "breakdown": {
                "device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": [["%s, at %.3f s" % (label((a + b) / 2 - shift),
                                                  a - w0), b - a]
                              for a, b in gaps[:TOP]]}}
