"""The traced run's records: ``torch.profiler`` over the window, kept in
memory (no trace file), reduced to kernel intervals and host spans.

Kineto stamps host and device events on one clock, the host's
``time.time_ns`` (device times are mapped onto it), so the window's bounds,
the probe's fit marks and the kernels compare directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

#: Host events that launch device work; their correlation ids tie each
#: kernel to the time the host launched it.
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
             "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
             "cudaMemcpy", "cudaMemset")

#: The longest idle gaps that the breakdown names by the host's activity.
_NAMED_GAPS = 2000


@dataclass
class Records:
    """What one traced window left: [t0_ns, t1_ns], the device's
    operations (name, start_ns, end_ns, launch_ns), the host's events
    (name, start_ns, end_ns), the probe's counters, the configuration and
    its objective's operation count ``flops(config, q)``."""

    t0_ns: int
    t1_ns: int
    device_ops: list = field(default_factory=list)
    host_events: list = field(default_factory=list)
    probe: object = None
    config: dict = field(default_factory=dict)
    window_s: float = 0.0
    flops: object = None

    def clipped(self):
        """Device operations clipped to the window: (name, start, end,
        launch)."""
        for name, s, e, launch in self.device_ops:
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e > s:
                yield name, s, e, launch

    def busy_intervals(self) -> list:
        """The union of the device's operations in the window, merged."""
        merged = []
        for _, s, e, _ in sorted(self.clipped(), key=lambda r: r[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> list:
        """The idle stretches of the window: [(start_ns, end_ns)]."""
        out, at = [], self.t0_ns
        for s, e in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.t1_ns > at:
            out.append((at, self.t1_ns))
        return out

    def host_at(self, times_ns) -> list:
        """The innermost host event running at each of ``times_ns``: what
        the host was doing; "python" where no recorded operation covers it."""
        if not self.host_events:
            return ["python"] * len(times_ns)
        names = [n for n, _, _ in self.host_events]
        start = np.array([s for _, s, _ in self.host_events], np.int64)
        end = np.array([e for _, _, e in self.host_events], np.int64)
        length = (end - start).astype(np.float64)
        out = []
        for t in times_ns:
            cover = np.flatnonzero((start <= t) & (end > t))
            out.append("python" if cover.size == 0
                       else names[cover[np.argmin(length[cover])]])
        return out

    def q_at(self, t_ns: int) -> int | None:
        """Input columns of the fit running at ``t_ns`` (the probe's marks)."""
        q = None
        for mark, mq in self.probe.marks:
            if mark <= t_ns:
                q = mq
        return q

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, seconds each."""
        ops: dict = {}
        for name, s, e, _ in self.clipped():
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        idle: dict = {}
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:_NAMED_GAPS]
        for (s, e), name in zip(gaps, self.host_at([(s + e) // 2
                                                    for s, e in gaps])):
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in rank(ops)],
                "idle_gaps": [[n, v] for n, v in rank(idle)]}


class Tracer:
    """``torch.profiler`` (host and CUDA) around a window."""

    def __init__(self):
        import torch
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def records(self, t0_ns: int, t1_ns: int) -> Records:
        rec = Records(t0_ns=t0_ns, t1_ns=t1_ns)
        events = self._prof.profiler.kineto_results.events()
        launch_at = {}
        for e in events:
            if e.device_type() == DeviceType.CPU:
                name = e.name()
                start, end = e.start_ns(), e.end_ns()
                if name.startswith(_LAUNCHES):
                    launch_at[e.correlation_id()] = start
                if end > start:
                    rec.host_events.append((name, start, end))
        # A host annotation has a copy on the device's timeline under the
        # same name; that copy is no device work.
        host_names = {name for name, _, _ in rec.host_events}
        for e in events:
            if (e.device_type() == DeviceType.CUDA
                    and e.name() not in host_names):
                start, end = e.start_ns(), e.end_ns()
                rec.device_ops.append((e.name(), start, end,
                                       launch_at.get(e.correlation_id(),
                                                     start)))
        return rec
