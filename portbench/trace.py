"""The device's trace over a run's window, from ``torch.profiler`` (CUPTI
activity records), reduced to what the readers need: each device
operation's name, start and length, the union of the intervals in which
the device was busy, and the idle gaps between them labelled by the span
the host was in when the gap began."""
from __future__ import annotations

from collections import defaultdict

__all__ = ["DeviceTrace", "start_profiler"]


def start_profiler():
    """A started profiler recording the card's activity only: host-side
    operator records would cost every launch of the eager program."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


class DeviceTrace:
    """``ops``: (name, start ns, duration ns, is_kernel) of every device
    operation inside [t0, t1] (time.time_ns, the profiler's clock)."""

    def __init__(self, prof, t0_ns: int, t1_ns: int):
        from torch.autograd import DeviceType

        self.t0, self.t1 = t0_ns, t1_ns
        self.ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s, d = e.start_ns(), e.duration_ns()
            if s + d < t0_ns or s > t1_ns:
                continue
            name = e.name()
            self.ops.append((name, s, d, not name.startswith(("Memcpy", "Memset"))))
        self.ops.sort(key=lambda o: o[1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        """The union of the operations' intervals, clipped to the window."""
        out = []
        for _, s, d, _ in self.ops:
            a, b = max(s, self.t0), min(s + d, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernels(self, part: str = ""):
        """(count, summed seconds) of the kernels whose name holds ``part``
        (all kernels for "")."""
        n, ns = 0, 0
        for name, _, d, is_kernel in self.ops:
            if is_kernel and part in name:
                n += 1
                ns += d
        return n, ns / 1e9

    def top_ops(self, n: int = 10):
        """The ``n`` device operations that took most time, by name."""
        by = defaultdict(int)
        for name, _, d, _ in self.ops:
            by[name] += d
        return [[k[:120], v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans, n: int = 10):
        """The device's idle time summed by the innermost span the host was
        in when each gap began (``spans``: label → list of (start ns, end
        ns)); "harness" outside every span. The ``n`` largest."""
        marks = sorted((a, -(b - a), b, label) for label, ivs in spans.items() for a, b in ivs)
        busy = self.busy_intervals()
        gaps = []
        prev = self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        by = defaultdict(int)
        j, open_ = 0, []
        for g0, g1 in gaps:
            while j < len(marks) and marks[j][0] <= g0:
                open_.append(marks[j])
                j += 1
            open_ = [m for m in open_ if m[2] > g0]
            # the innermost: the latest-started span still open
            label = max(open_, key=lambda m: m[0])[3] if open_ else "harness"
            by[label] += g1 - g0
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
