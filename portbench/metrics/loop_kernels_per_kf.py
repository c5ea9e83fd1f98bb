"""Loop closing, launches: the card's kernels in the traced part of the
window whose start lies inside one of the program's ``slam.loop`` spans
(the loop stage of a keyframe, vocabulary training included), over the
number of those spans.

The spans are host intervals on the profiler's clock (``time.time_ns``,
the clock of the trace's device operations), recorded by
``se2lam_tpu_torch.utils.timing.RECORDER`` while the profiler runs; the
card is idle most of the window, so a kernel starts soon after its launch.
A program without the recorder reads None."""
import bisect

from se2lam_tpu_torch.utils import timing


def read(run):
    rec = getattr(timing, "RECORDER", None)
    if run.trace is None or rec is None:
        return None
    loops = rec.records("slam.loop", run.trace.t0, run.trace.t1)
    if not loops:
        return None
    starts = sorted(s for _, s, _, is_kernel in run.trace.ops if is_kernel)
    n = sum(bisect.bisect_right(starts, r.end_ns) - bisect.bisect_left(starts, r.start_ns)
            for r in loops)
    return n / len(loops)
