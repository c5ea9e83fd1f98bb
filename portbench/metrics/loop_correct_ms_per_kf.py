"""Loop closing, correction: the program's ``loop.correct`` spans (the
branch of ``loopclose.loop_stage`` after its decision read, run on a
closure or a feature-graph renewal: the merge, the pose graph, the joint
GBA) summed over the traced part of the window, over its ``slam.loop``
spans (one a keyframe), in ms; 0 where no correction ran.

The spans are host intervals on the profiler's clock (``time.time_ns``),
recorded by ``se2lam_tpu_torch.utils.timing.RECORDER`` while the profiler
runs. The branch reads nothing back after its last solve, so the interval
ends when that solve's last launch is queued, and device work queued faster
than it runs finishes in a later stage. It also holds the profiler's own
host cost of each launch (~13 us a launch, measured on an H100 host), so it
reads above the same stage untraced. A program without the recorder reads
None."""
from se2lam_tpu_torch.utils import timing


def read(run):
    rec = getattr(timing, "RECORDER", None)
    if run.trace is None or rec is None:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    loops = rec.records("slam.loop", t0, t1)
    if not loops:
        return None
    return sum(r.ms for r in rec.records("loop.correct", t0, t1)) / len(loops)
