"""Loop closing, detection and verification: the program's ``loop.detect``
spans (``loopclose.loop_stage`` from its entry through its one decision
read: candidate selection, the BoW write and detect, the batched RANSAC
verification, the feature edges) summed over the traced part of the
window, over its ``slam.loop`` spans (one a keyframe), in ms.

The spans are host intervals on the profiler's clock (``time.time_ns``),
recorded by ``se2lam_tpu_torch.utils.timing.RECORDER`` while the profiler
runs. The stage ends in its decision read, so the interval ends with its
device work. It also holds the profiler's own host cost of each launch
(~13 us a launch, measured on an H100 host; the stage makes ~27,600
launches a keyframe), so it reads above the same stage untraced, and a
change that removes launches reads a larger gain here than end to end. A
program without the recorder reads None."""
from se2lam_tpu_torch.utils import timing


def read(run):
    rec = getattr(timing, "RECORDER", None)
    if run.trace is None or rec is None:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    loops = rec.records("slam.loop", t0, t1)
    if not loops:
        return None
    return sum(r.ms for r in rec.records("loop.detect", t0, t1)) / len(loops)
