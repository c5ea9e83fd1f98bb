"""Device: CUDA kernels launched in the traced part of the window, over the
frames completed in it."""


def read(run):
    if run.trace is None or run.traced_frames == 0:
        return None
    n, _ = run.trace.kernels()
    return n / run.traced_frames if n else None
