"""renderer.launches_per_frame (launches/frame): device activities
(kernels, copies, memsets) in the traced window over the render calls in
it, from the profiler's device trace. On a path bound by the host, each
launch costs host time; moves frame_ms in every cell."""


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    n = ctx.trace.device_count()
    return n / ctx.frames if n else None
