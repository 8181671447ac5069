"""roofline.bounce12 (%): kernel B's (the no-colour-carry build's) share
of its roofline, the least time its frame's bounce work could take on the
card over the time its launches took in the traced window (the profiler's
device trace).

The least time is a bytes bound, bytes over the card's peak memory
bandwidth (``portbench/peaks.json``, stated against the card's power
limit): each ray entering a bounce walk (the calls' rays traced less the
primaries) reads and writes its origin, direction, throughput and seed,
and each triangle's vertices and material are read once a frame. It
counts from ray and triangle counts only, never from the program's table
layouts, round widths or launch arguments. The operation count is left
out, so this is a lower bound on the share. Moves frame_ms."""

RAY_BYTES = 2 * (12 + 12 + 12 + 4)   # origin, direction, throughput, seed
TRI_BYTES = 36 + 16                  # three vertices; rgb + type
KERNEL = r"bounce_kernel<false"


def read(ctx):
    if ctx.trace is None or not ctx.peaks:
        return None
    seconds = ctx.trace.kernel_s(KERNEL)
    bounces = ctx.rays - ctx.primaries
    if seconds <= 0.0 or bounces <= 0:
        return None
    nbytes = bounces * RAY_BYTES + ctx.frames * ctx.triangles * TRI_BYTES
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / seconds
