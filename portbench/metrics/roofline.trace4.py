"""roofline.trace4 (%): kernel A's share of its roofline, the least time
its frame's work could take on the card over the time its launches took
in the traced window (the profiler's device trace).

The least time is a bytes bound, bytes over the card's peak memory
bandwidth (``portbench/peaks.json``, stated against the card's power
limit): each primary ray's origin and direction read and its hit record
(t, normal, albedo, material type) written, and each triangle's vertices
and material read once a frame. It counts from the frame's ray count and
the scene's triangle count only, never from the program's table layouts
or launch arguments, so a later layout meets the same yardstick. The
operation count is left out, so this is a lower bound on the share.
Moves frame_ms."""

RAY_BYTES = 24 + 32          # origin + direction in; t, n, albedo, type out
TRI_BYTES = 36 + 16          # three vertices; rgb + type
KERNEL = r"trace4_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.peaks:
        return None
    seconds = ctx.trace.kernel_s(KERNEL)
    if seconds <= 0.0:
        return None
    nbytes = ctx.primaries * RAY_BYTES + ctx.frames * ctx.triangles * TRI_BYTES
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / seconds
