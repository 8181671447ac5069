"""wavefront.host_ms (ms/frame): host time per render call inside the
bounce engine, ``kernels.wavefront.wavefront_bounces`` and the renderer's
``wavefront_tail`` (the benchmark's span "wavefront" around both, host
clock). Moves frame_ms in the cells whose frames run sorted bounce
rounds."""


def read(ctx):
    seconds, calls = ctx.spans.get("wavefront", (0.0, 0))
    if not calls or not ctx.frames:
        return None
    return 1e3 * seconds / ctx.frames
