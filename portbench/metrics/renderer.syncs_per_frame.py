"""renderer.syncs_per_frame (syncs/frame): synchronising CUDA calls (a
device-to-host read, a blocking copy, a stream wait) in the traced window
over its render calls, counted as PyTorch's sync debug mode warns of them.
Each stalls the host until the device drains; moves frame_ms in every
cell."""


def read(ctx):
    if ctx.syncs is None or not ctx.frames:
        return None
    return ctx.syncs / ctx.frames
