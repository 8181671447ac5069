"""device.idle_share (%): the share of the traced window in which no
kernel, copy or memset ran on the device (one minus the union of the
profiler's device intervals over the window). Moves frame_ms in every
cell: on a path bound by the host the device waits."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    busy = ctx.trace.busy_s()
    if busy <= 0.0:             # nothing ran on a device: not a card's run
        return None
    return 100.0 * (1.0 - busy / ctx.trace.window_s)
