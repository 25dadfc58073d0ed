"""Share of the traced window with no operation on the device (100 - the
union of device activity over the window)."""

LAYER = "Device"
MOVES = "matmul_ops_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
